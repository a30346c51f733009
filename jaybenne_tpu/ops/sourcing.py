"""Photon sourcing (thermal initialization and per-step emission).

JAX equivalent of ``SourcePhotons<T, SourceType>``
(``/root/reference/src/jaybenne/sourcing.cpp:25-208``). The reference's two-pass
scheme (per-cell counts + team prefix-scan, host ``AddEmptyParticles``, then a
per-cell fill kernel) becomes a fully vectorized candidate grid + rank-ordered
free-slot scatter:

  1. per cell: source energy ``erad`` — thermal ``(4 sb / c) T^4 dV`` or emission
     ``f * emis * dV * dt`` — and a stochastically rounded particle count
     ``n = floor(npc) + Bernoulli(npc - floor(npc))`` with per-particle weight
     ``erad / n`` (``sourcing.cpp:81-105``);
  2. a static candidate grid of shape ``[n_cells, floor(npc)+1]`` holds every
     potential birth; the Bernoulli tail masks the last column;
  3. valid candidates are ranked by prefix sum and scattered into the ledger's dead
     slots (dead-first stable ordering of the alive mask) — overflow beyond capacity
     is counted and dropped (reported via ``SimState.overflow``).

Deviation from the reference: per-cell ``npc`` here is ``num_particles /
total_mesh_cells`` so the whole mesh sources ~``num_particles`` regardless of the
block/rank partition; the reference divides by pack-block-count *and* total blocks
(``sourcing.cpp:68-69``), making the sourced count depend on the MPI layout. Tallied
energies are identical either way (weights are ``erad / n``), only sampling noise
differs.

Emission debits the per-cell ``energy_delta`` by the summed birth weights
(``sourcing.cpp:195-198``); birth times are uniform in the step (stored as
``tau ~ U[0,1)``), thermal births start at ``tau = 0``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import planck, rng


def external_source_setup(mesh, jb):
    """Static (host-side) geometry of the external volume source
    (``jaybenne/external_source*``): returns ``(inside_mask, src_cells,
    n_src_cells, ext_prm)`` — the GLOBAL box mask over cell centers
    ([n_blocks, nz, ny, nx] bool), the flat global source-cell ids, their
    count, and the ``(q, tmax, temperature)`` parameter tuple. Shared by the
    single/particle-sharded step builder and the spatial one."""
    import numpy as np

    box = jb.external_source_box or mesh.bounds
    xc, yc, zc = (np.asarray(a) for a in mesh.cell_centers())
    m = (
        (xc >= box[0]) & (xc < box[1])
        & (yc >= box[2]) & (yc < box[3])
        & (zc >= box[4]) & (zc < box[5])
    )
    n_src = int(m.sum())
    if n_src == 0:
        raise ValueError("external_source box contains no cell centers")
    src_cells = jnp.asarray(np.flatnonzero(m.reshape(-1)), jnp.int32)
    prm = (
        jb.external_source_q,
        # clamp the open-ended default below f32 max (cast warning)
        min(jb.external_source_tmax, 3.0e38),
        jb.external_source_temperature,
    )
    return jnp.asarray(m), src_cells, n_src, prm


def source_photons(
    fields,
    particles,
    mesh,
    key,
    *,
    source_type: str,
    eos,
    opacity,
    sb: float,
    c: float,
    num_particles: int,
    dt,
    dtype,
    axis_name=None,
    cell_mask=None,
    block_offset=None,
    t=None,
    external=None,
    inside_mask=None,
    src_cells=None,
    n_src_cells=None,
):
    """Returns (fields, particles, n_dropped).

    Under the particle-sharded distribution (``axis_name`` set, no ``cell_mask``),
    each shard sources ``num_particles`` candidates locally (callers pass the
    per-shard share) but the per-particle weight uses the GLOBAL per-cell count
    (``psum`` over shards) so the summed energy per cell is exactly ``erad``
    regardless of the device count.

    Under the spatial distribution with REPLICATED fields, ``cell_mask``
    ([B,1,1,1] broadcastable bool) restricts births to this shard's owned blocks
    at the full per-cell rate; the psum reconstructs the (disjoint-union) global
    counts.

    Under the spatial distribution with SHARDED fields, ``fields`` arrays are the
    shard's local ``[B_local, ...]`` block slice and ``block_offset`` is the
    global id of its first block: every cell is owned by exactly one shard, so
    counts/weights are purely local (no psum), particles are emitted with global
    block ids, and padding blocks (global id >= mesh.n_blocks) source nothing.

    ``source_type = "external"`` (an extension of this build, the Su-Olson driving
    term): isotropic radiation injected at the fixed rate ``q`` [erg/cm^3/s]
    inside ``inside_mask`` (a local-fields-shaped bool; ``n_src_cells`` is the
    static GLOBAL source-cell count normalizing the per-cell particle budget)
    while ``t < tmax``. ``external = (q, tmax, src_temp)``; births are uniform
    over the in-step source window, energy is NOT debited from the matter
    (``energy_delta`` passes through — the source is external by definition)."""
    assert source_type in ("thermal", "emission", "external")
    B, nz, ny, nx = fields.rho.shape  # B is the LOCAL block count when offset set
    n_cells_local = B * nz * ny * nx
    # the per-cell rate normalizes by the GLOBAL cell count so the whole mesh
    # sources ~num_particles regardless of the partition
    n_cells = mesh.total_cells if block_offset is not None else n_cells_local

    temp = eos.temperature_from_density_internal_energy(fields.rho, fields.sie)
    if block_offset is not None:
        vol_padded = jnp.concatenate(
            [mesh.block_volume, jnp.ones((B,), mesh.block_volume.dtype)]
        )
        dv = jax.lax.dynamic_slice_in_dim(vol_padded, block_offset, B, 0)[
            :, None, None, None
        ]
    else:
        dv = mesh.block_volume[:, None, None, None]  # [B,1,1,1]

    if source_type == "thermal":
        erad = (4.0 * sb / c) * temp**4 * dv
    elif source_type == "emission":
        emis = opacity.emissivity(fields.rho, temp)
        erad = fields.fleck * emis * dv * dt
    else:
        q, tmax, _ = external
        # in-step source window [t, min(t+dt, tmax)); zero once past the cutoff
        # (also reused below to place birth times inside the window)
        overlap = jnp.clip(jnp.minimum(t + dt, tmax) - t, 0.0, dt).astype(dtype)
        erad = (q * overlap) * dv * inside_mask.astype(dtype)

    norm_cells = n_src_cells if source_type == "external" else n_cells
    npc = float(num_particles) / float(norm_cells)
    base = int(npc)
    frac = npc - base
    k_round, k_attr = jax.random.split(key)
    bern = rng.uniform(k_round, erad.shape, dtype) < frac
    n_cell = base + bern.astype(jnp.int32)  # [B,nz,ny,nx] — local births this shard
    if cell_mask is not None:
        n_cell = jnp.where(cell_mask, n_cell, 0)
    if block_offset is not None:
        own = (jnp.arange(B) + block_offset) < mesh.n_blocks  # padding sources nothing
        n_cell = jnp.where(own[:, None, None, None], n_cell, 0)
    # cells with no source energy emit nothing (deviation: the reference creates
    # zero-weight particles there — e.g. emission with a zero-opacity model,
    # sourcing.cpp:98-103 — which transport as pure dead weight)
    n_cell = jnp.where(erad > 0, n_cell, 0)
    # sharded-fields spatial mode: every cell is owned by exactly one shard, so the
    # local counts ARE the global per-cell counts — no reduction
    n_glob = (
        jax.lax.psum(n_cell, axis_name)
        if (axis_name and block_offset is None)
        else n_cell
    )
    ew = jnp.where(n_glob > 0, erad / jnp.maximum(n_glob, 1).astype(dtype), 0.0)
    ew = ew.astype(dtype)

    if source_type == "external":
        # accumulate over the preceding emission pass, keeping the dumped
        # invariant source_num * source_ew == total sourced energy per cell;
        # external energy is not debited from the matter (it enters the system
        # from outside)
        tot_e = fields.source_num * fields.source_ew + n_glob.astype(dtype) * ew
        new_num = fields.source_num + n_glob.astype(dtype)
        fields = dataclasses.replace(
            fields,
            source_num=new_num,
            source_ew=jnp.where(
                new_num > 0, tot_e / jnp.maximum(new_num, 1.0), 0.0
            ).astype(dtype),
        )
    else:
        fields = dataclasses.replace(
            fields,
            source_num=n_glob.astype(dtype),
            source_ew=ew,
            energy_delta=(
                -(n_glob.astype(dtype) * ew)
                if source_type == "emission"
                else jnp.zeros_like(ew)
            ),
        )

    # ---- candidate grid ------------------------------------------------------
    K = base + 1  # static max births per cell
    if source_type == "external":
        # rows = the (static) global source-cell set, NOT the whole local grid:
        # K scales as ext_num / n_src_cells, so a localized box would inflate a
        # whole-grid candidate array by n_cells / n_src_cells — unusable at big
        # mesh sizes. ``src_cells`` are flat GLOBAL cell ids; each shard keeps
        # the rows it owns (every one, when fields are global/replicated).
        C = int(src_cells.shape[0])
        g = src_cells.astype(jnp.int32)
        i_c = g % nx
        j_c = (g // nx) % ny
        k_c = (g // (nx * ny)) % nz
        b_c = g // (nx * ny * nz)  # GLOBAL block ids
        if block_offset is not None:
            lb = b_c - block_offset
            owned = (lb >= 0) & (lb < B)
            lflat = jnp.where(
                owned, (lb * nz + k_c) * ny * nx + j_c * nx + i_c, 0
            )
        else:
            owned = jnp.ones((C,), bool)
            lflat = g
        n_flat = jnp.where(owned, n_cell.reshape(n_cells_local)[lflat], 0)
        ew_flat = jnp.where(owned, ew.reshape(n_cells_local)[lflat], 0.0)
        temp_flat = temp.reshape(n_cells_local)[lflat].astype(dtype)
    else:
        C = n_cells_local
        cflat = jnp.arange(C, dtype=jnp.int32)
        i_c = cflat % nx
        j_c = (cflat // nx) % ny
        k_c = (cflat // (nx * ny)) % nz
        b_c = cflat // (nx * ny * nz)
        if block_offset is not None:
            b_c = jnp.clip(b_c + block_offset, 0, mesh.n_blocks - 1)  # global ids
        n_flat = n_cell.reshape(C)
        ew_flat = ew.reshape(C)
        temp_flat = temp.reshape(C).astype(dtype)
    valid = jnp.arange(K, dtype=jnp.int32)[None, :] < n_flat[:, None]  # [C, K]

    keys = jax.random.split(k_attr, 6)
    shape = (C, K)
    ux = rng.uniform(keys[0], shape, dtype)
    uy = rng.uniform(keys[1], shape, dtype)
    uz = rng.uniform(keys[2], shape, dtype)
    ndir = rng.isotropic_direction(keys[3], shape, dtype)

    dxv = mesh.block_dx[b_c]  # [C, 3]
    # block-local positions, uniform over the cell (sourcing.cpp:175-177)
    x = (i_c.astype(dtype)[:, None] + ux) * dxv[:, 0:1]
    y = (j_c.astype(dtype)[:, None] + uy) * dxv[:, 1:2]
    z = (k_c.astype(dtype)[:, None] + uz) * dxv[:, 2:3]
    # isotropic velocity; the reference samples (theta, phi) with the polar axis on z
    # (sourcing.cpp:180-185) — identical distribution
    vx = c * ndir[0]
    vy = c * ndir[1]
    vz = c * ndir[2]

    if source_type == "external" and external[2] > 0:
        # fixed injection spectrum (only frequency-dependent models care)
        temp_flat = jnp.full((C,), external[2], dtype)
    energy = planck.sample_planck_energy(keys[4], sb, temp_flat[:, None], shape, dtype)
    weight = jnp.broadcast_to(ew_flat[:, None], shape)
    if source_type == "emission":
        tau = rng.uniform(keys[5], shape, dtype)
    elif source_type == "external":
        # births uniform over the in-step source window [t, t + overlap)
        tau = rng.uniform(keys[5], shape, dtype) * (
            overlap / jnp.asarray(dt, dtype)
        )
    else:
        tau = jnp.zeros(shape, dtype)

    # ---- rank-ordered free-slot scatter -------------------------------------
    from ..particles import insert_particles

    cand = dict(
        x=x, y=y, z=z, vx=vx, vy=vy, vz=vz,
        tau=tau, weight=weight, energy=energy,
        block=jnp.broadcast_to(b_c[:, None], shape),
        i=jnp.broadcast_to(i_c[:, None], shape),
        j=jnp.broadcast_to(j_c[:, None], shape),
        k=jnp.broadcast_to(k_c[:, None], shape),
    )
    particles, n_dropped = insert_particles(particles, cand, valid)
    return fields, particles, n_dropped
