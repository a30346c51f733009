"""Spatial (block-sharded) distribution with particle migration and SHARDED fields.

The mapping of the reference's MPI decomposition (SURVEY §2d):
blocks are assigned contiguously to shards; particles live on the shard owning their
block; the per-step census loop becomes

    iterate {  local transport to census/exit  ->  all_to_all particle migration
               ->  subface fixup of DDMC arrivals  }
    until psum(unfinished) == 0

which is exactly the reference's iterative task list (``jaybenne.cpp:113-131``:
transport -> swarm Send/Receive -> ``SampleDDMCBlockFace`` -> global completion
check), with ``lax.all_to_all`` in place of per-neighbor MPI buffers and
``psum`` in place of the allreduce.

**Memory layout.** Field arrays are SHARDED along the block axis (padded to
``n_shards * B_local`` for an even split; see ``pad_field_blocks``): each shard
holds only its ``[B_local, nz, ny, nx]`` slice of matter + radiation state, so
per-device field bytes scale ~1/N — the regime this decomposition exists for
(reference blocks are distributed the same way, ``jaybenne.cpp:26-61``). Block
METADATA (origins, sizes, levels, lookup grid — a few KB) stays replicated, which is
what lets a shard compute the full block transition for an outgoing particle before
shipping it. The one cross-shard field communication is the DDMC face-probability
construction: each face samples tau on BOTH sides, and every cross-block sample
lands in the neighbor block's first cell layer, so only the blocks' boundary-
SURFACE ``sigma_t`` values are ``all_gather``-ed (O(B * surface) bytes — the
ghost-face-only exchange of the reference's ``ddmc_reg`` pass,
``jaybenne.cpp:108-110``).

Migration uses fixed-size per-pair buffers: overflowing SENT particles stay in
transit and ride the next iteration (lossless); RECEIVED particles that find no free
ledger slot are dropped and counted into ``SimState.overflow`` (the driver warns —
raise ``jaybenne/capacity_factor`` if it fires). DDMC particles that leaked into a
finer REMOTE block carry a pending-leak code and are subface-resampled by the owner
on arrival (``ParticleLedger.leak``), mirroring the reference's post-communication
``SampleDDMCBlockFace`` pass.

Prefer the particle-sharded strategy (``jaybenne_tpu.parallel.sharding``) unless the
mesh is too large to replicate: it needs no migration at all. This module exists for
(a) capability parity with the reference's decomposition, (b) the huge-mesh regime,
and (c) exercising the multi-chip communication path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..config import RunConfig
from ..particles import insert_particles
from ..state import SimState
from ..step import StepStats, census_path, make_transport_params
from ..ops import fleck as fleck_ops
from ..ops import rng, sourcing, tally
from ..ops import transport as transport_ops
from .sharding import state_specs

# particle fields shipped during migration
_MIGRATE_FIELDS = (
    "x", "y", "z", "vx", "vy", "vz", "tau", "weight", "energy",
    "block", "i", "j", "k", "face", "leak",
)
# the migration-round cap and per-pair buffer size are deck-configurable:
# jaybenne/max_migration_rounds, jaybenne/migration_buffer_k (config.py)


def _pad_blocks(arr, n_pad, fill=0.0):
    if n_pad == 0:
        return arr
    pad_shape = (n_pad,) + arr.shape[1:]
    return jnp.concatenate([arr, jnp.full(pad_shape, fill, dtype=arr.dtype)])


def _pack_cols(cols, idx):
    """Stack ``cols`` (each [n]) as i32 lanes of one [n + 1, L] row matrix
    (a zero row appended) and gather its rows at ``idx``. 64-bit columns
    (precision = f64) are bitcast to TWO i32 lanes, f32 bitcast to one, other
    types converted. Returns ``(rows, offsets)``: column ``c`` starts at lane
    ``offsets[c]``; unpack with ``_unpack_col(rows, offsets[c], dtype)``."""
    i32 = jnp.int32
    packed = []
    offsets = []
    for c in cols:
        offsets.append(len(packed))
        if np.dtype(c.dtype).itemsize == 8:
            two = jax.lax.bitcast_convert_type(c, i32)  # [n, 2]
            packed += [two[:, 0], two[:, 1]]
        elif c.dtype == jnp.float32:
            packed.append(jax.lax.bitcast_convert_type(c, i32))
        else:
            packed.append(c.astype(i32))
    mat = jnp.stack(packed, axis=1)
    mat = jnp.concatenate([mat, jnp.zeros((1, mat.shape[1]), i32)])
    return mat[idx], tuple(offsets)


def _unpack_col(rows, off, dtype):
    """Inverse of ``_pack_cols`` for the column starting at lane ``off``."""
    if np.dtype(dtype).itemsize == 8:
        return jax.lax.bitcast_convert_type(rows[:, off : off + 2], dtype)
    v = rows[:, off]
    if dtype == jnp.float32:
        return jax.lax.bitcast_convert_type(v, dtype)
    return v.astype(dtype)


def migrate(p, offset, blocks_per_shard, n_shards, K, axis_name):
    """One round of all_to_all particle migration. Particles flagged in transit
    (block outside the local range) are grouped by destination shard via a stable
    sort, packed into fixed ``[n_shards, K]`` buffers, exchanged, and inserted into
    the receiver's free slots. Returns (particles, n_received_dropped, n_sent)."""
    cap = p.capacity
    in_transit = p.alive & (
        (p.block < offset) | (p.block >= offset + blocks_per_shard)
    )
    dest = jnp.clip(p.block // blocks_per_shard, 0, n_shards - 1)
    dest = jnp.where(in_transit, dest, n_shards)  # n_shards == "stay"

    order = jnp.argsort(dest, stable=True).astype(jnp.int32)
    sdest = dest[order]
    first = jnp.searchsorted(sdest, jnp.arange(n_shards + 1, dtype=sdest.dtype))
    rank_sorted = jnp.arange(cap, dtype=jnp.int32) - first[jnp.clip(sdest, 0, n_shards)]
    ok_sorted = (sdest < n_shards) & (rank_sorted < K)
    slot_sorted = jnp.where(ok_sorted, sdest * K + rank_sorted, n_shards * K)

    # Pack all fields through the permutation with ONE row gather. One small
    # index scatter builds slot -> source; unfilled slots read the appended
    # zero row (valid=False). The dtype-preserving pack carries 64-bit fields
    # (precision = f64) as two i32 lanes.
    src_of_slot = (
        jnp.full((n_shards * K,), cap, jnp.int32)
        .at[slot_sorted]
        .set(order, mode="drop")
    )
    cols = [getattr(p, n) for n in _MIGRATE_FIELDS] + [in_transit]
    rows, offs = _pack_cols(cols, src_of_slot)
    buffers = {
        name: _unpack_col(rows, offs[c], getattr(p, name).dtype).reshape(n_shards, K)
        for c, name in enumerate(_MIGRATE_FIELDS)
    }
    valid_buf = _unpack_col(rows, offs[len(_MIGRATE_FIELDS)], jnp.bool_).reshape(
        n_shards, K
    )

    # mark shipped particles dead locally
    sent = jnp.zeros((cap,), dtype=bool).at[order].set(ok_sorted & (sdest < n_shards))
    p = dataclasses.replace(p, alive=p.alive & ~sent)

    # exchange: out[j] on this shard = what shard j addressed to us
    def xchg(buf):
        return jax.lax.all_to_all(buf, axis_name, split_axis=0, concat_axis=0, tiled=False)

    recv = {name: xchg(buf) for name, buf in buffers.items()}
    recv_valid = xchg(valid_buf)

    # absorbed rows still carry weight for the end-of-step absorption tally:
    # reserve them so mid-step arrivals cannot recycle (and destroy) them
    p, dropped = insert_particles(
        p,
        {name: arr.reshape(-1) for name, arr in recv.items()},
        recv_valid.reshape(-1),
        reserved=p.absorbed,
    )
    n_sent = jnp.sum(sent.astype(jnp.int32), dtype=jnp.int32)
    return p, dropped, n_sent


def rehome_restart_ledger(p, mesh, n_shards):
    """Host-side ledger reorder at RESTART: place every alive particle in the
    ledger slice of the shard that owns its block, so a checkpoint written at
    any device count resumes correctly at any other.

    ``shard_state`` splits the ledger by slot position, so without this a
    restored particle can land on a non-owning shard. Normally the first
    migration round re-homes it, but when migration is statically impossible
    (``B <= blocks_per_shard``: every real block owned by shard 0) such a
    particle would be masked out of transport forever.

    Only MISPLACED particles move (into free slots of their owner's slice);
    everything else stays byte-identical — slot order seeds the per-lane RNG
    streams, so touching correctly-placed particles would change their
    trajectories and break the bitwise same-count-resume guarantee even when
    an unrelated in-transit particle happens to be in the checkpoint."""
    import numpy as np

    cap = p.capacity
    if cap % n_shards:
        raise ValueError(
            f"ledger capacity {cap} not divisible by n_devices {n_shards}"
        )
    cap_l = cap // n_shards
    Bl = -(-mesh.n_blocks // n_shards)
    alive = np.asarray(p.alive)
    owner = np.clip(np.asarray(p.block) // Bl, 0, n_shards - 1)
    slot_shard = np.arange(cap) // cap_l
    move = alive & (owner != slot_shard)
    if not move.any():
        return p
    cols = {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}
    out = {name: arr.copy() for name, arr in cols.items()}
    out["alive"][move] = False  # vacated sources become free slots
    free = ~alive | move
    for s in range(n_shards):
        idx = np.nonzero(move & (owner == s))[0]
        if idx.size == 0:
            continue
        dst = np.nonzero(free[s * cap_l : (s + 1) * cap_l])[0] + s * cap_l
        if idx.size > dst.size:
            raise ValueError(
                f"restart re-homing: shard {s} owns {idx.size} relocated "
                f"particles but its ledger slice has only {dst.size} free "
                f"slots; raise jaybenne/capacity_factor"
            )
        dst = dst[: idx.size]
        for name, arr in cols.items():
            out[name][dst] = arr[idx]
    return dataclasses.replace(
        p, **{k: jnp.asarray(v) for k, v in out.items()}
    )


# Matter fields whose padding-block fill must be 1.0 (not 0.0) so pointwise
# derived-field math (EOS temperature, Fleck factor) stays finite on padding
# blocks. Shared with io.read_checkpoint's block re-padding.
PAD_ONES = ("rho", "sie", "u")


def pad_field_blocks(fields, mesh, n_shards):
    """Pad every field array's block axis from ``B`` to ``n_shards * ceil(B/n)`` so
    it splits evenly over the device mesh. Padding matter blocks carry benign
    values (rho = sie = u = 1) so pointwise derived-field math stays finite; they
    source no particles and no particle ever enters them (they cover no domain
    volume in the lookup grid)."""
    B = mesh.n_blocks
    Bl = -(-B // n_shards)
    n_pad = n_shards * Bl - B
    if n_pad == 0:
        return fields
    return dataclasses.replace(
        fields,
        **{
            f.name: _pad_blocks(
                getattr(fields, f.name), n_pad, 1.0 if f.name in PAD_ONES else 0.0
            )
            for f in dataclasses.fields(fields)
        },
    )


def _fixup_subface_arrivals(p, coefs_local, mesh, prm, offset, n_local, key):
    """Subface-resample DDMC particles that arrived via migration with a pending
    coarse->fine leak code (the reference's post-communication
    ``SampleDDMCBlockFace``): choose among the destination block's fine faces with
    probability ~ its local ``ddmc_face_prob`` values, re-seat the transverse
    position, redraw a hemisphere direction, and clear the code."""
    need = p.alive & (p.leak != 0) & (p.block >= offset) & (p.block < offset + n_local)
    dtype = p.x.dtype
    U = jax.random.uniform(key, (5,) + p.x.shape, dtype=dtype)
    mu = jnp.sqrt(U[3])
    nu = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
    phi = (2.0 * jnp.pi) * U[4]
    draws = (U[0], U[1], U[2], mu, nu * jnp.cos(phi), nu * jnp.sin(phi))
    b_loc = jnp.clip(p.block - offset, 0, n_local - 1)
    dxv = mesh.block_dx[p.block]
    lx, ly, lz, vx, vy, vz, ii, jj, kk = transport_ops._ddmc_subface_resample(
        mesh, coefs_local, prm, draws, need, p.leak, b_loc, dxv,
        p.x, p.y, p.z, p.vx, p.vy, p.vz, p.i, p.j, p.k,
    )
    return dataclasses.replace(
        p,
        x=lx, y=ly, z=lz, vx=vx, vy=vy, vz=vz, i=ii, j=jj, k=kk,
        leak=jnp.where(need, 0, p.leak),
    )


def build_spatial_step_core(mesh, cfg: RunConfig, n_shards: int, axis_name="shard"):
    """Per-cycle step body for ``shard_map``: fields AND particles sharded by
    owning block, census via migration rounds + psum completion. The per-round
    local transport is the XLA event loop with ``block_offset`` (the census
    kernel does not cover this decomposition; ``use_pallas = on`` raises)."""
    eos = cfg.mcblock.build_eos()
    opacity = cfg.mcblock.build_opacity()
    scattering = cfg.mcblock.build_scattering()
    consts = opacity.get_runtime_physical_constants()
    jb = cfg.jaybenne
    dtype = jb.dtype
    prm = make_transport_params(cfg, dtype)
    periodic = cfg.mesh.periodic_flags
    census_path(jb.use_pallas, dtype, spatial=True)  # raises for on/interpret

    B = mesh.n_blocks
    Bl = -(-B // n_shards)  # blocks per shard (last shard may own padding)
    smr_ddmc = jb.use_ddmc and mesh.max_level > 0
    # Migration is statically impossible when every REAL block is owned by
    # shard 0 (B <= Bl: the other shards hold only padding blocks, which cover
    # no domain volume, so no particle can ever address them). Skip both the
    # all_to_all machinery and the per-round iteration budget — each would be
    # pure per-round overhead (e.g. a 1-block deck at n_devices=2 otherwise
    # pays ~50 budget-truncated rounds of pack/exchange/insert per cycle).
    can_migrate = n_shards > 1 and B > Bl

    # external volume source: static global box mask (padded along the block
    # axis, sliced to each shard's owned blocks) + global source-cell set
    ext_on = jb.external_source_q > 0
    if ext_on:
        inside_mask, ext_src_cells, n_src_cells, ext_prm = (
            sourcing.external_source_setup(mesh, jb)
        )
        ext_mask_padded = _pad_blocks(inside_mask, n_shards * Bl - B, False)
        ext_num = jb.external_source_num or jb.num_particles

    def step(state, dt):
        f = state.fields  # this shard's LOCAL [Bl, ...] block slice
        p = state.particles
        shard = jax.lax.axis_index(axis_name)
        offset = shard * Bl
        key = jax.random.fold_in(state.rng_key, state.cycle)
        key = jax.random.fold_in(key, shard)
        if ext_on:
            k_src, k_tr, k_fix, k_ext = jax.random.split(key, 4)
        else:
            k_src, k_tr, k_fix = jax.random.split(key, 3)

        # 1. derived fields: the Fleck factor is pointwise on local blocks; the
        # DDMC face probabilities need tau on BOTH sides of every local face.
        # Every cross-block sample point lands in the neighbor block's first
        # cell layer, so only each block's boundary-SURFACE sigma_t is
        # exchanged — O(B * surface) instead of the full O(B * volume) array
        # (the ghost-face-only exchange of jaybenne.cpp:108-110).
        f = dataclasses.replace(
            f, fleck=fleck_ops.fleck_factor(f.rho, f.sie, eos, opacity, dt, dtype)
        )
        if jb.use_ddmc:
            temp = eos.temperature_from_density_internal_energy(f.rho, f.sie)
            sig_t = (
                opacity.absorption_coefficient(f.rho, temp)
                + scattering.total_scattering_coefficient(f.rho, temp)
            )
            sig_t = jnp.broadcast_to(jnp.asarray(sig_t, dtype), f.rho.shape)
            surf_local = fleck_ops.pack_boundary_surface(mesh, sig_t)
            surf_glob = jax.lax.all_gather(
                surf_local, axis_name, axis=0, tiled=True
            )
            px, py, pz = fleck_ops.ddmc_face_probs_spatial(
                mesh, sig_t, surf_glob, offset, jb.tau_ddmc, periodic, dtype
            )
            f = dataclasses.replace(f, ddmc_px=px, ddmc_py=py, ddmc_pz=pz)

        # 2. emission sourcing into local blocks (disjoint ownership — no psum)
        dropped = jnp.zeros((), jnp.int32)
        if jb.do_emission:
            f, p, dropped = sourcing.source_photons(
                f, p, mesh, k_src,
                source_type="emission",
                eos=eos, opacity=opacity,
                sb=consts.sb, c=consts.c,
                num_particles=jb.num_particles,
                dt=dt, dtype=dtype,
                block_offset=offset,
            )
            dropped = dropped.astype(jnp.int32)
        else:
            f = dataclasses.replace(
                f,
                energy_delta=jnp.zeros_like(f.energy_delta),
                **(
                    dict(
                        source_num=jnp.zeros_like(f.source_num),
                        source_ew=jnp.zeros_like(f.source_ew),
                    )
                    if ext_on
                    else {}
                ),
            )

        if ext_on:
            local_mask = jax.lax.dynamic_slice_in_dim(
                ext_mask_padded, offset, Bl, 0
            )
            f, p, ext_drop = sourcing.source_photons(
                f, p, mesh, k_ext,
                source_type="external",
                eos=eos, opacity=opacity,
                sb=consts.sb, c=consts.c,
                num_particles=ext_num,
                dt=dt, dtype=dtype,
                block_offset=offset,
                t=state.t,
                external=ext_prm,
                inside_mask=local_mask,
                src_cells=ext_src_cells,
                n_src_cells=n_src_cells,
            )
            dropped = dropped + ext_drop.astype(jnp.int32)

        # 3. census loop with migration (jaybenne.cpp:113-131): the local fields
        # ARE the transport coefficients' extent — no slicing
        coefs_local = transport_ops.precompute_coefs(
            f, mesh, eos, opacity, scattering, jb.use_ddmc, dtype
        )
        K = jb.migration_buffer_k or max(64, p.capacity // (2 * n_shards))
        max_rounds = jb.max_migration_rounds

        # Per-round iteration budget (census_iters_per_round): without it a
        # round drains to LOCAL completion while migrated-out lanes idle,
        # so k-hop particles cost ~(k+1) full census lengths on the worst
        # device; with it the rounds interleave. The budget never fails a
        # step — lanes unfinished at the cap simply continue next round —
        # so cap_hits below keeps counting only the real hang backstop.
        prm_round = prm
        if can_migrate and jb.census_iters_per_round > 0:
            budget = min(jb.census_iters_per_round, prm.max_iters)
            prm_round = dataclasses.replace(prm, max_iters=budget)
            # budget-truncated rounds must not eat the migration-round
            # allowance: the unbudgeted path grants max_transport_iterations
            # PER round for up to max_migration_rounds rounds, so scale the
            # round cap to keep the same total-iteration backstop (it is a
            # hang backstop only — the loop exits at unfinished == 0)
            max_rounds = max_rounds * -(-prm.max_iters // budget)

        def local_transport(p, rounds):
            return transport_ops.transport(
                p, coefs_local, mesh, rng.fold(k_tr, rounds), prm_round, dt,
                block_offset=offset,
            )

        def round_body(carry):
            p, rounds, iters_acc, ev_acc, drop_acc, sent_acc, hit_acc, _ = carry
            # Subface-resample pending coarse->fine DDMC leaks BEFORE transport
            # (not after migrate): arrivals from the previous round's migrate
            # see no transport in between either way, and pending leaks
            # restored from a checkpoint (or left by a round-capped census) are
            # resampled before their first transport instead of moving from the
            # unresampled coarse mid-face state.
            if smr_ddmc:
                p = _fixup_subface_arrivals(
                    p, coefs_local, mesh, prm, offset, Bl, rng.fold(k_fix, rounds)
                )
            p, iters, ev = local_transport(p, rounds)
            hit_acc = hit_acc + (iters >= prm.max_iters).astype(jnp.int32)
            if can_migrate:
                p, mig_dropped, n_sent = migrate(
                    p, offset, Bl, n_shards, K, axis_name
                )
            else:
                # one shard owns every real block: nothing can be in transit,
                # so the pack/exchange/insert machinery is pure per-round
                # overhead
                mig_dropped = jnp.zeros((), jnp.int32)
                n_sent = jnp.zeros((), jnp.int32)
            # dtype pinned: under jax_enable_x64 an unpinned int32 sum upcasts
            # to int64 and breaks the while_loop carry
            local_unfinished = jnp.sum(
                (p.alive & (p.tau < 1.0)).astype(jnp.int32), dtype=jnp.int32
            )
            unfinished = jax.lax.psum(local_unfinished, axis_name)
            return (
                p, rounds + 1, iters_acc + iters, ev_acc + ev,
                drop_acc + mig_dropped.astype(jnp.int32), sent_acc + n_sent,
                hit_acc, unfinished,
            )

        def round_cond(carry):
            _, rounds, _, _, _, _, _, unfinished = carry
            return (rounds < max_rounds) & (unfinished > 0)

        p, rounds, iters, events, mig_drop, n_sent, cap_hits, unfin = jax.lax.while_loop(
            round_cond,
            round_body,
            (p, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
             jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
             jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
             jnp.ones((), jnp.int32)),
        )
        dropped = dropped + mig_drop

        # 4./5. tallies + feedback, purely local (each cell owned by one shard)
        if prm.has_absorption:  # statically none -> mask provably all-false
            f = tally.accumulate_absorption(f, p, mesh, block_offset=offset)
        f = tally.evaluate_radiation_energy(f, p, mesh, block_offset=offset)
        if jb.do_feedback:
            f = tally.update_fluid(f, mesh, block_offset=offset)

        p = dataclasses.replace(
            p, absorbed=jnp.zeros_like(p.absorbed), tau=jnp.zeros_like(p.tau)
        )

        new_state = dataclasses.replace(
            state,
            fields=f,
            particles=p,
            t=state.t + dt,
            cycle=state.cycle + 1,
            overflow=state.overflow + jax.lax.psum(dropped, axis_name),
        )
        stats = StepStats(
            iterations=jax.lax.pmax(iters, axis_name),
            events=jax.lax.psum(events, axis_name),
            n_alive=jax.lax.psum(p.num_alive(), axis_name),
            dropped=jax.lax.psum(dropped, axis_name),
            migration_rounds=jax.lax.pmax(rounds, axis_name),
            migrated=jax.lax.psum(n_sent, axis_name),
            cap_hits=jax.lax.psum(cap_hits, axis_name),
            unfinished=jax.lax.pmax(unfin, axis_name),  # already a global psum
        )
        return new_state, stats

    return step


def make_spatial_step(mesh, cfg: RunConfig, dmesh):
    n = dmesh.devices.size
    core = build_spatial_step_core(mesh, cfg, n)

    def run(state, dt):
        specs = state_specs(state, shard_fields=True)
        stats_spec = StepStats(
            iterations=P(), events=P(), n_alive=P(), dropped=P(),
            migration_rounds=P(), migrated=P(), cap_hits=P(), unfinished=P(),
        )
        fn = jax.shard_map(
            core, mesh=dmesh,
            in_specs=(specs, P()), out_specs=(specs, stats_spec),
            check_vma=False,
        )
        return fn(state, dt)

    return jax.jit(run)


def make_spatial_init(mesh, cfg: RunConfig, dmesh):
    """Sharded thermal init: each shard sources its OWNED (local) blocks' cells."""
    from ..config import InitialRadiation

    n = dmesh.devices.size
    B = mesh.n_blocks
    Bl = -(-B // n)
    eos = cfg.mcblock.build_eos()
    opacity = cfg.mcblock.build_opacity()
    consts = opacity.get_runtime_physical_constants()
    jb = cfg.jaybenne

    def core(state):
        f, p = state.fields, state.particles
        shard = jax.lax.axis_index("shard")
        offset = shard * Bl
        dropped = jnp.zeros((), jnp.int32)
        if cfg.mcblock.initial_radiation == InitialRadiation.thermal:
            key = jax.random.fold_in(state.rng_key, 0x7FFFFFFF)
            key = jax.random.fold_in(key, shard)
            f, p, dropped = sourcing.source_photons(
                f, p, mesh, key,
                source_type="thermal",
                eos=eos, opacity=opacity,
                sb=consts.sb, c=consts.c,
                num_particles=jb.num_particles,
                dt=0.0, dtype=jb.dtype,
                block_offset=offset,
            )
            dropped = jnp.asarray(dropped, jnp.int32)
        f = tally.evaluate_radiation_energy(f, p, mesh, block_offset=offset)
        return dataclasses.replace(
            state, fields=f, particles=p,
            overflow=state.overflow + jax.lax.psum(dropped, "shard"),
        )

    def run(state):
        specs = state_specs(state, shard_fields=True)
        fn = jax.shard_map(
            core, mesh=dmesh, in_specs=(specs,), out_specs=specs, check_vma=False
        )
        return fn(state)

    return jax.jit(run)
