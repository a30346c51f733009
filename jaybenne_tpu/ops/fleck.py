"""Derived transport fields: Fleck factor and DDMC face probabilities.

JAX equivalent of ``UpdateDerivedTransportFields``
(``/root/reference/src/jaybenne/jaybenne.cpp:277-492``).

Fleck factor (Fleck & Cummings 1971), per cell::

    f = 1 / (1 + (4 * emis / (rho * cv * T)) * dt)

DDMC face probability (Habetler-Matkowsky extrapolation, lambda_ext = 0.7104), per
face between cells l (lower) and u (upper)::

    tau_s = dx_s * (sigma_s + sigma_a)_s        for side s in {l, u}
    tau_s = tau_s            if tau_s > tau_ddmc
          = 2 * lambda_ext   otherwise
    P     = 2 / (3 * (tau_l + tau_u))

where ``dx_s`` is the cell size of the side's OWNING block (the reference's
level-scaled ``2^(rlev - rlev_n) * dx`` at ``jaybenne.cpp:354-355`` equals the
neighbor's actual dx).

Across block boundaries the reference reads ghost cells filled by a
prolongation/restriction exchange; here every face evaluates its two sides by a
**position-based sample**: a point a quarter local-cell inward/outward of the face is
located with the mesh's block-lookup grid and the owning cell's (tau, dx) gathered
directly. That single code path covers interior faces, same-level block faces,
coarse/fine (2:1) faces (piecewise-constant sampling in place of prolongation), and
physical boundaries (the sample point is wrapped for periodic field BCs or clamped
into the domain otherwise, reproducing zero-gradient ghosts).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

LAM_EXT = 0.7104  # Habetler & Matkowsky (1975) extrapolation distance


def fleck_factor(rho, sie, eos, opacity, dt, dtype):
    """Per-cell Fleck factor (``jaybenne.cpp:304-316``)."""
    temp = eos.temperature_from_density_internal_energy(rho, sie)
    cv = eos.specific_heat_from_density_internal_energy(rho, sie)
    emis = opacity.emissivity(rho, temp)
    return (1.0 / (1.0 + (4.0 * emis / (rho * cv * temp)) * dt)).astype(dtype)


def _wrap_or_clamp(coord, lo, hi, periodic):
    if periodic:
        return lo + jnp.mod(coord - lo, hi - lo)
    return jnp.clip(coord, lo, hi)


def _sample_tau(mesh, tau_cell_flat, px, py, pz, axis, periodic_flags):
    """Gather tau (along ``axis``) of the cell owning physical point (px, py, pz)."""
    x1min, x1max, x2min, x2max, x3min, x3max = mesh.bounds
    px = _wrap_or_clamp(px, x1min, x1max, periodic_flags[0])
    py = _wrap_or_clamp(py, x2min, x2max, periodic_flags[1])
    pz = _wrap_or_clamp(pz, x3min, x3max, periodic_flags[2])
    b = mesh.locate_block(px, py, pz)
    org = mesh.block_origin[b]
    i, j, k = mesh.cell_of_local(b, px - org[..., 0], py - org[..., 1], pz - org[..., 2])
    flat = mesh.flat_cell(b, k, j, i)
    # tau_cell_flat is [NC, 3]; pick the requested axis
    return jnp.take(tau_cell_flat[:, axis], flat, axis=0)


def ddmc_face_probs(mesh, sigma_t, tau_ddmc, periodic_flags, dtype):
    """Face probability arrays (px, py, pz) of shapes
    ``[B, nz, ny, nx+1] / [B, nz, ny+1, nx] / [B, nz+1, ny, nx]``.

    ``sigma_t``: per-cell total interaction coefficient [B, nz, ny, nx].
    ``periodic_flags``: (x, y, z) bools from the *field* boundary conditions.
    """
    B, nz, ny, nx = sigma_t.shape
    dxv = mesh.block_dx  # [B, 3]
    # tau along each axis for every cell, flattened [B*nz*ny*nx, 3]
    tau3 = sigma_t[..., None] * dxv[:, None, None, None, :]
    tau_flat = tau3.reshape(-1, 3).astype(dtype)

    def one_direction(axis):
        # face-center coordinate grids for this direction
        if axis == 0:
            fshape = (B, nz, ny, nx + 1)
            fi = jnp.arange(nx + 1, dtype=dtype)[None, None, None, :]
            fj = (jnp.arange(ny, dtype=dtype) + 0.5)[None, None, :, None]
            fk = (jnp.arange(nz, dtype=dtype) + 0.5)[None, :, None, None]
        elif axis == 1:
            fshape = (B, nz, ny + 1, nx)
            fi = (jnp.arange(nx, dtype=dtype) + 0.5)[None, None, None, :]
            fj = jnp.arange(ny + 1, dtype=dtype)[None, None, :, None]
            fk = (jnp.arange(nz, dtype=dtype) + 0.5)[None, :, None, None]
        else:
            fshape = (B, nz + 1, ny, nx)
            fi = (jnp.arange(nx, dtype=dtype) + 0.5)[None, None, None, :]
            fj = (jnp.arange(ny, dtype=dtype) + 0.5)[None, None, :, None]
            fk = jnp.arange(nz + 1, dtype=dtype)[None, :, None, None]

        org = mesh.block_origin
        dx = dxv
        px = jnp.broadcast_to(org[:, 0][:, None, None, None] + fi * dx[:, 0][:, None, None, None], fshape)
        py = jnp.broadcast_to(org[:, 1][:, None, None, None] + fj * dx[:, 1][:, None, None, None], fshape)
        pz = jnp.broadcast_to(org[:, 2][:, None, None, None] + fk * dx[:, 2][:, None, None, None], fshape)

        # sample points a quarter local-cell to either side of the face along `axis`
        # (inside the adjacent cell for same/coarser neighbors, and inside the
        # face-adjacent fine cell for 2x finer neighbors)
        d_ax = dx[:, axis][:, None, None, None]
        off = 0.25 * d_ax
        if axis == 0:
            pl = (px - off, py, pz)
            pu = (px + off, py, pz)
        elif axis == 1:
            pl = (px, py - off, pz)
            pu = (px, py + off, pz)
        else:
            pl = (px, py, pz - off)
            pu = (px, py, pz + off)

        tau_l = _sample_tau(mesh, tau_flat, *pl, axis=axis, periodic_flags=periodic_flags)
        tau_u = _sample_tau(mesh, tau_flat, *pu, axis=axis, periodic_flags=periodic_flags)
        tau_l = jnp.where(tau_l > tau_ddmc, tau_l, 2.0 * LAM_EXT)
        tau_u = jnp.where(tau_u > tau_ddmc, tau_u, 2.0 * LAM_EXT)
        return (2.0 / (3.0 * (tau_l + tau_u))).astype(dtype)

    px_arr = one_direction(0)
    py_arr = one_direction(1) if mesh.ndim > 1 else jnp.zeros((B, nz, ny + 1, nx), dtype)
    pz_arr = one_direction(2) if mesh.ndim > 2 else jnp.zeros((B, nz + 1, ny, nx), dtype)
    return px_arr, py_arr, pz_arr


# --------------------------------------------------- spatial (sharded) variant
#
# Under the spatial decomposition each shard holds only its blocks' sigma_t.
# Every face sample point a quarter LOCAL cell beyond a block face lands in the
# FIRST cell layer of the owning neighbor block (same-level, 2:1 fine — a
# quarter coarse cell is half a fine cell — and 2:1 coarse alike), i.e. always
# in a cell on that block's BOUNDARY SURFACE. So the only remote data the
# face-prob construction needs is each block's surface-cell sigma_t: an
# all_gather of O(B * surface) values instead of O(B * volume) — the ghost-
# face-only exchange of the reference (``jaybenne.cpp:108-110``), with
# per-device comm scaling as block surface/volume.


@functools.lru_cache(maxsize=None)
def _surface_maps(nz, ny, nx):
    """Canonical boundary-surface indexing for an (nz, ny, nx) block:
    ``(surf_flat[S], cell_to_surf[ncpb])`` where ``surf_flat`` lists the flat
    in-block cell ids of the boundary cells (each once) and ``cell_to_surf``
    maps any flat cell id to its surface slot (-1 for interior cells)."""
    kk, jj, ii = np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
    )
    on_surf = (ii == 0) | (ii == nx - 1)
    if ny > 1:
        on_surf |= (jj == 0) | (jj == ny - 1)
    if nz > 1:
        on_surf |= (kk == 0) | (kk == nz - 1)
    flat = ((kk * ny + jj) * nx + ii).reshape(-1)
    mask = on_surf.reshape(-1)
    surf_flat = flat[mask].astype(np.int32)
    cell_to_surf = np.full(nz * ny * nx, -1, np.int32)
    cell_to_surf[surf_flat] = np.arange(len(surf_flat), dtype=np.int32)
    return surf_flat, cell_to_surf


def pack_boundary_surface(mesh, sigma_local):
    """[Bl, nz, ny, nx] local sigma_t -> [Bl, S] boundary-surface values (the
    per-block payload of the spatial ghost exchange)."""
    surf_flat, _ = _surface_maps(mesh.nz, mesh.ny, mesh.nx)
    Bl = sigma_local.shape[0]
    return sigma_local.reshape(Bl, -1)[:, jnp.asarray(surf_flat)]


def _sample_tau_spatial(
    mesh, tau_local_flat, surf_glob, offset, Bl, px, py, pz, axis, periodic_flags
):
    """Gather tau along ``axis`` of the cell owning (px, py, pz): locally from
    the shard's cell slab, remotely from the gathered boundary surfaces."""
    x1min, x1max, x2min, x2max, x3min, x3max = mesh.bounds
    px = _wrap_or_clamp(px, x1min, x1max, periodic_flags[0])
    py = _wrap_or_clamp(py, x2min, x2max, periodic_flags[1])
    pz = _wrap_or_clamp(pz, x3min, x3max, periodic_flags[2])
    b = mesh.locate_block(px, py, pz)
    org = mesh.block_origin[b]
    i, j, k = mesh.cell_of_local(b, px - org[..., 0], py - org[..., 1], pz - org[..., 2])
    in_block = (k * mesh.ny + j) * mesh.nx + i
    local = (b >= offset) & (b < offset + Bl)
    b_loc = jnp.clip(b - offset, 0, Bl - 1)
    tau_own = jnp.take(
        tau_local_flat[:, axis], b_loc * mesh.ncells_per_block + in_block
    )
    _, cell_to_surf = _surface_maps(mesh.nz, mesh.ny, mesh.nx)
    S = surf_glob.shape[1]
    s_idx = jnp.asarray(cell_to_surf)[in_block]
    sig_rem = surf_glob[b, jnp.clip(s_idx, 0, S - 1)]
    tau_rem = sig_rem * mesh.block_dx[b, axis]
    return jnp.where(local, tau_own, tau_rem)


def ddmc_face_probs_spatial(
    mesh, sigma_local, surf_glob, offset, tau_ddmc, periodic_flags, dtype
):
    """Shard-local DDMC face probabilities: same formula and bitwise-identical
    values as ``ddmc_face_probs`` restricted to this shard's blocks, but the
    only cross-shard input is the O(surface) ``surf_glob`` ([B_pad, S], from
    ``pack_boundary_surface`` + all_gather) instead of the full sigma_t.

    ``sigma_local``: [Bl, nz, ny, nx] (may include padding blocks — their face
    values are benign garbage; no particle ever occupies a padding block).
    Returns local (px, py, pz) of shapes [Bl, nz, ny, nx+1] etc.
    """
    Bl, nz, ny, nx = sigma_local.shape
    B = mesh.n_blocks
    bid = jnp.clip(offset + jnp.arange(Bl), 0, B - 1)
    org_l = mesh.block_origin[bid]   # [Bl, 3]
    dxv_l = mesh.block_dx[bid]       # [Bl, 3]
    tau3 = sigma_local[..., None] * dxv_l[:, None, None, None, :]
    tau_local_flat = tau3.reshape(-1, 3).astype(dtype)

    def one_direction(axis):
        if axis == 0:
            fshape = (Bl, nz, ny, nx + 1)
            fi = jnp.arange(nx + 1, dtype=dtype)[None, None, None, :]
            fj = (jnp.arange(ny, dtype=dtype) + 0.5)[None, None, :, None]
            fk = (jnp.arange(nz, dtype=dtype) + 0.5)[None, :, None, None]
        elif axis == 1:
            fshape = (Bl, nz, ny + 1, nx)
            fi = (jnp.arange(nx, dtype=dtype) + 0.5)[None, None, None, :]
            fj = jnp.arange(ny + 1, dtype=dtype)[None, None, :, None]
            fk = (jnp.arange(nz, dtype=dtype) + 0.5)[None, :, None, None]
        else:
            fshape = (Bl, nz + 1, ny, nx)
            fi = (jnp.arange(nx, dtype=dtype) + 0.5)[None, None, None, :]
            fj = (jnp.arange(ny, dtype=dtype) + 0.5)[None, None, :, None]
            fk = jnp.arange(nz + 1, dtype=dtype)[None, :, None, None]

        px = jnp.broadcast_to(
            org_l[:, 0][:, None, None, None] + fi * dxv_l[:, 0][:, None, None, None],
            fshape,
        )
        py = jnp.broadcast_to(
            org_l[:, 1][:, None, None, None] + fj * dxv_l[:, 1][:, None, None, None],
            fshape,
        )
        pz = jnp.broadcast_to(
            org_l[:, 2][:, None, None, None] + fk * dxv_l[:, 2][:, None, None, None],
            fshape,
        )
        d_ax = dxv_l[:, axis][:, None, None, None]
        off = 0.25 * d_ax
        if axis == 0:
            pl = (px - off, py, pz)
            pu = (px + off, py, pz)
        elif axis == 1:
            pl = (px, py - off, pz)
            pu = (px, py + off, pz)
        else:
            pl = (px, py, pz - off)
            pu = (px, py, pz + off)

        tau_l = _sample_tau_spatial(
            mesh, tau_local_flat, surf_glob, offset, Bl, *pl, axis=axis,
            periodic_flags=periodic_flags,
        )
        tau_u = _sample_tau_spatial(
            mesh, tau_local_flat, surf_glob, offset, Bl, *pu, axis=axis,
            periodic_flags=periodic_flags,
        )
        tau_l = jnp.where(tau_l > tau_ddmc, tau_l, 2.0 * LAM_EXT)
        tau_u = jnp.where(tau_u > tau_ddmc, tau_u, 2.0 * LAM_EXT)
        return (2.0 / (3.0 * (tau_l + tau_u))).astype(dtype)

    px_arr = one_direction(0)
    py_arr = (
        one_direction(1) if mesh.ndim > 1 else jnp.zeros((Bl, nz, ny + 1, nx), dtype)
    )
    pz_arr = (
        one_direction(2) if mesh.ndim > 2 else jnp.zeros((Bl, nz + 1, ny, nx), dtype)
    )
    return px_arr, py_arr, pz_arr
