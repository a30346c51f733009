"""Census kernel: one GPU thread carries one packet to census (Pallas, Triton).

The XLA event loop (``ops/transport.py``) advances the whole ledger by one event
per ``lax.while_loop`` iteration; at the stepdiff headline size that is over a
thousand iterations per step, each a chain of kernel launches. This kernel runs
the reference's flat per-history loop instead (``transport.cpp:67-70``): each
program owns ``BLOCK`` packets, one per lane, and iterates until every lane of
its block reaches census (tau >= 1), is absorbed, or leaves the domain.

* Particle state lives in registers for the whole loop.
* Cell coefficients, DDMC face probabilities, block geometry and the block-lookup
  grid stay in global memory and are read by per-lane gathers (``ref[idx]``);
  the 64^3 gray table is ~3 MB and sits in L2.
* Random numbers come from the counter hash in ``ops/pallas_rng.py``, keyed by
  (seed, global slot, iteration, call site).
* A uniform block forest is handled as ONE synthetic block (``_uniform_view``):
  cell size and origin are static scalars and interior block faces are not
  transitions at all.

Physics is the algorithm of the XLA path (the branch structure of
``ptcl_transport_step``, reference ``transport_utils.hpp:111-160``; the DDMC
branch of ``transport_ddmc.cpp:28-237`` including the in-kernel coarse->fine
subface resample of ``sample_ddmc_bface.cpp``; inline block transitions and
domain boundary conditions). Only the RNG stream differs, which Monte Carlo
tolerances absorb. Frequency-dependent models are evaluated per event at the
packet's photon energy (``transport.cpp:122-127``).

Scope: float32, single-shard and particle-sharded runs, every mesh (uniform and
SMR, 1D-3D), IMC and DDMC, gray and non-gray. The spatial decomposition's census
rounds use the XLA loop.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..config import BC
from . import pallas_rng as rng

# packets per program (one per lane); a power of two, as Triton requires
BLOCK = 128
NUM_WARPS = 4
NUM_STAGES = 1


def _uniform_view(mesh):
    """Synthetic single-block ``MeshGeometry`` covering a uniform (max_level == 0)
    block forest: one block of ``root_grid * block_shape`` cells with the domain
    bounds. Block ids in a uniform forest are row-major in (z, y, x) logical
    location (``build_mesh`` sorts by (level, z, y, x)), so cell tables remap by
    a pure reshape/transpose (``_to_global_cells``) and particle state by an
    affine shift (``transport_kernel``); the kernel then skips every block
    geometry and lookup gather."""
    from ..mesh import MeshGeometry

    b = mesh.bounds
    nrbz, nrby, nrbx = mesh.root_grid
    NX, NY, NZ = nrbx * mesh.nx, nrby * mesh.ny, nrbz * mesh.nz
    f32, i32 = jnp.float32, jnp.int32
    return MeshGeometry(
        ndim=mesh.ndim,
        nx=NX, ny=NY, nz=NZ,
        n_blocks=1,
        max_level=0,
        bounds=b,
        tile_shape=(1, 1, 1),
        root_grid=(1, 1, 1),
        finest=mesh.finest,
        block_origin=jnp.asarray([[b[0], b[2], b[4]]], f32),
        block_dx=jnp.asarray(
            [[(b[1] - b[0]) / NX, (b[3] - b[2]) / NY, (b[5] - b[4]) / NZ]], f32
        ),
        block_level=jnp.zeros((1,), i32),
        lookup=jnp.zeros((1, 1, 1), i32),
    )


def _to_global_cells(vec, mesh):
    """Per-cell vector in block order ([B * nz*ny*nx], i fastest) -> global
    row-major cell order of the uniform synthetic block — a reshape/transpose
    (no gather), valid because uniform block ids are (z, y, x) row-major."""
    nrbz, nrby, nrbx = mesh.root_grid
    return (
        vec.reshape(nrbz, nrby, nrbx, mesh.nz, mesh.ny, mesh.nx)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(-1)
    )


def _face_prob_vectors(coefs, nx, ny, nz):
    """Per-cell (P_lower, P_upper) DDMC leak probabilities per axis, each a
    [B * ncells_per_block] f32 vector in cell order — gathered in-kernel with
    the same cell index as the coefficients (one index serves both faces)."""
    px = coefs.px.reshape(-1, nz, ny, nx + 1)
    py = coefs.py.reshape(-1, nz, ny + 1, nx)
    pz = coefs.pz.reshape(-1, nz + 1, ny, nx)
    return (
        px[:, :, :, :nx], px[:, :, :, 1:],
        py[:, :, :ny, :], py[:, :, 1:, :],
        pz[:, :nz, :, :], pz[:, 1:, :, :],
    )


# table order in the kernel signature
_TABLES = (
    "c0", "c1", "c2",                      # cell coefficients (see _cell_tables)
    "bdx", "bdy", "bdz", "box", "boy", "boz",  # per-block cell size / origin
    "lut", "blv",                          # block-lookup grid, block level
    "fxl", "fxu", "fyl", "fyu", "fzl", "fzu",  # per-cell DDMC face probs
)
_N_PART_IN = 15   # x y z vx vy vz tau blk i j k alive absorbed face energy
_N_PART_OUT = 14  # the same minus energy (read-only)


def _census_kernel(scal_ref, seed_ref, *refs, st, opacity=None, scattering=None):
    (ndim, nx, ny, nz, max_iters, bcs, bounds, tile_shape, finest,
     single_block, block_dx0, block_org0, has_absorption,
     use_ddmc, tau_ddmc, eps_imc, eps_ddmc, has_smr, nongray) = st
    (x_ref, y_ref, z_ref, vx_ref, vy_ref, vz_ref, tau_ref,
     blk_ref, ci_ref, cj_ref, ck_ref, alive_ref, absorbed_ref, face_ref,
     en_ref) = refs[:_N_PART_IN]
    tabs = dict(zip(_TABLES, refs[_N_PART_IN:_N_PART_IN + len(_TABLES)]))
    outs = refs[_N_PART_IN + len(_TABLES):]
    multi_d = ndim >= 2
    three_d = ndim == 3
    dt = scal_ref[0]
    c = scal_ref[1]
    x1min, x1max, x2min, x2max, x3min, x3max = bounds
    ntz, nty, ntx = tile_shape
    tsx = (x1max - x1min) / ntx
    tsy = (x2max - x2min) / nty
    tsz = (x3max - x3min) / ntz

    shape = (BLOCK,)
    BIG = 3.0e38
    tiny = 1.0e-37
    f32, i32 = jnp.float32, jnp.int32

    def gather(name, idx):
        return tabs[name][idx]

    raw_bits = rng.make_raw_bits(BLOCK, seed_ref[0], pl.program_id(0) * BLOCK)
    inv_c = 1.0 / c
    inv_cdt = 1.0 / (c * dt)
    energy = en_ref[...]  # constant through the census loop

    def body(carry):
        (x, y, z, vx, vy, vz, tau, blk, ci, cj, ck, alive, absorbed, face,
         it, ev) = carry
        pool = rng.DrawPool(raw_bits)
        active = (alive != 0) & (tau < 1.0)

        if single_block:
            dxb, dyb, dzb = (np.float32(v) for v in block_dx0)
            dmin = np.float32(min(block_dx0[:ndim]))
            if three_d:
                cell = (ck * ny + cj) * nx + ci
            elif multi_d:
                cell = cj * nx + ci
            else:
                cell = ci
        else:
            dxb = gather("bdx", blk)
            dyb = gather("bdy", blk) if multi_d else dxb
            dzb = gather("bdz", blk) if three_d else dxb
            if three_d:
                dmin = jnp.minimum(dxb, jnp.minimum(dyb, dzb))
                cell = (blk * (nz * ny) + ck * ny + cj) * nx + ci
            elif multi_d:
                dmin = jnp.minimum(dxb, dyb)
                cell = (blk * ny + cj) * nx + ci
            else:
                dmin = dxb
                cell = blk * nx + ci

        # Collision rates. Gray: the tables hold the derived pair
        # (ea = fleck*sigma_a, es = sigma_s + (1-fleck)*sigma_a), or without
        # DDMC (p_abs = ea/sig_t, 1/sig_t) so the loop needs no divide.
        # Non-gray: (rho, T, fleck), models evaluated at the photon energy.
        inv_sigt = p_abs = ea = None
        if nongray:
            rho_g = gather("c0", cell)
            tt_g = gather("c1", cell)
            ff = gather("c2", cell)
            sa = jnp.broadcast_to(
                opacity.absorption_coefficient(rho_g, tt_g, energy).astype(f32),
                shape,
            )
            ss = jnp.broadcast_to(
                scattering.total_scattering_coefficient(rho_g, tt_g, energy)
                .astype(f32),
                shape,
            )
            ea = ff * sa
            es = ss + (1.0 - ff) * sa
            sig_t = ea + es
        elif use_ddmc:
            es = gather("c1", cell)
            ea = gather("c0", cell) if has_absorption else None
            sig_t = es if ea is None else ea + es
        else:
            inv_sigt = gather("c1", cell)
            p_abs = gather("c0", cell) if has_absorption else None

        fi = ci.astype(f32)
        xl, xu = fi * dxb, (fi + 1.0) * dxb
        if multi_d:
            fj = cj.astype(f32)
            yl, yu = fj * dyb, (fj + 1.0) * dyb
        if three_d:
            fk = ck.astype(f32)
            zl, zu = fk * dzb, (fk + 1.0) * dzb

        if use_ddmc:
            is_ddmc = active & (dmin * sig_t > tau_ddmc)
            act_imc = active & ~is_ddmc
        else:
            act_imc = active

        # Competing risks: the min of the absorption and scattering
        # exponentials is one exponential at the total rate; the branch is
        # absorption with probability ea/(ea+es) (the reference draws the two
        # distances separately — identical in distribution).
        if inv_sigt is not None:
            d_coll = pool.exp23(it) * inv_sigt
        else:
            d_coll = pool.exp23(it) / (sig_t + tiny)
        u_branch = pool.u23(it) if has_absorption else None
        d_end = c * dt * (1.0 - tau)
        d_geom = jnp.minimum(dmin, d_end)

        def face_dist(v, lo, hi, q):
            tgt = jnp.where(v > 0, hi, lo)
            d = c * (tgt - q) / jnp.where(v != 0, v, 1.0)
            return jnp.where(v != 0, d, BIG)

        fxd = face_dist(vx, xl, xu, x)
        d_push = jnp.minimum(d_geom, fxd)
        if multi_d:
            fyd = face_dist(vy, yl, yu, y)
            d_push = jnp.minimum(d_push, fyd)
        if three_d:
            fzd = face_dist(vz, zl, zu, z)
            d_push = jnp.minimum(d_push, fzd)
        coll = act_imc & (d_coll < d_push)
        if has_absorption:
            if p_abs is not None:
                i_abs = coll & (u_branch < p_abs)
            else:
                i_abs = coll & (u_branch * sig_t < ea)
            i_sc = coll & ~i_abs
        else:
            i_abs = None
            i_sc = coll
        no_coll = act_imc & ~coll
        cr_x = no_coll & (fxd <= d_geom)
        if multi_d:
            cr_x = cr_x & (fxd <= fyd)
            cr_y = no_coll & ~cr_x & (fyd <= d_geom)
        if three_d:
            cr_x = cr_x & (fxd <= fzd)
            cr_y = cr_y & (fyd <= fzd)
            cr_z = no_coll & ~cr_x & ~cr_y & (fzd <= d_geom)
        no_cross = no_coll & ~cr_x
        if multi_d:
            no_cross = no_cross & ~cr_y
        if three_d:
            no_cross = no_cross & ~cr_z
        i_census = no_cross & (d_end <= dmin)

        d = jnp.where(coll, d_coll, d_push)
        # zero the step for lanes at census or dead: every position, tau and
        # index update below then degenerates to the identity
        d = jnp.where(active, d, 0.0)
        ntau = jnp.where(i_census, 1.0, tau + d * inv_cdt)
        step = d * inv_c
        nx_ = jnp.where(cr_x, jnp.where(vx > 0, xu, xl), x + vx * step)
        nci = ci + jnp.where(cr_x, jnp.where(vx > 0, 1, -1), 0)
        ny_, ncj, nz_, nck = y, cj, z, ck
        if multi_d:
            ny_ = jnp.where(cr_y, jnp.where(vy > 0, yu, yl), y + vy * step)
            ncj = cj + jnp.where(cr_y, jnp.where(vy > 0, 1, -1), 0)
        if three_d:
            nz_ = jnp.where(cr_z, jnp.where(vz > 0, zu, zl), z + vz * step)
            nck = ck + jnp.where(cr_z, jnp.where(vz > 0, 1, -1), 0)

        # isotropic scatter redraw (scattering.hpp:21-29). 1D: the azimuth is
        # unobservable (transport, tallies and BCs read only vx), so the
        # x-projection is drawn directly and the transverse magnitude is
        # parked in vy, keeping |v| = c.
        mu = 1.0 - 2.0 * pool.u16(it)
        st_ = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
        if multi_d:
            cph, sph = pool.circle(it)
            nvx = jnp.where(i_sc, c * st_ * cph, vx)
            nvy = jnp.where(i_sc, c * st_ * sph, vy)
            nvz = jnp.where(i_sc, c * mu, vz)
        else:
            nvx = jnp.where(i_sc, c * mu, vx)
            nvy = jnp.where(i_sc, c * st_, vy)
            nvz = jnp.where(i_sc, 0.0, vz)

        nalive, nabsorbed = alive, absorbed
        if i_abs is not None:
            nalive = jnp.where(i_abs, 0, alive)
            nabsorbed = jnp.where(i_abs, 1, absorbed)
        # face-arrival code (see ParticleLedger.face): only the DDMC at-face
        # albedo test reads it
        nface = face
        if use_ddmc:
            nface = jnp.where(cr_x, jnp.where(vx > 0, 1, -1), 0)
            if multi_d:
                nface = jnp.where(cr_y, jnp.where(vy > 0, 2, -2), nface)
            if three_d:
                nface = jnp.where(cr_z, jnp.where(vz > 0, 3, -3), nface)

        # ================= DDMC branch (ptcl_ddmc_albedo / ptcl_ddmc_step) ====
        nleak = None
        if use_ddmc:
            ea_dd = jnp.zeros(shape, f32) if ea is None else ea
            if single_block:
                inv_d = [np.float32(1.0 / v) for v in block_dx0]
            else:
                inv_d = [1.0 / dxb, 1.0 / dyb, 1.0 / dzb]
            sel = []
            for ax in range(ndim):
                sel += [is_ddmc & (face == ax + 1), is_ddmc & (face == -(ax + 1))]
            at_face = is_ddmc & (face != 0)

            lam2 = 2.0 * 0.7104
            P = jnp.zeros(shape, f32)
            for ax, (fdx_, fv) in enumerate([(dxb, vx), (dyb, vy), (dzb, vz)][:ndim]):
                Pf2 = 2.0 * (2.0 / 3.0) / (sig_t * fdx_ + lam2)
                drift = 1.5 * fv * inv_c
                P = jnp.where(sel[2 * ax], Pf2 * (1.0 + drift), P)
                P = jnp.where(sel[2 * ax + 1], Pf2 * (1.0 - drift), P)
            rejected = at_face & (pool.u23(it) > P)

            def hemisphere():
                hmu = jnp.sqrt(pool.u16(it))
                hnu = jnp.sqrt(jnp.maximum(1.0 - hmu * hmu, 0.0))
                if multi_d:
                    hc, hs = pool.circle(it)
                    return hmu, hnu * hc, hnu * hs
                return hmu, hnu, jnp.zeros(shape, f32)

            a1, a2, a3 = hemisphere()
            lo_hi = [(xl, xu, dxb), (yl, yu, dyb) if multi_d else None,
                     (zl, zu, dzb) if three_d else None]
            pos = [x, y, z]
            vel = [vx, vy, vz]
            zero_i = jnp.zeros(shape, i32)

            def face_move(masks, eps, h1, h2, h3, recenter):
                """Move masked lanes eps outside the selected face, with a
                hemisphere direction (h1 along the outward normal, then the
                cyclically next axes, as at the sample_face_iso_dir call
                sites); recenter the transverse coordinates if asked. Returns
                (pos, vel, cell steps, leak code)."""
                p_out, v_out = list(pos), list(vel)
                steps = [zero_i, zero_i, zero_i]
                code = zero_i
                for e in range(2 * ndim):
                    ax, lower = e // 2, e % 2 == 0
                    m = masks[e]
                    lo, hi, dd = lo_hi[ax]
                    sgn = -1.0 if lower else 1.0
                    tgt = lo - eps * dd if lower else hi + eps * dd
                    p_out[ax] = jnp.where(m, tgt, p_out[ax])
                    for k, val in enumerate((c * sgn * h1, c * h2, c * h3)):
                        a = (ax + k) % 3
                        v_out[a] = jnp.where(m, val, v_out[a])
                    steps[ax] = jnp.where(m, -1 if lower else 1, steps[ax])
                    code = jnp.where(m, (-1 if lower else 1) * (ax + 1), code)
                    if recenter:
                        for t in range(ndim):
                            if t != ax:
                                tlo, _, tdd = lo_hi[t]
                                p_out[t] = jnp.where(m, tlo + 0.5 * tdd, p_out[t])
                return p_out, v_out, steps, code

            rj_pos, rj_vel, rj_steps, _ = face_move(
                sel, eps_imc, a1, a2, a3, recenter=False
            )

            # in-cell DDMC step: leak opacities P_face / dx per face
            names = ("fxl", "fxu", "fyl", "fyu", "fzl", "fzu")
            lk = [gather(names[e], cell) * inv_d[e // 2] for e in range(2 * ndim)]
            leak_tot = lk[0]
            for l in lk[1:]:
                leak_tot = leak_tot + l
            cdf = ea_dd + leak_tot + tiny
            dt_ev = pool.exp23(it) / (c * cdf)
            is_event = dt_ev < dt * (1.0 - tau)
            do_step = is_ddmc & ~rejected

            dd_tau = jnp.where(is_event, tau + dt_ev * (1.0 / dt), 1.0)
            xi = cdf * pool.u23(it)
            dd_absorbed = do_step & is_event & (xi < ea_dd)
            xim = xi - ea_dd
            cum = jnp.zeros(shape, f32)
            leak_sel = []
            leak_any = dd_absorbed & ~dd_absorbed
            for l in lk:
                m = do_step & is_event & ~dd_absorbed & ~leak_any & (xim < cum + l)
                leak_sel.append(m)
                leak_any = leak_any | m
                cum = cum + l
            # numerical fall-through lands on the last active face
            leak_sel[-1] = leak_sel[-1] | (do_step & is_event & ~dd_absorbed & ~leak_any)

            b1, b2, b3 = hemisphere()
            dd_pos, dd_vel, dd_steps, dd_leak = face_move(
                leak_sel, eps_ddmc, b1, b2, b3, recenter=True
            )

            # census: resample position uniformly in the cell + isotropic dir
            dd_census = do_step & ~is_event
            for ax in range(ndim):
                lo, _, dd = lo_hi[ax]
                dd_pos[ax] = jnp.where(dd_census, lo + pool.u16(it) * dd, dd_pos[ax])
            cmu = 1.0 - 2.0 * pool.u16(it)
            cst = jnp.sqrt(jnp.maximum(1.0 - cmu * cmu, 0.0))
            if multi_d:
                cph2, csh2 = pool.circle(it)
                cen_v = (c * cst * cph2, c * cst * csh2, c * cmu)
            else:
                cen_v = (c * cmu, c * cst, jnp.zeros(shape, f32))
            for a in range(3):
                dd_vel[a] = jnp.where(dd_census, cen_v[a], dd_vel[a])

            # merge the rejected bounce (no time advance), then DDMC over IMC
            for a in range(3):
                dd_pos[a] = jnp.where(rejected, rj_pos[a], dd_pos[a])
                dd_vel[a] = jnp.where(rejected, rj_vel[a], dd_vel[a])
                dd_steps[a] = jnp.where(rejected, rj_steps[a], dd_steps[a])
            dd_tau = jnp.where(rejected, tau, dd_tau)
            dd_leak = jnp.where(rejected, 0, dd_leak)

            nx_ = jnp.where(is_ddmc, dd_pos[0], nx_)
            ny_ = jnp.where(is_ddmc, dd_pos[1], ny_)
            nz_ = jnp.where(is_ddmc, dd_pos[2], nz_)
            nvx = jnp.where(is_ddmc, dd_vel[0], nvx)
            nvy = jnp.where(is_ddmc, dd_vel[1], nvy)
            nvz = jnp.where(is_ddmc, dd_vel[2], nvz)
            ntau = jnp.where(is_ddmc, dd_tau, ntau)
            nci = jnp.where(is_ddmc, ci + dd_steps[0], nci)
            ncj = jnp.where(is_ddmc, cj + dd_steps[1], ncj)
            nck = jnp.where(is_ddmc, ck + dd_steps[2], nck)
            nalive = jnp.where(dd_absorbed, 0, nalive)
            nabsorbed = jnp.where(dd_absorbed, 1, nabsorbed)
            nface = jnp.where(is_ddmc, 0, nface)  # every DDMC outcome is off-face
            nleak = jnp.where(is_ddmc, dd_leak, 0)

        # ---- block transition / domain BCs ------------------------------
        outs_lo = [nci < 0, ncj < 0, nck < 0][:ndim]
        outs_hi = [nci >= nx, ncj >= ny, nck >= nz][:ndim]
        if single_block:
            g = [np.float32(block_org0[a]) + q for a, q in enumerate((nx_, ny_, nz_)[:ndim])]
        else:
            g = [gather(nm, blk) + q
                 for nm, q in zip(("box", "boy", "boz")[:ndim], (nx_, ny_, nz_))]
        nv = [nvx, nvy, nvz]
        fc = nface if use_ddmc else None

        # half-finest-cell tolerant hit test + domain clip, as in
        # ops/transport.py::apply_bc (inexact deck extents round the pinned
        # face position below the bound; an exact comparison would livelock)
        for a in range(ndim):
            lo, hi = np.float32(bounds[2 * a]), np.float32(bounds[2 * a + 1])
            half = 0.5 * finest[a]
            hit_lo = outs_lo[a] & (g[a] <= lo + half)
            hit_hi = outs_hi[a] & (g[a] >= hi - half)
            for hit, bc, mirror, shift in (
                (hit_lo, bcs[2 * a], 2.0 * lo, hi - lo),
                (hit_hi, bcs[2 * a + 1], 2.0 * hi, lo - hi),
            ):
                if bc == BC.reflecting:
                    g[a] = jnp.where(hit, jnp.clip(mirror - g[a], lo, hi), g[a])
                    nv[a] = jnp.where(hit, -nv[a], nv[a])
                    if fc is not None:
                        fc = jnp.where(hit, -fc, fc)
                elif bc == BC.periodic:
                    g[a] = jnp.where(hit, jnp.clip(g[a] + shift, lo, hi), g[a])
                else:
                    nalive = jnp.where(hit, 0, nalive)
        if use_ddmc:
            nface = fc
        nvx, nvy, nvz = nv

        out = outs_lo[0] | outs_hi[0]
        for a in range(1, ndim):
            out = out | outs_lo[a] | outs_hi[a]
        out = out & (nalive != 0)
        loc = [nx_, ny_, nz_]
        idx = [nci, ncj, nck]
        dims = (nx, ny, nz)
        nblk = blk
        if single_block:
            # transitions are BC-only: rebase into the single block
            for a in range(ndim):
                loc[a] = g[a] - np.float32(block_org0[a])
                idx[a] = jnp.clip(
                    (loc[a] * np.float32(1.0 / block_dx0[a])).astype(i32), 0, dims[a] - 1
                )
        else:
            # lookup probe: nudge half a finest cell along the CROSSED face's
            # normal (known exactly from the out flags); a velocity nudge
            # vanishes for grazing crossings and can re-pick the block just
            # left. Non-crossing axes keep a small directional tiebreak.
            t_lo = (x1min, x2min, x3min)
            t_sz = (tsx, tsy, tsz)
            t_n = (ntx, nty, ntz)
            tidx = None
            for a in range(ndim):
                sg = jnp.where(outs_hi[a], 1.0, 0.0) - jnp.where(outs_lo[a], 1.0, 0.0)
                probe = g[a] + jnp.where(
                    sg != 0.0, (0.5 * finest[a]) * sg, (0.01 * finest[a]) * (nv[a] * inv_c)
                )
                t = jnp.clip(
                    jnp.floor((probe - t_lo[a]) / t_sz[a]).astype(i32), 0, t_n[a] - 1
                )
                tidx = t if tidx is None else tidx + t * (
                    ntx if a == 1 else ntx * nty
                )
            b_new = gather("lut", tidx)
            ndx = [gather(nm, b_new) for nm in ("bdx", "bdy", "bdz")[:ndim]]
            for a, nm in enumerate(("box", "boy", "boz")[:ndim]):
                loc[a] = g[a] - gather(nm, b_new)
                idx[a] = jnp.clip(
                    jnp.floor(loc[a] / ndx[a]).astype(i32), 0, dims[a] - 1
                )
            nblk = jnp.where(out, b_new, blk)

            if use_ddmc and has_smr and multi_d:
                loc, idx, nv = _subface_resample(
                    pool, it, gather, ndim, dims, out, nleak, blk, b_new,
                    loc, idx, ndx, nv, c, tiny,
                )
                nvx, nvy, nvz = nv

        nx_ = jnp.where(out, loc[0], nx_)
        nci = jnp.where(out, idx[0], jnp.clip(nci, 0, nx - 1))
        if multi_d:
            ny_ = jnp.where(out, loc[1], ny_)
            ncj = jnp.where(out, idx[1], jnp.clip(ncj, 0, ny - 1))
        if three_d:
            nz_ = jnp.where(out, loc[2], nz_)
            nck = jnp.where(out, idx[2], jnp.clip(nck, 0, nz - 1))

        # inactive lanes already pass every field through unchanged (d = 0 and
        # every event mask includes ``active``); ``face`` is the exception:
        # its IMC chain rebuilds from 0
        if use_ddmc:
            nface = jnp.where(active, nface, face)
        return (
            nx_, ny_, nz_, nvx, nvy, nvz, ntau,
            nblk, nci, ncj, nck, nalive, nabsorbed, nface,
            it + 1, ev + active.astype(i32),
        )

    def cond(carry):
        tau, alive, it = carry[6], carry[11], carry[14]
        busy = ((alive != 0) & (tau < 1.0)).astype(i32)
        return (it < max_iters) & (jnp.max(busy) > 0)

    init = tuple(r[...] for r in refs[:_N_PART_OUT]) + (
        np.int32(0), jnp.zeros(shape, i32),
    )
    res = jax.lax.while_loop(cond, body, init)
    for o_ref, v in zip(outs[:_N_PART_OUT], res[:_N_PART_OUT]):
        o_ref[...] = v
    outs[_N_PART_OUT][...] = res[15]                         # events per lane
    outs[_N_PART_OUT + 1][...] = jnp.full(shape, res[14], i32)  # block iterations


def _subface_resample(pool, it, gather, ndim, dims, out, nleak, blk, b_new,
                      loc, idx, ndx, nv, c, tiny):
    """DDMC coarse->fine subface resample (ops/transport.py::
    _ddmc_subface_resample; reference SampleFace2D/3D, sample_ddmc_bface.cpp:
    24-78): a leak into a FINER block landed at the transverse centre of the
    coarse source cell — on the edge (2D) or corner (3D) shared by 2 or 4 fine
    faces. Choose one with probability proportional to its ddmc_face_prob,
    re-seat the transverse position uniformly on it, and redraw a hemisphere
    direction into the block."""
    f32, i32 = jnp.float32, jnp.int32
    nx, ny, nz = dims
    refine = out & (nleak != 0) & (gather("blv", b_new) > gather("blv", blk))
    lax_axis = jnp.where(nleak < 0, -nleak, nleak) - 1
    up = nleak > 0  # leaked in +axis: entered the LOWER face of cell 0
    u_sel = pool.u16(it)
    u_t = [pool.u16(it), pool.u16(it) if ndim == 3 else None]
    smu = jnp.sqrt(pool.u16(it))
    snu = jnp.sqrt(jnp.maximum(1.0 - smu * smu, 0.0))
    sph, ssh = pool.circle(it)
    h = (smu, snu * sph, snu * ssh)
    names = (("fxl", "fxu"), ("fyl", "fyu"), ("fzl", "fzu"))

    def face_prob(ax, kji):
        kk, jj, ii = kji
        flat = ((b_new * nz + kk) * ny + jj) * nx + ii
        lo_name, hi_name = names[ax]
        return jnp.where(up, gather(lo_name, flat), gather(hi_name, flat))

    new_loc, new_idx, new_v = list(loc), list(idx), list(nv)
    for ax in range(ndim):
        m_ax = refine & (lax_axis == ax)
        f_ax = jnp.where(up, 0, dims[ax] - 1)
        trans = [t for t in range(ndim) if t != ax]
        edges = []
        for t in trans:
            e = jnp.clip(
                jnp.floor(loc[t] / jnp.maximum(ndx[t], tiny) + 0.5).astype(i32),
                1, dims[t] - 1,
            )
            edges.append((e - 1, e))

        def kji_of(cs):
            kji = [jnp.clip(idx[d], 0, dims[d] - 1) if d < ndim else 0 for d in range(3)]
            kji[ax] = f_ax
            for t, cv in zip(trans, cs):
                kji[t] = cv
            return kji[2], kji[1], kji[0]

        if len(trans) == 1:
            cands = [(edges[0][0],), (edges[0][1],)]
        else:
            (lo1, hi1), (lo2, hi2) = edges
            cands = [(lo1, lo2), (hi1, lo2), (lo1, hi2), (hi1, hi2)]
        Ps = [face_prob(ax, kji_of(cs)) for cs in cands]
        tot = Ps[0]
        for P in Ps[1:]:
            tot = tot + P
        xi = u_sel * (tot + tiny)
        cum = jnp.zeros_like(xi)
        chosen = m_ax & ~m_ax
        sel = [cv for cv in cands[-1]]  # numerical fall-through: last candidate
        picks = [jnp.zeros_like(cands[0][0]) for _ in trans]
        for cs, P in zip(cands, Ps):
            hit = ~chosen & (xi < cum + P)
            picks = [jnp.where(hit, cv, pk) for cv, pk in zip(cs, picks)]
            chosen = chosen | hit
            cum = cum + P
        sel = [jnp.where(chosen, pk, fb) for pk, fb in zip(picks, sel)]
        for t, cv, ut in zip(trans, sel, u_t):
            new_idx[t] = jnp.where(m_ax, cv, new_idx[t])
            new_loc[t] = jnp.where(m_ax, (cv.astype(f32) + ut) * ndx[t], new_loc[t])
        # hemisphere direction into the block (cyclic axis permutation)
        sgn = jnp.where(up, 1.0, -1.0)
        for k, val in enumerate((c * sgn * h[0], c * h[1], c * h[2])):
            a = (ax + k) % 3
            new_v[a] = jnp.where(m_ax, val, new_v[a])
    return new_loc, new_idx, new_v


def _cell_tables(coefs, prm, remap):
    """The three per-cell tables c0, c1, c2 (see the kernel's rate block)."""
    f32 = jnp.float32
    if coefs.opacity is not None:
        return tuple(remap(coefs.packed[:, k]).astype(f32) for k in range(3))
    if prm.has_absorption:
        ea = coefs.fleck * coefs.sigma_a
        es = coefs.sigma_s + (1.0 - coefs.fleck) * coefs.sigma_a
    else:
        ea = jnp.zeros_like(coefs.sigma_s)
        es = coefs.sigma_s
    if prm.use_ddmc:
        pair = (ea, es)
    else:
        inv = 1.0 / (ea + es + 1.0e-37)
        pair = (ea * inv, inv)
    dummy = jnp.zeros((1,), f32)
    return remap(pair[0]).astype(f32), remap(pair[1]).astype(f32), dummy


def transport_kernel(particles, coefs, mesh, key, prm, dt, interpret=False):
    """Drop-in replacement for ``transport_ops.transport`` (float32 ledgers).

    Pads the ledger to a whole number of blocks. ``interpret=True`` runs the
    kernel in the Pallas interpreter (CPU tests). Returns (particles,
    iterations, events): iterations is the longest block's loop count."""
    p = particles
    cap = p.capacity
    f32, i32 = jnp.float32, jnp.int32
    mesh_b = mesh  # the block forest the ledger and coefficients live on
    uniform = mesh.n_blocks > 1 and mesh.max_level == 0
    if uniform:
        # ONE synthetic block: shift block-local state to global-in-domain
        # (elementwise, no gathers — the decomposition is affine). The f32
        # round trip errs by <= nrb * extent * 2^-24, far below the eps
        # face offsets.
        nrbz, nrby, nrbx = mesh_b.root_grid
        bnds = mesh_b.bounds
        Dx = f32((bnds[1] - bnds[0]) / nrbx)
        Dy = f32((bnds[3] - bnds[2]) / nrby)
        Dz = f32((bnds[5] - bnds[4]) / nrbz)
        bx = p.block % nrbx
        by = (p.block // nrbx) % nrby
        bz = p.block // (nrbx * nrby)
        p = dataclasses.replace(
            p,
            x=p.x + bx.astype(f32) * Dx,
            y=p.y + by.astype(f32) * Dy,
            z=p.z + bz.astype(f32) * Dz,
            i=p.i + bx * mesh_b.nx,
            j=p.j + by * mesh_b.ny,
            k=p.k + bz * mesh_b.nz,
            block=jnp.zeros_like(p.block),
        )
        mesh = _uniform_view(mesh_b)
        remap = functools.partial(_to_global_cells, mesh=mesh_b)
    else:
        remap = lambda v: v  # noqa: E731

    c0, c1, c2 = _cell_tables(coefs, prm, remap)
    if prm.use_ddmc:
        faces = [
            remap(v.reshape(-1)).astype(f32)
            for v in _face_prob_vectors(coefs, mesh_b.nx, mesh_b.ny, mesh_b.nz)
        ]
    else:
        faces = [jnp.zeros((1,), f32)] * 6
    bdx, org = mesh.block_dx.astype(f32), mesh.block_origin.astype(f32)
    tables = [
        c0, c1, c2, bdx[:, 0], bdx[:, 1], bdx[:, 2], org[:, 0], org[:, 1], org[:, 2],
        mesh.lookup.reshape(-1).astype(i32), mesh.block_level.astype(i32), *faces,
    ]

    single_block = mesh.n_blocks == 1
    bnd = tuple(float(b) for b in mesh.bounds)
    if single_block:
        block_dx0 = (
            (bnd[1] - bnd[0]) / mesh.nx,
            (bnd[3] - bnd[2]) / mesh.ny,
            (bnd[5] - bnd[4]) / mesh.nz,
        )
        block_org0 = (bnd[0], bnd[2], bnd[4])
    else:
        block_dx0 = block_org0 = (0.0, 0.0, 0.0)
    st = (
        prm.ndim, mesh.nx, mesh.ny, mesh.nz, prm.max_iters,
        tuple(prm.swarm_bc), bnd, mesh.tile_shape,
        tuple(float(v) for v in mesh.finest), single_block, block_dx0, block_org0,
        prm.has_absorption, prm.use_ddmc, float(prm.tau_ddmc),
        float(prm.eps_imc), float(prm.eps_ddmc), mesh.max_level > 0,
        coefs.opacity is not None,
    )

    n_blocks = -(-cap // BLOCK)
    padded = n_blocks * BLOCK

    def lane(arr, dtype):
        a = arr.astype(dtype)
        return jnp.pad(a, (0, padded - cap)) if padded != cap else a

    inputs = [
        lane(p.x, f32), lane(p.y, f32), lane(p.z, f32),
        lane(p.vx, f32), lane(p.vy, f32), lane(p.vz, f32), lane(p.tau, f32),
        lane(p.block, i32), lane(p.i, i32), lane(p.j, i32), lane(p.k, i32),
        lane(p.alive, i32), lane(p.absorbed, i32), lane(p.face, i32),
        lane(p.energy, f32),
    ]
    scal = jnp.stack([jnp.asarray(dt, f32), jnp.asarray(prm.c, f32)])
    try:
        kd = jax.random.key_data(key)
    except (TypeError, AttributeError):
        kd = key
    seed = kd.reshape(-1)[-1:].astype(i32)

    lane_spec = pl.BlockSpec((BLOCK,), lambda g: (g,))

    def whole(arr):
        return pl.BlockSpec(arr.shape, lambda g: (0,))

    out_shape = (
        [jax.ShapeDtypeStruct((padded,), f32)] * 7
        + [jax.ShapeDtypeStruct((padded,), i32)] * 7
        + [jax.ShapeDtypeStruct((padded,), i32)] * 2
    )
    kernel = functools.partial(
        _census_kernel, st=st, opacity=coefs.opacity, scattering=coefs.scattering
    )
    res = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[whole(scal), whole(seed)] + [lane_spec] * _N_PART_IN
        + [whole(t) for t in tables],
        out_specs=[lane_spec] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="jaybenne_census",
    )(scal, seed, *inputs, *tables)

    (x, y, z, vx, vy, vz, tau, blk, ci, cj, ck, alive, absorbed, face,
     ev, it) = (r[:cap] for r in res)
    if uniform:
        # global-in-domain -> block-local: (ci, cj, ck) stay inside the
        # synthetic block, so integer division recovers the owning block
        bx = ci // mesh_b.nx
        by = cj // mesh_b.ny
        bz = ck // mesh_b.nz
        blk = (bz * nrby + by) * nrbx + bx
        ci = ci - bx * mesh_b.nx
        cj = cj - by * mesh_b.ny
        ck = ck - bz * mesh_b.nz
        x = x - bx.astype(f32) * Dx
        y = y - by.astype(f32) * Dy
        z = z - bz.astype(f32) * Dz
    dtype = particles.x.dtype
    p = dataclasses.replace(
        p,
        x=x.astype(dtype), y=y.astype(dtype), z=z.astype(dtype),
        vx=vx.astype(dtype), vy=vy.astype(dtype), vz=vz.astype(dtype),
        tau=tau.astype(dtype),
        block=blk, i=ci, j=cj, k=ck,
        alive=alive.astype(bool), absorbed=absorbed.astype(bool), face=face,
    )
    return p, jnp.max(it), jnp.sum(ev)
