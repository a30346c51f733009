"""Event-based IMC / DDMC photon transport.

JAX replacement for the reference's per-history device loops
(``TransportPhotons``, ``/root/reference/src/jaybenne/transport.cpp:28-181``;
``TransportPhotons_DDMC``, ``transport_ddmc.cpp:28-237``; step math in
``transport_utils.hpp:111-397``). The divergent per-particle ``while`` loop becomes a
``lax.while_loop`` whose body advances EVERY unfinished particle by exactly one event
— a fully vectorized, gather-only kernel (no scatter ops in the loop; absorption is
recorded in the ledger and tallied once afterwards).

One body application per active particle is one **event** (free-flight segment capped
at a cell width, scatter, absorption, cell/block crossing, DDMC leak/absorb, or
census) — the unit of the benchmark metric.

Key architectural deviations from the reference (correctness-preserving, see
SURVEY §7):

  * Cell identity is tracked by integer (block, i, j, k) through every event; the
    crossing branch increments indices and pins the position exactly onto the shared
    face. The reference instead re-derives indices from nudged positions
    (``Xtoijk`` + ``eps_imc_offset`` games, ``transport_utils.hpp:151-159``), which is
    fragile in float32.
  * Block transitions are resolved inline via the mesh's O(1) block-lookup grid
    (same-level, 2:1 coarse/fine, periodic wrap), replacing swarm send/receive and the
    iterate-until-complete task loop on a single shard. The multi-device spatial
    decomposition reintroduces the census iteration with ``all_to_all`` migration +
    ``psum`` completion (see ``jaybenne_tpu.parallel``).
  * The hybrid IMC/DDMC switch (``dx_min * sigma_t > tau_ddmc``,
    ``transport_ddmc.cpp:135``) is a per-particle mask, not a branch.

Physics is per the reference exactly:

  IMC step: sample ``d_abs ~ Exp(1/(f sa))``, ``d_sc ~ Exp(1/(ss + (1-f) sa))``,
  compare against the zone-size cap (min cell width), census distance, and the three
  face distances; absorb / isotropically scatter / cross / advance accordingly.

  DDMC step: leakage opacities ``P_face / dx`` per face; exponential event time vs
  census; event CDF = absorb vs six-way face leak (mid-face exit, cosine-weighted
  hemisphere direction); census resamples position uniformly in the cell and an
  isotropic direction. Particles arriving at a DDMC cell edge first pass the
  Habetler-Matkowsky albedo test ``P = 2 P_face (1 +/- 1.5 v_a / c)`` and are bounced
  back with a hemisphere direction on rejection.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import rng
from .fleck import LAM_EXT
from ..utils.tree import pytree_dataclass, static


@pytree_dataclass
class TransportCoefs:
    """Per-cell transport coefficients, precomputed once per radiation step (fields do
    not change during transport).

    Gray models (the whole shipped deck corpus): coefficients are precomputed per
    cell, ``packed`` rows are ``(sigma_a, sigma_s, fleck)``, and the event loop never
    touches the model objects — bitwise-identical to evaluating per event. With a
    frequency-DEPENDENT model, ``opacity``/``scattering`` are attached (static) and
    ``packed`` rows carry ``(rho, temp, fleck)`` instead: the event loop gathers the
    matter state and evaluates ``AbsorptionCoefficient(rho, T, E_photon)`` per event,
    exactly like the reference (``transport.cpp:122-127``).
    """

    sigma_a: jnp.ndarray  # [NC] Planck-mean absorption coefficient
    sigma_s: jnp.ndarray  # [NC] scattering coefficient (mean if non-gray)
    fleck: jnp.ndarray    # [NC] Fleck factor
    px: jnp.ndarray       # [B, nz, ny, nx+1] DDMC face probs (zeros if unused)
    py: jnp.ndarray       # [B, nz, ny+1, nx]
    pz: jnp.ndarray       # [B, nz+1, ny, nx]
    # [NC, 3]: one row gather per event fetches all three values (see class doc)
    packed: jnp.ndarray = None
    # frequency-dependent surface: static model objects, None for gray physics
    opacity: object = static(default=None)
    scattering: object = static(default=None)


@pytree_dataclass
class TransportParams:
    # static configuration (hashable -> one compilation per physics setup)
    ndim: int = static()
    use_ddmc: bool = static()
    max_iters: int = static()
    swarm_bc: tuple = static()   # 6 BC enums (ix1, ox1, ix2, ox2, ix3, ox3)
    c: float = static()          # speed of light (code units)
    tau_ddmc: float = static()
    eps_imc: float = static()    # relative face offset for albedo bounce-back
    eps_ddmc: float = static()   # relative face offset for DDMC leak placement
    # absorption opacity identically zero (opacity_model = none): the Fleck factor
    # is exactly 1, absorption never fires, and kernels can skip that work
    has_absorption: bool = static(default=True)


def default_eps(dtype):
    """Face-offset epsilons. The reference uses 1e6/1e8 x DBL_EPSILON
    (``transport_utils.hpp:24-25``); in float32 the offsets must clear the position
    representation error (~1e-5 of a cell near large coordinates), so they are scaled
    up. They only set where bounced/leaked particles are re-seeded inside a cell —
    O(eps * dx) spatial blur, far below Monte Carlo noise."""
    if dtype == jnp.float64:
        return dict(eps_imc=2.2e-10, eps_ddmc=2.2e-8)
    return dict(eps_imc=1.0e-3, eps_ddmc=1.0e-2)


def precompute_coefs(fields, mesh, eos, opacity, scattering, use_ddmc, dtype):
    temp = eos.temperature_from_density_internal_energy(fields.rho, fields.sie)
    sigma_s = scattering.total_scattering_coefficient(fields.rho, temp)
    sigma_a = opacity.absorption_coefficient(fields.rho, temp)
    sigma_s = jnp.broadcast_to(jnp.asarray(sigma_s, dtype), fields.rho.shape)
    sigma_a = jnp.broadcast_to(jnp.asarray(sigma_a, dtype), fields.rho.shape)
    sa_flat = sigma_a.reshape(-1)
    ss_flat = sigma_s.reshape(-1)
    ff_flat = fields.fleck.reshape(-1).astype(dtype)
    gray = getattr(opacity, "is_gray", True) and getattr(scattering, "is_gray", True)
    if gray:
        packed = jnp.stack([sa_flat, ss_flat, ff_flat], axis=-1)
        models = dict(opacity=None, scattering=None)
    else:
        # per-event surface: the loop gathers (rho, T, fleck) and evaluates the
        # models at the particle's photon energy
        rho_flat = fields.rho.reshape(-1).astype(dtype)
        tt_flat = jnp.asarray(temp, dtype).reshape(-1)
        packed = jnp.stack([rho_flat, tt_flat, ff_flat], axis=-1)
        models = dict(opacity=opacity, scattering=scattering)
    return TransportCoefs(
        sigma_a=sa_flat,
        sigma_s=ss_flat,
        fleck=ff_flat,
        packed=packed,
        px=fields.ddmc_px if use_ddmc else jnp.zeros_like(fields.ddmc_px),
        py=fields.ddmc_py if use_ddmc else jnp.zeros_like(fields.ddmc_py),
        pz=fields.ddmc_pz if use_ddmc else jnp.zeros_like(fields.ddmc_pz),
        **models,
    )


def _face_flat(mesh, b, k, j, i, axis):
    """Flat index into the face array for `axis` at cell-corner index (k, j, i)."""
    nx, ny, nz = mesh.nx, mesh.ny, mesh.nz
    if axis == 0:
        return ((b * nz + k) * ny + j) * (nx + 1) + i
    if axis == 1:
        return ((b * nz + k) * (ny + 1) + j) * nx + i
    return ((b * (nz + 1) + k) * ny + j) * nx + i


# --------------------------------------------------------------------------- body
def _one_event(p, coefs, mesh, prm: TransportParams, dt, key, block_offset=None):
    """Advance every unfinished particle by one event. Returns (particles, n_active).

    ``block_offset``: under the spatial (block-sharded) decomposition, the global id
    of this shard's first block. Field coefficient arrays are then shard-local
    ([B_local * ncells]); particles whose block lies outside the local range are in
    transit awaiting migration and are skipped (the analog of the reference's
    off-block break at ``transport.cpp:151-155``)."""
    dtype = p.x.dtype
    tiny = jnp.finfo(dtype).tiny
    BIG = jnp.asarray(jnp.finfo(dtype).max, dtype)
    c = jnp.asarray(prm.c, dtype)
    multi_d = prm.ndim >= 2
    three_d = prm.ndim == 3

    active = p.alive & (p.tau < 1.0)
    if block_offset is not None:
        n_local = coefs.px.shape[0]
        b_local = p.block - block_offset
        owned = (b_local >= 0) & (b_local < n_local)
        active = active & owned
    else:
        b_local = p.block

    meta = mesh.block_meta[p.block]  # [P, 6] one gather: (dx, dy, dz, origin)
    dx, dy, dz = meta[:, 0], meta[:, 1], meta[:, 2]
    org_own = meta[:, 3:6]
    # transport scale: the smallest cell extent over TRANSPORT dimensions only
    # (transverse block extents of a 1D/2D problem are not transport scales;
    # matches the Pallas kernels' static [:ndim] min)
    if prm.ndim == 3:
        dmin = jnp.minimum(dx, jnp.minimum(dy, dz))
    elif prm.ndim == 2:
        dmin = jnp.minimum(dx, dy)
    else:
        dmin = dx
    b_idx = jnp.clip(b_local, 0, coefs.px.shape[0] - 1)  # field-gather block index
    cell = mesh.flat_cell(b_idx, p.k, p.j, p.i)
    if coefs.opacity is not None:
        # frequency-dependent surface: gather the matter state and evaluate the
        # models at the particle's photon energy, as the reference does per event
        # (transport.cpp:122-127)
        rows = jnp.take(coefs.packed, cell, axis=0)  # (rho, temp, fleck)
        rho_g, tt_g, ff = rows[:, 0], rows[:, 1], rows[:, 2]
        sa = jnp.asarray(
            coefs.opacity.absorption_coefficient(rho_g, tt_g, p.energy), dtype
        )
        ss = jnp.asarray(
            coefs.scattering.total_scattering_coefficient(rho_g, tt_g, p.energy),
            dtype,
        )
        sa = jnp.broadcast_to(sa, rho_g.shape)
        ss = jnp.broadcast_to(ss, rho_g.shape)
    elif coefs.packed is not None:
        rows = jnp.take(coefs.packed, cell, axis=0)  # one 3-wide row gather
        sa, ss, ff = rows[:, 0], rows[:, 1], rows[:, 2]
    else:
        sa = jnp.take(coefs.sigma_a, cell)
        ss = jnp.take(coefs.sigma_s, cell)
        ff = jnp.take(coefs.fleck, cell)
    sig_t = sa + ss

    is_ddmc = active & (dmin * sig_t > prm.tau_ddmc) if prm.use_ddmc else jnp.zeros_like(active)
    is_imc = active & ~is_ddmc

    # cell bounds in block-local coordinates
    fi = p.i.astype(dtype)
    fj = p.j.astype(dtype)
    fk = p.k.astype(dtype)
    xl, xu = fi * dx, (fi + 1.0) * dx
    yl, yu = fj * dy, (fj + 1.0) * dy
    zl, zu = fk * dz, (fk + 1.0) * dz

    shape = p.x.shape
    # ONE batched threefry draw per event covers every variate this iteration
    # needs (the reference draws lazily from a stateful per-thread pool; separate
    # jax.random calls here cost ~10x the dispatch/overhead on the fallback path).
    # Row map: 0-1 exp distances, 2-3 scatter; DDMC: 4 albedo, 5-6 bounce dir,
    # 7 event time, 8 event CDF, 9-10 leak dir, 11-13 census pos, 14-15 census
    # dir; SMR subface resample: 16-18 selection, 19-20 hemisphere dir.
    smr_resample = prm.use_ddmc and mesh.max_level > 0
    n_draw = 21 if smr_resample else (16 if prm.use_ddmc else 4)
    U = jax.random.uniform(key, (n_draw,) + shape, dtype=dtype)

    def u(i):
        return U[i]

    def expd(i):
        return -jnp.log(jnp.maximum(U[i], tiny))

    def iso_dir(i):
        """Isotropic direction from rows (i, i+1), polar axis z (scatter conv)."""
        mu = 1.0 - 2.0 * U[i]
        phi = (2.0 * jnp.pi) * U[i + 1]
        st = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
        return st * jnp.cos(phi), st * jnp.sin(phi), mu

    def face_iso(i):
        """Cosine-weighted hemisphere dir from rows (i, i+1): unsigned principal
        component first (see rng.face_isotropic_direction)."""
        mu = jnp.sqrt(U[i])
        nu = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
        phi = (2.0 * jnp.pi) * U[i + 1]
        return mu, nu * jnp.cos(phi), nu * jnp.sin(phi)

    # ===================== IMC branch (ptcl_transport_step) ====================
    d_abs = expd(0) / (ff * sa + tiny)
    d_sc = expd(1) / (ss + (1.0 - ff) * sa + tiny)
    d_end = c * dt * (1.0 - p.tau)
    d_geom = jnp.minimum(dmin, d_end)

    def face_dist(v, lo, hi, x):
        return jnp.where(
            v > 0, c * (hi - x) / jnp.where(v > 0, v, 1.0),
            jnp.where(v < 0, c * (lo - x) / jnp.where(v < 0, v, 1.0), BIG),
        )

    fxd = face_dist(p.vx, xl, xu, p.x)
    fyd = face_dist(p.vy, yl, yu, p.y) if multi_d else jnp.full(shape, BIG, dtype)
    fzd = face_dist(p.vz, zl, zu, p.z) if three_d else jnp.full(shape, BIG, dtype)

    d_push = jnp.minimum(jnp.minimum(d_geom, fxd), jnp.minimum(fyd, fzd))
    i_abs = is_imc & (d_abs < d_push) & (d_abs < d_sc)
    i_sc = is_imc & ~i_abs & (d_sc < d_push)
    no_coll = is_imc & ~i_abs & ~i_sc
    cr_x = no_coll & (fxd <= fyd) & (fxd <= fzd) & (fxd <= d_geom)
    cr_y = no_coll & ~cr_x & (fyd <= fzd) & (fyd <= d_geom)
    cr_z = no_coll & ~cr_x & ~cr_y & (fzd <= d_geom)
    i_census = no_coll & ~cr_x & ~cr_y & ~cr_z & (d_end <= dmin)

    d = jnp.where(i_abs, d_abs, jnp.where(i_sc, d_sc, d_push))

    imc_tau = jnp.where(i_census, 1.0, p.tau + d / (c * dt))
    imc_x = p.x + p.vx * (d / c)
    imc_y = p.y + p.vy * (d / c) if multi_d else p.y
    imc_z = p.z + p.vz * (d / c) if three_d else p.z
    # pin crossings exactly onto the shared face and step the cell index
    imc_x = jnp.where(cr_x, jnp.where(p.vx > 0, xu, xl), imc_x)
    imc_y = jnp.where(cr_y, jnp.where(p.vy > 0, yu, yl), imc_y)
    imc_z = jnp.where(cr_z, jnp.where(p.vz > 0, zu, zl), imc_z)
    step_x = jnp.where(cr_x, jnp.where(p.vx > 0, 1, -1), 0).astype(jnp.int32)
    step_y = jnp.where(cr_y, jnp.where(p.vy > 0, 1, -1), 0).astype(jnp.int32)
    step_z = jnp.where(cr_z, jnp.where(p.vz > 0, 1, -1), 0).astype(jnp.int32)

    # isotropic scatter redraw (scattering.hpp:21-29)
    snx, sny, snz = iso_dir(2)
    imc_vx = jnp.where(i_sc, c * snx, p.vx)
    imc_vy = jnp.where(i_sc, c * sny, p.vy)
    imc_vz = jnp.where(i_sc, c * snz, p.vz)

    # face-arrival code: a crossing pins the particle onto a face of its new cell
    # (+ = lower face, entered travelling up); any other outcome clears it
    imc_face = jnp.where(cr_x, jnp.where(p.vx > 0, 1, -1), 0).astype(jnp.int32)
    imc_face = jnp.where(cr_y, jnp.where(p.vy > 0, 2, -2), imc_face)
    imc_face = jnp.where(cr_z, jnp.where(p.vz > 0, 3, -3), imc_face)

    # ===================== DDMC branch =========================================
    if prm.use_ddmc:
        # at-face detection keys on the IMC-crossing arrival flag (see
        # ParticleLedger.face): the reference's fuzzy position window
        # (``2.5 * eps_imc_offset`` relative, transport_utils.hpp:286) only ever
        # catches genuinely pinned IMC arrivals; the flag is the exact equivalent.
        # The codes are mutually exclusive, so no priority chain is needed.
        sel = [
            is_ddmc & (p.face == 1),   # at lower x face
            is_ddmc & (p.face == -1),  # at upper x face
            is_ddmc & (p.face == 2),
            is_ddmc & (p.face == -2),
            is_ddmc & (p.face == 3),
            is_ddmc & (p.face == -3),
        ]
        at_face = is_ddmc & (p.face != 0)

        # albedo acceptance: P = 2 P_face (1 +/- 1.5 v_a/c)
        face_dx = [dx, dx, dy, dy, dz, dz]
        face_v = [p.vx, p.vx, p.vy, p.vy, p.vz, p.vz]
        face_sign = [1.0, -1.0, 1.0, -1.0, 1.0, -1.0]  # + for lower faces
        P = jnp.zeros(shape, dtype)
        for m, fdx, fv, sgn in zip(sel, face_dx, face_v, face_sign):
            Pf = (2.0 / 3.0) / (sig_t * fdx + 2.0 * LAM_EXT)
            P = jnp.where(m, 2.0 * Pf * (1.0 + sgn * 1.5 * fv / c), P)
        u_alb = u(4)
        rejected = at_face & (u_alb > P)

        # rejected: hemisphere direction away from the face; re-seed eps into the
        # neighboring cell (index steps; block transition handles edges)
        a1, a2, a3 = face_iso(5)
        rj_x, rj_y, rj_z = p.x, p.y, p.z
        rj_vx, rj_vy, rj_vz = p.vx, p.vy, p.vz
        rj_si = jnp.zeros(shape, jnp.int32)
        rj_sj = jnp.zeros(shape, jnp.int32)
        rj_sk = jnp.zeros(shape, jnp.int32)
        # (axis permutations follow sample_face_iso_dir call sites in
        #  transport_utils.hpp:296-386: principal, then the cyclically next axes)
        specs = [
            # (mask, axis, lower?)
            (sel[0], 0, True), (sel[1], 0, False),
            (sel[2], 1, True), (sel[3], 1, False),
            (sel[4], 2, True), (sel[5], 2, False),
        ]
        for m, axis, lower in specs:
            sgn = jnp.asarray(-1.0 if lower else 1.0, dtype)  # outward = away from cell
            v1 = c * sgn * a1
            v2 = c * a2
            v3 = c * a3
            if axis == 0:
                rj_vx = jnp.where(m, v1, rj_vx)
                rj_vy = jnp.where(m, v2, rj_vy)
                rj_vz = jnp.where(m, v3, rj_vz)
                rj_x = jnp.where(m, jnp.where(lower, xl - prm.eps_imc * dx, xu + prm.eps_imc * dx), rj_x)
                rj_si = jnp.where(m, -1 if lower else 1, rj_si)
            elif axis == 1:
                rj_vy = jnp.where(m, v1, rj_vy)
                rj_vz = jnp.where(m, v2, rj_vz)
                rj_vx = jnp.where(m, v3, rj_vx)
                rj_y = jnp.where(m, jnp.where(lower, yl - prm.eps_imc * dy, yu + prm.eps_imc * dy), rj_y)
                rj_sj = jnp.where(m, -1 if lower else 1, rj_sj)
            else:
                rj_vz = jnp.where(m, v1, rj_vz)
                rj_vx = jnp.where(m, v2, rj_vx)
                rj_vy = jnp.where(m, v3, rj_vy)
                rj_z = jnp.where(m, jnp.where(lower, zl - prm.eps_imc * dz, zu + prm.eps_imc * dz), rj_z)
                rj_sk = jnp.where(m, -1 if lower else 1, rj_sk)

        # ---- in-cell DDMC step (ptcl_ddmc_step) for non-rejected particles ----
        do_step = is_ddmc & ~rejected
        fp_xl = jnp.take(coefs.px.reshape(-1), _face_flat(mesh, b_idx, p.k, p.j, p.i, 0))
        fp_xu = jnp.take(coefs.px.reshape(-1), _face_flat(mesh, b_idx, p.k, p.j, p.i + 1, 0))
        if multi_d:
            fp_yl = jnp.take(coefs.py.reshape(-1), _face_flat(mesh, b_idx, p.k, p.j, p.i, 1))
            fp_yu = jnp.take(coefs.py.reshape(-1), _face_flat(mesh, b_idx, p.k, p.j + 1, p.i, 1))
        else:
            fp_yl = fp_yu = jnp.zeros(shape, dtype)
        if three_d:
            fp_zl = jnp.take(coefs.pz.reshape(-1), _face_flat(mesh, b_idx, p.k, p.j, p.i, 2))
            fp_zu = jnp.take(coefs.pz.reshape(-1), _face_flat(mesh, b_idx, p.k + 1, p.j, p.i, 2))
        else:
            fp_zl = fp_zu = jnp.zeros(shape, dtype)

        lk = [fp_xl / dx, fp_xu / dx, fp_yl / dy, fp_yu / dy, fp_zl / dz, fp_zu / dz]
        leak_tot = sum(lk)
        cdf = ff * sa + leak_tot + tiny
        dt_ev = expd(7) / (c * cdf)
        dt_rem = dt * (1.0 - p.tau)
        is_event = dt_ev < dt_rem

        dd_tau = jnp.where(is_event, p.tau + dt_ev / dt, 1.0)

        xi = cdf * u(8)
        dd_absorbed = do_step & is_event & (xi < ff * sa)
        xim = xi - ff * sa
        cum = jnp.zeros(shape, dtype)
        leak_sel = []
        leak_any = jnp.zeros_like(active)
        for l in lk:
            m = do_step & is_event & ~dd_absorbed & ~leak_any & (xim < cum + l)
            leak_sel.append(m)
            leak_any = leak_any | m
            cum = cum + l
        # numerical remainder: force the last face for leak events that fell through
        fallthrough = do_step & is_event & ~dd_absorbed & ~leak_any
        if three_d:
            leak_sel[5] = leak_sel[5] | fallthrough
        elif multi_d:
            leak_sel[3] = leak_sel[3] | fallthrough
        else:
            leak_sel[1] = leak_sel[1] | fallthrough
        leak_any = leak_any | fallthrough

        b1, b2, b3 = face_iso(9)
        dd_x, dd_y, dd_z = p.x, p.y, p.z
        dd_vx, dd_vy, dd_vz = p.vx, p.vy, p.vz
        dd_si = jnp.zeros(shape, jnp.int32)
        dd_sj = jnp.zeros(shape, jnp.int32)
        dd_sk = jnp.zeros(shape, jnp.int32)
        dd_leak_code = jnp.zeros(shape, jnp.int32)  # ±(axis+1) of a leak this event
        cx, cy, cz = xl + 0.5 * dx, yl + 0.5 * dy, zl + 0.5 * dz
        leak_specs = [
            (leak_sel[0], 0, True), (leak_sel[1], 0, False),
            (leak_sel[2], 1, True), (leak_sel[3], 1, False),
            (leak_sel[4], 2, True), (leak_sel[5], 2, False),
        ]
        for m, axis, lower in leak_specs:
            dd_leak_code = jnp.where(m, (-1 if lower else 1) * (axis + 1), dd_leak_code)
            out_sgn = -1.0 if lower else 1.0  # direction of travel = outward
            v1 = c * out_sgn * b1
            v2 = c * b2
            v3 = c * b3
            if axis == 0:
                dd_x = jnp.where(m, jnp.where(lower, xl - prm.eps_ddmc * dx, xu + prm.eps_ddmc * dx), dd_x)
                dd_y = jnp.where(m, cy, dd_y)
                dd_z = jnp.where(m, cz, dd_z)
                dd_vx = jnp.where(m, v1, dd_vx)
                dd_vy = jnp.where(m, v2, dd_vy)
                dd_vz = jnp.where(m, v3, dd_vz)
                dd_si = jnp.where(m, -1 if lower else 1, dd_si)
            elif axis == 1:
                dd_y = jnp.where(m, jnp.where(lower, yl - prm.eps_ddmc * dy, yu + prm.eps_ddmc * dy), dd_y)
                dd_z = jnp.where(m, cz, dd_z)
                dd_x = jnp.where(m, cx, dd_x)
                dd_vy = jnp.where(m, v1, dd_vy)
                dd_vz = jnp.where(m, v2, dd_vz)
                dd_vx = jnp.where(m, v3, dd_vx)
                dd_sj = jnp.where(m, -1 if lower else 1, dd_sj)
            else:
                dd_z = jnp.where(m, jnp.where(lower, zl - prm.eps_ddmc * dz, zu + prm.eps_ddmc * dz), dd_z)
                dd_x = jnp.where(m, cx, dd_x)
                dd_y = jnp.where(m, cy, dd_y)
                dd_vz = jnp.where(m, v1, dd_vz)
                dd_vx = jnp.where(m, v2, dd_vx)
                dd_vy = jnp.where(m, v3, dd_vy)
                dd_sk = jnp.where(m, -1 if lower else 1, dd_sk)

        # census: resample position uniform in cell + isotropic direction
        dd_census = do_step & ~is_event
        ucx = u(11)
        ucy = u(12)
        ucz = u(13)
        cnx, cny, cnz = iso_dir(14)
        dd_x = jnp.where(dd_census, xl + ucx * dx, dd_x)
        dd_y = jnp.where(dd_census, yl + ucy * dy, dd_y)
        dd_z = jnp.where(dd_census, zl + ucz * dz, dd_z)
        dd_vx = jnp.where(dd_census, c * cnx, dd_vx)
        dd_vy = jnp.where(dd_census, c * cny, dd_vy)
        dd_vz = jnp.where(dd_census, c * cnz, dd_vz)

        # merge rejected-bounce with ddmc-step results
        dd_x = jnp.where(rejected, rj_x, dd_x)
        dd_y = jnp.where(rejected, rj_y, dd_y)
        dd_z = jnp.where(rejected, rj_z, dd_z)
        dd_vx = jnp.where(rejected, rj_vx, dd_vx)
        dd_vy = jnp.where(rejected, rj_vy, dd_vy)
        dd_vz = jnp.where(rejected, rj_vz, dd_vz)
        dd_si = jnp.where(rejected, rj_si, dd_si)
        dd_sj = jnp.where(rejected, rj_sj, dd_sj)
        dd_sk = jnp.where(rejected, rj_sk, dd_sk)
        dd_tau = jnp.where(rejected, p.tau, dd_tau)  # bounce-back costs no time
        dd_leak_code = jnp.where(rejected, 0, dd_leak_code)
    else:
        dd_x = dd_y = dd_z = jnp.zeros(shape, dtype)
        dd_vx = dd_vy = dd_vz = jnp.zeros(shape, dtype)
        dd_si = dd_sj = dd_sk = jnp.zeros(shape, jnp.int32)
        dd_tau = jnp.zeros(shape, dtype)
        dd_absorbed = jnp.zeros_like(active)
        dd_leak_code = jnp.zeros(shape, jnp.int32)

    # ===================== merge branches =====================================
    new_x = jnp.where(is_ddmc, dd_x, jnp.where(is_imc, imc_x, p.x))
    new_y = jnp.where(is_ddmc, dd_y, jnp.where(is_imc, imc_y, p.y))
    new_z = jnp.where(is_ddmc, dd_z, jnp.where(is_imc, imc_z, p.z))
    new_vx = jnp.where(is_ddmc, dd_vx, jnp.where(is_imc, imc_vx, p.vx))
    new_vy = jnp.where(is_ddmc, dd_vy, jnp.where(is_imc, imc_vy, p.vy))
    new_vz = jnp.where(is_ddmc, dd_vz, jnp.where(is_imc, imc_vz, p.vz))
    new_tau = jnp.where(is_ddmc, dd_tau, jnp.where(is_imc, imc_tau, p.tau))
    new_i = p.i + jnp.where(is_ddmc, dd_si, step_x)
    new_j = p.j + jnp.where(is_ddmc, dd_sj, step_y)
    new_k = p.k + jnp.where(is_ddmc, dd_sk, step_z)
    # every DDMC outcome (albedo bounce, leak, census, absorb) leaves the particle
    # off-face (eps offsets / uniform resample), so the flag clears
    new_face = jnp.where(is_ddmc, 0, jnp.where(is_imc, imc_face, p.face))

    absorbed_now = i_abs | dd_absorbed
    new_alive = p.alive & ~absorbed_now
    new_absorbed = p.absorbed | absorbed_now

    p = dataclasses.replace(
        p,
        x=new_x, y=new_y, z=new_z,
        vx=new_vx, vy=new_vy, vz=new_vz,
        tau=new_tau, i=new_i, j=new_j, k=new_k,
        alive=new_alive, absorbed=new_absorbed, face=new_face,
    )

    n_active = jnp.sum(active.astype(jnp.int32)).astype(jnp.int32)

    # ===================== block transition / boundary conditions =============
    leak_code = jnp.where(is_ddmc, dd_leak_code, 0) if prm.use_ddmc else None
    # DDMC leaks into a FINER block resample among its subfaces inline when the
    # destination's face probs are on this shard; under the spatial decomposition
    # a remote destination instead records a pending-leak code that the OWNING
    # shard resolves on arrival (the reference's post-communication
    # SampleDDMCBlockFace pass)
    sub_coefs = coefs if smr_resample else None
    sub_draws = (u(16), u(17), u(18), *face_iso(19)) if smr_resample else None
    p = resolve_block_transition(
        p, mesh, prm, coefs=sub_coefs, leak_code=leak_code, draws=sub_draws,
        org=org_own, block_offset=block_offset,
        n_local=coefs.px.shape[0] if block_offset is not None else None,
    )
    return p, n_active


def resolve_block_transition(
    p, mesh, prm: TransportParams, coefs=None, leak_code=None, draws=None, org=None,
    block_offset=None, n_local=None,
):
    """Re-home particles whose cell index stepped off their block: apply domain
    (swarm) boundary conditions, locate the new owning block via the lookup grid, and
    rebase local coordinates. Replaces the reference's swarm communication + photon
    reflect BC (``boundaries.hpp:24-84``) + post-comms ``Xtoijk``.

    With ``coefs``/``leak_code`` (DDMC on an SMR mesh), particles that LEAKED across
    a block face into a FINER block additionally choose among the 2 (2D) / 4 (3D)
    refined subfaces with probability proportional to the fine faces'
    ``ddmc_face_prob`` and re-sample a hemisphere direction into the block — the
    inline equivalent of the reference's post-communication ``SampleDDMCBlockFace``
    pass (``sample_ddmc_bface.cpp:81-427``; same-level and fine->coarse arrivals need
    no adjustment because the leak already drew the correct face-isotropic direction
    and mid-face position)."""
    from ..config import BC  # local import to avoid a cycle

    dtype = p.x.dtype
    out_lo_x = p.i < 0
    out_hi_x = p.i >= mesh.nx
    out_lo_y = p.j < 0
    out_hi_y = p.j >= mesh.ny
    out_lo_z = p.k < 0
    out_hi_z = p.k >= mesh.nz
    out = (out_lo_x | out_hi_x | out_lo_y | out_hi_y | out_lo_z | out_hi_z) & p.alive
    # fast exit is not possible under jit; the ops below are cheap masked arithmetic

    if org is None:
        org = mesh.block_origin[p.block]
    gx = org[:, 0] + p.x
    gy = org[:, 1] + p.y
    gz = org[:, 2] + p.z
    x1min, x1max, x2min, x2max, x3min, x3max = mesh.bounds

    alive = p.alive
    vx, vy, vz = p.vx, p.vy, p.vz
    face = p.face

    def apply_bc(g, v, lo, hi, out_lo, out_hi, bc_lo, bc_hi, half):
        # The hit test is tolerant by half a finest cell: with inexact domain
        # extents (e.g. [0, 0.1] at nx=10) the pinned face position of the
        # outermost cell can round BELOW the deck's upper bound, and an exact
        # ``g >= hi`` would never fire — re-homing the particle into the same
        # boundary cell forever. Internal block faces always sit at least one
        # finest cell inside the bound, so the window cannot catch a genuine
        # interior crossing.
        nonlocal alive, face
        L = hi - lo
        hit_lo = out_lo & (g <= lo + half)
        hit_hi = out_hi & (g >= hi - half)
        # reflecting: mirror position about the bound, flip velocity (clipped to
        # the domain: a sub-half-cell rounding of g must not mirror to outside);
        # a face-arrival flag flips side (the particle now sits at the OTHER face
        # of the boundary cell, travelling inward)
        if bc_lo == BC.reflecting:
            g = jnp.where(hit_lo, jnp.clip(2.0 * lo - g, lo, hi), g)
            v = jnp.where(hit_lo, -v, v)
            face = jnp.where(hit_lo, -face, face)
        elif bc_lo == BC.periodic:
            g = jnp.where(hit_lo, jnp.clip(g + L, lo, hi), g)
        else:  # outflow
            alive = jnp.where(hit_lo, False, alive)
        if bc_hi == BC.reflecting:
            g = jnp.where(hit_hi, jnp.clip(2.0 * hi - g, lo, hi), g)
            v = jnp.where(hit_hi, -v, v)
            face = jnp.where(hit_hi, -face, face)
        elif bc_hi == BC.periodic:
            g = jnp.where(hit_hi, jnp.clip(g - L, lo, hi), g)
        else:
            alive = jnp.where(hit_hi, False, alive)
        return g, v

    bcs = prm.swarm_bc
    fx, fy, fz = mesh.finest
    gx, vx = apply_bc(gx, vx, x1min, x1max, out_lo_x, out_hi_x, bcs[0], bcs[1], 0.5 * fx)
    if prm.ndim >= 2:
        gy, vy = apply_bc(gy, vy, x2min, x2max, out_lo_y, out_hi_y, bcs[2], bcs[3], 0.5 * fy)
    if prm.ndim == 3:
        gz, vz = apply_bc(gz, vz, x3min, x3max, out_lo_z, out_hi_z, bcs[4], bcs[5], 0.5 * fz)

    # Crossing positions sit EXACTLY on block faces, where a position-only lookup is
    # ambiguous (it would always pick the upper block, livelocking a downward-moving
    # particle in zero-length crossings). Probe the lookup with the position nudged
    # HALF a finest cell along the CROSSED face's normal — known exactly from the
    # out flags, like the census kernel (pallas_census.py). A velocity-scaled
    # nudge is NOT enough: for grazing crossings (|v_axis|/c below ~position-ulp /
    # 0.01 cell) the f32 add rounds away entirely, the lookup re-picks the block
    # just left, and the particle spins at face distance 0 to the iteration cap
    # (observed: 118/20k particles stuck at x=0, |mu| < 0.04, on an 8192-cell
    # run). Non-crossing axes keep the small directional tiebreak for corners.
    # Only the block choice uses the probe; local coords rebase the exact position.
    finest = jnp.min(mesh.block_dx, axis=0)  # [3]
    c = jnp.asarray(prm.c, dtype)
    sgx = jnp.where(out_hi_x, 1.0, 0.0) - jnp.where(out_lo_x, 1.0, 0.0)
    px = gx + jnp.where(
        sgx != 0, 0.5 * finest[0] * sgx, 0.01 * finest[0] * (vx / c)
    )
    if prm.ndim >= 2:
        sgy = jnp.where(out_hi_y, 1.0, 0.0) - jnp.where(out_lo_y, 1.0, 0.0)
        py = gy + jnp.where(
            sgy != 0, 0.5 * finest[1] * sgy, 0.01 * finest[1] * (vy / c)
        )
    else:
        py = gy
    if prm.ndim == 3:
        sgz = jnp.where(out_hi_z, 1.0, 0.0) - jnp.where(out_lo_z, 1.0, 0.0)
        pz = gz + jnp.where(
            sgz != 0, 0.5 * finest[2] * sgz, 0.01 * finest[2] * (vz / c)
        )
    else:
        pz = gz
    b_new = mesh.locate_block(px, py, pz)
    meta_new = mesh.block_meta[b_new]  # one gather: (dx, origin) of the new block
    dx_new = meta_new[:, 0:3]
    lx = (gx - meta_new[:, 3]).astype(dtype)
    ly = (gy - meta_new[:, 4]).astype(dtype)
    lz = (gz - meta_new[:, 5]).astype(dtype)
    # cell of the local position, clamped to the interior (resolves the at-face
    # ambiguity of a just-migrated particle in favor of the entry cell)
    i_new = jnp.clip(jnp.floor(lx / dx_new[:, 0]).astype(jnp.int32), 0, mesh.nx - 1)
    j_new = jnp.clip(jnp.floor(ly / dx_new[:, 1]).astype(jnp.int32), 0, mesh.ny - 1)
    k_new = jnp.clip(jnp.floor(lz / dx_new[:, 2]).astype(jnp.int32), 0, mesh.nz - 1)

    upd = out & alive
    leak_field = p.leak

    # ---- DDMC coarse->fine subface resampling --------------------------------
    if coefs is not None and leak_code is not None and draws is not None:
        refine = (
            upd
            & (leak_code != 0)
            & (mesh.block_level[b_new] > mesh.block_level[p.block])
        )
        if block_offset is None:
            refine_here = refine
            b_coef = b_new  # coefs are global: face index by global block id
        else:
            # only destinations on this shard have their face probs resident;
            # remote ones carry a pending-leak code for the owner to resolve
            here = (b_new >= block_offset) & (b_new < block_offset + n_local)
            refine_here = refine & here
            b_coef = jnp.clip(b_new - block_offset, 0, n_local - 1)
            leak_field = jnp.where(
                upd, jnp.where(refine & ~here, leak_code, 0), leak_field
            )
        lx, ly, lz, vx, vy, vz, i_new, j_new, k_new = _ddmc_subface_resample(
            mesh, coefs, prm, draws, refine_here, leak_code, b_coef, dx_new,
            lx, ly, lz, vx, vy, vz, i_new, j_new, k_new,
        )

    return dataclasses.replace(
        p,
        x=jnp.where(upd, lx, p.x),
        y=jnp.where(upd, ly, p.y),
        z=jnp.where(upd, lz, p.z),
        vx=jnp.where(upd, vx, p.vx),
        vy=jnp.where(upd, vy, p.vy),
        vz=jnp.where(upd, vz, p.vz),
        block=jnp.where(upd, b_new, p.block),
        i=jnp.where(upd, i_new, jnp.clip(p.i, 0, mesh.nx - 1)),
        j=jnp.where(upd, j_new, jnp.clip(p.j, 0, mesh.ny - 1)),
        k=jnp.where(upd, k_new, jnp.clip(p.k, 0, mesh.nz - 1)),
        alive=alive,
        face=face,
        leak=leak_field,
    )


def _ddmc_subface_resample(
    mesh, coefs, prm, draws, refine, leak_code, b, dxv,
    lx, ly, lz, vx, vy, vz, ii, jj, kk,
):
    """Choose among the refined subfaces for DDMC particles leaking coarse->fine.

    The leak placed the particle at the transverse CENTER of the coarse source cell,
    which lands exactly on the edge shared by 2 (2D) or corner shared by 4 (3D) fine
    cells of the destination block. Pick the fine face with probability proportional
    to its ``ddmc_face_prob`` (reference ``SampleFace2D``/``SampleFace3D``,
    ``sample_ddmc_bface.cpp:24-78``), re-seat the transverse position uniformly on
    the chosen face, and redraw a hemisphere direction pointing into the block."""
    dtype = lx.dtype
    c = jnp.asarray(prm.c, dtype)
    multi_d = prm.ndim >= 2
    three_d = prm.ndim == 3
    if not multi_d:
        return lx, ly, lz, vx, vy, vz, ii, jj, kk  # 1D: nothing to resample

    shape = lx.shape
    u_sel, u_t1, u_t2, a1, a2, a3 = draws  # pre-drawn rows of the event's batch

    axis = jnp.abs(leak_code) - 1  # 0 / 1 / 2
    sgn = jnp.sign(leak_code).astype(dtype)

    locs = (lx, ly, lz)
    dims = (mesh.nx, mesh.ny, mesh.nz)
    idxs = (ii, jj, kk)

    def face_prob(ax, fk, fj, fi):
        # face array of direction `ax`, indices per _face_flat
        arr = (coefs.px, coefs.py, coefs.pz)[ax]
        return jnp.take(arr.reshape(-1), _face_flat(mesh, b, fk, fj, fi, ax))

    new_loc = list(locs)
    new_idx = list(idxs)
    new_v = [vx, vy, vz]

    for ax in range(3 if three_d else (2 if multi_d else 1)):
        m_ax = refine & (axis == ax)
        # face index along the leak axis: entering upward -> fine face 0, else n_ax
        f_ax = jnp.where(sgn > 0, 0, dims[ax]).astype(jnp.int32)
        # transverse axes (active only)
        trans = [t for t in range(prm.ndim) if t != ax]
        if not trans:
            continue
        t1 = trans[0]
        d1 = dxv[:, t1]
        # edge index: transverse position sits on a fine-cell boundary
        e1 = jnp.clip(
            jnp.round(locs[t1] / jnp.maximum(d1, 1e-30)).astype(jnp.int32),
            1, dims[t1] - 1,
        )
        lo1, hi1 = e1 - 1, e1

        def fidx(c1, c2=None):
            """(k, j, i) triplet for the face of direction `ax` at cell (c1 on t1,
            c2 on t2), with f_ax on the leak axis."""
            kji = [None, None, None]
            kji[ax] = f_ax
            kji[t1] = c1
            if len(trans) > 1 and c2 is not None:
                kji[trans[1]] = c2
            for d in range(3):
                if kji[d] is None:
                    kji[d] = jnp.clip(idxs[d], 0, dims[d] - 1)
            return kji[2], kji[1], kji[0]  # (k, j, i) ordering: axis2=k, 1=j, 0=i

        if len(trans) == 1:
            # 2D: choose between the two fine faces bordering the edge
            k_l, j_l, i_l = fidx(lo1)
            k_u, j_u, i_u = fidx(hi1)
            P_l = face_prob(ax, k_l, j_l, i_l)
            P_u = face_prob(ax, k_u, j_u, i_u)
            pick_u = u_sel * (P_l + P_u) >= P_l
            c1 = jnp.where(pick_u, hi1, lo1)
            new_idx[t1] = jnp.where(m_ax, c1, new_idx[t1])
            new_loc[t1] = jnp.where(m_ax, (c1.astype(dtype) + u_t1) * d1, new_loc[t1])
        else:
            t2 = trans[1]
            d2 = dxv[:, t2]
            e2 = jnp.clip(
                jnp.round(locs[t2] / jnp.maximum(d2, 1e-30)).astype(jnp.int32),
                1, dims[t2] - 1,
            )
            lo2, hi2 = e2 - 1, e2
            cands = [(lo1, lo2), (hi1, lo2), (lo1, hi2), (hi1, hi2)]
            Ps = []
            for c1, c2 in cands:
                k_, j_, i_ = fidx(c1, c2)
                Ps.append(face_prob(ax, k_, j_, i_))
            tot = sum(Ps) + jnp.finfo(dtype).tiny
            xi = u_sel * tot
            cum = jnp.zeros(shape, dtype)
            sel1 = jnp.zeros(shape, jnp.int32)
            sel2 = jnp.zeros(shape, jnp.int32)
            chosen = jnp.zeros(shape, bool)
            for (c1, c2), P in zip(cands, Ps):
                hit = ~chosen & (xi < cum + P)
                sel1 = jnp.where(hit, c1, sel1)
                sel2 = jnp.where(hit, c2, sel2)
                chosen = chosen | hit
                cum = cum + P
            sel1 = jnp.where(chosen, sel1, hi1)
            sel2 = jnp.where(chosen, sel2, hi2)
            new_idx[t1] = jnp.where(m_ax, sel1, new_idx[t1])
            new_idx[t2] = jnp.where(m_ax, sel2, new_idx[t2])
            new_loc[t1] = jnp.where(m_ax, (sel1.astype(dtype) + u_t1) * d1, new_loc[t1])
            new_loc[t2] = jnp.where(m_ax, (sel2.astype(dtype) + u_t2) * d2, new_loc[t2])

        # hemisphere direction into the block along the leak axis (cyclic perm, as
        # in sample_face_iso_dir call sites)
        v_ax = c * sgn * a1
        v_n1 = c * a2
        v_n2 = c * a3
        perm = {0: (0, 1, 2), 1: (1, 2, 0), 2: (2, 0, 1)}[ax]
        vals = [None, None, None]
        vals[perm[0]] = v_ax
        vals[perm[1]] = v_n1
        vals[perm[2]] = v_n2
        for d in range(3):
            new_v[d] = jnp.where(m_ax, vals[d], new_v[d])

    return (
        new_loc[0], new_loc[1], new_loc[2],
        new_v[0], new_v[1], new_v[2],
        new_idx[0], new_idx[1], new_idx[2],
    )


def transport(particles, coefs, mesh, key, prm: TransportParams, dt, block_offset=None):
    """Run the census loop: advance all particles event-by-event until every live
    particle reaches ``tau >= 1`` (or ``max_iters``, the reference's
    ``max_transport_iterations`` hang backstop, ``jaybenne.cpp:195-197``).

    With ``block_offset`` (spatial decomposition), the loop runs until every OWNED
    particle is finished or in transit; migration and the global completion check
    happen in the caller's outer loop (``jaybenne_tpu.parallel.spatial``).

    Returns (particles, n_iterations, n_events)."""

    def unfinished(p):
        m = p.alive & (p.tau < 1.0)
        if block_offset is not None:
            b_local = p.block - block_offset
            m = m & (b_local >= 0) & (b_local < coefs.px.shape[0])
        return m

    def cond(carry):
        p, it, _ = carry
        return (it < prm.max_iters) & jnp.any(unfinished(p))

    def body(carry):
        p, it, ev = carry
        p, n_active = _one_event(
            p, coefs, mesh, prm, dt, rng.fold(key, it), block_offset
        )
        return p, it + 1, ev + n_active

    p, iters, events = jax.lax.while_loop(
        cond, body, (particles, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    )
    return p, iters, events
