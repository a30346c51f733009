"""3D validation (VERDICT r2 #3): the 3D code paths — z crossings, 6-face DDMC
leakage, the 4-subface quad resample mirroring the reference's ``SampleFace3D``
(``sample_ddmc_bface.cpp:43-78,241-424``) — exercised directly here and through
the census kernel in ``tests/test_census_kernel.py``. The end-to-end 3D
acceptance gate is
``tst/stepdiff_3d.py`` on ``inputs/stepdiff_3d_smr_ddmc.in``."""

import dataclasses
import os

import numpy as np
import pytest

import jax.numpy as jnp
import jax.random as jr

from jaybenne_tpu import config as cm
from jaybenne_tpu.mesh import build_mesh
from jaybenne_tpu.particles import empty_ledger
from jaybenne_tpu.step import make_transport_params
from jaybenne_tpu.ops import fleck as F
from jaybenne_tpu.ops import transport as T
from jaybenne_tpu.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DECK3D = """
<parthenon/job>
problem_id = stepdiff

<parthenon/mesh>
nx1 = 16
x1min = -0.5
x1max = 0.5
ix1_bc = outflow
ox1_bc = outflow
nx2 = 8
x2min = -0.25
x2max = 0.25
ix2_bc = periodic
ox2_bc = periodic
nx3 = 8
x3min = -0.25
x3max = 0.25
ix3_bc = periodic
ox3_bc = periodic

<parthenon/swarm>
ix1_bc = jaybenne_reflecting
ox1_bc = jaybenne_reflecting
ix2_bc = periodic
ox2_bc = periodic
ix3_bc = periodic
ox3_bc = periodic

<parthenon/meshblock>
nx1 = 4
nx2 = 4
nx3 = 4

<parthenon/time>
tlim = 1.e-12

<jaybenne>
num_particles = 4000
dt = 1.e-12
do_emission = false
do_feedback = false
seed = 11

<mcblock>
opacity_model = none
scattering_model = constant
scattering_constant_value = 1.0e3
cv = 1.0e8
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
"""

REFINE_RIGHT = """
<parthenon/mesh>
refinement = static

<parthenon/static_refinement1>
level = 1
x1min = 0.0
x1max = 0.5
x2min = -0.25
x2max = 0.25
x3min = -0.25
x3max = 0.25
"""


def _cfg(extra=None, refined=False):
    text = DECK3D + (REFINE_RIGHT if refined else "")
    deck = Deck.parse(text)
    if extra:
        deck = deck.update(extra)
    return cm.from_deck(deck)


def _center_particles(mesh, n, key, cap=None):
    """n isotropic particles uniform in the center-ish of the domain."""
    cap = cap or n
    p = empty_ledger(cap)
    ks = jr.split(key, 6)
    c = 2.99792458e10
    nx_ = 1.0 - 2.0 * jr.uniform(ks[0], (n,))
    ny_ = 1.0 - 2.0 * jr.uniform(ks[1], (n,))
    nz_ = 1.0 - 2.0 * jr.uniform(ks[2], (n,))
    nrm = jnp.sqrt(nx_**2 + ny_**2 + nz_**2) + 1e-12
    gx = 0.2 * (jr.uniform(ks[3], (n,)) - 0.5)
    gy = 0.2 * (jr.uniform(ks[4], (n,)) - 0.5)
    gz = 0.2 * (jr.uniform(ks[5], (n,)) - 0.5)
    b = mesh.locate_block(gx, gy, gz)
    org = mesh.block_origin[b]
    lx, ly, lz = gx - org[:, 0], gy - org[:, 1], gz - org[:, 2]
    i, j, k = mesh.cell_of_local(b, lx, ly, lz)
    return dataclasses.replace(
        p,
        x=p.x.at[:n].set(lx), y=p.y.at[:n].set(ly), z=p.z.at[:n].set(lz),
        vx=p.vx.at[:n].set(c * nx_ / nrm),
        vy=p.vy.at[:n].set(c * ny_ / nrm),
        vz=p.vz.at[:n].set(c * nz_ / nrm),
        block=p.block.at[:n].set(b),
        i=p.i.at[:n].set(i), j=p.j.at[:n].set(j), k=p.k.at[:n].set(k),
        alive=p.alive.at[:n].set(True),
        weight=p.weight.at[:n].set(1.0),
    )


def _coefs(mesh, sigma_s, prm, tau_ddmc=5.0):
    NC = mesh.total_cells
    B, nz, ny, nx = mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx
    coefs = T.TransportCoefs(
        sigma_a=jnp.zeros((NC,)),
        sigma_s=jnp.full((NC,), float(sigma_s)),
        fleck=jnp.ones((NC,)),
        px=jnp.zeros((B, nz, ny, nx + 1)),
        py=jnp.zeros((B, nz, ny + 1, nx)),
        pz=jnp.zeros((B, nz + 1, ny, nx)),
    )
    if prm.use_ddmc:
        sig = jnp.full((B, nz, ny, nx), float(sigma_s))
        px, py, pz = F.ddmc_face_probs(
            mesh, sig, tau_ddmc, (False, True, True), jnp.float32
        )
        coefs = dataclasses.replace(coefs, px=px, py=py, pz=pz)
    return coefs


# ------------------------------------------------------------------ unit: quad
def test_subface_resample_3d_quad():
    """The 3D coarse->fine DDMC leak picks among the 4 fine subfaces sharing the
    entry corner with probability proportional to their face probabilities,
    re-seats the transverse position inside the chosen fine cell, and redraws a
    hemisphere direction INTO the destination block (reference ``SampleFace3D``,
    ``sample_ddmc_bface.cpp:43-78``)."""
    cfg = _cfg({"jaybenne/use_ddmc": "true"}, refined=True)
    mesh = build_mesh(cfg.mesh)
    assert mesh.max_level == 1 and mesh.ndim == 3
    prm = make_transport_params(cfg, jnp.float32)

    # destination: a FINE block just right of x = 0
    b_f = int(mesh.locate_block(
        jnp.array([0.001]), jnp.array([-0.2]), jnp.array([-0.2]))[0])
    assert int(mesh.block_level[b_f]) == 1
    B, nz, ny, nx = mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx
    dxf = np.asarray(mesh.block_dx)[b_f]

    # 4 candidate subfaces around the interior corner (e1, e2) = (2, 2):
    # cells (j, k) in {1,2}x{1,2}; unequal probabilities 0.1/0.2/0.3/0.4
    probs = {(1, 1): 0.1, (2, 1): 0.2, (1, 2): 0.3, (2, 2): 0.4}
    px = np.zeros((B, nz, ny, nx + 1), np.float32)
    for (j, k), v in probs.items():
        px[b_f, k, j, 0] = v
    NC = mesh.total_cells
    coefs = T.TransportCoefs(
        sigma_a=jnp.zeros((NC,)), sigma_s=jnp.ones((NC,)),
        fleck=jnp.ones((NC,)),
        px=jnp.asarray(px),
        py=jnp.zeros((B, nz, ny + 1, nx)),
        pz=jnp.zeros((B, nz + 1, ny, nx)),
    )

    n = 20000
    key = jr.PRNGKey(3)
    U = jr.uniform(key, (5, n))
    mu = jnp.sqrt(U[3])
    nu = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
    phi = (2.0 * jnp.pi) * U[4]
    draws = (U[0], U[1], U[2], mu, nu * jnp.cos(phi), nu * jnp.sin(phi))

    e1 = e2 = 2
    ones = jnp.ones((n,))
    lx = 0.0 * ones
    ly = e1 * float(dxf[1]) * ones   # exactly on the fine-cell corner
    lz = e2 * float(dxf[2]) * ones
    ii = jnp.zeros((n,), jnp.int32)
    jj = jnp.full((n,), e1, jnp.int32)
    kk = jnp.full((n,), e2, jnp.int32)
    refine = jnp.ones((n,), bool)
    leak = jnp.ones((n,), jnp.int32)   # +x leak (entering travelling up)
    b = jnp.full((n,), b_f, jnp.int32)
    dxv = mesh.block_dx[b]
    c = prm.c

    lx2, ly2, lz2, vx2, vy2, vz2, i2, j2, k2 = T._ddmc_subface_resample(
        mesh, coefs, prm, draws, refine, leak, b, dxv,
        lx, ly, lz, 0 * ones, 0 * ones, 0 * ones, ii, jj, kk,
    )
    j2 = np.asarray(j2)
    k2 = np.asarray(k2)
    ly2 = np.asarray(ly2)
    lz2 = np.asarray(lz2)
    vx2 = np.asarray(vx2)

    # only the 4 corner-adjacent fine cells are chosen
    assert set(map(tuple, np.stack([j2, k2], 1))) <= set(probs)
    # empirical frequencies proportional to the face probabilities (3-sigma)
    for (j, k), pv in probs.items():
        frac = float(((j2 == j) & (k2 == k)).mean())
        sig = np.sqrt(pv * (1 - pv) / n)
        assert abs(frac - pv) < 4 * sig, ((j, k), frac, pv)
    # transverse re-seat inside the chosen fine cell
    assert (ly2 >= j2 * dxf[1] - 1e-7).all() and (ly2 <= (j2 + 1) * dxf[1] + 1e-7).all()
    assert (lz2 >= k2 * dxf[2] - 1e-7).all() and (lz2 <= (k2 + 1) * dxf[2] + 1e-7).all()
    # hemisphere direction INTO the block (+x), leak-axis position untouched
    assert (vx2 > 0).all()
    assert np.allclose(np.asarray(lx2), 0.0)
    assert (np.asarray(i2) == 0).all()


# -------------------------------------------------------------- XLA 3D physics
def test_xla_3d_isotropic_diffusion():
    """3D census through the XLA loop: completes, conserves, and diffuses
    isotropically (y/z crossings are not second-class)."""
    cfg = _cfg()
    mesh = build_mesh(cfg.mesh)
    prm = make_transport_params(cfg, jnp.float32)
    n = 4000
    p = _center_particles(mesh, n, jr.PRNGKey(0))
    coefs = _coefs(mesh, 1.0e3, prm)
    dt = jnp.float32(cfg.jaybenne.dt)
    out, iters, ev = T.transport(p, coefs, mesh, jr.PRNGKey(1), prm, dt)
    alive = np.asarray(out.alive)
    assert int(alive.sum()) == n
    assert not (np.asarray(out.tau)[alive] < 1.0).any()
    gx, gy, gz = (np.asarray(a)[alive] for a in out.global_position(mesh))
    vx, vy, vz = np.var(gx), np.var(gy), np.var(gz)
    assert vy > 0 and vz > 0
    assert abs(vy - vz) / vz < 0.15
    assert abs(vx - vy) / vy < 0.2


def test_xla_3d_ddmc_six_face_leak():
    """3D DDMC (thick cells): all six leakage faces fire and the walk spreads
    isotropically; energy (weight) is conserved without absorption."""
    # sigma*dx = 125 >> tau_ddmc (DDMC everywhere) with c*dt*leak_opacity ~ 0.6
    # expected leaks per particle — enough that every face fires
    cfg = _cfg({"jaybenne/use_ddmc": "true", "jaybenne/dt": "4.e-11",
                "mcblock/scattering_constant_value": "2.0e3"})
    mesh = build_mesh(cfg.mesh)
    prm = make_transport_params(cfg, jnp.float32)
    n = 4000
    p = _center_particles(mesh, n, jr.PRNGKey(5))
    coefs = _coefs(mesh, 2.0e3, prm, cfg.jaybenne.tau_ddmc)
    dt = jnp.float32(cfg.jaybenne.dt)
    out, iters, ev = T.transport(p, coefs, mesh, jr.PRNGKey(6), prm, dt)
    alive = np.asarray(out.alive)
    assert int(alive.sum()) == n  # no absorption, reflecting/periodic walls
    assert not (np.asarray(out.tau)[alive] < 1.0).any()
    # cells moved in every axis (6-face leakage active)
    di = np.asarray(out.i) - np.asarray(p.i)
    dj = np.asarray(out.j) - np.asarray(p.j)
    dk = np.asarray(out.k) - np.asarray(p.k)
    for d in (di, dj, dk):
        assert (d[alive] > 0).any() and (d[alive] < 0).any()


# ------------------------------------------------------------------- e2e gate
@pytest.mark.slow
def test_driver_3d_smr_ddmc_profile():
    """Reduced-size end-to-end run of the 3D SMR+DDMC deck: energy conserved
    exactly and the x-profile within 0.35 of the analytic erf solution (the
    full-size gate is tst/stepdiff_3d.py, tolerance 0.3)."""
    from scipy.special import erf

    from jaybenne_tpu.driver import Simulation

    deck = Deck.from_file(
        os.path.join(_ROOT, "inputs/stepdiff_3d_smr_ddmc.in")
    ).update(
        {
            "parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 8,
            "parthenon/mesh/nx3": 8,
            "parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 4,
            "parthenon/meshblock/nx3": 4,
            "jaybenne/num_particles": 40000,
            "parthenon/time/tlim": "1.3342564e-10",  # 4 steps
        }
    )
    sim = Simulation(cm.from_deck(deck), quiet=True)
    assert sim.mesh.max_level == 1 and sim.mesh.ndim == 3
    p0 = sim.state.particles
    w0 = float(np.asarray(p0.weight)[np.asarray(p0.alive)].sum())
    sim.run()
    p = sim.state.particles
    w = float(np.asarray(p.weight)[np.asarray(p.alive)].sum())
    assert np.isclose(w, w0, rtol=1e-5)

    tally = np.asarray(sim.state.fields.energy_tally).reshape(-1)
    xc = np.asarray(sim.mesh.cell_centers()[0]).reshape(-1)
    t = sim.t
    tau, ur0 = 1.000692e-7, 7.5646e5
    s = 2.0 * np.sqrt(t / tau)
    sol = 0.5 * ur0 * (erf(((xc + 0.5) + 0.5) / s) - erf(((xc + 0.5) - 0.5) / s))
    werr = (np.abs(sol - tally) / np.abs((sol + tally) / 2) * sol).sum() / sol.sum()
    assert werr < 0.35, werr
