"""The census kernel (ops/pallas_census.py) against the XLA event loop.

Every case runs the SAME kernel body in the Pallas interpreter on the CPU and
compares it with ``ops/transport.py::transport`` from an identical initial
state: different RNG streams, so diffusive cases agree statistically and
ballistic (scatter-free) cases agree to float32 rounding. The compiled kernel
runs on the GPU in the ``gpu``-marked test below and in chip_smoke.py.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import jax.random as jr

from jaybenne_tpu import config as cm
from jaybenne_tpu.mesh import build_mesh
from jaybenne_tpu.ops import fleck as F
from jaybenne_tpu.ops import pallas_census as pc
from jaybenne_tpu.ops import transport as T
from jaybenne_tpu.particles import empty_ledger
from jaybenne_tpu.step import census_path, make_transport_params
from jaybenne_tpu.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 2.99792458e10

DECK1D = """
<parthenon/job>
problem_id = stepdiff
<parthenon/mesh>
nx1 = 100
x1min = -0.5
x1max = 0.5
ix1_bc = outflow
ox1_bc = outflow
<parthenon/swarm>
ix1_bc = jaybenne_reflecting
ox1_bc = jaybenne_reflecting
<parthenon/meshblock>
nx1 = 50
<parthenon/time>
tlim = 1.e-11
<jaybenne>
num_particles = 4000
dt = 1.e-11
do_emission = false
do_feedback = false
<mcblock>
opacity_model = none
scattering_model = constant
scattering_constant_value = 2.0e2
cv = 1.0e8
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
"""

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
tlim = 1.e-11
<jaybenne>
num_particles = 4000
dt = 1.e-11
do_emission = false
do_feedback = false
<mcblock>
opacity_model = none
scattering_model = constant
scattering_constant_value = 2.0e2
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

_SMR2D = {
    "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
    "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
    "jaybenne/dt": "1.e-11", "parthenon/time/tlim": "1.e-11",
    "jaybenne/do_emission": "false", "jaybenne/do_feedback": "false",
}

# geometry -> (deck source, overrides, expected max refinement level)
GEOMETRIES = {
    "1d": (DECK1D, {}, 0),
    "2d_smr_l1": ("inputs/stepdiff_smr.in", _SMR2D, 1),
    "2d_smr_l2": ("inputs/stepdiff_smr2.in", _SMR2D, 2),
    "3d_uniform": (DECK3D, {}, 0),
    "3d_smr": (DECK3D + REFINE_RIGHT, {}, 1),
}


def _cfg(geom, extra=None):
    src, mods, _ = GEOMETRIES[geom]
    if src.startswith("inputs/"):
        deck = Deck.from_file(os.path.join(_ROOT, src))
    else:
        deck = Deck.parse(src)
    return cm.from_deck(deck.update({**mods, **(extra or {})}))


def _particles(mesh, n, cap, key, lo=None, hi=None):
    """n isotropic unit-weight particles uniform over [lo, hi] (default: the
    whole domain) on ``mesh``, in a ledger of capacity ``cap``."""
    b = np.asarray(mesh.bounds, np.float64)
    lo = b[0::2] if lo is None else np.asarray(lo)
    hi = b[1::2] if hi is None else np.asarray(hi)
    ks = jr.split(key, 6)
    g = [
        lo[a] + (hi[a] - lo[a]) * (0.02 + 0.96 * jr.uniform(ks[a], (n,)))
        for a in range(3)
    ]
    mu = 1.0 - 2.0 * jr.uniform(ks[3], (n,))
    phi = 2.0 * np.pi * jr.uniform(ks[4], (n,))
    st = jnp.sqrt(1.0 - mu * mu)
    if mesh.ndim == 1:
        v = (C * mu, C * st, jnp.zeros((n,)))
    else:
        v = (C * st * jnp.cos(phi), C * st * jnp.sin(phi), C * mu)
    return _place(mesh, g, v, cap)


def _place(mesh, g, v, cap):
    """A ledger holding particles at global positions g with velocities v."""
    n = g[0].shape[0]
    blk = mesh.locate_block(*g)
    org = mesh.block_origin[blk]
    loc = [g[a] - org[:, a] for a in range(3)]
    i, j, k = mesh.cell_of_local(blk, *loc)
    p = empty_ledger(cap)
    return dataclasses.replace(
        p,
        x=p.x.at[:n].set(loc[0]), y=p.y.at[:n].set(loc[1]), z=p.z.at[:n].set(loc[2]),
        vx=p.vx.at[:n].set(v[0]), vy=p.vy.at[:n].set(v[1]), vz=p.vz.at[:n].set(v[2]),
        block=p.block.at[:n].set(blk),
        i=p.i.at[:n].set(i), j=p.j.at[:n].set(j), k=p.k.at[:n].set(k),
        alive=p.alive.at[:n].set(True),
        weight=p.weight.at[:n].set(1.0),
        energy=p.energy.at[:n].set(1.0),
    )


def _coefs(cfg, mesh, sigma_s, sigma_a=0.0, fleck=1.0):
    NC = mesh.total_cells
    B, nz, ny, nx = mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx
    coefs = T.TransportCoefs(
        sigma_a=jnp.full((NC,), sigma_a, jnp.float32),
        sigma_s=jnp.full((NC,), sigma_s, jnp.float32),
        fleck=jnp.full((NC,), fleck, jnp.float32),
        px=jnp.zeros((B, nz, ny, nx + 1)),
        py=jnp.zeros((B, nz, ny + 1, nx)),
        pz=jnp.zeros((B, nz + 1, ny, nx)),
    )
    if cfg.jaybenne.use_ddmc:
        sig = jnp.full((B, nz, ny, nx), sigma_s + sigma_a, jnp.float32)
        px, py, pz = F.ddmc_face_probs(
            mesh, sig, cfg.jaybenne.tau_ddmc, cfg.mesh.periodic_flags, jnp.float32
        )
        coefs = dataclasses.replace(coefs, px=px, py=py, pz=pz)
    return coefs


def _both(cfg, mesh, p, coefs, prm=None, key=jr.PRNGKey(5)):
    prm = prm or make_transport_params(cfg, jnp.float32)
    dt = jnp.float32(cfg.jaybenne.dt)
    pk, it_k, ev_k = pc.transport_kernel(p, coefs, mesh, key, prm, dt, interpret=True)
    px, it_x, ev_x = T.transport(p, coefs, mesh, key, prm, dt)
    return (pk, int(it_k), int(ev_k)), (px, int(it_x), int(ev_x))


def _check_ledger(out, mesh, n):
    """Every survivor at census, inside its block, cell ids consistent."""
    alive = np.asarray(out.alive)
    assert not (np.asarray(out.tau)[alive] < 1.0).any()
    blk = np.asarray(out.block)[alive]
    assert ((blk >= 0) & (blk < mesh.n_blocks)).all()
    bdx = np.asarray(mesh.block_dx)
    for a, (idx, pos, nloc) in enumerate((
        (out.i, out.x, mesh.nx), (out.j, out.y, mesh.ny), (out.k, out.z, mesh.nz)
    )[: mesh.ndim]):
        idx = np.asarray(idx)[alive]
        pos = np.asarray(pos)[alive]
        assert ((idx >= 0) & (idx < nloc)).all()
        cell_err = pos / bdx[blk, a] - idx
        assert ((cell_err > -0.1) & (cell_err < 1.1)).all()
    return int(alive.sum())


@pytest.mark.parametrize("physics", ["imc", "ddmc"])
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_kernel_matches_xla(geom, physics):
    """Uniform and SMR meshes to level 2, 1D to 3D, IMC and DDMC: full census,
    nothing lost in a closed domain, the same diffusion moments and event
    totals as the XLA loop. With DDMC on, sigma*dx straddles tau_ddmc on the
    refined meshes, so the hybrid interface and coarse->fine leaks (subface
    resample) are exercised."""
    extra = {"jaybenne/use_ddmc": "true", "jaybenne/tau_ddmc": "5.0"} if physics == "ddmc" else {}
    cfg = _cfg(geom, extra)
    mesh = build_mesh(cfg.mesh)
    assert mesh.max_level == GEOMETRIES[geom][2]
    n = 3000
    p = _particles(mesh, n, 4096, jr.PRNGKey(1))
    sigma = {"imc": 2.0e2, "ddmc": 4.0e2}[physics]
    coefs = _coefs(cfg, mesh, sigma)
    (pk, it_k, ev_k), (px, it_x, ev_x) = _both(cfg, mesh, p, coefs)
    assert _check_ledger(pk, mesh, n) == n
    assert _check_ledger(px, mesh, n) == n
    if physics == "imc":
        assert abs(ev_k - ev_x) / ev_x < 0.05, (ev_k, ev_x)
    ext = np.asarray(mesh.bounds[1::2]) - np.asarray(mesh.bounds[0::2])
    for a in range(mesh.ndim):
        gk = np.asarray(pk.global_position(mesh)[a])[:n]
        gx = np.asarray(px.global_position(mesh)[a])[:n]
        assert abs(gk.mean() - gx.mean()) < 0.02 * ext[a], (a, gk.mean(), gx.mean())
        assert abs(gk.std() - gx.std()) / gx.std() < 0.1, (a, gk.std(), gx.std())


def test_kernel_absorption_matches_xla():
    """Absorption at a Fleck factor < 1: both paths absorb the expected
    fraction 1 - exp(-f sigma_a c dt) within binomial noise."""
    cfg = _cfg("1d", {"jaybenne/dt": "3.335641e-11"})
    mesh = build_mesh(cfg.mesh)
    prm = dataclasses.replace(make_transport_params(cfg, jnp.float32), has_absorption=True)
    n = 4000
    p = _particles(mesh, n, 4096, jr.PRNGKey(2))
    coefs = _coefs(cfg, mesh, 2.0e2, sigma_a=0.5, fleck=0.7)
    (pk, _, _), (px, _, _) = _both(cfg, mesh, p, coefs, prm)
    expect = n * (1.0 - np.exp(-0.35 * C * 3.335641e-11))
    sd = np.sqrt(expect * (1.0 - expect / n))
    for out in (pk, px):
        absorbed = int(np.asarray(out.absorbed).sum())
        assert absorbed + int(np.asarray(out.alive).sum()) == n
        assert abs(absorbed - expect) < 4.0 * sd, (absorbed, expect)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("bc", ["periodic", "reflecting"])
def test_kernel_ballistic_boundaries(axis, bc):
    """Scatter-free flight across a domain face on each axis: a periodic
    boundary wraps the packet in-kernel, a reflecting one mirrors it and
    flips the velocity. Ballistic motion draws no random numbers, so the
    kernel and the XLA loop agree to float32 rounding."""
    mods = {}
    for a, nm in enumerate(("1", "2", "3")):
        swarm = "periodic" if bc == "periodic" else "jaybenne_reflecting"
        mods[f"parthenon/swarm/ix{nm}_bc"] = swarm
        mods[f"parthenon/swarm/ox{nm}_bc"] = swarm
        mods[f"parthenon/mesh/ix{nm}_bc"] = "periodic" if bc == "periodic" else "outflow"
        mods[f"parthenon/mesh/ox{nm}_bc"] = "periodic" if bc == "periodic" else "outflow"
    cfg = cm.from_deck(Deck.parse(DECK3D).update({**mods, "jaybenne/dt": "1.e-12"}))
    mesh = build_mesh(cfg.mesh)
    n = 64
    b = np.asarray(mesh.bounds, np.float64)
    key = jr.split(jr.PRNGKey(axis), 3)
    # start within 0.01 cm of the upper face, flying up at ~c along the axis:
    # c*dt = 0.03 cm carries every packet across the face
    g = [
        jnp.asarray(b[2 * a] + (b[2 * a + 1] - b[2 * a]) * (0.1 + 0.8 * jr.uniform(key[0], (n,))))
        for a in range(3)
    ]
    g[axis] = jnp.asarray(b[2 * axis + 1] - 0.01 * jr.uniform(key[1], (n,)) - 1e-4)
    tr = 0.05 * (jr.uniform(key[2], (n,)) - 0.5)
    v = [C * tr, C * tr[::-1], C * tr]
    v[axis] = C * jnp.sqrt(1.0 - 2.0 * tr * tr)
    p = _place(mesh, g, v, 128)
    coefs = _coefs(cfg, mesh, 1.0e-8)
    (pk, _, _), (px, _, _) = _both(cfg, mesh, p, coefs)
    for out in (pk, px):
        assert int(np.asarray(out.alive).sum()) == n
        _check_ledger(out, mesh, n)
    gk = np.asarray(pk.global_position(mesh)[axis])[:n]
    gx = np.asarray(px.global_position(mesh)[axis])[:n]
    np.testing.assert_allclose(gk, gx, atol=1e-4)
    vk = np.asarray((pk.vx, pk.vy, pk.vz)[axis])[:n]
    if bc == "periodic":
        assert (gk < b[2 * axis] + 0.03).all()  # wrapped to the low side
        assert (vk > 0).all()
    else:
        assert (gk > b[2 * axis + 1] - 0.03).all()  # mirrored back inside
        assert (vk < 0).all()
    np.testing.assert_allclose(vk, np.asarray((px.vx, px.vy, px.vz)[axis])[:n], rtol=1e-6)


@pytest.mark.parametrize("physics", ["imc", "ddmc"])
def test_kernel_big_mesh(physics):
    """An 8192-cell, 32-block mesh — past what the old on-chip table budget
    allowed — runs through the same kernel: tables are gathered from global
    memory, so there is no size cap."""
    extra = {
        "parthenon/mesh/nx1": 8192, "parthenon/meshblock/nx1": 256,
        "jaybenne/dt": "3.3e-13", "parthenon/time/tlim": "3.3e-13",
    }
    if physics == "ddmc":
        extra["jaybenne/use_ddmc"] = "true"
    cfg = _cfg("1d", extra)
    mesh = build_mesh(cfg.mesh)
    assert mesh.total_cells == 8192 and mesh.n_blocks == 32
    n = 2000
    p = _particles(mesh, n, 2048, jr.PRNGKey(3))
    sigma = {"imc": 2.0e2, "ddmc": 1.0e6}[physics]
    coefs = _coefs(cfg, mesh, sigma)
    (pk, _, ev_k), (px, _, ev_x) = _both(cfg, mesh, p, coefs)
    assert _check_ledger(pk, mesh, n) == n
    assert _check_ledger(px, mesh, n) == n
    gk = np.asarray(pk.global_position(mesh)[0])[:n]
    gx = np.asarray(px.global_position(mesh)[0])[:n]
    assert abs(gk.mean() - gx.mean()) < 2e-3
    assert abs(gk.std() - gx.std()) / gx.std() < 0.05
    if physics == "imc":
        assert abs(ev_k - ev_x) / ev_x < 0.05


@pytest.mark.parametrize("cap", [1, 100, 127, 129, 1000])
def test_kernel_pads_ledger(cap):
    """Capacities that are not a whole number of blocks: the wrapper pads to
    ``BLOCK`` lanes and trims back, and the padding lanes (dead) change
    nothing. Ballistic flight makes the comparison with the XLA loop exact."""
    cfg = _cfg("3d_uniform", {"jaybenne/dt": "1.e-12"})
    mesh = build_mesh(cfg.mesh)
    n = min(cap, 90)
    p = _particles(mesh, n, cap, jr.PRNGKey(4))
    coefs = _coefs(cfg, mesh, 1.0e-8)
    (pk, it_k, ev_k), (px, it_x, ev_x) = _both(cfg, mesh, p, coefs)
    assert pk.capacity == cap and pk.x.shape == (cap,)
    assert ev_k == ev_x and it_k == it_x
    for name in ("block", "i", "j", "k", "alive"):
        np.testing.assert_array_equal(np.asarray(getattr(pk, name)), np.asarray(getattr(px, name)))
    for a in range(3):
        np.testing.assert_allclose(
            np.asarray(pk.global_position(mesh)[a]), np.asarray(px.global_position(mesh)[a]),
            atol=1e-5,
        )


@pytest.mark.parametrize("model", ["ep_bremss", "table"])
def test_kernel_opacity_models(model, tmp_path):
    """Frequency-dependent EPBremss (evaluated per event at the photon energy)
    and a gray opacity table (precomputed per cell): the kernel conserves
    live + absorbed energy exactly, as the XLA loop does, and both absorb a
    comparable share."""
    from jaybenne_tpu.driver import Simulation

    mods = {
        "mcblock/initial_temperature": "1.0e6",
        "mcblock/scattering_constant_value": "1.0e2",
        "jaybenne/dt": "1.e-12", "parthenon/time/tlim": "1.e-12",
    }
    if model == "table":
        path = str(tmp_path / "tab.npz")
        np.savez(path, rho=[0.1, 1.0, 10.0], T=[1.0e3, 1.0e5, 1.0e7],
                 kappa=np.full((3, 3), 20.0))
        mods.update({"mcblock/opacity_model": "table", "mcblock/opacity_table_file": path})
    else:
        mods["mcblock/opacity_model"] = "ep_bremss"
    absorbed = {}
    for mode in ("interpret", "off"):
        cfg = cm.from_deck(Deck.parse(DECK1D).update({**mods, "jaybenne/use_pallas": mode}))
        sim = Simulation(cfg, quiet=True)
        p0 = sim.state.particles
        w0 = float(np.asarray(p0.weight, np.float64)[np.asarray(p0.alive)].sum())
        sim.run()
        p = sim.state.particles
        w = float(np.asarray(p.weight, np.float64)[np.asarray(p.alive)].sum())
        ab = float(np.asarray(sim.state.fields.energy_delta, np.float64).sum())
        assert np.isclose(w + ab, w0, rtol=1e-4), mode
        absorbed[mode] = ab / w0
    assert absorbed["interpret"] > 0.01
    assert abs(absorbed["interpret"] - absorbed["off"]) < 0.25 * absorbed["off"], absorbed


@pytest.mark.parametrize(
    "mode,dtype,spatial,backend,expect",
    [
        ("off", jnp.float32, False, "cpu", None),
        ("auto", jnp.float32, False, "cpu", None),
        ("auto", jnp.float32, False, "gpu", "kernel"),
        ("auto", jnp.float64, False, "gpu", None),
        ("auto", jnp.float32, True, "gpu", None),
        ("interpret", jnp.float32, False, "cpu", "interpret"),
        ("interpret", jnp.float32, False, "gpu", "interpret"),
        ("on", jnp.float32, False, "gpu", "kernel"),
        ("on", jnp.float32, False, "cpu", RuntimeError),
        ("on", jnp.float64, False, "gpu", ValueError),
        ("on", jnp.float32, True, "gpu", ValueError),
        ("interpret", jnp.float64, False, "cpu", ValueError),
        ("bogus", jnp.float32, False, "cpu", ValueError),
    ],
)
def test_census_path_selector(mode, dtype, spatial, backend, expect, monkeypatch):
    """The one selector: auto takes the kernel only on a GPU where it
    applies; on and interpret never fall back to the XLA loop."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if isinstance(expect, type) and issubclass(expect, Exception):
        with pytest.raises(expect):
            census_path(mode, dtype, spatial)
    else:
        assert census_path(mode, dtype, spatial) == expect


_LOWER_CASES = {
    "1d_imc": ("1d", {}),
    "1d_ddmc_absorb": ("1d", {"jaybenne/use_ddmc": "true"}),
    "2d_smr_l2_ddmc": ("2d_smr_l2", {"jaybenne/use_ddmc": "true"}),
    "3d_uniform": ("3d_uniform", {}),
    "3d_smr_ddmc": ("3d_smr", {"jaybenne/use_ddmc": "true"}),
    "1d_ep_bremss": ("1d", {"mcblock/opacity_model": "ep_bremss"}),
}


@pytest.mark.parametrize("case", list(_LOWER_CASES))
def test_kernel_lowers_for_cuda(case):
    """The Triton route lowers every configuration family for CUDA: each
    primitive of the kernel body has a Triton lowering rule. (Compiling the
    lowered module to PTX needs the card; chip_smoke.py does that.)"""
    geom, extra = _LOWER_CASES[case]
    cfg = _cfg(geom, extra)
    mesh = build_mesh(cfg.mesh)
    prm = make_transport_params(cfg, jnp.float32)
    if "ddmc_absorb" in case:
        prm = dataclasses.replace(prm, has_absorption=True)
    p = _particles(mesh, 100, 256, jr.PRNGKey(0))
    coefs = _coefs(cfg, mesh, 2.0e2)
    if "ep_bremss" in case:
        opac = cfg.mcblock.build_opacity()
        coefs = dataclasses.replace(
            coefs, packed=jnp.ones((mesh.total_cells, 3), jnp.float32),
            opacity=opac, scattering=cfg.mcblock.build_scattering(),
        )
    fn = jax.jit(
        lambda p, c, k, d: pc.transport_kernel(p, c, mesh, k, prm, d)
    )
    lowered = fn.trace(p, coefs, jr.PRNGKey(0), jnp.float32(1e-12)).lower(
        lowering_platforms=("cuda",)
    )
    text = lowered.as_text()
    assert "jaybenne_census" in text


def test_step_is_deterministic():
    """Stepping the same state twice gives bitwise-identical results on the
    CPU (the GPU's atomic tally order is checked by chip_smoke.py)."""
    from jaybenne_tpu.driver import Simulation

    cfg = cm.from_deck(Deck.parse(DECK1D).update({"jaybenne/use_pallas": "interpret"}))
    sim = Simulation(cfg, quiet=True)
    dt = jnp.float32(cfg.jaybenne.dt)
    a, _ = sim.step_fn(sim.state, dt)
    b, _ = sim.step_fn(sim.state, dt)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """On the card: the compiled kernel against the XLA loop, as the
    interpret-mode cases above do on the CPU."""
    cfg = _cfg("3d_smr", {"jaybenne/use_ddmc": "true"})
    mesh = build_mesh(cfg.mesh)
    n = 3000
    p = _particles(mesh, n, 4096, jr.PRNGKey(1))
    coefs = _coefs(cfg, mesh, 4.0e2)
    prm = make_transport_params(cfg, jnp.float32)
    dt = jnp.float32(cfg.jaybenne.dt)
    pk, _, _ = pc.transport_kernel(p, coefs, mesh, jr.PRNGKey(5), prm, dt)
    px, _, _ = T.transport(p, coefs, mesh, jr.PRNGKey(5), prm, dt)
    assert _check_ledger(pk, mesh, n) == n
    assert _check_ledger(px, mesh, n) == n


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, tmp_path):
    """The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR
    says when it is set, else at a fixed <repo>/.jax_cache."""
    from jaybenne_tpu import compile_cache_dir

    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    want = str(tmp_path) if env_set else os.path.join(_ROOT, ".jax_cache")
    assert compile_cache_dir(env) == want
