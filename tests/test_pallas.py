"""Census-kernel tests via the Pallas interpreter (CPU-runnable).

The compiled kernel runs on the GPU in chip_smoke.py and the GPU-marked tests;
here the SAME kernel body runs in the Pallas interpreter and is cross-checked
against the XLA event loop on identical initial states (different RNG streams —
statistical agreement)."""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import jax.random as jr

from jaybenne_tpu import config as cm
from jaybenne_tpu.mesh import build_mesh
from jaybenne_tpu.particles import empty_ledger
from jaybenne_tpu.step import make_transport_params
from jaybenne_tpu.ops import transport as T
from jaybenne_tpu.ops.pallas_census import transport_kernel
from jaybenne_tpu.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 16384  # ledger capacity of the direct-kernel cases


DECK = """
<parthenon/job>
problem_id = stepdiff

<parthenon/mesh>
nx1 = 100
x1min = -0.5
x1max = 0.5
ix1_bc = outflow
ox1_bc = outflow
nx2 = 1
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<parthenon/swarm>
ix1_bc = jaybenne_reflecting
ox1_bc = jaybenne_reflecting

<parthenon/meshblock>
nx1 = 50

<parthenon/time>
tlim = 3.335641e-11

<jaybenne>
num_particles = 4000
dt = 3.335641e-11

<mcblock>
opacity_model = none
scattering_model = constant
scattering_constant_value = 2.0e2
cv = 1.0e8
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
"""



def _setup(sigma_s=2.0e2):
    cfg = cm.from_deck(Deck.parse(DECK))
    mesh = build_mesh(cfg.mesh)
    prm = make_transport_params(cfg, jnp.float32)
    n = 4000
    key = jr.PRNGKey(0)
    p = empty_ledger(CAP)
    dxc = 1.0 / 100
    ks = jr.split(key, 4)
    nx_, ny_, nz_ = (
        1.0 - 2.0 * jr.uniform(ks[1], (n,)),
        jr.uniform(ks[2], (n,)) - 0.5,
        jr.uniform(ks[3], (n,)) - 0.5,
    )
    nrm = jnp.sqrt(nx_**2 + ny_**2 + nz_**2)
    c = 2.99792458e10
    p = dataclasses.replace(
        p,
        x=p.x.at[:n].set((25.0 + jr.uniform(ks[0], (n,))) * dxc),
        vx=p.vx.at[:n].set(c * nx_ / nrm),
        vy=p.vy.at[:n].set(c * ny_ / nrm),
        vz=p.vz.at[:n].set(c * nz_ / nrm),
        i=p.i.at[:n].set(25),
        alive=p.alive.at[:n].set(True),
        weight=p.weight.at[:n].set(1.0),
    )
    NC = mesh.total_cells
    coefs = T.TransportCoefs(
        sigma_a=jnp.zeros((NC,)),
        sigma_s=jnp.full((NC,), sigma_s),
        fleck=jnp.ones((NC,)),
        px=jnp.zeros((2, 1, 1, 51)),
        py=jnp.zeros((2, 1, 2, 50)),
        pz=jnp.zeros((2, 2, 1, 50)),
    )
    return cfg, mesh, prm, p, coefs, key


def test_pallas_interpret_matches_xla():
    cfg, mesh, prm, p, coefs, key = _setup()
    dt = jnp.float32(cfg.jaybenne.dt)
    pp, it_p, ev_p = transport_kernel(p, coefs, mesh, key, prm, dt, interpret=True)
    px_, it_x, ev_x = T.transport(p, coefs, mesh, key, prm, dt)

    for out, name in ((pp, "pallas"), (px_, "xla")):
        alive = np.asarray(out.alive)
        assert int(alive.sum()) == 4000, name  # pure scattering: nothing dies
        assert not (np.asarray(out.tau)[alive] < 1.0).any(), name  # census reached
        # positions within the block, indices consistent
        assert (np.asarray(out.i)[alive] >= 0).all() and (
            np.asarray(out.i)[alive] < mesh.nx
        ).all(), name

    # same diffusion statistics (different RNG streams)
    gx_p = np.asarray(pp.global_position(mesh)[0])[np.asarray(pp.alive)]
    gx_x = np.asarray(px_.global_position(mesh)[0])[np.asarray(px_.alive)]
    assert abs(gx_p.mean() - gx_x.mean()) < 0.01
    assert abs(gx_p.std() - gx_x.std()) / gx_x.std() < 0.1
    # comparable event totals (event count is RNG-stream dependent but tight)
    assert abs(int(ev_p) - int(ev_x)) / int(ev_x) < 0.05


def test_pallas_interpret_ddmc_matches_xla():
    """DDMC branch of the kernel vs the XLA DDMC branch on a thick slab: same
    diffusion statistics, full census, identical survivor counts."""
    from jaybenne_tpu.ops import fleck as F

    cfg = cm.from_deck(
        Deck.parse(DECK).update(
            {"jaybenne/use_ddmc": "true", "mcblock/scattering_constant_value": "1.0e3"}
        )
    )
    mesh = build_mesh(cfg.mesh)
    prm = make_transport_params(cfg, jnp.float32)
    _, _, _, p, coefs, key = _setup(sigma_s=1.0e3)
    sig = jnp.full((mesh.n_blocks, 1, 1, mesh.nx), 1.0e3)
    px, py, pz = F.ddmc_face_probs(
        mesh, sig, cfg.jaybenne.tau_ddmc, (False, False, False), jnp.float32
    )
    coefs = dataclasses.replace(coefs, px=px, py=py, pz=pz)
    dt = jnp.float32(cfg.jaybenne.dt)
    pp, _, ev_p = transport_kernel(p, coefs, mesh, key, prm, dt, interpret=True)
    px_, _, ev_x = T.transport(p, coefs, mesh, key, prm, dt)
    for out in (pp, px_):
        alive = np.asarray(out.alive)
        assert int(alive.sum()) == 4000
        assert not (np.asarray(out.tau)[alive] < 1.0).any()
    gx_p = np.asarray(pp.global_position(mesh)[0])[np.asarray(pp.alive)]
    gx_x = np.asarray(px_.global_position(mesh)[0])[np.asarray(px_.alive)]
    assert abs(gx_p.mean() - gx_x.mean()) < 0.01
    assert abs(gx_p.std() - gx_x.std()) / gx_x.std() < 0.15


def test_pallas_interpret_smr_conserves_energy():
    """Mixed-level path: a 20-block SMR mesh through the kernel conserves
    energy exactly and agrees with the XLA path's totals."""
    from jaybenne_tpu.driver import Simulation

    mods = {
        "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
        "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
        "jaybenne/num_particles": 8000,
        "jaybenne/dt": "1.e-11", "parthenon/time/tlim": "1.e-11",
        "mcblock/scattering_constant_value": "2.0e2",
    }
    totals = {}
    for mode in ("interpret", "off"):
        deck = Deck.from_file(
            os.path.join(_ROOT, "inputs/stepdiff_smr.in")
        ).update({**mods, "jaybenne/use_pallas": mode})
        sim = Simulation(cm.from_deck(deck), quiet=True)
        sim.run()
        dv = np.asarray(sim.mesh.block_volume)[:, None, None, None]
        p = sim.state.particles
        w = float(np.asarray(p.weight)[np.asarray(p.alive)].sum())
        e = float((np.asarray(sim.state.fields.energy_tally) * dv).sum())
        assert np.isclose(e, w, rtol=1e-5)  # tally == live weights exactly
        totals[mode] = w
    assert np.isclose(totals["interpret"], totals["off"], rtol=1e-5)


def _run_smr_conservation(deck_file, mods, expect_max_level):
    """Run use_pallas interpret/off on an SMR deck; assert exact tally==weights
    conservation on each path and cross-path total agreement. Returns the mesh
    so callers can assert forest structure."""
    from jaybenne_tpu.driver import Simulation

    totals = {}
    mesh = None
    for mode in ("interpret", "off"):
        deck = Deck.from_file(
            os.path.join(_ROOT, deck_file)
        ).update({**mods, "jaybenne/use_pallas": mode})
        sim = Simulation(cm.from_deck(deck), quiet=True)
        mesh = sim.mesh
        assert sim.mesh.max_level == expect_max_level
        sim.run()
        dv = np.asarray(sim.mesh.block_volume)[:, None, None, None]
        p = sim.state.particles
        w = float(np.asarray(p.weight)[np.asarray(p.alive)].sum())
        e = float((np.asarray(sim.state.fields.energy_tally) * dv).sum())
        assert np.isclose(e, w, rtol=1e-5)  # tally == live weights exactly
        totals[mode] = w
    assert np.isclose(totals["interpret"], totals["off"], rtol=1e-5)
    return mesh


def test_pallas_interpret_smr_level2_conserves_energy():
    """Nested level-2 forest (levels 0/1/2 present, 2:1 graded) through the
    kernel: IMC transport across BOTH refinement jumps conserves energy and
    matches the XLA path. Level >= 2 is inherited from Parthenon in the
    reference (arbitrary <parthenon/static_refinement*> nesting,
    reference inputs/stepdiff_smr_hybrid.in:52-59) but its decks only reach
    level 1 — this pins the deeper path."""
    mods = {
        "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
        "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
        "jaybenne/num_particles": 8000,
        "jaybenne/dt": "1.e-11", "parthenon/time/tlim": "1.e-11",
        "mcblock/scattering_constant_value": "2.0e2",
    }
    mesh = _run_smr_conservation("inputs/stepdiff_smr2.in", mods, 2)
    lv = np.asarray(mesh.block_level)
    assert set(np.unique(lv)) == {0, 1, 2}  # all three levels in the forest


def test_pallas_interpret_smr_level2_ddmc_conserves_energy():
    """DDMC on the nested level-2 forest: level-aware face probabilities and
    subface resampling at a level-1 -> level-2 boundary (the reference's
    sample_ddmc_bface.cpp:81-427 paths at a deeper jump than any stock deck)."""
    mods = {
        "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
        "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
        "jaybenne/num_particles": 8000,
        "jaybenne/dt": "1.e-11", "parthenon/time/tlim": "1.e-11",
        "mcblock/scattering_constant_value": "1.0e3",
        "jaybenne/use_ddmc": "true", "jaybenne/tau_ddmc": "2.5",
    }
    mesh = _run_smr_conservation("inputs/stepdiff_smr2.in", mods, 2)
    assert set(np.unique(np.asarray(mesh.block_level))) == {0, 1, 2}


def test_pallas_interpret_absorption():
    cfg, mesh, prm, p, coefs, key = _setup()
    prm = dataclasses.replace(prm, has_absorption=True)
    NC = mesh.total_cells
    coefs = dataclasses.replace(
        coefs, sigma_a=jnp.full((NC,), 0.5), fleck=jnp.full((NC,), 0.7)
    )
    dt = jnp.float32(cfg.jaybenne.dt)
    pp, _, _ = transport_kernel(p, coefs, mesh, key, prm, dt, interpret=True)
    alive = np.asarray(pp.alive)
    absorbed = np.asarray(pp.absorbed)
    assert absorbed.sum() > 0
    assert alive.sum() + absorbed.sum() == 4000
    # expected absorption over one step: 1 - exp(-f*sigma_a*c*dt), with
    # f*sigma_a = 0.35/cm over a path of c*dt = 1 cm -> ~0.295
    frac = absorbed.sum() / 4000
    assert 0.2 < frac < 0.4, frac


def test_rare_absorption_unbiased():
    """Probability-threshold draws in the kernel must be 23-bit, not 16-bit.

    With sigma_a/sigma_t ~ 7.5e-6 (scattering-dominated, like ``inf.in``'s
    1/1e5), a 16-bit branch uniform quantizes the absorption probability to
    P(u16 < p) = 1/65536 — a +103% bias at this ratio. The 23-bit draw
    resolves p to 1.2e-7. Expected absorbed
    over one step: n*(1 - exp(-f*sigma_a*c*dt)) = 16000*0.0015 = 24, sd ~ 4.9;
    the gate at +-3.2 sd rejects the biased mean of ~49 at ~5 sd."""
    sigma_a, sigma_s = 0.0015, 200.0
    cfg, mesh, prm, p, coefs, key = _setup(sigma_s=sigma_s)
    prm = dataclasses.replace(prm, has_absorption=True)
    NC = mesh.total_cells
    n = 16000
    c = 2.99792458e10
    ks = jr.split(jr.PRNGKey(7), 4)
    nx_, ny_, nz_ = (
        1.0 - 2.0 * jr.uniform(ks[1], (n,)),
        jr.uniform(ks[2], (n,)) - 0.5,
        jr.uniform(ks[3], (n,)) - 0.5,
    )
    nrm = jnp.sqrt(nx_**2 + ny_**2 + nz_**2)
    dxc = 1.0 / 100
    p = dataclasses.replace(
        p,
        x=p.x.at[:n].set((25.0 + jr.uniform(ks[0], (n,))) * dxc),
        vx=p.vx.at[:n].set(c * nx_ / nrm),
        vy=p.vy.at[:n].set(c * ny_ / nrm),
        vz=p.vz.at[:n].set(c * nz_ / nrm),
        i=p.i.at[:n].set(25),
        alive=jnp.zeros_like(p.alive).at[:n].set(True),
        weight=p.weight.at[:n].set(1.0),
    )
    coefs = dataclasses.replace(coefs, sigma_a=jnp.full((NC,), sigma_a))
    dt = jnp.float32(cfg.jaybenne.dt)
    pp, _, _ = transport_kernel(p, coefs, mesh, key, prm, dt, interpret=True)
    absorbed = int(np.asarray(pp.absorbed).sum())
    expect = n * (1.0 - np.exp(-sigma_a * c * float(dt)))  # c*dt = 1 cm
    sd = np.sqrt(expect)
    assert abs(absorbed - expect) < 3.2 * sd, (absorbed, expect)


def test_pallas_interpret_smr_ddmc_conserves_energy():
    """SMR + DDMC through the kernel: exercises the in-kernel coarse->fine subface
    resample and level-aware transitions (reference sample_ddmc_bface.cpp). Energy
    must be conserved exactly and totals must match the XLA path."""
    from jaybenne_tpu.driver import Simulation

    mods = {
        "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
        "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
        "jaybenne/num_particles": 8000,
        "jaybenne/dt": "1.e-11", "parthenon/time/tlim": "1.e-11",
    }
    totals = {}
    for mode in ("interpret", "off"):
        deck = Deck.from_file(
            os.path.join(_ROOT, "inputs/stepdiff_smr_ddmc.in")
        ).update({**mods, "jaybenne/use_pallas": mode})
        sim = Simulation(cm.from_deck(deck), quiet=True)
        assert sim.mesh.max_level > 0
        if mode == "interpret":
            assert make_transport_params(sim.cfg, jnp.float32).use_ddmc
        sim.run()
        dv = np.asarray(sim.mesh.block_volume)[:, None, None, None]
        p = sim.state.particles
        alive = np.asarray(p.alive)
        w = float(np.asarray(p.weight)[alive].sum())
        e = float((np.asarray(sim.state.fields.energy_tally) * dv).sum())
        assert np.isclose(e, w, rtol=1e-5)
        # survivors sit inside their blocks
        assert (np.asarray(p.i)[alive] >= 0).all()
        assert (np.asarray(p.i)[alive] < sim.mesh.nx).all()
        assert (np.asarray(p.j)[alive] >= 0).all()
        assert (np.asarray(p.j)[alive] < sim.mesh.ny).all()
        totals[mode] = w
    assert np.isclose(totals["interpret"], totals["off"], rtol=1e-5)


def test_uniform_view_remap_matches_lookup():
    """The census kernel's uniform synthetic-block remap (_to_global_cells, a
    pure reshape/transpose keyed on the (z, y, x) row-major block ordering)
    must agree with an INDEPENDENT mapping built from each block's origin in
    the mesh geometry, on every uniform forest shape."""
    from jaybenne_tpu.ops import pallas_census as pc

    for mods in (
        {},  # 100 cells / 2 blocks (1D)
        {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
         "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8},
        {"parthenon/mesh/nx1": 8, "parthenon/mesh/nx2": 8,
         "parthenon/mesh/nx3": 8, "parthenon/meshblock/nx1": 4,
         "parthenon/meshblock/nx2": 4, "parthenon/meshblock/nx3": 4},
    ):
        cfg = cm.from_deck(Deck.parse(DECK).update(mods))
        mesh = build_mesh(cfg.mesh)
        assert mesh.max_level == 0 and mesh.n_blocks > 1
        v = jnp.arange(mesh.total_cells, dtype=jnp.int32)
        got = np.asarray(pc._to_global_cells(v, mesh))
        nrbz, nrby, nrbx = mesh.root_grid
        NX, NY = nrbx * mesh.nx, nrby * mesh.ny
        lo = np.asarray(mesh.bounds, np.float64)[[0, 2, 4]]
        ext = np.asarray(mesh.block_dx, np.float64) * [mesh.nx, mesh.ny, mesh.nz]
        want = np.empty(mesh.total_cells, np.int64)
        k, j, i = np.meshgrid(
            np.arange(mesh.nz), np.arange(mesh.ny), np.arange(mesh.nx),
            indexing="ij",
        )
        for b in range(mesh.n_blocks):
            ox, oy, oz = np.rint(
                (np.asarray(mesh.block_origin[b], np.float64) - lo) / ext[b]
            ).astype(int)
            g = ((oz * mesh.nz + k) * NY + oy * mesh.ny + j) * NX + ox * mesh.nx + i
            want[g.reshape(-1)] = b * mesh.ncells_per_block + np.arange(
                mesh.ncells_per_block
            )
        assert np.array_equal(got, want), mods


def test_pallas_uniform_view_3d():
    """3D uniform multi-block forest through the census kernel's synthetic
    single-block path: the block/position round-trip must land every survivor
    back on a consistent (block, i, j, k, block-local position) tuple, and the
    diffusion statistics must match the XLA loop's."""
    mods = {
        "parthenon/mesh/nx1": 8, "parthenon/mesh/nx2": 8,
        "parthenon/mesh/nx3": 8, "parthenon/meshblock/nx1": 4,
        "parthenon/meshblock/nx2": 4, "parthenon/meshblock/nx3": 4,
        "parthenon/swarm/ix2_bc": "jaybenne_reflecting",
        "parthenon/swarm/ox2_bc": "jaybenne_reflecting",
        "parthenon/swarm/ix3_bc": "jaybenne_reflecting",
        "parthenon/swarm/ox3_bc": "jaybenne_reflecting",
    }
    cfg = cm.from_deck(Deck.parse(DECK).update(mods))
    mesh = build_mesh(cfg.mesh)
    prm = make_transport_params(cfg, jnp.float32)
    assert mesh.n_blocks == 8 and mesh.max_level == 0
    n = 4000
    c = 2.99792458e10
    ks = jr.split(jr.PRNGKey(3), 4)
    nx_, ny_, nz_ = (
        1.0 - 2.0 * jr.uniform(ks[1], (n,)),
        1.0 - 2.0 * jr.uniform(ks[2], (n,)),
        1.0 - 2.0 * jr.uniform(ks[3], (n,)),
    )
    nrm = jnp.sqrt(nx_**2 + ny_**2 + nz_**2)
    dxc = 1.0 / 8
    p = empty_ledger(CAP)
    # start in block 0, local cell (3, 3, 3) — adjacent to interior block faces
    # in every axis, so the synthetic view's cell tracking crosses them all
    p = dataclasses.replace(
        p,
        x=p.x.at[:n].set((3.0 + jr.uniform(ks[0], (n,))) * dxc),
        y=p.y.at[:n].set((3.0 + jr.uniform(ks[1], (n,))) * dxc),
        z=p.z.at[:n].set((3.0 + jr.uniform(ks[2], (n,))) * dxc),
        vx=p.vx.at[:n].set(c * nx_ / nrm),
        vy=p.vy.at[:n].set(c * ny_ / nrm),
        vz=p.vz.at[:n].set(c * nz_ / nrm),
        i=p.i.at[:n].set(3),
        j=p.j.at[:n].set(3),
        k=p.k.at[:n].set(3),
        alive=p.alive.at[:n].set(True),
        weight=p.weight.at[:n].set(1.0),
    )
    NC = mesh.total_cells
    coefs = T.TransportCoefs(
        sigma_a=jnp.zeros((NC,)),
        sigma_s=jnp.full((NC,), 2.0e2),
        fleck=jnp.ones((NC,)),
        px=jnp.zeros((8, 4, 4, 5)),
        py=jnp.zeros((8, 4, 5, 4)),
        pz=jnp.zeros((8, 5, 4, 4)),
    )
    dt = jnp.float32(cfg.jaybenne.dt)
    pp, _, _ = transport_kernel(p, coefs, mesh, jr.PRNGKey(1), prm, dt,
                                interpret=True)
    px_, _, _ = T.transport(p, coefs, mesh, jr.PRNGKey(1), prm, dt)
    bdx = np.asarray(mesh.block_dx)
    for out, name in ((pp, "pallas"), (px_, "xla")):
        alive = np.asarray(out.alive)
        assert int(alive.sum()) == n, name
        assert not (np.asarray(out.tau)[alive] < 1.0).any(), name
        blk = np.asarray(out.block)[alive]
        assert (blk >= 0).all() and (blk < 8).all(), name
        for idx, pos, nloc, ax in (
            (np.asarray(out.i)[alive], np.asarray(out.x)[alive], mesh.nx, 0),
            (np.asarray(out.j)[alive], np.asarray(out.y)[alive], mesh.ny, 1),
            (np.asarray(out.k)[alive], np.asarray(out.z)[alive], mesh.nz, 2),
        ):
            assert (idx >= 0).all() and (idx < nloc).all(), name
            # the f32 global->local rebase leaves survivors within ~1e-4 of the
            # block box (both paths; measured XLA-loop excursion ~6e-5)
            ext = bdx[blk, ax] * nloc
            assert (pos >= -1e-3 * ext).all(), name
            assert (pos <= ext * (1.0 + 1e-3)).all(), name
            # block-local position lands in (or within an eps offset of) the
            # integer-tracked cell
            cell_err = pos / bdx[blk, ax] - idx
            assert (cell_err > -0.1).all() and (cell_err < 1.1).all(), name
    for axis in range(3):
        g_p = np.asarray(pp.global_position(mesh)[axis])[np.asarray(pp.alive)]
        g_x = np.asarray(px_.global_position(mesh)[axis])[np.asarray(px_.alive)]
        assert abs(g_p.mean() - g_x.mean()) < 0.015, axis
        assert abs(g_p.std() - g_x.std()) / g_x.std() < 0.15, axis


def test_grazing_block_crossing_no_spin():
    """Regression: a particle crossing a block face with a grazing (near-zero
    normal velocity) crossing must not be re-homed into the block it just left.
    With the old velocity-proportional lookup nudge and an f32-inexact extent
    (domain [0, 0.1]: 8 * f32(0.00625) = 0.049999999 < 0.05, the lookup-tile
    boundary) the probe binned back into the source block, where the face
    distance is 0 and crossing always beats scattering — a zero-progress spin
    to the 10000-iteration cap. The fix probes half a finest cell along the
    crossed face's normal."""
    deck = Deck.parse(DECK).update(
        {
            "parthenon/mesh/nx1": 16,
            "parthenon/mesh/x1min": 0.0,
            "parthenon/mesh/x1max": 0.1,
            "parthenon/mesh/nx2": 8,
            "parthenon/mesh/x2min": 0.0,
            "parthenon/mesh/x2max": 0.05,
            "parthenon/mesh/ix2_bc": "periodic",
            "parthenon/mesh/ox2_bc": "periodic",
            "parthenon/meshblock/nx1": 8,
            "parthenon/meshblock/nx2": 8,
            "jaybenne/dt": "2.0e-12",
            "parthenon/time/tlim": "2.0e-12",
            "mcblock/scattering_constant_value": 1.0e-1,
        }
    )
    cfg = cm.from_deck(deck)
    mesh = build_mesh(cfg.mesh)
    prm = make_transport_params(cfg, jnp.float32)
    n = 64
    c = 2.99792458e10
    dxb = np.float32(mesh.block_dx[0, 0])
    face = np.float32(8.0) * dxb  # block 0's upper x face, block-local
    p = empty_ledger(CAP)
    p = dataclasses.replace(
        p,
        x=p.x.at[:n].set(face),
        y=p.y.at[:n].set(
            jnp.linspace(0.001, float(mesh.block_dx[0, 1]) * 7.9, n, dtype=jnp.float32)
        ),
        vx=p.vx.at[:n].set(c * 1.0e-7),
        vy=p.vy.at[:n].set(c),
        block=p.block.at[:n].set(0),
        i=p.i.at[:n].set(7),
        j=p.j.at[:n].set(jnp.arange(n, dtype=jnp.int32) % 8),
        alive=p.alive.at[:n].set(True),
        weight=p.weight.at[:n].set(1.0),
    )
    NC = mesh.total_cells
    B = mesh.n_blocks
    coefs = T.TransportCoefs(
        sigma_a=jnp.zeros((NC,)),
        sigma_s=jnp.full((NC,), 1.0e-1),
        fleck=jnp.ones((NC,)),
        px=jnp.zeros((B, 1, 8, 9)),
        py=jnp.zeros((B, 1, 9, 8)),
        pz=jnp.zeros((B, 2, 8, 8)),
    )
    dt = jnp.float32(2.0e-12)
    pp, iters, _ = transport_kernel(
        p, coefs, mesh, jr.PRNGKey(3), prm, dt, interpret=True
    )
    alive = np.asarray(pp.alive)
    assert int(alive.sum()) == n
    assert not (np.asarray(pp.tau)[alive] < 1.0).any()
    # a spin would burn the full max_transport_iterations budget
    assert int(iters) < 500, int(iters)


def _run_stable_order_cases(_stable_order):
    for n, r, seed in ((4096, 257, 0), (10000, 33, 1), (8192, 2049, 2), (129, 5, 3)):
        keys = jr.randint(jr.PRNGKey(seed), (n,), 0, r, dtype=jnp.int32)
        got = np.asarray(_stable_order(keys, r))
        want = np.asarray(jnp.argsort(keys, stable=True))
        np.testing.assert_array_equal(got, want)


def test_tabulated_opacity_runs_the_kernel(tmp_path):
    """opacity_model = table is a GRAY Planck-mean table — kappa(rho, T) is
    frequency-independent, so coefficients precompute per cell and the config
    routes to the census kernel, not the XLA loop.
    A stepdiff variant with an absorbing table runs the kernel (interpret) and
    conserves total energy (live weight + absorbed deposits)."""
    import numpy as np_

    from jaybenne_tpu.driver import Simulation

    rho_ax = np_.array([0.1, 1.0, 10.0])
    t_ax = np_.array([1.0e3, 1.0e5, 1.0e7])
    kap = np_.outer([1.0, 1.0, 1.0], [2.0, 2.0, 2.0])  # kappa = 2 cm^2/g
    path = str(tmp_path / "tab.npz")
    np_.savez(path, rho=rho_ax, T=t_ax, kappa=kap)

    deck = Deck.parse(DECK).update(
        {
            "mcblock/opacity_model": "table",
            "mcblock/opacity_table_file": path,
            "jaybenne/use_pallas": "interpret",
            "jaybenne/do_emission": "false",
            "jaybenne/do_feedback": "false",
        }
    )
    cfg = cm.from_deck(deck)
    opacity = cfg.mcblock.build_opacity()
    assert opacity.is_gray  # the production table path is Planck-mean (gray)

    sim = Simulation(cfg, quiet=True)
    # the step routes to the kernel (not the XLA loop)
    from jaybenne_tpu.step import census_path

    assert census_path(cfg.jaybenne.use_pallas, cfg.jaybenne.dtype) == "interpret"
    p0 = sim.state.particles
    w0 = float(np.asarray(p0.weight)[np.asarray(p0.alive)].sum())
    sim.run()
    p = sim.state.particles
    alive = np.asarray(p.alive)
    w_live = float(np.asarray(p.weight)[alive].sum())
    dv = np.asarray(sim.mesh.block_volume)[:, None, None, None]
    absorbed = float(np.asarray(sim.state.fields.energy_delta).sum())
    assert absorbed > 0  # the table's kappa actually absorbed
    assert np.isclose(w_live + absorbed, w0, rtol=1e-4)


def test_epbremss_per_event_in_kernel():
    """The genuinely frequency-dependent model (EPBremss, alpha ~ nu^-3)
    evaluates PER EVENT inside the census kernel at the
    particle's photon energy — the reference's device-side
    ``AbsorptionCoefficient(rho, T, ee)`` (transport.cpp:122-127). Kernel
    (interpret) and XLA trajectories conserve energy identically and agree
    statistically; absorption must show the spectral bias (soft photons die)."""
    from jaybenne_tpu.driver import Simulation

    mods = {
        "mcblock/opacity_model": "ep_bremss",
        "mcblock/initial_temperature": "1.0e6",
        # cv is the LIVE heat-capacity key (the decks' `specific_heat` is dead
        # in the reference too, mcblock.cpp:79). Without it cv = 1/(gamma-1) =
        # 1.5 -> fleck ~ 1e-7, and ep_bremss soft photons become pure
        # effective-scatterers at sigma ~ 1e20/cm: census physically cannot
        # complete (the reference trips max_transport_iterations identically).
        "mcblock/cv": "1.0e8",
        "mcblock/scattering_constant_value": "1.0e2",
        "jaybenne/do_emission": "false",
        "jaybenne/do_feedback": "false",
        "jaybenne/dt": "1.e-12",
        "parthenon/time/tlim": "1.e-12",
    }
    out = {}
    for mode in ("interpret", "off"):
        deck = Deck.parse(DECK).update({**mods, "jaybenne/use_pallas": mode})
        cfg = cm.from_deck(deck)
        assert not cfg.mcblock.build_opacity().is_gray
        sim = Simulation(cfg, quiet=True)
        p0 = sim.state.particles
        w0 = float(np.asarray(p0.weight)[np.asarray(p0.alive)].sum())
        sim.run()
        p = sim.state.particles
        alive = np.asarray(p.alive)
        w_live = float(np.asarray(p.weight)[alive].sum())
        absorbed = float(np.asarray(sim.state.fields.energy_delta).sum())
        assert np.isclose(w_live + absorbed, w0, rtol=1e-4), mode
        assert absorbed > 0, mode
        out[mode] = {
            "surv": int(alive.sum()),
            "mean_E": float(np.asarray(p.energy)[alive].mean()),
            "mean_E0": float(np.asarray(p0.energy)[np.asarray(p0.alive)].mean()),
        }
    for mode, o in out.items():
        # nu^-3: low-energy photons absorb preferentially, survivors harden
        assert o["mean_E"] > o["mean_E0"], (mode, o)
    # kernel vs XLA survivor statistics agree (independent RNG streams;
    # ~100 survivors of 4000 -> Poisson bounds, not tight percentages)
    n_on, n_off = out["interpret"]["surv"], out["off"]["surv"]
    assert abs(n_on - n_off) < 4.0 * np.sqrt(n_on + n_off), (n_on, n_off)
    assert (
        abs(out["interpret"]["mean_E"] - out["off"]["mean_E"]) / out["off"]["mean_E"]
        < 0.3
    )


def test_step_census_incomplete_signal():
    """StepStats on the kernel path: the exact ``unfinished`` count — survivors
    with tau < 1 when transport returned — is the census-incomplete signal,
    and ``cap_hits`` fires only when the per-call iteration cap cut the
    census off."""
    from jaybenne_tpu.driver import Simulation

    mods = {
        "parthenon/mesh/nx1": 2048,
        "parthenon/meshblock/nx1": 64,
        "jaybenne/num_particles": 1000,
        "jaybenne/use_pallas": "interpret",
        # c*dt spans ~20 zone-capped events per particle
        "jaybenne/dt": "3.3e-13",
        "parthenon/time/tlim": "3.3e-13",
        "mcblock/scattering_constant_value": "2.0e2",
    }
    cfg = cm.from_deck(Deck.parse(DECK).update(mods))
    sim = Simulation(cfg, quiet=True)
    _, stats = sim.step_fn(sim.state, jnp.float32(cfg.jaybenne.dt))
    assert int(stats.iterations) > 12, int(stats.iterations)
    assert int(stats.unfinished) == 0
    assert int(stats.cap_hits) == 0

    # a 12-iteration cap cuts the census off: both signals must report it
    cfg2 = cm.from_deck(
        Deck.parse(DECK).update({**mods, "jaybenne/max_transport_iterations": 12})
    )
    sim2 = Simulation(cfg2, quiet=True)
    _, stats2 = sim2.step_fn(sim2.state, jnp.float32(cfg.jaybenne.dt))
    assert int(stats2.iterations) == 12
    assert int(stats2.unfinished) > 0
    assert int(stats2.cap_hits) == 1
