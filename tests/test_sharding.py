"""Particle-sharded distribution tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax

from jaybenne_tpu import config as cfg_mod
from jaybenne_tpu.driver import Simulation
from jaybenne_tpu.utils.deck import Deck

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

DECK = """
<parthenon/job>
problem_id = stepdiff

<parthenon/mesh>
nx1 = 32
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
nx1 = 16

<parthenon/time>
tlim = 6.671282e-11

<jaybenne>
num_particles = 64000
dt = 3.335641e-11
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


def _run(n_devices):
    deck = Deck.parse(DECK).update({"jaybenne/n_devices": n_devices})
    cfg = cfg_mod.from_deck(deck)
    sim = Simulation(cfg, quiet=True)
    sim.run()
    return sim


def test_sharded_smoke_two_devices():
    """Fast default-suite check: a 2-device particle-sharded run conserves energy
    exactly and produces a replicated tally (heavier statistical comparisons are
    slow-marked below)."""
    deck = Deck.parse(DECK).update(
        {"jaybenne/n_devices": 2, "jaybenne/num_particles": 8000,
         "parthenon/time/tlim": "3.335641e-11"}
    )
    sim = Simulation(cfg_mod.from_deck(deck), quiet=True)
    p0 = sim.state.particles
    w0 = float(np.asarray(p0.weight)[np.asarray(p0.alive)].sum())
    sim.run()
    p = sim.state.particles
    w1 = float(np.asarray(p.weight)[np.asarray(p.alive)].sum())
    assert np.isclose(w0, w1, rtol=1e-5)
    t = np.asarray(sim.state.fields.energy_tally)
    dv = np.asarray(sim.mesh.block_volume)[:, None, None, None]
    assert np.isclose((t * dv).sum(), w1, rtol=1e-4)
    assert int(sim.state.overflow) == 0


def test_sharded_census_kernel_two_devices():
    """Particle-sharded run through the census kernel (interpret): the kernel
    composes with shard_map (each shard runs its ledger slice), conserves
    energy exactly, and leaves a replicated tally."""
    deck = Deck.parse(DECK).update(
        {
            "jaybenne/n_devices": 2,
            "jaybenne/num_particles": 6000,
            "jaybenne/use_pallas": "interpret",
            "parthenon/time/tlim": "3.335641e-11",
            "mcblock/scattering_constant_value": "2.0e2",
        }
    )
    sim = Simulation(cfg_mod.from_deck(deck), quiet=True)
    p0 = sim.state.particles
    w0 = float(np.asarray(p0.weight)[np.asarray(p0.alive)].sum())
    sim.run()
    p = sim.state.particles
    w1 = float(np.asarray(p.weight)[np.asarray(p.alive)].sum())
    assert np.isclose(w0, w1, rtol=1e-5)
    t = np.asarray(sim.state.fields.energy_tally)
    dv = np.asarray(sim.mesh.block_volume)[:, None, None, None]
    assert np.isclose((t * dv).sum(), w1, rtol=1e-4)
    assert int(sim.state.overflow) == 0
    assert sim.history[-1]["events"] > 0


@pytest.mark.slow
def test_sharded_matches_single_device_statistics():
    """1-device and 8-device runs of the same problem agree to MC noise, and the
    sharded tally is replicated across devices (the analog of the reference's
    1-vs-8-rank CI check)."""
    s1 = _run(1)
    s8 = _run(8)
    t1 = np.asarray(s1.state.fields.energy_tally).reshape(-1)
    t8 = np.asarray(s8.state.fields.energy_tally).reshape(-1)
    w = t1 + t8
    err = np.abs(t1 - t8)[w > 0].sum() / w[w > 0].sum()
    assert err < 0.05, err
    # total energy identical to the thermal init in both (pure scattering)
    assert np.isclose(t1.sum(), t8.sum(), rtol=2e-2)


@pytest.mark.slow
def test_sharded_emission_feedback_and_growth():
    """Sharded run with emission + feedback + ledger auto-growth under pressure:
    total (matter + radiation) energy is exactly conserved and nothing overflows."""
    import os

    deck = Deck.from_file(
        os.path.join(os.path.dirname(__file__), "../inputs/inf.in")
    ).update(
        {
            "jaybenne/n_devices": 2,
            "jaybenne/num_particles": 512,
            "parthenon/time/tlim": "5.e-12",
            "jaybenne/do_feedback": "true",
            "jaybenne/capacity_factor": "1.2",
        }
    )
    cfg = cfg_mod.from_deck(deck)
    sim = Simulation(cfg, quiet=True)
    dv = np.asarray(sim.mesh.block_volume)[:, None, None, None]
    f0, p0 = sim.state.fields, sim.state.particles
    e0 = float((np.asarray(f0.u) * dv).sum()) + float(
        np.asarray(p0.weight)[np.asarray(p0.alive)].sum()
    )
    sim.run()
    f1, p1 = sim.state.fields, sim.state.particles
    e1 = float((np.asarray(f1.u) * dv).sum()) + float(
        np.asarray(p1.weight)[np.asarray(p1.alive)].sum()
    )
    assert int(sim.state.overflow) == 0
    assert int(p1.num_alive()) > 512  # population grew toward equilibrium
    assert abs(e1 - e0) / e0 < 5e-4


@pytest.mark.slow
def test_sharded_energy_conservation():
    s8 = _run(8)
    p = s8.state.particles
    alive = np.asarray(p.alive)
    w_total = float(np.asarray(p.weight)[alive].sum())
    # initial thermal energy: a T^4 * V_hot (half the domain hot; cold half ~1e-20 of it)
    from jaybenne_tpu.utils import constants

    expect = constants.AR * (1.0e5**4) * 0.5
    assert abs(w_total - expect) / expect < 2e-3
    assert int(s8.state.overflow) == 0

