"""External volume radiation source (the Su-Olson driving term) + PowerLawCv EOS.

The reference sources photons only from the matter Planck field
(``/root/reference/src/jaybenne/sourcing.cpp``); ``jaybenne/external_source``
is an extension of this build injecting radiation at a fixed energy-density rate
inside a box while ``t < tmax`` — the configuration of the Su & Olson (1996)
non-equilibrium benchmark family. Gates here are closed-form:

  * exact energy bookkeeping (injected == matter gain + radiation gain) through
    emission + feedback, in single-device, particle-sharded, and spatial modes;
  * the source-window cutoff (partial-step overlap, then zero);
  * the diffusion limit: a single-cell pulse in a pure-scattering medium
    spreads with the exact isotropic-scattering position variance
    ``2 D t (1 - (1 - e^(-s))/s)``, s = sigma*c*t (the finite-time transport
    correction to 2Dt).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jaybenne_tpu import config as cfg_mod
from jaybenne_tpu.driver import Simulation
from jaybenne_tpu.models import eos as eos_models
from jaybenne_tpu.utils import constants
from jaybenne_tpu.utils.deck import Deck

DT = 1.0e-11

DECK = f"""
<parthenon/job>
problem_id = uniform

<parthenon/mesh>
nx1 = 16
x1min = -0.5
x1max = 0.5

<parthenon/time>
tlim = {4 * DT}

<jaybenne>
num_particles = 4096
dt = {DT}
seed = 7
external_source = 1.0e9
external_source_x1min = -0.5
external_source_x1max = 0.0
external_source_num = 4000

<mcblock>
eos_model = power_law_cv
cv_alpha = 1.0
opacity_model = constant
opacity_constant_value = 1.0
initial_density = 1.0
initial_temperature = 1.0e-2
initial_radiation = none
"""


def _energies(sim):
    """(matter, radiation) total energies [erg] of the current state."""
    f = sim.state.fields
    p = sim.state.particles
    dv = np.asarray(sim.mesh.block_volume)
    b = np.asarray(f.u).shape[0]
    mat = float((np.asarray(f.u).reshape(b, -1).sum(axis=1) * dv[:b]).sum())
    alive = np.asarray(p.alive)
    rad = float(np.asarray(p.weight)[alive].sum())
    return mat, rad


def _injected(sim, n_cycles):
    """Exact injected energy: the particle budget divides evenly over the 8
    source cells (npc = 500, zero fractional part), so every source cell births
    exactly 500 particles carrying erad/500 each — total q * V_src * t."""
    jb = sim.cfg.jaybenne
    dv = float(np.asarray(sim.mesh.block_volume)[0])
    return jb.external_source_q * 8 * dv * n_cycles * DT


def _run_conservation(updates):
    deck = Deck.parse(DECK).update(updates or {})
    sim = Simulation(cfg_mod.from_deck(deck), quiet=True)
    e0 = sum(_energies(sim))
    sim.run()
    assert int(sim.state.overflow) == 0
    e1 = sum(_energies(sim))
    inj = _injected(sim, 4)
    assert inj > 100 * e0  # the budget is dominated by the injection
    np.testing.assert_allclose(e1 - e0, inj, rtol=2e-3)


def test_external_source_conservation_single():
    _run_conservation({})


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 (virtual) devices")
def test_external_source_conservation_sharded():
    """Particle-sharded mode: each shard sources its share; psum-ed weights keep
    the injected total exact (npc per shard stays integral: 2000/8 src cells)."""
    _run_conservation({"jaybenne/n_devices": 2})


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 (virtual) devices")
def test_external_source_conservation_spatial():
    """Spatial (block-sharded) mode: the box mask is sliced per shard; counts
    and weights are shard-local (disjoint cell ownership)."""
    _run_conservation(
        {
            "jaybenne/n_devices": 2,
            "jaybenne/decomposition": "spatial",
            "parthenon/meshblock/nx1": 8,
        }
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_external_source_conservation_spatial_concentrated():
    """8 shards, the source box owned by half of them: capacity provisioning
    must account for births concentrating on the box-owning shards' ledger
    slices (a global headroom number split evenly would overflow and silently
    lose injected energy)."""
    _run_conservation(
        {
            "jaybenne/n_devices": 8,
            "jaybenne/decomposition": "spatial",
            "parthenon/meshblock/nx1": 2,
        }
    )


def test_external_source_tmax_cutoff():
    """The source window [t, min(t+dt, tmax)) injects a partial step's worth
    when tmax lands mid-step and nothing afterwards."""
    deck = Deck.parse(DECK).update(
        {
            "jaybenne/external_source_tmax": 1.5 * DT,
            "jaybenne/do_emission": "false",
            "jaybenne/do_feedback": "false",
        }
    )
    sim = Simulation(cfg_mod.from_deck(deck), quiet=True)
    dv = float(np.asarray(sim.mesh.block_volume)[0])
    q = sim.cfg.jaybenne.external_source_q
    state = sim.state
    per_cycle = []
    for _ in range(3):
        state, _ = sim.step_fn(state, jnp.float32(DT))
        f = state.fields
        per_cycle.append(float((np.asarray(f.source_num) * np.asarray(f.source_ew)).sum()))
    expect = [q * 8 * dv * DT, q * 8 * dv * 0.5 * DT, 0.0]
    np.testing.assert_allclose(per_cycle, expect, rtol=1e-5, atol=1e-30)
    # past the cutoff no particles are born at all
    assert float(np.asarray(state.fields.source_num).sum()) == 0.0


def test_external_source_diffusion_variance():
    """Single-cell pulse in a pure-scattering medium: the position variance
    after t matches the exact isotropic-scattering random-flight result
    (transport-corrected 2Dt), averaged over the in-step birth times."""
    nx = 64
    h = 1.0 / nx
    sig = 100.0
    dt = 2.0e-12
    n_steps = 5
    deck = Deck.parse(DECK).update(
        {
            "parthenon/mesh/nx1": nx,
            "parthenon/time/tlim": n_steps * dt,
            "jaybenne/dt": dt,
            "jaybenne/num_particles": 1000,
            "jaybenne/do_emission": "false",
            "jaybenne/do_feedback": "false",
            "jaybenne/external_source_num": 20000,
            # exactly the cell straddling x = -h/2 (center -h/2 + h/2 per grid)
            "jaybenne/external_source_x1min": -h,
            "jaybenne/external_source_x1max": 0.0,
            "jaybenne/external_source_tmax": dt,
            "mcblock/opacity_model": "none",
            "mcblock/scattering_model": "constant",
            "mcblock/scattering_constant_value": sig,
        }
    )
    sim = Simulation(cfg_mod.from_deck(deck), quiet=True)
    sim.run()
    p = sim.state.particles
    alive = np.asarray(p.alive)
    assert alive.sum() == 20000  # no absorption, no escapes (periodic)
    x = np.asarray(p.x)[alive] + float(np.asarray(sim.mesh.block_origin)[0, 0])
    var = float(np.var(x))

    c = constants.CC
    d = c / (3.0 * sig)
    t_end = n_steps * dt

    def var_exact(tau):
        s = sig * c * tau
        return 2.0 * d * tau * (1.0 - (1.0 - np.exp(-s)) / s)

    # average over birth times uniform in [0, dt), plus the in-cell birth spread
    tb = (np.arange(1000) + 0.5) / 1000 * dt
    expect = var_exact(t_end - tb).mean() + h * h / 12.0
    np.testing.assert_allclose(var, expect, rtol=0.06)


def test_external_source_restart_bitwise(tmp_path):
    """Checkpoint/restart INSIDE the source window: the injection rate depends
    on absolute time (the [t, min(t+dt, tmax)) overlap), so a resume that lost
    or rescaled ``state.t`` would inject the wrong energy. The restarted
    trajectory must match the uninterrupted one bitwise."""
    base = {"jaybenne/external_source_tmax": 2.5 * DT}

    def cfg(tlim):
        return cfg_mod.from_deck(
            Deck.parse(DECK).update({**base, "parthenon/time/tlim": tlim})
        )

    sim_a = Simulation(cfg(4 * DT), outdir=str(tmp_path), quiet=True)
    sim_a.run()

    sim_b = Simulation(cfg(2 * DT), outdir=str(tmp_path), quiet=True)
    sim_b.run()
    ck = sim_b.write_checkpoint()
    sim_c = Simulation(cfg(4 * DT), outdir=str(tmp_path), quiet=True, restart=ck)
    sim_c.run()

    assert np.array_equal(
        np.asarray(sim_a.state.fields.energy_tally),
        np.asarray(sim_c.state.fields.energy_tally),
    )
    assert np.array_equal(
        np.asarray(sim_a.state.fields.u), np.asarray(sim_c.state.fields.u)
    )
    assert np.array_equal(
        np.asarray(sim_a.state.particles.weight),
        np.asarray(sim_c.state.particles.weight),
    )


def test_power_law_cv_eos():
    """sie = alpha T^(n+1)/(n+1) roundtrip and cv = alpha T^n."""
    eos = eos_models.PowerLawCv(alpha=2.5, n=3.0)
    t = jnp.asarray([1.0e-3, 0.7, 12.0])
    sie = eos.internal_energy_from_density_temperature(1.0, t)
    np.testing.assert_allclose(sie, 2.5 * t**4 / 4.0, rtol=1e-6)
    t_back = eos.temperature_from_density_internal_energy(1.0, sie)
    np.testing.assert_allclose(t_back, t, rtol=1e-5)
    cv = eos.specific_heat_from_density_internal_energy(1.0, sie)
    np.testing.assert_allclose(cv, 2.5 * t**3, rtol=1e-5)
    # the wrapped (unit-scaled) form used by build_eos
    wrapped = eos_models.UnitSystemEOS(eos, temperature_scale=2.0)
    tw = wrapped.temperature_from_density_internal_energy(1.0, sie)
    np.testing.assert_allclose(tw, t / 2.0, rtol=1e-5)
