"""Multi-device distribution.

The reference distributes by spatial block decomposition over MPI ranks with particle
migration and a global completion reduction (SURVEY §2d). Two strategies are
provided:

**Particle sharding (default).** The particle ledger is sharded over the
device mesh; block field arrays are replicated (they are orders of magnitude smaller
than the ledger for production particle counts). Consequences:

  * the census loop needs ZERO communication — every shard transports its particles
    to completion independently (no migration, no per-iteration allreduce, perfect
    load balance regardless of the spatial particle distribution);
  * per-step communication is exactly three ``psum``s (global per-cell birth counts,
    absorption deposits, tally) over NVLink;
  * RNG streams are decorrelated by folding ``axis_index`` into the step key — the
    analog of the reference's ``seed + my_rank`` (``jaybenne.cpp:187-190``).

This inverts the reference's decomposition on purpose: MPI jaybenne must decompose
space because fields and particles live together in block memory; on an accelerator the
ledger dominates memory and the fields fit everywhere exercised by the reference's
problem class. The crossover (huge meshes, ~>10^8 cells) is where the spatial
strategy below takes over.

**Spatial (block) sharding** (``jaybenne_tpu.parallel.spatial``): blocks sharded over
devices, particles migrate via ``all_to_all`` inside an iterate-until-``psum``-zero
census loop — a faithful mapping of the reference's swarm communication
(``jaybenne.cpp:113-131``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import RunConfig

from ..state import SimState
from ..step import StepStats, build_step_core


def device_mesh(n_devices: int = 0) -> DeviceMesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices but only {len(devs)} available")
    return DeviceMesh(np_devices(devs[:n]), ("shard",))


def np_devices(devs):
    import numpy as np

    return np.asarray(devs)


def state_specs(state: SimState, shard_fields: bool = False) -> SimState:
    """Build a SimState-of-PartitionSpecs matching ``state``'s tree structure.

    ``shard_fields``: shard field arrays along the block axis (spatial
    decomposition — requires the block axis padded to a multiple of the device
    count, see ``spatial.pad_field_blocks``); otherwise fields are replicated."""
    fspec = P("shard") if shard_fields else P()
    fields_spec = jax.tree.map(lambda _: fspec, state.fields)
    particles_spec = jax.tree.map(lambda _: P("shard"), state.particles)
    return SimState(
        fields=fields_spec,
        particles=particles_spec,
        t=P(),
        cycle=P(),
        rng_key=P(),
        overflow=P(),
    )


def pad_capacity(capacity: int, n: int) -> int:
    return ((capacity + n - 1) // n) * n


def shard_state(state: SimState, dmesh: DeviceMesh, shard_fields: bool = False) -> SimState:
    """Place the state on the device mesh (particles split; fields split along the
    block axis too when ``shard_fields``, else replicated)."""
    specs = state_specs(state, shard_fields)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(dmesh, s)), state, specs
    )


def make_sharded_step(mesh, cfg: RunConfig, dmesh: DeviceMesh):
    """Particle-sharded ``step(state, dt) -> (state, stats)`` via ``shard_map``."""
    n = dmesh.devices.size
    per_shard = max(1, round(cfg.jaybenne.num_particles / n))
    ext_total = cfg.jaybenne.external_source_num or cfg.jaybenne.num_particles
    core = build_step_core(
        mesh, cfg, axis_name="shard", num_particles=per_shard,
        ext_num=max(1, round(ext_total / n)),
    )

    def run(state, dt):
        specs = state_specs(state)
        stats_spec = StepStats(
            iterations=P(), events=P(), n_alive=P(), dropped=P(),
            migration_rounds=P(), migrated=P(), cap_hits=P(), unfinished=P(),
        )
        fn = jax.shard_map(
            core,
            mesh=dmesh,
            in_specs=(specs, P()),
            out_specs=(specs, stats_spec),
            check_vma=False,
        )
        return fn(state, dt)

    return jax.jit(run)


def make_sharded_init(mesh, cfg: RunConfig, dmesh: DeviceMesh):
    """Sharded ``initialize_radiation``: each shard thermal-sources its share."""
    from ..config import InitialRadiation
    from ..ops import sourcing, tally

    n = dmesh.devices.size
    per_shard = max(1, round(cfg.jaybenne.num_particles / n))
    eos = cfg.mcblock.build_eos()
    opacity = cfg.mcblock.build_opacity()
    consts = opacity.get_runtime_physical_constants()
    jb = cfg.jaybenne

    def core(state):
        f, p = state.fields, state.particles
        dropped = jnp.zeros((), jnp.int32)
        if cfg.mcblock.initial_radiation == InitialRadiation.thermal:
            key = jax.random.fold_in(state.rng_key, 0x7FFFFFFF)
            key = jax.random.fold_in(key, jax.lax.axis_index("shard"))
            f, p, dropped = sourcing.source_photons(
                f, p, mesh, key,
                source_type="thermal",
                eos=eos, opacity=opacity,
                sb=consts.sb, c=consts.c,
                num_particles=per_shard,
                dt=0.0, dtype=jb.dtype,
                axis_name="shard",
            )
            dropped = jnp.asarray(dropped, jnp.int32)
        f = tally.evaluate_radiation_energy(f, p, mesh, "shard")
        return dataclasses.replace(
            state,
            fields=f,
            particles=p,
            overflow=state.overflow + jax.lax.psum(dropped, "shard"),
        )

    def run(state):
        specs = state_specs(state)
        fn = jax.shard_map(
            core, mesh=dmesh, in_specs=(specs,), out_specs=specs, check_vma=False
        )
        return fn(state)

    return jax.jit(run)
