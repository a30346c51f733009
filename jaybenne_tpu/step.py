"""The radiation step: one full cycle from t to t + dt.

Equivalent of ``jaybenne::RadiationStep``
(``/root/reference/src/jaybenne/jaybenne.cpp:68-151``). The reference builds a
Parthenon task graph (derived fields -> sourcing -> [ddmc ghost exchange] ->
iterative {transport -> swarm comms -> completion check} -> tally -> fluid update);
under XLA the whole graph collapses to straight-line jitted code with the census
iteration inside ``lax.while_loop`` — there is no task DAG, no per-task launch, and
on a single shard no communication at all.

``make_radiation_step`` closes over the (static) mesh geometry and physics models and
returns a pure jitted ``step(state, dt) -> (state, StepStats)``. The driver's
"HostUpdateTasks" (ghost exchange + ``sie = u / rho``,
``src/mcblock/mcblock_driver.cpp:58-71``) is folded into the same function: the
derived ``sie`` update happens right after the fluid update, and ghost exchange does
not exist (neighbor data is gathered positionally where needed).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .config import USE_PALLAS_MODES, RunConfig
from .ops import fleck as fleck_ops
from .ops import sourcing, tally
from .ops import transport as transport_ops
from .utils.tree import pytree_dataclass


@pytree_dataclass
class StepStats:
    iterations: jnp.ndarray  # census-loop iterations this step
    events: jnp.ndarray      # particle events this step
    n_alive: jnp.ndarray     # live particles after the step
    dropped: jnp.ndarray     # sourced particles dropped (ledger overflow)
    # spatial (block-sharded) decomposition only, zero elsewhere: census
    # migration rounds this step and total particles shipped between shards
    migration_rounds: jnp.ndarray = 0
    migrated: jnp.ndarray = 0
    # transport calls that hit the max_transport_iterations hang backstop (in
    # spatial mode iterations accumulates over migration rounds, so the cap
    # must be checked per call, not against the total)
    cap_hits: jnp.ndarray = 0
    # spatial mode: particles still short of census when the round loop ended —
    # the EXACT census-incomplete signal (a census that drains on the final
    # allowed round is complete; comparing rounds to the cap cannot tell)
    unfinished: jnp.ndarray = 0


def make_transport_params(cfg: RunConfig, dtype) -> transport_ops.TransportParams:
    consts = cfg.mcblock.build_opacity().get_runtime_physical_constants()
    eps = transport_ops.default_eps(dtype)
    return transport_ops.TransportParams(
        ndim=cfg.mesh.ndim,
        use_ddmc=cfg.jaybenne.use_ddmc,
        max_iters=cfg.jaybenne.max_transport_iterations,
        swarm_bc=cfg.mesh.swarm_bc,
        c=consts.c,
        tau_ddmc=cfg.jaybenne.tau_ddmc,
        has_absorption=cfg.mcblock.opacity_model != "none",
        **eps,
    )


def census_path(use_pallas: str, dtype, spatial: bool = False):
    """The one census-path selector: ``"kernel"`` (the Pallas census kernel,
    compiled for the GPU), ``"interpret"`` (the same kernel in the Pallas
    interpreter — an explicit deck value that only tests use), or ``None``
    (the XLA event loop).

    ``auto`` takes the kernel on a GPU wherever it applies (float32, not the
    spatial decomposition's census rounds) and the XLA loop elsewhere. ``on``
    and ``interpret`` never fall back: where the kernel cannot run they raise."""
    if use_pallas not in USE_PALLAS_MODES:
        raise ValueError(
            f"jaybenne/use_pallas must be one of {USE_PALLAS_MODES}, got {use_pallas!r}"
        )
    if use_pallas == "off":
        return None
    applies = jnp.dtype(dtype) == jnp.float32 and not spatial
    on_gpu = jax.default_backend() == "gpu"
    if use_pallas == "auto":
        return "kernel" if (applies and on_gpu) else None
    if not applies:
        raise ValueError(
            f"jaybenne/use_pallas = {use_pallas}: the census kernel runs float32 "
            "particle-sharded or single-device census loops only "
            f"(precision = {jnp.dtype(dtype).name}, spatial = {spatial})"
        )
    if use_pallas == "on" and not on_gpu:
        raise RuntimeError(
            "jaybenne/use_pallas = on needs a GPU, but JAX's backend is "
            f"{jax.default_backend()!r} (use 'interpret' to run the kernel in "
            "the Pallas interpreter)"
        )
    return "kernel" if use_pallas == "on" else "interpret"


def make_radiation_step(mesh, cfg: RunConfig):
    """Build the jitted single-device per-cycle step function."""
    return jax.jit(build_step_core(mesh, cfg))


def build_step_core(
    mesh, cfg: RunConfig, axis_name=None, num_particles=None, ext_num=None
):
    """The per-cycle step body.

    With ``axis_name`` set, the function is meant to run inside ``shard_map`` over a
    particle-sharded ledger: fields/mesh are replicated, each shard sources
    ``num_particles`` births (the per-shard share), transport needs zero
    communication, and tallies are ``psum``-ed (SURVEY §2d/§5 mapping)."""
    eos = cfg.mcblock.build_eos()
    opacity = cfg.mcblock.build_opacity()
    scattering = cfg.mcblock.build_scattering()
    consts = opacity.get_runtime_physical_constants()
    jb = cfg.jaybenne
    dtype = jb.dtype
    prm = make_transport_params(cfg, dtype)
    periodic = cfg.mesh.periodic_flags
    if num_particles is None:
        num_particles = jb.num_particles

    # external volume source (Su-Olson driving term): the box mask and source-
    # cell set are static mesh geometry, precomputed host-side once
    ext_on = jb.external_source_q > 0
    if ext_on:
        inside_mask, src_cells, n_src_cells, ext_prm = (
            sourcing.external_source_setup(mesh, jb)
        )
        if ext_num is None:
            ext_num = jb.external_source_num or jb.num_particles

    path = census_path(jb.use_pallas, dtype)

    def step(state, dt):
        # jax.named_scope regions are the trace-annotation analog of the reference's
        # Kokkos::Profiling::pushRegion("Jaybenne::Timestep"/"Jaybenne::TransportLoop")
        # (jaybenne.cpp:86-90,114-117); view with jax.profiler / XProf.
        f = state.fields
        p = state.particles
        key = jax.random.fold_in(state.rng_key, state.cycle)
        if axis_name is not None:
            key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        if ext_on:
            k_src, k_ext, k_tr = jax.random.split(key, 3)
        else:
            k_src, k_tr = jax.random.split(key)

        # 1. derived transport fields (jaybenne.cpp:104 -> :277-492)
        with jax.named_scope("jaybenne.derived_fields"):
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
                px, py, pz = fleck_ops.ddmc_face_probs(
                    mesh, sig_t, jb.tau_ddmc, periodic, dtype
                )
                f = dataclasses.replace(f, ddmc_px=px, ddmc_py=py, ddmc_pz=pz)

        # 2. emission sourcing (jaybenne.cpp:105 -> sourcing.cpp)
        dropped = jnp.zeros((), jnp.int32)
        if jb.do_emission:
            with jax.named_scope("jaybenne.sourcing"):
                f, p, dropped = sourcing.source_photons(
                    f, p, mesh, k_src,
                    source_type="emission",
                    eos=eos, opacity=opacity,
                    sb=consts.sb, c=consts.c,
                    num_particles=num_particles,
                    dt=dt, dtype=dtype,
                    axis_name=axis_name,
                )
            dropped = dropped.astype(jnp.int32)
        else:
            f = dataclasses.replace(
                f,
                energy_delta=jnp.zeros_like(f.energy_delta),
                # keep the source diagnostics clean for the external pass below
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
            with jax.named_scope("jaybenne.external_source"):
                f, p, ext_drop = sourcing.source_photons(
                    f, p, mesh, k_ext,
                    source_type="external",
                    eos=eos, opacity=opacity,
                    sb=consts.sb, c=consts.c,
                    num_particles=ext_num,
                    dt=dt, dtype=dtype,
                    axis_name=axis_name,
                    t=state.t,
                    external=ext_prm,
                    inside_mask=inside_mask,
                    src_cells=src_cells,
                    n_src_cells=n_src_cells,
                )
            dropped = dropped + ext_drop.astype(jnp.int32)

        # 3. census transport loop (jaybenne.cpp:113-131)
        with jax.named_scope("jaybenne.transport_loop"):
            coefs = transport_ops.precompute_coefs(
                f, mesh, eos, opacity, scattering, jb.use_ddmc, dtype
            )
            if path is None:
                p, iters, events = transport_ops.transport(
                    p, coefs, mesh, k_tr, prm, dt
                )
            else:
                from .ops.pallas_census import transport_kernel

                p, iters, events = transport_kernel(
                    p, coefs, mesh, k_tr, prm, dt, interpret=path == "interpret"
                )
            # exact census-incomplete signal, path-independent: survivors
            # still short of end-of-step (tau < 1) when transport returned.
            # Computed BEFORE the tau reset below.
            unfinished = jnp.sum(
                (p.alive & (p.tau < jnp.asarray(1.0, p.tau.dtype))).astype(
                    jnp.int32
                )
            )

        # absorption deposition + 4. radiation tally (jaybenne.cpp:134)
        with jax.named_scope("jaybenne.tally"):
            if prm.has_absorption:
                # statically no absorption model -> the absorbed mask is
                # provably all-false; skip the capacity-sized segment_sum
                # instead of summing zeros every step
                f = tally.accumulate_absorption(f, p, mesh, axis_name)
            f = tally.evaluate_radiation_energy(f, p, mesh, axis_name)

            # 5. fluid feedback (jaybenne.cpp:138) + derived (mcblock.cpp:208-232)
            if jb.do_feedback:
                f = tally.update_fluid(f, mesh)

        # reset per-step flags; census survivors restart at tau = 0 next cycle
        p = dataclasses.replace(
            p,
            absorbed=jnp.zeros_like(p.absorbed),
            tau=jnp.zeros_like(p.tau),
        )

        new_state = dataclasses.replace(
            state,
            fields=f,
            particles=p,
            t=state.t + dt,
            cycle=state.cycle + 1,
            rng_key=state.rng_key,
            overflow=state.overflow + dropped,
        )
        n_alive = p.num_alive()
        if axis_name is not None:
            iters = jax.lax.pmax(iters, axis_name)
            events = jax.lax.psum(events, axis_name)
            n_alive = jax.lax.psum(n_alive, axis_name)
            dropped = jax.lax.psum(dropped, axis_name)
            unfinished = jax.lax.psum(unfinished, axis_name)
            new_state = dataclasses.replace(
                new_state, overflow=state.overflow + dropped
            )
        cap_hits = (iters >= prm.max_iters).astype(jnp.int32)
        stats = StepStats(
            iterations=iters,
            events=events,
            n_alive=n_alive,
            dropped=dropped,
            migration_rounds=jnp.zeros((), jnp.int32),
            migrated=jnp.zeros((), jnp.int32),
            cap_hits=cap_hits,
            unfinished=unfinished,
        )
        return new_state, stats

    return step


def initialize_radiation(state, mesh, cfg: RunConfig):
    """Thermal-source the initial photon field (if requested) and evaluate the tally
    for outputs — ``jaybenne::InitializeRadiation`` (``jaybenne.cpp:570-578``)."""
    from .config import InitialRadiation

    eos = cfg.mcblock.build_eos()
    opacity = cfg.mcblock.build_opacity()
    consts = opacity.get_runtime_physical_constants()
    jb = cfg.jaybenne
    f, p = state.fields, state.particles
    dropped = jnp.zeros((), jnp.int32)
    if cfg.mcblock.initial_radiation == InitialRadiation.thermal:
        key = jax.random.fold_in(state.rng_key, 0x7FFFFFFF)
        f, p, dropped = sourcing.source_photons(
            f, p, mesh, key,
            source_type="thermal",
            eos=eos, opacity=opacity,
            sb=consts.sb, c=consts.c,
            num_particles=jb.num_particles,
            dt=0.0, dtype=jb.dtype,
        )
        dropped = dropped.astype(jnp.int32)
    f = tally.evaluate_radiation_energy(f, p, mesh)
    return dataclasses.replace(
        state, fields=f, particles=p, overflow=state.overflow + dropped
    )
