"""Evolution driver and CLI — the mcblock equivalent.

Owns what Parthenon's ``EvolutionDriver`` + ``McblockDriver`` own in the reference
(``/root/reference/src/mcblock/mcblock_driver.cpp``, ``main.cpp``): the cycle loop,
per-cycle stdout, output cadence, and the wall of initialization (problem generation,
post-init, radiation init). One cycle is ``RadiationStep`` then the host derived-field
update, exactly the reference's ``Step()`` (``mcblock_driver.cpp:38-53``).

CLI: ``python -m jaybenne_tpu.driver -i inputs/stepdiff.in [-d outdir] [-r ckpt]``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time

import jax

from . import config as config_mod
from . import io as io_mod
from . import state as state_mod
from .mesh import build_mesh
from .models.problems import generate_problem
from .step import initialize_radiation, make_radiation_step


class Simulation:
    """Host-side orchestration around the jitted step."""

    def __init__(
        self,
        cfg: config_mod.RunConfig,
        outdir: str = ".",
        quiet: bool = False,
        restart: str = None,
    ):
        self.cfg = cfg
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.quiet = quiet
        jb = cfg.jaybenne
        if jb.precision == "f64" and not jax.config.read("jax_enable_x64"):
            jax.config.update("jax_enable_x64", True)
        self.dtype = jb.dtype
        self.mesh = build_mesh(cfg.mesh, dtype=self.dtype)
        self.n_devices = jb.n_devices if jb.n_devices != 0 else len(jax.devices())
        # the spatial decomposition always runs through shard_map (a 1-device
        # mesh is valid), so a single chip exercises the same sharded-field +
        # migration-round code path it scales with
        self._distributed = self.n_devices > 1 or jb.decomposition == "spatial"
        capacity = self._capacity()
        if self._distributed:
            from .parallel import sharding

            self.dmesh = sharding.device_mesh(self.n_devices)
        self.state = state_mod.initial_state(self.mesh, capacity, jb.seed, self.dtype)
        self.state = state_mod.SimState(
            fields=generate_problem(self.state.fields, self.mesh, cfg, self.dtype),
            particles=self.state.particles,
            t=self.state.t,
            cycle=self.state.cycle,
            rng_key=self.state.rng_key,
            overflow=self.state.overflow,
        )
        if self._distributed:
            from .parallel import sharding

            if jb.decomposition == "spatial":
                from .parallel import spatial

                # fields are sharded along the (padded) block axis: per-device
                # field memory scales ~1/N — the huge-mesh regime
                self.state = state_mod.SimState(
                    fields=spatial.pad_field_blocks(
                        self.state.fields, self.mesh, self.n_devices
                    ),
                    particles=self.state.particles,
                    t=self.state.t,
                    cycle=self.state.cycle,
                    rng_key=self.state.rng_key,
                    overflow=self.state.overflow,
                )
                self.state = sharding.shard_state(
                    self.state, self.dmesh, shard_fields=True
                )
                self.state = spatial.make_spatial_init(self.mesh, cfg, self.dmesh)(
                    self.state
                )
                self.step_fn = spatial.make_spatial_step(self.mesh, cfg, self.dmesh)
            else:
                self.state = sharding.shard_state(self.state, self.dmesh)
                self.state = sharding.make_sharded_init(self.mesh, cfg, self.dmesh)(
                    self.state
                )
                self.step_fn = sharding.make_sharded_step(self.mesh, cfg, self.dmesh)
        else:
            self.state = initialize_radiation(self.state, self.mesh, cfg)
            self.step_fn = make_radiation_step(self.mesh, cfg)
        self.t = 0.0  # authoritative (host float64) simulation time
        self.cycle = 0
        self.total_events = 0
        self.total_iters = 0
        self.dump_count = 0
        self._next_dump_t = 0.0
        self.history = []  # per-cycle diagnostics (written to history.json)
        if restart:
            # checkpoint/resume: full state (fields + particle ledger + RNG +
            # counters) — SURVEY §5 notes this as a cheap win over the reference,
            # whose restart path is inherited from Parthenon but never exercised
            # a run that grew its ledger resumes with the grown ledger: the
            # per-slot random streams depend on the capacity, so the same
            # capacity is what keeps a resumed run bitwise on track
            self.t, self.cycle, saved_cap = io_mod.read_checkpoint_header(restart)
            capacity = max(
                self.state.particles.capacity, self._round_capacity(saved_cap)
            )
            self.state = io_mod.read_checkpoint(restart, self.state, capacity)
            if self._distributed:
                # re-place the restored host arrays on the device mesh (restart
                # with the same device count resumes bitwise; in spatial mode
                # the ledger is first re-homed host-side so every particle sits
                # in its owning shard's slice regardless of the writing run's
                # device count — shard_state splits by slot position, and
                # transport only sees shard-owned particles)
                import dataclasses

                from .parallel import sharding

                if jb.decomposition == "spatial":
                    from .parallel import spatial

                    self.state = dataclasses.replace(
                        self.state,
                        particles=spatial.rehome_restart_ledger(
                            self.state.particles, self.mesh, self.n_devices
                        ),
                    )
                self.state = sharding.shard_state(
                    self.state, self.dmesh,
                    shard_fields=jb.decomposition == "spatial",
                )
            self._next_dump_t = self.t
            if not quiet:
                print(f"restarted from {restart} at t={self.t:.6e} cycle={self.cycle}")

    def _round_capacity(self, cap: int) -> int:
        """Round up to a whole number of equal per-device ledger slices."""
        n = max(self.n_devices, 1) if self._distributed else 1
        return -(-cap // n) * n

    def _capacity(self) -> int:
        jb = self.cfg.jaybenne
        # room for census survivors + one step of births + stochastic slack
        cap = int(jb.num_particles * jb.capacity_factor) + self.mesh.total_cells + 1024
        cap += self._ext_births()
        return self._round_capacity(cap)

    def _ext_births(self) -> int:
        jb = self.cfg.jaybenne
        if jb.external_source_q <= 0:
            return 0
        n = jb.external_source_num or jb.num_particles
        if jb.decomposition == "spatial":
            # births land on the ledger slices of the box-OWNING shards (worst
            # case: one shard owns the whole box), but capacity is a global
            # number split evenly per shard — provision for the concentration
            n *= max(self.n_devices, 1)
        return n

    def _ensure_headroom(self):
        """Grow the particle ledger before the next sourcing could overflow it — the
        equivalent of Parthenon's swarm pool growth in ``AddEmptyParticles``
        (reference ``sourcing.cpp:122-131``). Growth doubles capacity (amortized
        recompile) and keeps all live particles in place. A sharded ledger grows
        slice by slice, so every particle stays on its shard."""
        import dataclasses

        import jax.numpy as jnp

        p = self.state.particles
        need = (
            int(p.num_alive()) + self.cfg.jaybenne.num_particles
            + self._ext_births() + self.mesh.total_cells + 64
        )
        if need <= p.capacity:
            return
        new_cap = self._round_capacity(max(need, 2 * p.capacity))
        n = self.n_devices if self._distributed else 1
        pad = (new_cap - p.capacity) // n

        def grow(arr):
            a = arr.reshape((n, -1) + arr.shape[1:])
            z = jnp.zeros((n, pad) + arr.shape[1:], dtype=arr.dtype)
            return jnp.concatenate([a, z], axis=1).reshape((new_cap,) + arr.shape[1:])

        grown = dataclasses.replace(
            p, **{f.name: grow(getattr(p, f.name)) for f in dataclasses.fields(p)}
        )
        self.state = dataclasses.replace(self.state, particles=grown)
        if self._distributed:
            from .parallel import sharding

            self.state = sharding.shard_state(
                self.state, self.dmesh,
                shard_fields=self.cfg.jaybenne.decomposition == "spatial",
            )
        if not self.quiet:
            print(f"ledger grown: capacity {p.capacity} -> {new_cap}", flush=True)

    # ------------------------------------------------------------------ outputs
    def _maybe_dump(self, force=False):
        outs = [
            o
            for o in self.cfg.outputs
            if o.file_type in ("hdf5", "phdf", "phdf_parthenon")
        ]
        if outs:
            out = outs[0]
            if force or (
                out.dt > 0 and self.t >= self._next_dump_t - 1e-12 * max(out.dt, 1.0)
            ):
                path = io_mod.dump_filename(
                    self.cfg.problem_id, self.dump_count, self.outdir
                )
                # phdf_parthenon selects the Parthenon-binary-layout writer the
                # reference's parthenon_tools-based tooling can read directly
                writer = (
                    io_mod.write_dump_parthenon
                    if out.file_type == "phdf_parthenon"
                    else io_mod.write_dump
                )
                writer(
                    path, self.state, self.mesh, self.cfg,
                    out.variables, out.swarm_variables,
                )
                self.dump_count += 1
                while out.dt > 0 and self._next_dump_t <= self.t + 1e-12 * max(out.dt, 1.0):
                    self._next_dump_t += out.dt
        # restart dumps: <parthenon/outputN> file_type = rst (Parthenon's restart
        # output type; resumed with the -r flag)
        rsts = [o for o in self.cfg.outputs if o.file_type in ("rst", "restart")]
        if rsts:
            out = rsts[0]
            if not hasattr(self, "_next_rst_t"):
                self._next_rst_t = out.dt
            if out.dt > 0 and self.t >= self._next_rst_t - 1e-12 * out.dt:
                self.write_checkpoint()
                while self._next_rst_t <= self.t + 1e-12 * out.dt:
                    self._next_rst_t += out.dt

    def write_checkpoint(self, path=None) -> str:
        path = path or os.path.join(
            self.outdir, f"{self.cfg.problem_id}.ckpt.{self.cycle:05d}.rhdf"
        )
        io_mod.write_checkpoint(path, self.state, self.mesh, t=self.t, cycle=self.cycle)
        return path

    # ------------------------------------------------------------------ run loop
    def run(self, wall_limit_s=None, nlim=None) -> None:
        """Evolve to ``tlim``. ``wall_limit_s`` stops cleanly (final dumps still
        written) when the wall clock is exceeded — the reference driver's ``-t``
        walltime limit; ``nlim`` caps the number of cycles (``-n``)."""
        cfg = self.cfg
        dt = cfg.jaybenne.dt
        tlim = cfg.time.tlim
        n_cycles = max(1, int(round(tlim / dt)))
        if nlim is not None:
            n_cycles = min(n_cycles, max(0, int(nlim)))
        self._maybe_dump()  # initial conditions

        wall0 = _time.time()
        for n in range(n_cycles):
            step_dt = min(dt, tlim - self.t)
            if step_dt <= 0:
                break
            if wall_limit_s is not None and _time.time() - wall0 >= wall_limit_s:
                print(
                    f"walltime limit reached after {self.cycle} cycles; stopping",
                    file=sys.stderr,
                )
                break
            if self.cfg.jaybenne.do_emission:
                self._ensure_headroom()
            self.state, stats = self.step_fn(self.state, self.dtype(step_dt))
            self.t += step_dt
            self.cycle += 1
            ev = int(stats.events)
            self.total_events += ev
            self.total_iters += int(stats.iterations)
            mig_rounds = int(stats.migration_rounds)
            migrated = int(stats.migrated)
            self.history.append(
                {
                    "cycle": self.cycle,
                    "time": self.t,
                    "dt": step_dt,
                    "iterations": int(stats.iterations),
                    "events": ev,
                    "alive": int(stats.n_alive),
                    "dropped": int(stats.dropped),
                    "migration_rounds": mig_rounds,
                    "migrated": migrated,
                    "unfinished": int(stats.unfinished),
                }
            )
            if not self.quiet:
                mig = (
                    f" mig_rounds={mig_rounds} migrated={migrated}"
                    if mig_rounds else ""
                )
                print(
                    f"cycle={self.cycle} time={self.t:.6e} dt={step_dt:.6e} "
                    f"iters={int(stats.iterations)} events={ev} "
                    f"alive={int(stats.n_alive)}" + mig,
                    flush=True,
                )
            if int(stats.unfinished) > 0:
                # exact signal: particles still short of census when the round
                # loop ended (a census that drains ON the final allowed round
                # is complete — comparing rounds to the cap cannot tell)
                print(
                    f"WARNING: census incomplete this cycle — "
                    f"{int(stats.unfinished)} particles unfinished after "
                    f"{mig_rounds} migration rounds",
                    file=sys.stderr,
                )
            if int(stats.dropped) > 0:
                print(
                    f"WARNING: particle ledger overflow, dropped {int(stats.dropped)} "
                    f"sourced particles (raise jaybenne/capacity_factor)",
                    file=sys.stderr,
                )
            if self.cfg.jaybenne.debug_checks:
                from .utils.debug import validate_state

                validate_state(self.state, self.mesh, self.cfg)
            if int(stats.cap_hits) > 0:
                # the reference's hang backstop (jaybenne.cpp:195-197): a census
                # loop was cut off; some particles did not reach end-of-step
                # (checked per transport call — in spatial mode ``iterations``
                # accumulates over migration rounds and cannot be compared to
                # the per-call cap)
                print(
                    f"WARNING: {int(stats.cap_hits)} transport call(s) hit "
                    f"max_transport_iterations "
                    f"({self.cfg.jaybenne.max_transport_iterations}); census "
                    "incomplete this cycle",
                    file=sys.stderr,
                )
            self._maybe_dump()
        self.walltime = _time.time() - wall0
        self._maybe_dump(force=True)
        # per-cycle diagnostics ledger (observability: the per-cycle stdout plus a
        # machine-readable record, cf. the harness summaries in SURVEY §5)
        try:
            import json

            with open(os.path.join(self.outdir, "history.json"), "w") as fh:
                json.dump(
                    {
                        "problem_id": self.cfg.problem_id,
                        "walltime_s": self.walltime,
                        "total_events": self.total_events,
                        "cycles": self.history,
                    },
                    fh, indent=1,
                )
        except OSError:  # pragma: no cover
            pass
        if not self.quiet:
            rate = self.total_events / max(self.walltime, 1e-9)
            print(
                f"walltime={self.walltime:.3f}s events={self.total_events} "
                f"({rate:.3e} events/s)",
                flush=True,
            )


def run_file(
    input_path, outdir=".", modified_inputs=None, quiet=False, restart=None,
    wall_limit_s=None, nlim=None,
) -> Simulation:
    from .utils.deck import Deck

    deck = Deck.from_file(input_path).update(modified_inputs or {})
    cfg = config_mod.from_deck(deck)
    os.makedirs(outdir, exist_ok=True)
    sim = Simulation(cfg, outdir=outdir, quiet=quiet, restart=restart)
    sim.run(wall_limit_s=wall_limit_s, nlim=nlim)
    return sim


def _parse_walltime(text):
    """'HH:MM:SS' / 'MM:SS' / plain seconds -> seconds (reference -t flag).

    Raises ValueError on malformed input (non-numeric fields or more than three
    colon-separated fields); main() turns that into an argparse error."""
    fields = str(text).split(":")
    if len(fields) > 3:
        raise ValueError(f"walltime {text!r} has more than 3 ':' fields")
    parts = [float(x) for x in fields]
    secs = 0.0
    for v in parts:
        secs = secs * 60.0 + v
    return secs


def main(argv=None):
    ap = argparse.ArgumentParser(description="Implicit Monte Carlo thermal photon transport")
    ap.add_argument("-i", "--input", required=True, help="input deck (.in)")
    ap.add_argument("-d", "--outdir", default=".", help="output directory")
    ap.add_argument("-r", "--restart", default=None, help="checkpoint (.rhdf) to resume")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument(
        "--profile-dir",
        default=None,
        help="capture a jax.profiler trace of the run into this directory",
    )
    ap.add_argument(
        "-t", "--walltime", default=None, metavar="HH:MM:SS",
        help="wall-clock limit; stop cleanly (with final dumps) when exceeded",
    )
    ap.add_argument(
        "-n", "--nlim", type=int, default=None, help="max number of cycles"
    )
    ap.add_argument(
        "overrides", nargs="*", metavar="block/key=value",
        help="input-deck overrides applied after parsing, e.g. "
        "jaybenne/num_particles=1000 (the reference's ParameterInput CLI "
        "override syntax)",
    )
    args = ap.parse_args(argv)
    wall_limit_s = None
    if args.walltime:
        try:
            wall_limit_s = _parse_walltime(args.walltime)
        except ValueError:
            ap.error(
                f"invalid -t/--walltime {args.walltime!r}: expected seconds, "
                "MM:SS, or HH:MM:SS"
            )
    mods = {}
    for ov in args.overrides:
        if "=" not in ov or "/" not in ov.split("=", 1)[0]:
            ap.error(f"override must look like block/key=value, got: {ov!r}")
        k, v = ov.split("=", 1)
        mods[k] = v
    if args.profile_dir:
        import contextlib

        import jax.profiler

        ctx = jax.profiler.trace(args.profile_dir)
    else:
        import contextlib

        ctx = contextlib.nullcontext()
    with ctx:
        run_file(
            args.input, outdir=args.outdir, modified_inputs=mods,
            quiet=args.quiet, restart=args.restart,
            wall_limit_s=wall_limit_s,
            nlim=args.nlim,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
