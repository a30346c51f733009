#!/usr/bin/env python
"""Benchmark cells: the reference's acceptance problems at bench size, each
driven through ``Simulation`` and gated on its analytic or conservation check.

A cell is one deck with its overrides, a step count, and a gate. ``run_cell``
builds the simulation, times the first step (compilation included) apart from
the rest, runs the remaining steps through ``Simulation.run`` (the user's loop,
host syncs and all), and evaluates the gate. An event is one application of the
transport body to an active packet (flight segment, scatter, absorption, cell
crossing, DDMC leak, census) — BASELINE.md's unit.

``python bench.py`` runs every cell on the GPU and prints ONE JSON line;
``python bench.py --trace CELL ...`` prints each cell's device time per step
by op name from a profiler trace. It refuses to run without a GPU: a number
from another device is not a result. A failing cell fails the run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HERE = os.path.dirname(os.path.abspath(__file__))
OUTDIR = os.path.join(HERE, "chiprun_out", "bench")

_BIG = {
    "parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 64, "parthenon/mesh/nx3": 64,
    "parthenon/mesh/ix2_bc": "periodic", "parthenon/mesh/ox2_bc": "periodic",
    "parthenon/mesh/ix3_bc": "periodic", "parthenon/mesh/ox3_bc": "periodic",
    "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
    "parthenon/meshblock/nx3": 8,
    "jaybenne/num_particles": 200_000,
}


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    deck: str          # input deck under inputs/
    overrides: dict
    steps: int
    gate: str          # "erf" (1D stepdiff profile) or "energy" (closed box)
    limit: float


CELLS = {
    c.name: c
    for c in (
        # the reference's stepdiff acceptance problem at full size
        Cell("stepdiff", "stepdiff.in", {
            "parthenon/mesh/nx1": 128, "parthenon/meshblock/nx1": 128,
            "jaybenne/num_particles": 100_000,
        }, 10, "erf", 0.05),
        # the same physics through the DDMC branch (same 0.05 gate)
        Cell("stepdiff_ddmc", "stepdiff_ddmc.in", {
            "parthenon/mesh/nx1": 128, "parthenon/meshblock/nx1": 128,
            "jaybenne/num_particles": 100_000,
        }, 10, "erf", 0.05),
        # 64^3 cells with emission + fluid feedback. cv = 4aT^3 puts matter u
        # within ~4x of the radiation energy (feedback moves u above f32 ulp);
        # sigma_a = 3 gives fleck ~ 0.25, so emission and absorption balance at
        # ~2x num_particles live packets — capacity_factor 3 leaves headroom.
        # Closed box (reflecting x, periodic y/z): total energy is conserved.
        Cell("feedback64", "stepdiff.in", {
            **_BIG,
            "jaybenne/do_emission": "true", "jaybenne/do_feedback": "true",
            "mcblock/opacity_model": "constant",
            "mcblock/opacity_constant_value": 3.0,
            "mcblock/specific_heat": 30.3,
            "jaybenne/capacity_factor": 3,
        }, 3, "energy", 1.0e-2),
        # per-cell IMC/DDMC hybrid: at tau_ddmc = 10 the refinement jump splits
        # the branches (fine cells tau 7.8 -> IMC, coarse 15.6 -> DDMC); the
        # reference SMR tolerance 0.3 (the deck's native 128x64 size is too
        # noisy at 100k packets to carry it)
        Cell("hybrid_smr", "stepdiff_smr_hybrid.in", {
            "parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 32,
            "parthenon/meshblock/nx1": 16, "parthenon/meshblock/nx2": 16,
            "jaybenne/tau_ddmc": 10.0, "jaybenne/num_particles": 100_000,
        }, 10, "erf", 0.3),
        # the reference's precision: float64 runs the XLA event loop
        Cell("stepdiff_f64", "stepdiff.in", {
            "parthenon/mesh/nx1": 128, "parthenon/meshblock/nx1": 128,
            "jaybenne/num_particles": 100_000, "jaybenne/precision": "f64",
        }, 10, "erf", 0.05),
    )
}


def device_info():
    """JAX's view of the device plus the card's name and power limit as
    ``nvidia-smi`` reports them (None where nvidia-smi is absent)."""
    import jax

    d = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": smi,
    }


def require_gpu():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"no GPU: JAX's backend is {jax.default_backend()!r}; "
            "the benchmark measures the card or nothing"
        )


def make_sim(cell, **extra):
    """A ``Simulation`` of ``cell`` with deck overrides ``extra`` (keys as in
    the deck, e.g. ``jaybenne/use_pallas``). Dump outputs are dropped: the
    cells read their results from memory."""
    from jaybenne_tpu import config as cfg_mod
    from jaybenne_tpu.driver import Simulation
    from jaybenne_tpu.utils.deck import Deck

    deck = Deck.from_file(os.path.join(HERE, "inputs", cell.deck)).update(
        {**cell.overrides, **extra}
    )
    cfg = dataclasses.replace(cfg_mod.from_deck(deck), outputs=())
    return Simulation(cfg, outdir=OUTDIR, quiet=True)


def census_name(sim):
    from jaybenne_tpu.step import census_path

    jb = sim.cfg.jaybenne
    path = census_path(jb.use_pallas, jb.dtype, jb.decomposition == "spatial")
    return {"kernel": "pallas kernel", "interpret": "pallas interpreter"}.get(
        path, "xla loop"
    )


def stepdiff_werr(state, sim):
    """Weighted-mean fractional error of the tally against the analytic erf
    profile (tst/stepdiff_common.py), over every cell's x centre."""
    import numpy as np
    from scipy.special import erf

    tally = np.asarray(state.fields.energy_tally, np.float64).reshape(-1)
    xc = np.asarray(sim.mesh.cell_centers()[0], np.float64).reshape(-1)
    tau, ur0, shift = 1.000692e-7, 7.5646e5, 0.5
    s = 2.0 * np.sqrt(sim.t / tau)
    sol = 0.5 * ur0 * (erf(((xc + shift) + 0.5) / s) - erf(((xc + shift) - 0.5) / s))
    den = np.abs((sol + tally) / 2)
    rel = np.where(den > 0, np.abs(sol - tally) / np.where(den > 0, den, 1.0), 0.0)
    return float((rel * sol).sum() / sol.sum())


def total_energy(state, sim):
    """(matter + radiation energy, radiation energy) of a uniform mesh."""
    import numpy as np

    dv = float(np.prod(np.asarray(sim.mesh.block_dx, np.float64)[0]))
    mat = float(np.asarray(state.fields.u, np.float64).sum()) * dv
    w = np.asarray(state.particles.weight, np.float64)
    rad = float(w[np.asarray(state.particles.alive)].sum())
    return mat + rad, rad


def run_cell(cell, **extra):
    """Run ``cell``; returns (result dict, finished Simulation)."""
    import jax

    sim = make_sim(cell, **extra)
    state0 = sim.state
    dt = sim.dtype(sim.cfg.jaybenne.dt)
    e0, rad0 = total_energy(state0, sim) if cell.gate == "energy" else (0.0, 0.0)

    # first step: compilation + one step, on a throwaway copy of the state
    t0 = time.perf_counter()
    jax.block_until_ready(sim.step_fn(state0, dt))
    first = time.perf_counter() - t0

    sim.run(nlim=cell.steps)  # the user's loop: host syncs every step
    state = sim.state
    jax.block_until_ready(state)
    wall = sim.walltime / cell.steps
    if cell.gate == "erf":
        value = stepdiff_werr(state, sim)
    else:
        value = abs(total_energy(state, sim)[0] - e0) / rad0
    iters = [h["iterations"] for h in sim.history]
    res = {
        "cell": cell.name,
        "census": census_name(sim),
        "steps": cell.steps,
        "first_step_s": first,
        "compile_s": max(first - wall, 0.0),
        "wall_per_step_s": wall,
        "events_total": sim.total_events,
        "events_per_s": sim.total_events / sim.walltime,
        "iterations_per_step": sum(iters) / len(iters),
        "gate": cell.gate,
        "gate_value": value,
        "gate_limit": cell.limit,
        "gate_pass": bool(value <= cell.limit),
        "dropped": int(sim.state.overflow),
    }
    return res, sim


def device_time(trace_dir):
    """Reduce a ``jax.profiler`` trace: device time by op name (ns) and the
    busy time (union of device intervals, ns) over the GPU stream lines."""
    import collections
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    by_op, spans = collections.Counter(), []
    for plane in ProfileData.from_file(path).planes:
        if "GPU" not in plane.name:
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                by_op[ev.name] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return by_op, busy


def trace_cell(cell, steps=3, **extra):
    """Device time per step of ``steps`` steady steps of ``cell`` (after two
    warm-up steps), by op name, from a profiler trace under chiprun_out/."""
    import jax

    sim = make_sim(cell, **extra)
    dt = sim.dtype(sim.cfg.jaybenne.dt)
    st = sim.state
    for _ in range(2):
        st = jax.block_until_ready(sim.step_fn(st, dt))[0]
    trace_dir = os.path.join(HERE, "chiprun_out", f"trace_{cell.name}")
    with jax.profiler.trace(trace_dir):
        for _ in range(steps):
            st = jax.block_until_ready(sim.step_fn(st, dt))[0]
    by_op, busy = device_time(trace_dir)
    return {
        "cell": cell.name,
        "census": census_name(sim),
        "device_busy_ms_per_step": busy / steps / 1e6,
        "top_ops_ms_per_step": {
            k: v / steps / 1e6 for k, v in by_op.most_common(8)
        },
    }


def main():
    require_gpu()
    if "--trace" in sys.argv:
        for name in sys.argv[sys.argv.index("--trace") + 1:]:
            print(json.dumps(trace_cell(CELLS[name])))
        return
    rows = []
    for cell in CELLS.values():
        res, _ = run_cell(cell)
        print(json.dumps(res), file=sys.stderr, flush=True)
        if not res["gate_pass"]:
            raise SystemExit(f"cell {cell.name} failed its gate: {res}")
        rows.append(res)
    print(json.dumps({"device": device_info(), "cells": rows}))


if __name__ == "__main__":
    main()
