#!/usr/bin/env python
"""Quickest proof that the system runs on the GPU: the bench decks through
``Simulation`` on one card, each gated, the census kernel compared with the
plain XLA event loop at full width, the GPU-only tests, and a determinism
check.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # the four-GPU decompositions only

Every phase prints its numbers on its own lines; the last line of standard
output is one JSON object with the device JAX reports. Any failed gate or
comparison, or any error, exits non-zero without that line. Without a GPU the
script exits non-zero before doing anything.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    raise SystemExit(1)


def check(ok, msg):
    log(("ok    " if ok else "FAIL  ") + msg)
    if not ok:
        raise SystemExit(1)


def report(res):
    log(
        f"  {res['cell']:13s} census={res['census']:13s} "
        f"wall/step={res['wall_per_step_s'] * 1e3:.3f} ms "
        f"events/s={res['events_per_s']:.4e} "
        f"iters/step={res['iterations_per_step']:.1f} "
        f"compile={res['compile_s']:.2f} s "
        f"{res['gate']}={res['gate_value']:.4g} (limit {res['gate_limit']:g})"
    )


def packet_moments(sim):
    """Mean and std of the alive packets' global x positions."""
    import numpy as np

    p = sim.state.particles
    alive = np.asarray(p.alive)
    gx = np.asarray(p.global_position(sim.mesh)[0], np.float64)[alive]
    return gx.mean(), gx.std()


def x_profile(sim, nbins=8):
    """The radiation tally summed over y, z and ``nbins`` equal x slabs."""
    import numpy as np

    t = np.asarray(sim.state.fields.energy_tally, np.float64).reshape(-1)
    xc = np.asarray(sim.mesh.cell_centers()[0], np.float64).reshape(-1)
    lo, hi = sim.mesh.bounds[0], sim.mesh.bounds[1]
    idx = np.clip(((xc - lo) / (hi - lo) * nbins).astype(int), 0, nbins - 1)
    return np.bincount(idx, weights=t, minlength=nbins)


def phase_decks(bench):
    """The five decks through Simulation with use_pallas = auto."""
    log("phase decks: every bench deck on its default census path")
    runs = {}
    for cell in bench.CELLS.values():
        res, sim = bench.run_cell(cell)
        report(res)
        check(res["gate_pass"], f"{cell.name}: {res['gate']} gate")
        check(res["dropped"] == 0, f"{cell.name}: no packets dropped")
        want = "xla loop" if cell.name.endswith("f64") else "pallas kernel"
        check(res["census"] == want, f"{cell.name}: census path is the {want}")
        runs[cell.name] = (res, sim)
    return runs


def phase_compare(bench, runs):
    """Kernel against the XLA loop at full width, deck by deck."""
    log("phase compare: census kernel vs XLA event loop (use_pallas = off)")
    for name, (kres, ksim) in runs.items():
        if kres["census"] != "pallas kernel":
            continue
        xres, xsim = bench.run_cell(bench.CELLS[name], **{"jaybenne/use_pallas": "off"})
        report(xres)
        check(xres["gate_pass"], f"{name}: XLA loop passes the gate too")
        speedup = xres["wall_per_step_s"] / kres["wall_per_step_s"]
        log(f"  {name}: kernel {kres['wall_per_step_s'] * 1e3:.3f} ms/step, "
            f"XLA loop {xres['wall_per_step_s'] * 1e3:.3f} ms/step, "
            f"kernel is {speedup:.2f}x")
        ev = abs(kres["events_total"] - xres["events_total"]) / xres["events_total"]
        check(ev < 0.05, f"{name}: event totals within 5% ({ev:.4f})")
        if bench.CELLS[name].gate == "erf":
            (mk, sk), (mx, sx) = packet_moments(ksim), packet_moments(xsim)
            check(abs(mk - mx) < 0.01, f"{name}: packet x mean within 0.01 ({mk:.5f} vs {mx:.5f})")
            check(abs(sk - sx) / sx < 0.1, f"{name}: packet x std within 10% ({sk:.5f} vs {sx:.5f})")
        else:
            # different RNG streams and atomic tally order: both conserve
            # energy to f32 summation order, and the x profiles agree within
            # Monte Carlo noise (8 slabs of ~50k packets each at full size)
            check(kres["gate_value"] < 1e-5 and xres["gate_value"] < 1e-5,
                  f"{name}: energy conserved to f32 summation order "
                  f"({kres['gate_value']:.3g}, {xres['gate_value']:.3g})")
            pk, px = x_profile(ksim), x_profile(xsim)
            d = abs(pk - px).sum() / px.sum()
            check(d < 0.02, f"{name}: tally x profile within 2% L1 ({d:.4f})")


def phase_gpu_tests():
    """The tests marked ``gpu`` (they skip on the CPU), run in this process so
    that no second process opens the card."""
    import pytest

    log("phase gpu tests: pytest -m gpu")
    rc = pytest.main([os.path.join(HERE, "tests"), "-m", "gpu", "-q", "-p", "no:cacheprovider"])
    check(rc == 0, f"gpu-marked tests pass (pytest exit {int(rc)})")


def phase_determinism(bench):
    """Step one state twice on each census path and compare bitwise."""
    import jax
    import numpy as np

    log("phase determinism: the same state stepped twice")
    for mode in ("on", "off"):
        sim = bench.make_sim(bench.CELLS["stepdiff"], **{"jaybenne/use_pallas": mode})
        dt = sim.dtype(sim.cfg.jaybenne.dt)
        a = jax.block_until_ready(sim.step_fn(sim.state, dt))
        b = jax.block_until_ready(sim.step_fn(sim.state, dt))
        la = jax.tree_util.tree_leaves_with_path(a)
        lb = jax.tree.leaves(b)
        diff = [
            jax.tree_util.keystr(k)
            for (k, x), y in zip(la, lb)
            if not np.array_equal(np.asarray(x), np.asarray(y))
        ]
        log(f"  use_pallas={mode}: {'bitwise identical' if not diff else 'differs in ' + ', '.join(diff)}")


def phase_four(bench):
    """Particle-sharded stepdiff and spatial 64^3 feedback on four GPUs,
    each against its one-GPU run."""
    import jax
    import numpy as np

    if len(jax.devices()) < 4:
        fail(f"--four needs 4 GPUs, JAX sees {len(jax.devices())}")
    log("phase four: particle-sharded stepdiff, spatial 64^3 feedback")
    one, one_sim = bench.run_cell(bench.CELLS["stepdiff"], **{"jaybenne/n_devices": 1})
    report(one)
    four, four_sim = bench.run_cell(bench.CELLS["stepdiff"], **{"jaybenne/n_devices": 4})
    report(four)
    devs = four_sim.state.particles.x.sharding.device_set
    check(len(devs) == 4, f"particle shards on {len(devs)} distinct GPUs")
    check(one["gate_pass"] and four["gate_pass"],
          f"stepdiff erf gate on 1 and 4 GPUs ({one['gate_value']:.4g}, {four['gate_value']:.4g})")

    fb = bench.CELLS["feedback64"]
    r1, s1 = bench.run_cell(fb)
    report(r1)
    r4, s4 = bench.run_cell(
        fb, **{"jaybenne/decomposition": "spatial", "jaybenne/n_devices": 4}
    )
    report(r4)
    devs = s4.state.fields.u.sharding.device_set
    check(len(devs) == 4, f"spatial field shards on {len(devs)} distinct GPUs")
    check(r4["gate_pass"], f"spatial 64^3 energy conservation ({r4['gate_value']:.3g})")
    p1, p4 = x_profile(s1), x_profile(s4)
    d = abs(p1 - p4).sum() / p1.sum()
    check(d < 0.02, f"spatial vs one-GPU tally x profile within 2% L1 ({d:.4f})")
    rounds = [h["migration_rounds"] for h in s4.history]
    migrated = sum(h["migrated"] for h in s4.history)
    alive = np.mean([h["alive"] for h in s4.history])
    log(f"  spatial: migration rounds per step {rounds}, "
        f"packets migrated per live packet per step {migrated / len(rounds) / alive:.4f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU decompositions and their one-GPU baselines")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        fail(f"no GPU: JAX's backend is {jax.default_backend()!r}")
    import bench
    from jaybenne_tpu import compile_cache_dir

    info = bench.device_info()
    log(f"card: {info['nvidia_smi']}")
    log(f"jax: {jax.__version__}, {info['count']} x {info['kind']}")
    cache = compile_cache_dir()
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"compile cache: {cache} ({n_cached} entries at start)")
    t0 = time.perf_counter()
    if args.four:
        phase_four(bench)
    else:
        runs = phase_decks(bench)
        phase_compare(bench, runs)
        phase_gpu_tests()
        phase_determinism(bench)
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"compile cache: {n_cached} entries at end; total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {"platform": info["platform"], "kind": info["kind"], "count": info["count"]},
    }))


if __name__ == "__main__":
    main()
