"""Regression-test harness.

Reimplements the reference harness's semantics (``/root/reference/tst/regression_test.py``):

  * ``analytic_comparison``: run a problem from an input deck (with in-place
    parameter mutation), load the LAST dump, and compare a variable against a
    closed-form ``solution(t, x, y, z)`` per cell with ``pointwise`` / ``mean`` /
    ``weighted_mean`` criteria (reference ``:320-445``);
  * ``gold_comparison``: compare against committed ``.gold`` arrays with ``--upgold``
    regeneration (reference ``:450-548``);
  * ``soft_equiv`` and the default CLI argument surface.

Instead of building and shelling out to an ``mcblock`` executable, problems run
in-process through ``jaybenne_tpu.driver`` (there is nothing to compile); the
``--use_mpiexec/--mpi_nthreads`` flags of the reference map to ``--n_devices``, which
runs the problem on a sharded device mesh (virtual CPU devices in CI).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "analysis"))

def soft_equiv(val, ref, tol=1.0e-5):
    """Fractional comparison with an absolute floor (reference ``:45-52``)."""
    numerator = np.fabs(val - ref)
    denominator = max(np.fabs(ref), 1.0e-10)
    return numerator / denominator <= tol


def get_default_parser():
    parser = argparse.ArgumentParser(description="jaybenne_tpu regression test")
    parser.add_argument("--input", type=str, default=None, help="input deck name")
    parser.add_argument(
        "--comparison",
        type=str,
        default="weighted_mean",
        choices=["pointwise", "mean", "weighted_mean"],
    )
    parser.add_argument("--n_devices", type=int, default=1,
                        help="shard the run over N devices (0 = all available)")
    parser.add_argument("--cleanup", action="store_true", default=True)
    parser.add_argument("--no-cleanup", dest="cleanup", action="store_false")
    parser.add_argument("--visualize", action="store_true", default=False)
    parser.add_argument("--upgold", action="store_true", default=False)
    parser.add_argument("--precision", type=str, default=None, choices=[None, "f32", "f64"])
    parser.add_argument(
        "--decomposition", type=str, default=None,
        choices=[None, "particle", "spatial"],
        help="distribution strategy override (deck default otherwise)",
    )
    parser.add_argument(
        "--override", action="append", default=[], metavar="block/key=value",
        help="extra deck overrides applied after the gate's pinned values "
        "(the driver CLI's override syntax)",
    )
    return parser


def _force_cpu_devices(n):
    """Under ``JAX_PLATFORMS=cpu``, give XLA N virtual CPU devices (set before
    jax initializes). On a GPU host the run uses the real cards."""
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={max(n, 1)}"
        ).strip()


def run_problem(input_file, modified_inputs, outdir, n_devices=1, precision=None,
                decomposition=None):
    _force_cpu_devices(n_devices)
    from jaybenne_tpu.driver import run_file

    mods = dict(modified_inputs or {})
    if precision:
        mods["jaybenne/precision"] = precision
    if n_devices != 1:
        mods["jaybenne/n_devices"] = n_devices
    if decomposition:
        mods["jaybenne/decomposition"] = decomposition
    sim = run_file(input_file, outdir=outdir, modified_inputs=mods, quiet=True)
    return sim


def _load_last_dump(problem_id, outdir):
    import jhdf

    from jaybenne_tpu.io import latest_dump

    return jhdf.jhdf(latest_dump(problem_id, outdir))


def _merge_overrides(args, modified_inputs):
    mods = dict(modified_inputs or {})
    for ov in getattr(args, "override", []) or []:
        k, _, v = ov.partition("=")
        mods[k] = v
    return mods


def analytic_comparison(args, variables, solutions, modified_inputs={}, tolerance=1.0e-10):
    input_file = os.path.join(_ROOT, "inputs", args.input)
    modified_inputs = _merge_overrides(args, modified_inputs)

    print("\n=== ANALYTIC COMPARISON TEST PROBLEM ===")
    print(f"= input:        {args.input}")
    print(f"= n_devices:    {args.n_devices}")
    print(f"= tolerance:    {tolerance}")
    print(f"= comparison:   {args.comparison}")
    print("========================================\n")

    outdir = tempfile.mkdtemp(prefix="jbtpu_reg_")
    try:
        sim = run_problem(
            input_file, modified_inputs, outdir,
            n_devices=args.n_devices, precision=args.precision,
            decomposition=getattr(args, "decomposition", None),
        )
        dump = _load_last_dump(sim.cfg.problem_id, outdir)
        t = dump.Time

        mean_error = 0.0
        max_error = 1.0e-100
        mean_frac_error = 0.0
        mean_frac_error_weighted = 0.0
        max_frac_error = 1.0e-100
        mean_count = 0
        weighted_norm = 0.0
        success = True

        for nv, variable_name in enumerate(variables):
            print(variable_name)
            variable = dump.Get(variable_name)
            sol = solutions[nv](t, dump.X1c, dump.X2c, dump.X3c)
            error = np.fabs(sol - variable)
            frac_error = error / np.fabs((sol + variable) / 2.0)
            mean_error += error.sum()
            max_error = max(max_error, error.max())
            mean_frac_error += frac_error.sum()
            max_frac_error = max(max_frac_error, frac_error.max())
            mean_count += error.size
            mean_frac_error_weighted += (frac_error * sol).sum()
            weighted_norm += sol.sum()
            if args.comparison == "pointwise" and (frac_error > tolerance).any():
                success = False

        mean_error /= mean_count
        mean_frac_error /= mean_count
        mean_frac_error_weighted /= weighted_norm

        print(f"Mean error:                     {mean_error:.2e}")
        print(f"Mean fractional error:          {mean_frac_error:.2e}")
        print(f"Mean weighted fractional error: {mean_frac_error_weighted:.2e}")
        print(f"Max error:                      {max_error:.2e}")
        print(f"Max fractional error:           {max_frac_error:.2e}")

        if args.comparison == "mean" and mean_frac_error > tolerance:
            success = False
        elif args.comparison == "weighted_mean" and mean_frac_error_weighted > tolerance:
            success = False

        if args.visualize:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            for nv, variable_name in enumerate(variables):
                variable = dump.Get(variable_name)
                fig, ax = plt.subplots(1, 1)
                for nb in range(dump.NumBlocks):
                    x = dump.X1c[nb, 0, 0, :]
                    ax.plot(x, solutions[nv](t, x, 0, 0))
                    ax.plot(x, variable[nb, 0, 0, :], ".")
                plt.savefig(f"analytic_compare_{variable_name}.png")
                plt.close(fig)
    finally:
        if args.cleanup:
            shutil.rmtree(outdir, ignore_errors=True)

    if success:
        print("TEST PASSED")
        return os.EX_OK
    print("TEST FAILED")
    return 1  # os.EX_SOFTWARE differs across platforms


def profile_comparison(
    args, variables, solutions, modified_inputs={}, tolerance=1.0e-10, nbins=64
):
    """Analytic comparison of the volume-weighted 1D x-profile.

    Bins every cell's value into ``nbins`` uniform x-bins (volume-weighted
    mean — the physically correct aggregation of an intensive density across
    refinement levels) and gates the weighted-mean fractional error of the
    binned profile against the solution at the bin centers.

    This is the right gate for DEEPLY refined meshes: the per-cell comparison's
    noise grows with refinement depth (a level-L cell sees 4^L fewer particles
    under uniform-per-cell sourcing), while the x-profile averages the
    transverse direction and all levels together, so the same Monte Carlo run
    supports a ~3x tighter tolerance — and a level-boundary transport bug
    still shows up as a profile distortion at the refinement box edges.
    """
    input_file = os.path.join(_ROOT, "inputs", args.input)
    modified_inputs = _merge_overrides(args, modified_inputs)

    print("\n=== ANALYTIC X-PROFILE TEST PROBLEM ===")
    print(f"= input:        {args.input}")
    print(f"= n_devices:    {args.n_devices}")
    print(f"= tolerance:    {tolerance}")
    print(f"= bins:         {nbins}")
    print("========================================\n")

    outdir = tempfile.mkdtemp(prefix="jbtpu_prof_")
    try:
        sim = run_problem(
            input_file, modified_inputs, outdir,
            n_devices=args.n_devices, precision=args.precision,
            decomposition=getattr(args, "decomposition", None),
        )
        dump = _load_last_dump(sim.cfg.problem_id, outdir)
        t = dump.Time
        x1min, x1max = float(dump.bounds[0]), float(dump.bounds[1])
        width = (x1max - x1min) / nbins

        success = True
        for nv, variable_name in enumerate(variables):
            print(variable_name)
            v = dump.Get(variable_name)
            # per-cell volumes: block dx product broadcast over the block
            vol = np.prod(dump.dx, axis=1)[:, None, None, None] * np.ones_like(v)
            bins = np.clip(
                ((dump.X1c - x1min) / width).astype(np.int64), 0, nbins - 1
            )
            num = np.bincount(bins.reshape(-1), (v * vol).reshape(-1), nbins)
            den = np.bincount(bins.reshape(-1), vol.reshape(-1), nbins)
            prof = num / np.maximum(den, 1.0e-300)
            xc = x1min + (np.arange(nbins) + 0.5) * width
            sol = solutions[nv](t, xc, 0.0, 0.0)
            frac = np.fabs(sol - prof) / np.fabs((sol + prof) / 2.0)
            werr = (frac * sol).sum() / sol.sum()
            print(f"Profile weighted fractional error: {werr:.2e}")
            print(f"Profile max fractional error:      {frac.max():.2e}")
            if werr > tolerance:
                success = False
    finally:
        if args.cleanup:
            shutil.rmtree(outdir, ignore_errors=True)

    if success:
        print("TEST PASSED")
        return os.EX_OK
    print("TEST FAILED")
    return 1


def gold_comparison(args, variables, modified_inputs={}, compression_factor=1, tolerance=0.2):
    """Compare against stored ``.gold`` arrays (regenerate with ``--upgold``)."""
    input_file = os.path.join(_ROOT, "inputs", args.input)
    modified_inputs = _merge_overrides(args, modified_inputs)
    gold_name = os.path.join(_HERE, "goldfiles", os.path.splitext(args.input)[0] + ".gold.npz")

    outdir = tempfile.mkdtemp(prefix="jbtpu_gold_")
    try:
        sim = run_problem(
            input_file, modified_inputs, outdir,
            n_devices=args.n_devices, precision=args.precision,
            decomposition=getattr(args, "decomposition", None),
        )
        dump = _load_last_dump(sim.cfg.problem_id, outdir)
        data = {}
        for variable_name in variables:
            v = dump.Get(variable_name).reshape(-1)
            if compression_factor > 1:
                v = v[:: compression_factor]
            data[variable_name] = v

        if args.upgold:
            os.makedirs(os.path.dirname(gold_name), exist_ok=True)
            np.savez_compressed(gold_name, **data)
            print(f"gold file written: {gold_name}")
            return os.EX_OK

        gold = np.load(gold_name)
        success = True
        for variable_name in variables:
            ref = gold[variable_name]
            val = data[variable_name]
            if ref.shape != val.shape:
                print(f"{variable_name}: shape mismatch {ref.shape} vs {val.shape}")
                success = False
                continue
            denom = np.maximum(np.fabs(ref), 1.0e-10)
            frac = np.fabs(val - ref) / denom
            print(f"{variable_name}: max frac diff {frac.max():.3e}")
            if (frac > tolerance).any():
                success = False
    finally:
        if args.cleanup:
            shutil.rmtree(outdir, ignore_errors=True)

    if success:
        print("TEST PASSED")
        return os.EX_OK
    print("TEST FAILED")
    return 1
