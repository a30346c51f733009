"""HDF5 dumps and checkpoint/restart.

Replaces Parthenon's ``.phdf`` output machinery (consumed by the reference's
``analysis/jhdf.py``) with a compact HDF5 schema carrying the same information:
per-block bounds/levels, cell variables ``[n_blocks, nz, ny, nx]``, and (optionally)
swarm positions. ``analysis/jhdf.py`` in this repo reads these files and presents the
same attributes the reference reader exposes (``Time``, ``NumBlocks``, ``NX1..3``,
``X1c/X2c/X3c``, ``Get(var)``).

Checkpointing (a capability the reference inherits from Parthenon restart dumps but
never exercises — SURVEY §5) is a straight dump of the full state pytree: mesh
fields + particle ledger + RNG key + counters, written with the same writer.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

try:
    import h5py

    HAVE_H5PY = True
except Exception:  # pragma: no cover
    HAVE_H5PY = False


def _require_h5py(what):
    """h5py is optional (the run itself does not need it); dump, checkpoint
    and restart paths fail with a clear message when it is missing."""
    if not HAVE_H5PY:
        raise RuntimeError(f"h5py is unavailable; cannot {what}")

# dump-variable name -> Fields attribute
VARIABLE_MAP = {
    "field.material.density": "rho",
    "field.material.sie": "sie",
    "field.material.internal_energy": "u",
    "field.jaybenne.energy_tally": "energy_tally",
    "field.jaybenne.fleck_factor": "fleck",
    "field.jaybenne.energy_delta": "energy_delta",
    "field.jaybenne.source_ew_per_cell": "source_ew",
    "field.jaybenne.source_num_per_cell": "source_num",
}


def dump_filename(problem_id: str, number: int, outdir: str = ".") -> str:
    return os.path.join(outdir, f"{problem_id}.out0.{number:05d}.phdf")


def write_dump(path, state, mesh, cfg, variables, swarm_variables=()):
    _require_h5py("write HDF5 dumps")
    f = state.fields
    with h5py.File(path, "w") as h:
        h.attrs["Time"] = float(state.t)
        h.attrs["NCycle"] = int(state.cycle)
        h.attrs["NumBlocks"] = mesh.n_blocks
        h.attrs["ndim"] = mesh.ndim
        h.attrs["NX1"] = mesh.nx
        h.attrs["NX2"] = mesh.ny
        h.attrs["NX3"] = mesh.nz
        h.attrs["bounds"] = np.asarray(mesh.bounds)
        h.create_dataset("blocks/origin", data=np.asarray(mesh.block_origin))
        h.create_dataset("blocks/dx", data=np.asarray(mesh.block_dx))
        h.create_dataset("blocks/level", data=np.asarray(mesh.block_level))
        for var in variables:
            attr = VARIABLE_MAP.get(var)
            if attr is None:
                continue
            # sharded-fields spatial runs pad the block axis for even device
            # splits; dumps carry only the real blocks
            h.create_dataset(
                f"vars/{var}", data=np.asarray(getattr(f, attr))[: mesh.n_blocks]
            )
        if swarm_variables:
            p = state.particles
            alive = np.asarray(p.alive)
            gx, gy, gz = p.global_position(mesh)
            sw = {
                "swarm.x": np.asarray(gx)[alive],
                "swarm.y": np.asarray(gy)[alive],
                "swarm.z": np.asarray(gz)[alive],
                "swarm.weight": np.asarray(p.weight)[alive],
            }
            for name in swarm_variables:
                if name in sw:
                    h.create_dataset(f"swarm/photons/{name}", data=sw[name])


def write_dump_parthenon(path, state, mesh, cfg, variables, swarm_variables=()):
    """Parthenon-binary-layout ``.phdf`` writer (``file_type = phdf_parthenon``).

    Emits the dataset/attribute structure Parthenon's HDF5 output produces
    (OutputFormatVersion 3) so the reference's analysis stack — which reads
    dumps through ``parthenon_tools.phdf`` (reference ``analysis/jhdf.py:18-27``)
    — can open this repo's output with no conversion:

      * group ``Info`` with the attrs ``phdf`` consumes (``Time``, ``NCycle``,
        ``NumDims``, ``NumMeshBlocks``, ``MeshBlockSize``, ``MaxLevel``,
        ``RootGridDomain``, ``RootGridSize``, ``Coordinates``,
        ``OutputDatasetNames``/``ComponentNames``/``NumComponents``),
      * per-block node coordinates ``Locations/{x,y,z}`` (``[B, n+1]`` — the
        source of ``phdf.BlockBounds``, which the reference's jhdf uses for
        ``DX1..3``/``X1c..3c``), cell centers ``VolumeLocations/{x,y,z}``,
      * ``Levels`` ``[B]`` and ``LogicalLocations`` ``[B, 3]`` (level-local
        integer block coordinates),
      * one float64 dataset per output variable named exactly as in the deck
        (``field.jaybenne.energy_tally`` ...), shaped ``[B, nz, ny, nx]``,
      * a group per swarm (``photons``) holding one flat dataset per swarm
        variable plus ``counts``/``offsets`` per block (particles grouped by
        owning block, as Parthenon's swarm output lays them out).

    The native compact writer (``write_dump``) stays the default; this variant
    is pure layout — both carry identical values.
    """
    _require_h5py("write HDF5 dumps")
    B = mesh.n_blocks
    nx, ny, nz = mesh.nx, mesh.ny, mesh.nz
    origin = np.asarray(mesh.block_origin, dtype=np.float64)  # [B, 3] (x, y, z)
    bdx = np.asarray(mesh.block_dx, dtype=np.float64)
    levels = np.asarray(mesh.block_level, dtype=np.int64)
    x1min, x1max, x2min, x2max, x3min, x3max = mesh.bounds
    nrb3, nrb2, nrb1 = mesh.root_grid

    names = [v for v in variables if VARIABLE_MAP.get(v)]
    with h5py.File(path, "w") as h:
        info = h.create_group("Info")
        info.attrs["OutputFormatVersion"] = np.int32(3)
        info.attrs["Time"] = np.float64(state.t)
        info.attrs["NCycle"] = np.int32(state.cycle)
        info.attrs["WallTime"] = np.float64(0.0)
        info.attrs["NumDims"] = np.int32(mesh.ndim)
        info.attrs["NumMeshBlocks"] = np.int32(B)
        info.attrs["MeshBlockSize"] = np.asarray([nx, ny, nz], dtype=np.int32)
        info.attrs["MaxLevel"] = np.int32(mesh.max_level)
        info.attrs["NGhost"] = np.int32(0)
        info.attrs["IncludesGhost"] = np.int32(0)
        info.attrs["Multilevel"] = np.int32(1 if mesh.max_level > 0 else 0)
        info.attrs["NBNew"] = np.int32(0)
        info.attrs["NBDel"] = np.int32(0)
        info.attrs["RootLevel"] = np.int32(0)
        info.attrs["Coordinates"] = "UniformCartesian"
        info.attrs["RootGridSize"] = np.asarray(
            [nrb1 * nx, nrb2 * ny, nrb3 * nz], dtype=np.int32
        )
        # (min, max, ratio) triplets per axis; uniform grids have ratio 1
        info.attrs["RootGridDomain"] = np.asarray(
            [x1min, x1max, 1.0, x2min, x2max, 1.0, x3min, x3max, 1.0],
            dtype=np.float64,
        )
        info.attrs["OutputDatasetNames"] = names
        info.attrs["ComponentNames"] = names
        info.attrs["NumComponents"] = np.ones((len(names),), dtype=np.int32)

        # node + cell-center coordinates per block
        loc = h.create_group("Locations")
        vloc = h.create_group("VolumeLocations")
        for d, (axname, n) in enumerate((("x", nx), ("y", ny), ("z", nz))):
            nodes = origin[:, d : d + 1] + bdx[:, d : d + 1] * np.arange(n + 1)
            loc.create_dataset(axname, data=nodes)
            vloc.create_dataset(axname, data=0.5 * (nodes[:, :-1] + nodes[:, 1:]))

        h.create_dataset("Levels", data=levels)
        # level-local logical block coordinates (origin offset in block
        # strides) from EXACT integer data: each block's first (minimum)
        # finest-granularity lookup-grid tile, shifted down to its own level.
        # Rounding the f32-stored origins instead can mis-round by a whole
        # fine-level stride on very large root grids / deep refinement.
        lookup = np.asarray(mesh.lookup).reshape(-1)
        order = np.argsort(lookup, kind="stable")
        first = order[np.searchsorted(lookup[order], np.arange(B))]
        tz, ty, tx = np.unravel_index(first, np.asarray(mesh.lookup).shape)
        tiles = np.stack([tx, ty, tz], axis=1).astype(np.int64)
        # refined dims shrink by 2 per level below max_level; unrefined dims
        # (d >= ndim) keep one lookup tile per root block
        shift = np.where(
            np.arange(3)[None, :] < mesh.ndim,
            np.int64(mesh.max_level) - levels[:, None],
            0,
        )
        h.create_dataset("LogicalLocations", data=tiles >> shift)
        blocks = h.create_group("Blocks")
        blocks.create_dataset("xmin", data=origin[:, : max(mesh.ndim, 1)])
        lgl = np.zeros((B, 5), dtype=np.int32)
        lgl[:, 0] = levels
        lgl[:, 1] = np.arange(B)  # gid
        lgl[:, 2] = np.arange(B)  # lid (single "rank")
        blocks.create_dataset("loc.level-gid-lid-cnghost-gflag", data=lgl)

        f = state.fields
        for var in names:
            arr = np.asarray(getattr(f, VARIABLE_MAP[var]), dtype=np.float64)
            ds = h.create_dataset(var, data=arr[:B])
            ds.attrs["ComponentNames"] = [var]

        if swarm_variables:
            p = state.particles
            alive = np.asarray(p.alive)
            gx, gy, gz = p.global_position(mesh)
            blk = np.asarray(p.block)[alive]
            order = np.argsort(blk, kind="stable")  # group particles by block
            counts = np.bincount(blk, minlength=B).astype(np.int64)
            sw = h.create_group("photons")
            sw.create_dataset("counts", data=counts)
            sw.create_dataset(
                "offsets", data=np.concatenate([[0], np.cumsum(counts)[:-1]])
            )
            cols = {
                "x": np.asarray(gx)[alive],
                "y": np.asarray(gy)[alive],
                "z": np.asarray(gz)[alive],
                "weight": np.asarray(p.weight)[alive],
                "id": np.flatnonzero(alive).astype(np.int64),
            }
            for name in ("x", "y", "z", "weight", "id"):
                want = (
                    name in ("x", "y", "z", "id")
                    or f"swarm.{name}" in swarm_variables
                )
                if want:
                    sw.create_dataset(name, data=cols[name][order])


def latest_dump(problem_id: str, outdir: str = ".") -> str:
    files = sorted(glob.glob(os.path.join(outdir, f"{problem_id}.out0.*.phdf")))
    if not files:
        raise FileNotFoundError(f"no dumps for {problem_id} in {outdir}")
    return files[-1]


# ---------------------------------------------------------------- checkpoint
def write_checkpoint(path, state, mesh, t=None, cycle=None):
    """Full-state restart dump: fields + particle ledger + RNG + counters.

    ``t``/``cycle`` override the in-state values with the driver's full-precision
    host-side counters (the state stores compute-dtype copies). Field arrays are
    saved with only the REAL blocks (a block-sharded spatial run pads the block
    axis for an even device split; the pad depends on the device count, so
    checkpoints stay portable across decompositions and device counts)."""
    _require_h5py("write checkpoints")
    B = mesh.n_blocks
    with h5py.File(path, "w") as h:
        h.attrs["Time"] = float(state.t) if t is None else float(t)
        h.attrs["NCycle"] = int(state.cycle) if cycle is None else int(cycle)
        h.attrs["overflow"] = int(state.overflow)
        for fld in dataclasses.fields(state.fields):
            h.create_dataset(
                f"fields/{fld.name}",
                data=np.asarray(getattr(state.fields, fld.name))[:B],
            )
        for fld in dataclasses.fields(state.particles):
            h.create_dataset(
                f"particles/{fld.name}",
                data=np.asarray(getattr(state.particles, fld.name)),
            )
        h.create_dataset("rng_key", data=np.asarray(state.rng_key))


def read_checkpoint_header(path):
    """(time, cycle, ledger capacity) of a checkpoint, time at full host
    precision."""
    _require_h5py("read checkpoints")
    with h5py.File(path, "r") as h:
        return (
            float(h.attrs["Time"]), int(h.attrs["NCycle"]),
            int(h["particles/alive"].shape[0]),
        )


def read_checkpoint(path, state, capacity=None):
    """Load a checkpoint into an existing state (with its ledger resized to
    ``capacity`` when given).

    Shape adaptation (device-count portability): field block axes are re-padded
    to the state's (possibly padded) length with the benign spatial-pad fill;
    the particle ledger is re-fit to the state's capacity — growing pads dead
    slots, shrinking requires every dropped slot to be dead."""
    import jax.numpy as jnp

    from .parallel.spatial import PAD_ONES as pad_ones

    _require_h5py("read checkpoints")
    with h5py.File(path, "r") as h:
        fvals = {}
        for k in h["fields"]:
            arr = np.asarray(h[f"fields/{k}"][...])
            want = getattr(state.fields, k).shape[0]
            if arr.shape[0] < want:
                fill = 1.0 if k in pad_ones else 0.0
                pad = np.full((want - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
                arr = np.concatenate([arr, pad])
            elif arr.shape[0] > want:
                # legacy checkpoint with padded blocks restored at a smaller
                # padding: the tail blocks are padding by construction
                arr = arr[:want]
            fvals[k] = jnp.asarray(arr)
        fields = dataclasses.replace(state.fields, **fvals)

        alive_saved = np.asarray(h["particles/alive"][...])
        cap = capacity or state.particles.capacity
        perm = None
        if alive_saved.shape[0] > cap:
            n_live = int(alive_saved.sum())
            if n_live > cap:
                raise ValueError(
                    f"checkpoint holds {n_live} live particles but the restart "
                    f"ledger capacity is {cap}; raise jaybenne/capacity_factor"
                )
            if alive_saved[cap:].any():
                # shrink: live slots may sit anywhere (a sharded run fills each
                # shard's slice from the front) — compact live-first, stably
                perm = np.argsort(~alive_saved, kind="stable")
        pvals = {}
        for k in h["particles"]:
            arr = np.asarray(h[f"particles/{k}"][...])
            if perm is not None:
                arr = arr[perm]
            if arr.shape[0] < cap:
                pad = np.zeros((cap - arr.shape[0],) + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, pad])
            elif arr.shape[0] > cap:
                arr = arr[:cap]
            pvals[k] = jnp.asarray(arr).astype(getattr(state.particles, k).dtype)
        particles = dataclasses.replace(state.particles, **pvals)

        return dataclasses.replace(
            state,
            fields=fields,
            particles=particles,
            t=jnp.asarray(h.attrs["Time"], dtype=state.t.dtype),
            cycle=jnp.asarray(h.attrs["NCycle"], dtype=jnp.int32),
            overflow=jnp.asarray(h.attrs["overflow"], dtype=jnp.int32),
            rng_key=jnp.asarray(h["rng_key"][...], dtype=state.rng_key.dtype),
        )
