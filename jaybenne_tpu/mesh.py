"""Block-structured Cartesian mesh with optional static refinement (SMR).

JAX replacement for the Parthenon ``Mesh``/``MeshBlock`` layer the reference
consumes (SURVEY §2c): pointer-rich per-block objects become

  * dense per-variable field arrays of shape ``[n_blocks, nz, ny, nx]`` (every block
    has the same logical cell count, exactly as in Parthenon),
  * flat metadata arrays (origin, cell size, level) indexed by block id,
  * a finest-granularity **block lookup grid** mapping a physical position to the block
    that owns it in O(1).

The lookup grid replaces Parthenon's neighbor tables *and* its swarm communication
routing (``GetNeighborBlockIndex``, ``src/jaybenne/transport.cpp:150``): a particle
that steps off a block is re-homed by locating its position, which uniformly handles
same-level, coarse->fine and fine->coarse (2:1) transitions as well as periodic
wrap-around — there is no sentinel/post-comms pass.

Axis convention: physical axes are (x1, x2, x3) = (x, y, z); cell arrays are indexed
``[block, k, j, i]`` with i fastest (same as the reference's dumps).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .config import MeshConfig, RefinementRegion
from .utils.tree import pytree_dataclass, static


@pytree_dataclass
class MeshGeometry:
    # ---- static metadata (hashable; identical on every device) ----
    ndim: int = static()
    nx: int = static()           # cells per block, x1
    ny: int = static()           # cells per block, x2
    nz: int = static()           # cells per block, x3
    n_blocks: int = static()
    max_level: int = static()
    bounds: tuple = static()     # (x1min, x1max, x2min, x2max, x3min, x3max)
    tile_shape: tuple = static() # lookup grid dims (ntz, nty, ntx)
    root_grid: tuple = static()  # root blocks per dim (nrb3, nrb2, nrb1)
    finest: tuple = static()     # finest cell size per axis (dx, dy, dz)
    # ---- device arrays ----
    block_origin: jnp.ndarray    # f[B, 3] lower corner (x, y, z)
    block_dx: jnp.ndarray        # f[B, 3] cell size (dx, dy, dz)
    block_level: jnp.ndarray     # i32[B]
    lookup: jnp.ndarray          # i32[ntz, nty, ntx] -> block id

    @property
    def ncells_per_block(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def total_cells(self) -> int:
        return self.n_blocks * self.ncells_per_block

    @property
    def block_volume(self):
        """Cell volume per block, f[B] (Cartesian: dx*dy*dz; inactive dims carry the
        full domain extent, matching ``UniformCartesian::Volume<CC>``)."""
        return jnp.prod(self.block_dx, axis=1)

    def flat_cell(self, b, k, j, i):
        """Global flat cell index for segment reductions."""
        return ((b * self.nz + k) * self.ny + j) * self.nx + i

    @property
    def block_meta(self):
        """Packed per-block geometry ``[B, 6] = (dx, dy, dz, ox, oy, oz)``: lets the
        event loop fetch cell size AND origin with ONE row gather per particle.
        Built lazily inside jit; XLA hoists it out of the census loop."""
        return jnp.concatenate([self.block_dx, self.block_origin], axis=1)

    def cell_centers(self):
        """Physical cell-center coordinate arrays (xc, yc, zc), each f[B, nz, ny, nx]."""
        ii = jnp.arange(self.nx)
        jj = jnp.arange(self.ny)
        kk = jnp.arange(self.nz)
        ox = self.block_origin[:, 0][:, None, None, None]
        oy = self.block_origin[:, 1][:, None, None, None]
        oz = self.block_origin[:, 2][:, None, None, None]
        dx = self.block_dx[:, 0][:, None, None, None]
        dy = self.block_dx[:, 1][:, None, None, None]
        dz = self.block_dx[:, 2][:, None, None, None]
        shape = (self.n_blocks, self.nz, self.ny, self.nx)
        xc = ox + (jnp.broadcast_to(ii[None, None, None, :], shape) + 0.5) * dx
        yc = oy + (jnp.broadcast_to(jj[None, None, :, None], shape) + 0.5) * dy
        zc = oz + (jnp.broadcast_to(kk[None, :, None, None], shape) + 0.5) * dz
        return xc, yc, zc

    # -------------------------------------------------------------- locate
    def locate_block(self, x, y, z):
        """Vectorized position -> owning block id (positions must be inside the
        domain; callers apply boundary conditions first)."""
        x1min, _, x2min, _, x3min, _ = self.bounds
        ntz, nty, ntx = self.tile_shape
        tsx, tsy, tsz = self._tile_sizes()
        tx = jnp.clip(jnp.floor((x - x1min) / tsx).astype(jnp.int32), 0, ntx - 1)
        ty = jnp.clip(jnp.floor((y - x2min) / tsy).astype(jnp.int32), 0, nty - 1)
        tz = jnp.clip(jnp.floor((z - x3min) / tsz).astype(jnp.int32), 0, ntz - 1)
        return self.lookup[tz, ty, tx]

    def _tile_sizes(self):
        x1min, x1max, x2min, x2max, x3min, x3max = self.bounds
        ntz, nty, ntx = self.tile_shape
        return (
            (x1max - x1min) / ntx,
            (x2max - x2min) / nty,
            (x3max - x3min) / ntz,
        )

    def cell_of_local(self, b, lx, ly, lz):
        """Cell indices (i, j, k) of a block-local position, clamped to the interior.

        Clamping resolves the at-face ambiguity of a just-migrated particle in favor of
        the boundary cell, which is always the correct entry cell (the particle entered
        through that face)."""
        dx = self.block_dx[b]
        i = jnp.clip(jnp.floor(lx / dx[..., 0]).astype(jnp.int32), 0, self.nx - 1)
        j = jnp.clip(jnp.floor(ly / dx[..., 1]).astype(jnp.int32), 0, self.ny - 1)
        k = jnp.clip(jnp.floor(lz / dx[..., 2]).astype(jnp.int32), 0, self.nz - 1)
        return i, j, k


# ------------------------------------------------------------------ construction
def _intersects(bmin, bmax, rmin, rmax, ndim) -> bool:
    for d in range(ndim):
        if bmax[d] <= rmin[d] or bmin[d] >= rmax[d]:
            return False
    return True


def build_mesh(cfg: MeshConfig, dtype=jnp.float32, use_native=True) -> MeshGeometry:
    """Construct the block forest from a mesh config.

    Mirrors Parthenon's static-refinement semantics as exercised by the reference decks
    (``inputs/stepdiff_smr_hybrid.in``): root blocks overlapping a
    ``<parthenon/static_refinement*>`` box are refined (splitting into 2^ndim children)
    until they reach the requested level, then 2:1 balance is enforced by refining
    coarse blocks adjacent to much finer ones.

    The forest construction runs in the native C++ builder
    (``jaybenne_tpu/native/libjbmesh.so``, source ``native/mesh_builder.cc``) when
    available — the runtime analog of Parthenon's C++ Mesh machinery — with this
    module's pure-Python implementation as the bitwise-identical fallback.
    """
    nz_b, ny_b, nx_b = cfg.block_shape
    for n_tot, n_blk, name in (
        (cfg.nx1, nx_b, "nx1"),
        (cfg.nx2, ny_b, "nx2"),
        (cfg.nx3, nz_b, "nx3"),
    ):
        if n_tot % n_blk != 0:
            raise ValueError(f"mesh {name}={n_tot} not divisible by meshblock {n_blk}")

    ndim = cfg.ndim
    nrb = (cfg.nx1 // nx_b, cfg.nx2 // ny_b, cfg.nx3 // nz_b)  # root blocks (x, y, z)
    gmin = (cfg.x1min, cfg.x2min, cfg.x3min)
    gmax = (cfg.x1max, cfg.x2max, cfg.x3max)
    root_size = tuple((gmax[d] - gmin[d]) / nrb[d] for d in range(3))

    regions_cfg: tuple[RefinementRegion, ...] = (
        cfg.refinement_regions if cfg.refinement == "static" else ()
    )
    if use_native:
        from . import native as native_mod

        built = native_mod.build_forest_native(ndim, nrb, gmin, gmax, regions_cfg)
        if built is not None:
            origin, size, levels, lookup, max_level = built
            n_blocks = origin.shape[0]
            bdx = size / np.asarray([(nx_b, ny_b, nz_b)], dtype=np.float64)
            nt = lookup.shape
            return MeshGeometry(
                ndim=ndim,
                nx=nx_b, ny=ny_b, nz=nz_b,
                n_blocks=n_blocks,
                max_level=max_level,
                bounds=(cfg.x1min, cfg.x1max, cfg.x2min, cfg.x2max, cfg.x3min, cfg.x3max),
                tile_shape=(nt[0], nt[1], nt[2]),
                root_grid=(nrb[2], nrb[1], nrb[0]),
                finest=tuple(float(v) for v in bdx.min(axis=0)),
                block_origin=jnp.asarray(origin, dtype=dtype),
                block_dx=jnp.asarray(bdx, dtype=dtype),
                block_level=jnp.asarray(levels),
                lookup=jnp.asarray(lookup),
            )

    # block = (level, (lx, ly, lz)) with logical location in level-granularity units
    blocks = [
        (0, (ix, iy, iz))
        for iz in range(nrb[2])
        for iy in range(nrb[1])
        for ix in range(nrb[0])
    ]

    def block_bounds(level, loc):
        size = [root_size[d] / (2**level if d < ndim else 1) for d in range(3)]
        bmin = [gmin[d] + loc[d] * size[d] for d in range(3)]
        bmax = [bmin[d] + size[d] for d in range(3)]
        return bmin, bmax

    def split(level, loc):
        children = []
        steps = [range(2) if d < ndim else range(1) for d in range(3)]
        for cz in steps[2]:
            for cy in steps[1]:
                for cx in steps[0]:
                    children.append(
                        (level + 1, (2 * loc[0] + cx, 2 * loc[1] + cy, 2 * loc[2] + cz))
                    )
        return children

    regions = regions_cfg

    # refine to requested levels
    changed = True
    while changed:
        changed = False
        out = []
        for level, loc in blocks:
            bmin, bmax = block_bounds(level, loc)
            needs = any(
                level < r.level
                and _intersects(
                    bmin,
                    bmax,
                    (r.x1min, r.x2min, r.x3min),
                    (r.x1max, r.x2max, r.x3max),
                    ndim,
                )
                for r in regions
            )
            if needs:
                out.extend(split(level, loc))
                changed = True
            else:
                out.append((level, loc))
        blocks = out

    # enforce 2:1 balance (face/edge/corner neighbors differ by at most one level)
    def touches(a, b):
        (la, loca), (lb, locb) = a, b
        amin, amax = block_bounds(la, loca)
        bmin, bmax = block_bounds(lb, locb)
        eps = [1e-9 * root_size[d] for d in range(3)]
        for d in range(ndim):
            if amax[d] < bmin[d] - eps[d] or amin[d] > bmax[d] + eps[d]:
                return False
        return True

    changed = True
    while changed:
        changed = False
        out = []
        for a in blocks:
            if any(b[0] > a[0] + 1 and touches(a, b) for b in blocks if b is not a):
                out.extend(split(*a))
                changed = True
            else:
                out.append(a)
        blocks = out

    # deterministic ordering: by level, then z, y, x logical location
    blocks.sort(key=lambda t: (t[0], t[1][2], t[1][1], t[1][0]))
    n_blocks = len(blocks)

    max_level = max(l for l, _ in blocks)
    origin = np.zeros((n_blocks, 3))
    bdx = np.zeros((n_blocks, 3))
    levels = np.zeros((n_blocks,), dtype=np.int32)
    for bid, (level, loc) in enumerate(blocks):
        bmin, bmax = block_bounds(level, loc)
        origin[bid] = bmin
        ncell = (nx_b, ny_b, nz_b)
        bdx[bid] = [(bmax[d] - bmin[d]) / ncell[d] for d in range(3)]
        levels[bid] = level

    # finest-granularity lookup grid
    nt = [nrb[d] * (2**max_level if d < ndim else 1) for d in range(3)]
    lookup = np.full((nt[2], nt[1], nt[0]), -1, dtype=np.int32)
    for bid, (level, loc) in enumerate(blocks):
        mult = [2 ** (max_level - level) if d < ndim else 1 for d in range(3)]
        sx, sy, sz = (loc[d] * mult[d] for d in range(3))
        lookup[
            sz : sz + mult[2], sy : sy + mult[1], sx : sx + mult[0]
        ] = bid
    if (lookup < 0).any():
        raise RuntimeError("mesh construction left uncovered lookup tiles")

    return MeshGeometry(
        ndim=ndim,
        nx=nx_b,
        ny=ny_b,
        nz=nz_b,
        n_blocks=n_blocks,
        max_level=max_level,
        bounds=(cfg.x1min, cfg.x1max, cfg.x2min, cfg.x2max, cfg.x3min, cfg.x3max),
        tile_shape=(nt[2], nt[1], nt[0]),
        root_grid=(nrb[2], nrb[1], nrb[0]),
        finest=tuple(float(v) for v in bdx.min(axis=0)),
        block_origin=jnp.asarray(origin, dtype=dtype),
        block_dx=jnp.asarray(bdx, dtype=dtype),
        block_level=jnp.asarray(levels),
        lookup=jnp.asarray(lookup),
    )
