// Native mesh-forest builder.
//
// The reference delegates all host-side mesh graph construction (block forest,
// static refinement, 2:1 balance, neighbor/ownership structure) to Parthenon's
// C++ Mesh machinery (SURVEY §2c). This is the native equivalent: a small
// C++ runtime component that builds the block forest and the finest-granularity
// position->block lookup grid consumed by the JAX kernels. Loaded from Python via
// ctypes (jaybenne_tpu/mesh.py), with a pure-Python fallback producing identical
// output (cross-checked in tests/test_native.py).
//
// Semantics (matching Parthenon static refinement as exercised by
// inputs/stepdiff_smr*.in):
//   * root blocks covering the domain are split into 2^ndim children while their
//     extent overlaps a refinement region whose level exceeds theirs;
//   * 2:1 balance: any block touching (face/edge/corner) a block >=2 levels finer
//     is split, to fixpoint;
//   * blocks are ordered by (level, z, y, x logical location);
//   * the lookup grid tiles the domain at finest-block granularity and maps each
//     tile to its owning block id.
//
// Build: native/build.sh  (g++ -O2 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Block {
  int level;
  long lx, ly, lz;  // logical location in level-granularity units
};

struct Ctx {
  int ndim;
  long nrb[3];
  double gmin[3], gmax[3], root_size[3];
};

void block_bounds(const Ctx& c, const Block& b, double bmin[3], double bmax[3]) {
  const long loc[3] = {b.lx, b.ly, b.lz};
  for (int d = 0; d < 3; ++d) {
    const double size =
        c.root_size[d] / (d < c.ndim ? double(1L << b.level) : 1.0);
    bmin[d] = c.gmin[d] + loc[d] * size;
    bmax[d] = bmin[d] + size;
  }
}

bool intersects(const Ctx& c, const Block& b, const double* r /* 6 bounds */) {
  double bmin[3], bmax[3];
  block_bounds(c, b, bmin, bmax);
  for (int d = 0; d < c.ndim; ++d) {
    if (bmax[d] <= r[2 * d] || bmin[d] >= r[2 * d + 1]) return false;
  }
  return true;
}

bool touches(const Ctx& c, const Block& a, const Block& b) {
  double amin[3], amax[3], bmin[3], bmax[3];
  block_bounds(c, a, amin, amax);
  block_bounds(c, b, bmin, bmax);
  for (int d = 0; d < c.ndim; ++d) {
    const double eps = 1e-9 * c.root_size[d];
    if (amax[d] < bmin[d] - eps || amin[d] > bmax[d] + eps) return false;
  }
  return true;
}

void split(const Ctx& c, const Block& b, std::vector<Block>& out) {
  const int sx = 2, sy = c.ndim > 1 ? 2 : 1, sz = c.ndim > 2 ? 2 : 1;
  for (int cz = 0; cz < sz; ++cz)
    for (int cy = 0; cy < sy; ++cy)
      for (int cx = 0; cx < sx; ++cx)
        out.push_back(
            {b.level + 1, 2 * b.lx + cx, 2 * b.ly + cy, 2 * b.lz + cz});
}

std::vector<Block> build_forest(const Ctx& c, int n_regions,
                                const double* regions /* [n][7] */) {
  std::vector<Block> blocks;
  for (long iz = 0; iz < c.nrb[2]; ++iz)
    for (long iy = 0; iy < c.nrb[1]; ++iy)
      for (long ix = 0; ix < c.nrb[0]; ++ix) blocks.push_back({0, ix, iy, iz});

  // refine to requested levels
  bool changed = true;
  while (changed) {
    changed = false;
    std::vector<Block> out;
    out.reserve(blocks.size());
    for (const auto& b : blocks) {
      bool needs = false;
      for (int r = 0; r < n_regions; ++r) {
        const double* reg = regions + 7 * r;
        const int level = int(reg[0]);
        if (b.level < level && intersects(c, b, reg + 1)) {
          needs = true;
          break;
        }
      }
      if (needs) {
        split(c, b, out);
        changed = true;
      } else {
        out.push_back(b);
      }
    }
    blocks.swap(out);
  }

  // 2:1 balance
  changed = true;
  while (changed) {
    changed = false;
    std::vector<Block> out;
    out.reserve(blocks.size());
    for (size_t i = 0; i < blocks.size(); ++i) {
      bool needs = false;
      for (size_t j = 0; j < blocks.size(); ++j) {
        if (i == j) continue;
        if (blocks[j].level > blocks[i].level + 1 &&
            touches(c, blocks[i], blocks[j])) {
          needs = true;
          break;
        }
      }
      if (needs) {
        split(c, blocks[i], out);
        changed = true;
      } else {
        out.push_back(blocks[i]);
      }
    }
    blocks.swap(out);
  }

  std::sort(blocks.begin(), blocks.end(), [](const Block& a, const Block& b) {
    if (a.level != b.level) return a.level < b.level;
    if (a.lz != b.lz) return a.lz < b.lz;
    if (a.ly != b.ly) return a.ly < b.ly;
    return a.lx < b.lx;
  });
  return blocks;
}

}  // namespace

extern "C" {

// Phase 1: query sizes. Returns n_blocks; writes max_level.
int jb_mesh_query(int ndim, long nrbx, long nrby, long nrbz, const double* gmin,
                  const double* gmax, int n_regions, const double* regions,
                  int* max_level_out) {
  Ctx c{ndim, {nrbx, nrby, nrbz}, {}, {}, {}};
  for (int d = 0; d < 3; ++d) {
    c.gmin[d] = gmin[d];
    c.gmax[d] = gmax[d];
    c.root_size[d] = (gmax[d] - gmin[d]) / double(c.nrb[d]);
  }
  auto blocks = build_forest(c, n_regions, regions);
  int max_level = 0;
  for (const auto& b : blocks) max_level = std::max(max_level, b.level);
  *max_level_out = max_level;
  return int(blocks.size());
}

// Phase 2: fill caller-allocated buffers.
//   origin  [n_blocks*3] doubles (x, y, z lower corner)
//   size    [n_blocks*3] doubles (block physical extent)
//   level   [n_blocks]   ints
//   lookup  [ntz*nty*ntx] ints, where nt{x,y,z} = nrb * 2^max_level (active dims)
// Returns 0 on success.
int jb_mesh_fill(int ndim, long nrbx, long nrby, long nrbz, const double* gmin,
                 const double* gmax, int n_regions, const double* regions,
                 double* origin, double* size, int* level, int* lookup) {
  Ctx c{ndim, {nrbx, nrby, nrbz}, {}, {}, {}};
  for (int d = 0; d < 3; ++d) {
    c.gmin[d] = gmin[d];
    c.gmax[d] = gmax[d];
    c.root_size[d] = (gmax[d] - gmin[d]) / double(c.nrb[d]);
  }
  auto blocks = build_forest(c, n_regions, regions);
  int max_level = 0;
  for (const auto& b : blocks) max_level = std::max(max_level, b.level);

  long nt[3];
  for (int d = 0; d < 3; ++d)
    nt[d] = c.nrb[d] * (d < ndim ? (1L << max_level) : 1);

  for (long t = 0; t < nt[0] * nt[1] * nt[2]; ++t) lookup[t] = -1;

  for (size_t bid = 0; bid < blocks.size(); ++bid) {
    const auto& b = blocks[bid];
    double bmin[3], bmax[3];
    block_bounds(c, b, bmin, bmax);
    for (int d = 0; d < 3; ++d) {
      origin[3 * bid + d] = bmin[d];
      size[3 * bid + d] = bmax[d] - bmin[d];
    }
    level[bid] = b.level;
    long mult[3], start[3];
    const long loc[3] = {b.lx, b.ly, b.lz};
    for (int d = 0; d < 3; ++d) {
      mult[d] = d < ndim ? (1L << (max_level - b.level)) : 1;
      start[d] = loc[d] * mult[d];
    }
    for (long tz = start[2]; tz < start[2] + mult[2]; ++tz)
      for (long ty = start[1]; ty < start[1] + mult[1]; ++ty)
        for (long tx = start[0]; tx < start[0] + mult[0]; ++tx)
          lookup[(tz * nt[1] + ty) * nt[0] + tx] = int(bid);
  }

  for (long t = 0; t < nt[0] * nt[1] * nt[2]; ++t)
    if (lookup[t] < 0) return 1;  // uncovered tile
  return 0;
}

}  // extern "C"
