// Iso-surface extraction (marching tetrahedra) — native CPU extension.
//
// TPU-native replacement for the reference's torchmcubes CUDA extension
// (reference nerf2mesh.py:13, 98-99): the density grid is produced on
// TPU by a chunked forward sweep; this extension turns it into a
// triangle mesh on the host.  Marching tetrahedra (each cell split into
// 6 tets around the 0-6 diagonal) is used instead of classic marching
// cubes: the case analysis is derivable from first principles (no
// copied edge/triangle tables) and produces a crack-free surface.
//
// C ABI (ctypes-friendly):
//   mc_extract(grid, nx, ny, nz, iso, &verts, &nverts, &tris, &ntris,
//              &keys)
//     grid   : float32[nx*ny*nz], index (i, j, k) -> i*ny*nz + j*nz + k
//     verts  : malloc'd float32[nverts*3] in grid-index coordinates
//     tris   : malloc'd int32[ntris*3]
//     keys   : malloc'd int64[nverts] — canonical grid-edge id per
//              vertex (lo*ncells + hi over the edge's two endpoint
//              linear indices).  Every emitted vertex lies on a lattice
//              edge and the interpolation is a pure function of the two
//              endpoints, so equal key <=> bit-identical position:
//              the caller welds with a 1-D int64 unique instead of a
//              lexsort over float rows (~100x faster at 256^3).
//   mc_free(ptr) releases the returned buffers.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libmarching.so marching.cpp -lpthread

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// Cube-corner offsets, index by corner id 0..7 (binary zyx).
static const int CORNER[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// Six-tetrahedron decomposition of the cube around the 0-6 diagonal.
static const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

struct Chunk {
  std::vector<float> verts;   // xyz triples
  std::vector<int32_t> tris;  // indices into verts/3 (local)
  std::vector<int64_t> keys;  // canonical edge id per vertex
  int64_t ncells = 0;         // nx*ny*nz, for key packing
};

struct EV {
  V3 p;
  int64_t key;
};

inline EV lerp_edge(const V3 *a, const V3 *b, float va, float vb, float iso,
                    int64_t ia, int64_t ib, int64_t ncells) {
  // Canonical endpoint order: both tets sharing an edge produce the
  // same key AND compute the interpolation from the same ordered pair,
  // so shared-edge vertices are bit-identical, not merely close.
  if (ia > ib) {
    std::swap(a, b);
    std::swap(va, vb);
    std::swap(ia, ib);
  }
  float denom = vb - va;
  float t = (denom == 0.0f) ? 0.5f : (iso - va) / denom;
  if (t < 0.0f) t = 0.0f;
  if (t > 1.0f) t = 1.0f;
  return EV{V3{a->x + t * (b->x - a->x), a->y + t * (b->y - a->y),
               a->z + t * (b->z - a->z)},
            ia * ncells + ib};
}

inline void emit_tri(Chunk &c, const EV &p0, const EV &p1, const EV &p2) {
  int32_t base = static_cast<int32_t>(c.verts.size() / 3);
  const EV *ps[3] = {&p0, &p1, &p2};
  for (int i = 0; i < 3; ++i) {
    c.verts.push_back(ps[i]->p.x);
    c.verts.push_back(ps[i]->p.y);
    c.verts.push_back(ps[i]->p.z);
    c.keys.push_back(ps[i]->key);
  }
  c.tris.push_back(base);
  c.tris.push_back(base + 1);
  c.tris.push_back(base + 2);
}

// Process one tetrahedron: corners p[4] with values v[4] and linear
// grid indices gidx[4].
inline void do_tet(Chunk &c, const V3 p[4], const float v[4],
                   const int64_t gidx[4], float iso) {
  int mask = 0;
  for (int i = 0; i < 4; ++i)
    if (v[i] > iso) mask |= (1 << i);
  if (mask == 0 || mask == 15) return;

  // Collect the inside/outside split; by symmetry handle mask and ~mask
  // identically (winding is normalised afterwards by the caller if
  // needed; viewers here are winding-agnostic).
  int inside[4], outside[4];
  int ni = 0, no = 0;
  for (int i = 0; i < 4; ++i) {
    if (mask & (1 << i)) inside[ni++] = i;
    else outside[no++] = i;
  }

  const int64_t nc = c.ncells;
  if (ni == 1) {
    // One vertex inside: single triangle on its three edges.
    int a = inside[0];
    EV q0 = lerp_edge(&p[a], &p[outside[0]], v[a], v[outside[0]], iso,
                      gidx[a], gidx[outside[0]], nc);
    EV q1 = lerp_edge(&p[a], &p[outside[1]], v[a], v[outside[1]], iso,
                      gidx[a], gidx[outside[1]], nc);
    EV q2 = lerp_edge(&p[a], &p[outside[2]], v[a], v[outside[2]], iso,
                      gidx[a], gidx[outside[2]], nc);
    emit_tri(c, q0, q1, q2);
  } else if (no == 1) {
    int a = outside[0];
    EV q0 = lerp_edge(&p[a], &p[inside[0]], v[a], v[inside[0]], iso,
                      gidx[a], gidx[inside[0]], nc);
    EV q1 = lerp_edge(&p[a], &p[inside[1]], v[a], v[inside[1]], iso,
                      gidx[a], gidx[inside[1]], nc);
    EV q2 = lerp_edge(&p[a], &p[inside[2]], v[a], v[inside[2]], iso,
                      gidx[a], gidx[inside[2]], nc);
    emit_tri(c, q0, q1, q2);
  } else {
    // Two inside, two outside: quad across four crossing edges.
    int a0 = inside[0], a1 = inside[1];
    int b0 = outside[0], b1 = outside[1];
    EV q00 = lerp_edge(&p[a0], &p[b0], v[a0], v[b0], iso,
                       gidx[a0], gidx[b0], nc);
    EV q01 = lerp_edge(&p[a0], &p[b1], v[a0], v[b1], iso,
                       gidx[a0], gidx[b1], nc);
    EV q10 = lerp_edge(&p[a1], &p[b0], v[a1], v[b0], iso,
                       gidx[a1], gidx[b0], nc);
    EV q11 = lerp_edge(&p[a1], &p[b1], v[a1], v[b1], iso,
                       gidx[a1], gidx[b1], nc);
    emit_tri(c, q00, q01, q11);
    emit_tri(c, q00, q11, q10);
  }
}

void process_slab(const float *grid, int nx, int ny, int nz, float iso,
                  int x0, int x1, Chunk *out) {
  const int64_t sy = nz;
  const int64_t sx = static_cast<int64_t>(ny) * nz;
  out->ncells = static_cast<int64_t>(nx) * ny * nz;
  for (int i = x0; i < x1; ++i) {
    for (int j = 0; j < ny - 1; ++j) {
      for (int k = 0; k < nz - 1; ++k) {
        float val[8];
        V3 pos[8];
        int64_t idx[8];
        bool any_in = false, any_out = false;
        for (int ci = 0; ci < 8; ++ci) {
          int gi = i + CORNER[ci][0];
          int gj = j + CORNER[ci][1];
          int gk = k + CORNER[ci][2];
          idx[ci] = gi * sx + gj * sy + gk;
          val[ci] = grid[idx[ci]];
          pos[ci] = V3{(float)gi, (float)gj, (float)gk};
          if (val[ci] > iso) any_in = true;
          else any_out = true;
        }
        if (!any_in || !any_out) continue;  // fast reject
        for (int t = 0; t < 6; ++t) {
          V3 tp[4];
          float tv[4];
          int64_t ti[4];
          for (int q = 0; q < 4; ++q) {
            tp[q] = pos[TETS[t][q]];
            tv[q] = val[TETS[t][q]];
            ti[q] = idx[TETS[t][q]];
          }
          do_tet(*out, tp, tv, ti, iso);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int64_t mc_extract(const float *grid, int nx, int ny, int nz, float iso,
                   float **verts_out, int64_t *nverts_out, int32_t **tris_out,
                   int64_t *ntris_out, int64_t **keys_out) {
  if (nx < 2 || ny < 2 || nz < 2) return -1;
  int nthreads = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > nx - 1) nthreads = nx - 1;

  std::vector<Chunk> chunks(nthreads);
  std::vector<std::thread> threads;
  int per = (nx - 1 + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int x0 = t * per;
    int x1 = x0 + per;
    if (x1 > nx - 1) x1 = nx - 1;
    if (x0 >= x1) {
      continue;
    }
    threads.emplace_back(process_slab, grid, nx, ny, nz, iso, x0, x1,
                         &chunks[t]);
  }
  for (auto &th : threads) th.join();

  int64_t total_v = 0, total_t = 0;
  for (auto &c : chunks) {
    total_v += static_cast<int64_t>(c.verts.size() / 3);
    total_t += static_cast<int64_t>(c.tris.size() / 3);
  }
  float *verts =
      static_cast<float *>(std::malloc(sizeof(float) * 3 * (total_v ? total_v : 1)));
  int32_t *tris = static_cast<int32_t *>(
      std::malloc(sizeof(int32_t) * 3 * (total_t ? total_t : 1)));
  int64_t *keys = static_cast<int64_t *>(
      std::malloc(sizeof(int64_t) * (total_v ? total_v : 1)));
  if (!verts || !tris || !keys) {
    std::free(verts);
    std::free(tris);
    std::free(keys);
    return -2;
  }
  int64_t voff = 0, toff = 0;
  for (auto &c : chunks) {
    std::memcpy(verts + voff * 3, c.verts.data(),
                c.verts.size() * sizeof(float));
    std::memcpy(keys + voff, c.keys.data(), c.keys.size() * sizeof(int64_t));
    int64_t nv = static_cast<int64_t>(c.verts.size() / 3);
    for (size_t q = 0; q < c.tris.size(); ++q)
      tris[toff * 3 + q] = c.tris[q] + static_cast<int32_t>(voff);
    voff += nv;
    toff += static_cast<int64_t>(c.tris.size() / 3);
  }
  *verts_out = verts;
  *tris_out = tris;
  *keys_out = keys;
  *nverts_out = total_v;
  *ntris_out = total_t;
  return 0;
}

void mc_free(void *p) { std::free(p); }

}  // extern "C"
