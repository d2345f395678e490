// Forward and backward kernels of the multiresolution hash-grid encoder (the
// reference's "corner" variant), for Hopper (sm_90a).
//
// These two kernels have no TPU counterpart.  The JAX package gathers the
// hashed levels in plain jnp (ops/hash_encoding.py hash_encode and
// hash_encode_stochastic, and their autodiff scatters) and parked a Pallas
// gather kernel on the TPU compiler's limits: every random read there costs a
// whole memory tile.  On this card a random read costs a 32-byte sector, and
// the table (16 levels x 2^16 rows x 2 features in f32, 8.4 MB) stays in the
// 50 MB L2, so a direct gather is what the card does well.
//
// hbr_hash_forward: per (point, level) the eight corners of the point's cell
// are hashed, h = (c0 * 1) ^ (c1 * 2654435761) ^ (c2 * 805459861) mod 2^32,
// & (T - 1), and the trilinear sum of their F features is written (exact
// mode, the counterpart of hash_encode); or, given uniforms u (3, L, N), one
// corner is picked with offset bit d = (u_d < frac_d) and its features are
// written as they are (stochastic mode, the counterpart of
// hash_encode_stochastic: corner c is picked with its trilinear weight).  In
// stochastic mode it also writes the picked corner's offset bits, bit d of
// bits[l, p], a uint8 (L, N) array that the autograd Function keeps for the
// backward in place of u (16 MB against 197 MB at the hash path's 1,024,000
// points).
// hbr_hash_backward: the table gradient, the cells recomputed from the points
// and the picked corners from the bits: exact mode adds w * g into each
// corner's F entries, stochastic mode adds g into the picked corner's.  The
// sums are f32 atomics, so their order changes from run to run; the plain
// versions use index_add_.
//
// hbr_hash_forward.  What it must move: the points and the (N, L*F) f32
// features, and in stochastic mode the uniforms and the bits: 348 B a point
// at L 16, F 2 (0.106 ms of HBM at 1,024,000 points), 140 B exact (0.043
// ms).  Exact mode also gathers 8 rows a (point, level), 128 a point, which
// bind it: with the rows made up instead of read it takes 0.14 ms of 0.32
// (measured on an H100, PERF.md).
// The design:
//  * a thread normalises its point once (xn does not depend on the level);
//  * stochastic mode: HASH_FWD_GROUPS threads a point, each taking every
//    HASH_FWD_GROUPS-th level, the point fastest, so u (3, L, N) is read and
//    the bits (L, N) written coalesced (one thread a point walking all 16
//    levels took 0.21 ms against 0.16);
//  * exact mode: one thread a point walks the levels and asks for the next
//    level's eight rows before it sums this level's, so eight gathers are in
//    flight while it computes (0.32 against 0.35 ms on the training path's
//    points, 0.21 against 0.24 on a served frame's); it asks for
//    HASH_FWD_EXACT_CARVEOUT percent of the SM's memory as shared memory and
//    leaves the rest to L1, where a ray's samples find the coarse levels'
//    rows (left unset, the CUDA runtime gives the staging tiles nearly all
//    of it);
//  * a block's rows are staged in shared memory (padded by one word, so the
//    point-fastest writes touch 32 banks) and written by consecutive threads
//    on consecutive columns, in the caller's row stride.
// The corners x0 and x0 + 1 of a (y, z) share a 16-byte slot when x0 is even
// (rows h and h ^ 1, the x prime being 1), but one float4 load for the pair
// was measured slower than two float2 loads on every point set.
//
// hbr_hash_backward.  What it must move: the points, the (N, L*F) gradient
// and the bits (stochastic), 157 B a point (0.048 ms at 1,024,000 points),
// plus one write of the table's gradient.  What binds it is L2's f32 adds
// (about 230G a second on this card, whether one or four come a request):
// 16 a point and level exact, 2 stochastic, and on the coarse levels (16^3
// and up, fewer cells than rows) they land on few words, from every block.
// The design adds fewer of them:
//  * one thread walks a run of HASH_RUN consecutive points for one level and
//    keeps the current cell's 8 corners x F partials in registers; it adds
//    them only when the cell changes or the run ends, skipping corners still
//    zero.  The trainer's points are a ray's samples in order: on the hash
//    path a run visits 0.17 cells a point on level 0 and 0.69 over all 16;
//  * exact mode sends the corners x0 and x0 + 1 of a (y, z) as one float4
//    reduction where their rows share a 16-byte slot (float2 alone: 1.22
//    against 0.92 ms); stochastic mode, whose runs seldom pick both, as
//    float2;
//  * stochastic mode reads the forward's bits, 1 byte a (point, level),
//    where the uniforms were 12 (0.28 against 0.40 ms on the hash path).
// Every level adds to L2: level 0 in a block-private shared-memory box of its
// 18^3 corners saved 2% in exact mode on the hash path's points and lost in
// stochastic mode, the one trained (0.283 against 0.279 ms on the path's
// points, 0.299 against 0.245 on random ones).  The loop itself, with no
// adds at all, takes 0.11-0.12 ms.
//
// 2-D points (DIM = 2, exact mode only): the image fit (cli/image_fit.py)
// encodes pixel coordinates through the same grid, JAX hash_encode with
// cfg.dim = 2: four corners a (point, level), hashed as c0 ^ (c1 *
// 2654435761), weights w_0 * w_1, at the CLI's width L 16, F 2, T 2^18
// (33.5 MB, still inside L2).  The forward must move the points and the
// features, 136 B a point (8 + 16 x 2 x 4), and gathers 4 rows a (point,
// level) from L2; the backward reads the points and the gradient, 136 B a
// point, and writes the whole gradient table.  The kernels are the 3-D ones
// instantiated for DIM = 2: the run merge helps little there (the fit's
// pixels are drawn at random, so consecutive points seldom share a cell),
// and nothing else was tuned for it.
//
// Numerics follow hash_encode step for step, so the forward equals its plain
// version (ops/hash_kernel.py) bit for bit: xn = (x - mu) / sigma as a true
// division, xl = xn * scale_l with the f32 cast of the float64 level scale,
// frac = xl - floor(xl) (no clipping: points outside [0, 1]^3 hash their
// wrapped coordinates, as the JAX uint32 cast does), corner weights
// ((w_0 * w_1) * w_2) (w_0 * w_1 in 2-D) and the sum over corners c = 0..7
// (0..3; offset bit d of c is (c >> d) & 1) from 0, each operation a _rn
// intrinsic so nothing is contracted into an FMA: at n_max 2^16 xl keeps
// only 8 bits of fraction, so xn * scale and 1 - frac must round as the
// plain version's do.  The backward's terms are g * w (exact) or g, as
// the plain version's; only the order of their f32 sums differs.

#include <cuda_runtime.h>

#include "levels.cuh"

namespace {

constexpr int HASH_FWD_THREADS = 128;
constexpr int HASH_FWD_GROUPS = 4;  // threads a point, stochastic forward
// Percent of the SM's 228 KB of shared memory that the exact forward asks
// for, the rest kept as L1 for the corner gathers (PERF.md: 38 read 1-2%
// faster than 50, and 0.21 against 0.28 ms unset on a serving chunk).
constexpr int HASH_FWD_EXACT_CARVEOUT = 38;
constexpr int HASH_BWD_THREADS = 256;
constexpr int HASH_RUN = 16;           // consecutive points a backward thread walks

__device__ __forceinline__ unsigned hash3(unsigned c0, unsigned c1, unsigned c2,
                                          unsigned mask) {
  return (c0 ^ (c1 * 2654435761u) ^ (c2 * 805459861u)) & mask;
}

__device__ __forceinline__ unsigned hash2(unsigned c0, unsigned c1, unsigned mask) {
  return (c0 ^ (c1 * 2654435761u)) & mask;
}

// The row of corner c of the cell x0 (offset bit d of c is (c >> d) & 1).
template <int DIM>
__device__ __forceinline__ unsigned corner_row(const int* x0, int c, unsigned mask) {
  const unsigned c0 = (unsigned)x0[0] + (unsigned)(c & 1);
  const unsigned c1 = (unsigned)x0[1] + (unsigned)((c >> 1) & 1);
  if constexpr (DIM == 2) return hash2(c0, c1, mask);
  else return hash3(c0, c1, (unsigned)x0[2] + (unsigned)(c >> 2), mask);
}

// Cell x0 and frac of one level, per axis.
template <int DIM>
__device__ __forceinline__ void level_cell(const float* xn, float scale, int* x0,
                                           float* fr) {
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float xl = __fmul_rn(xn[d], scale);
    const float x0f = floorf(xl);
    fr[d] = __fsub_rn(xl, x0f);
    x0[d] = (int)x0f;
  }
}

// w[d][b]: the weight of offset bit b on axis d.
template <int DIM>
__device__ __forceinline__ void axis_weights(const float* fr, float (*w)[2]) {
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    w[d][0] = __fsub_rn(1.0f, fr[d]);
    w[d][1] = fr[d];
  }
}

// Corner c's weight: (w_0 * w_1) in 2-D, ((w_0 * w_1) * w_2) in 3-D.
template <int DIM>
__device__ __forceinline__ float corner_weight(const float (*w)[2], int c) {
  const float w01 = __fmul_rn(w[0][c & 1], w[1][(c >> 1) & 1]);
  if constexpr (DIM == 2) return w01;
  else return __fmul_rn(w01, w[2][c >> 2]);
}

// One row's F features, in the widest aligned loads (rows start at h * F).
template <int F>
__device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else if constexpr (F % 2 == 0) {
#pragma unroll
    for (int i = 0; i < F / 2; ++i) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = q.x;
      v[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(p + f);
  }
}

// The 2^DIM corner rows of one (point, level), corner c's offset bit d
// being (c >> d) & 1.
template <int F, int DIM>
__device__ __forceinline__ void load_corners(const float* tl, const int* x0,
                                             unsigned mask, float (*v)[F]) {
#pragma unroll
  for (int c = 0; c < (1 << DIM); ++c)
    load_row<F>(tl + (long long)corner_row<DIM>(x0, c, mask) * F, v[c]);
}

// The exact features: the sum over corners c = 0..2^DIM - 1 of row_c * w_c
// from 0, in that order.
template <int F, int DIM>
__device__ __forceinline__ void exact_sum(const float (*v)[F], const float* fr,
                                          float* acc) {
  float w[DIM][2];
  axis_weights<DIM>(fr, w);
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < (1 << DIM); ++c) {
    const float wc = corner_weight<DIM>(w, c);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(v[c][f], wc));
  }
}

// table: (L, T, F) f32, level l from row lv.offset[l].  out[p, l*F + f], row
// stride out_stride.  STOCH (3-D only): u (3, L, n) picks the corners, and
// bits (L, n) gets their offset bits.  A block takes P points; the G threads
// of a point take every G-th level.
template <int F, bool STOCH, int DIM>
__global__ void __launch_bounds__(HASH_FWD_THREADS)
hash_forward_kernel(WorldPoints pts, const float* __restrict__ table,
                    const float* __restrict__ u, long long n, int T, HbrLevels lv,
                    float* __restrict__ out, long long out_stride,
                    unsigned char* __restrict__ bits) {
  constexpr int G = STOCH ? HASH_FWD_GROUPS : 1;
  constexpr int P = HASH_FWD_THREADS / G;
  extern __shared__ float s_rows[];  // (P, L * F + 1)
  const int L = lv.n_levels;
  const int C = L * F;
  const int row_words = C + 1;
  const long long p0 = (long long)blockIdx.x * P;
  const int i = threadIdx.x % P;
  const long long p = p0 + i;
  const unsigned mask = (unsigned)(T - 1);
  static_assert(!STOCH || DIM == 3, "the stochastic mode is 3-D only");
  if (p < n) {
    float xn[DIM];
    pts.at<DIM>(p, xn);
    float* dst = s_rows + i * row_words;
    if constexpr (STOCH) {
      for (int l = threadIdx.x / P; l < L; l += G) {
        int x0[3];
        float fr[3];
        level_cell<3>(xn, lv.scale[l], x0, fr);
        unsigned c[3], b = 0;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const unsigned up = __ldg(u + ((long long)d * L + l) * n + p) < fr[d] ? 1u : 0u;
          c[d] = (unsigned)x0[d] + up;
          b |= up << d;
        }
        float v[F];
        load_row<F>(table + ((long long)lv.offset[l] + hash3(c[0], c[1], c[2], mask)) * F,
                    v);
        bits[(long long)l * n + p] = (unsigned char)b;
#pragma unroll
        for (int f = 0; f < F; ++f) dst[l * F + f] = v[f];
      }
    } else {
      // the next level's corner rows are asked for before this level's sum
      constexpr int NC = 1 << DIM;
      int x0[DIM];
      float fr[DIM], v[NC][F];
      level_cell<DIM>(xn, lv.scale[0], x0, fr);
      load_corners<F, DIM>(table + (long long)lv.offset[0] * F, x0, mask, v);
      for (int l = 0;; ++l) {
        float nfr[DIM], nv[NC][F];
        if (l + 1 < L) {
          level_cell<DIM>(xn, lv.scale[l + 1], x0, nfr);
          load_corners<F, DIM>(table + (long long)lv.offset[l + 1] * F, x0, mask, nv);
        }
        float acc[F];
        exact_sum<F, DIM>(v, fr, acc);
#pragma unroll
        for (int f = 0; f < F; ++f) dst[l * F + f] = acc[f];
        if (l + 1 == L) break;
#pragma unroll
        for (int d = 0; d < DIM; ++d) fr[d] = nfr[d];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int f = 0; f < F; ++f) v[c][f] = nv[c][f];
      }
    }
  }
  __syncthreads();
  const int np = (int)min((long long)P, n - p0);
  for (int k = threadIdx.x; k < np * C; k += blockDim.x) {
    const int r = k / C;
    const int c = k - r * C;
    out[(p0 + r) * out_stride + c] = s_rows[r * row_words + c];
  }
}

// Adds a row's F values into a level's gradient in L2 (all-zero skipped:
// adding +-0 to a sum that starts at +0 changes nothing).
template <int F>
__device__ __forceinline__ void add_row(float* dl, unsigned h, const float* v) {
  float* p = dl + (long long)h * F;
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int i = 0; i < F / 4; ++i)
      if (v[4 * i] != 0.0f || v[4 * i + 1] != 0.0f || v[4 * i + 2] != 0.0f ||
          v[4 * i + 3] != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(p) + i,
                  make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
  } else if constexpr (F % 2 == 0) {
#pragma unroll
    for (int i = 0; i < F / 2; ++i)
      if (v[2 * i] != 0.0f || v[2 * i + 1] != 0.0f)
        atomicAdd(reinterpret_cast<float2*>(p) + i, make_float2(v[2 * i], v[2 * i + 1]));
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f)
      if (v[f] != 0.0f) atomicAdd(p + f, v[f]);
  }
}

template <int F>
__device__ __forceinline__ bool all_zero(const float* v) {
  bool z = true;
#pragma unroll
  for (int f = 0; f < F; ++f) z = z && v[f] == 0.0f;
  return z;
}

// The corners x0 and x0 + 1 of one (y, z), rows h0 and h1: with F = 2 one
// float4 reduction where both rows share a 16-byte slot and both are
// nonzero.
template <int F>
__device__ __forceinline__ void add_pair(float* dl, unsigned h0, unsigned h1,
                                         const float* v0, const float* v1) {
  if constexpr (F == 2) {
    if ((h0 >> 1) == (h1 >> 1) && !all_zero<F>(v0) && !all_zero<F>(v1)) {
      const bool s = (h0 & 1u) != 0;  // h0 is the slot's second row
      atomicAdd(reinterpret_cast<float4*>(dl) + (h0 >> 1),
                make_float4(s ? v1[0] : v0[0], s ? v1[1] : v0[1],
                            s ? v0[0] : v1[0], s ? v0[1] : v1[1]));
      return;
    }
  }
  add_row<F>(dl, h0, v0);
  add_row<F>(dl, h1, v1);
}

// Adds the current cell's partials acc[c][f] into L2: the corners in pairs
// (c, c + 1) that differ in x alone.
template <int F, bool STOCH, int DIM>
__device__ __forceinline__ void flush_cell(float* dl, const int* cell, unsigned mask,
                                           float (*acc)[F]) {
#pragma unroll
  for (int k = 0; k < (1 << (DIM - 1)); ++k) {
    const float* v0 = acc[2 * k];
    const float* v1 = acc[2 * k + 1];
    const unsigned h0 = corner_row<DIM>(cell, 2 * k, mask);
    const unsigned h1 = corner_row<DIM>(cell, 2 * k + 1, mask);
    if (STOCH) {
      if (!all_zero<F>(v0)) add_row<F>(dl, h0, v0);
      if (!all_zero<F>(v1)) add_row<F>(dl, h1, v1);
    } else {
      add_pair<F>(dl, h0, h1, v0, v1);
    }
  }
}

// dtable: (L, T, F) f32, zeroed by the caller.  g: (n, L*F), row stride
// g_stride.  STOCH (3-D only): bits (L, n) hold the picked corners.  A unit
// is one (run of HASH_RUN points, level), the level fastest, so a warp's
// gradient reads are two rows.
template <int F, bool STOCH, int DIM>
__global__ void __launch_bounds__(HASH_BWD_THREADS)
hash_backward_kernel(WorldPoints pts, const unsigned char* __restrict__ bits,
                     const float* __restrict__ g, long long g_stride, long long n,
                     int T, HbrLevels lv, float* __restrict__ dtable) {
  const int L = lv.n_levels;
  const unsigned mask = (unsigned)(T - 1);
  const long long units = (n + HASH_RUN - 1) / HASH_RUN * L;
  for (long long unit = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       unit < units; unit += (long long)gridDim.x * blockDim.x) {
    const long long run = unit / L;
    const int l = (int)(unit - run * L);
    const float scale = lv.scale[l];
    float* dl = dtable + (long long)lv.offset[l] * F;
    constexpr int NC = 1 << DIM;
    int cell[DIM] = {};
    bool have = false;
    float acc[NC][F];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[c][f] = 0.0f;
    // one pass past the run's last point adds what is left
    const long long p0 = run * HASH_RUN;
    const int np = (int)min((long long)HASH_RUN, n - p0);
    for (int k = 0; k <= HASH_RUN; ++k) {
      if (k > np) break;
      const long long p = p0 + k;
      const bool live = k < np;
      int x0[DIM] = {};
      float fr[DIM] = {}, gf[F];
      unsigned b = 0;
      if (live) {
        float xn[DIM];
        pts.at<DIM>(p, xn);
        level_cell<DIM>(xn, scale, x0, fr);
#pragma unroll
        for (int f = 0; f < F; ++f) gf[f] = __ldg(g + p * g_stride + l * F + f);
        if (STOCH) b = __ldg(bits + (long long)l * n + p);
      }
      bool moved = !live;
#pragma unroll
      for (int d = 0; d < DIM; ++d) moved = moved || x0[d] != cell[d];
      if (have && moved) {
        flush_cell<F, STOCH, DIM>(dl, cell, mask, acc);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int f = 0; f < F; ++f) acc[c][f] = 0.0f;
      }
      if (!live) break;
#pragma unroll
      for (int d = 0; d < DIM; ++d) cell[d] = x0[d];
      have = true;
      if (STOCH) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if ((unsigned)c == b)
#pragma unroll
            for (int f = 0; f < F; ++f) acc[c][f] = __fadd_rn(acc[c][f], gf[f]);
      } else {
        float w[DIM][2];
        axis_weights<DIM>(fr, w);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float wc = corner_weight<DIM>(w, c);
#pragma unroll
          for (int f = 0; f < F; ++f)
            acc[c][f] = __fadd_rn(acc[c][f], __fmul_rn(gf[f], wc));
        }
      }
    }
  }
}

template <int F, bool STOCH, int DIM>
static int launch_hash_forward(const WorldPoints& pts, const float* table,
                               const float* u, long long n, int T,
                               const HbrLevels& lv, float* out, long long out_stride,
                               unsigned char* bits, cudaStream_t s) {
  constexpr int P = HASH_FWD_THREADS / (STOCH ? HASH_FWD_GROUPS : 1);
  const size_t smem = (size_t)P * (lv.n_levels * F + 1) * sizeof(float);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(hash_forward_kernel<F, STOCH, DIM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && !STOCH)
    e = cudaFuncSetAttribute(hash_forward_kernel<F, STOCH, DIM>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             HASH_FWD_EXACT_CARVEOUT);
  if (e != cudaSuccess) return (int)e;
  const unsigned int blocks = (unsigned int)((n + P - 1) / P);
  hash_forward_kernel<F, STOCH, DIM><<<blocks, HASH_FWD_THREADS, smem, s>>>(
      pts, table, u, n, T, lv, out, out_stride, bits);
  return (int)cudaGetLastError();
}

template <int F, bool STOCH, int DIM>
static int launch_hash_backward(const WorldPoints& pts, const unsigned char* bits,
                                const float* g, long long g_stride, long long n, int T,
                                const HbrLevels& lv, float* dtable, cudaStream_t s) {
  const long long units = (n + HASH_RUN - 1) / HASH_RUN * lv.n_levels;
  int blocks = 0;
  const int err = persistent_blocks(hash_backward_kernel<F, STOCH, DIM>,
                                    HASH_BWD_THREADS, 0,
                                    (units + HASH_BWD_THREADS - 1) / HASH_BWD_THREADS,
                                    &blocks);
  if (err) return err;
  hash_backward_kernel<F, STOCH, DIM><<<blocks, HASH_BWD_THREADS, 0, s>>>(
      pts, bits, g, g_stride, n, T, lv, dtable);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 = ok),
// or the error of its set-up (cudaErrorInvalidValue for arguments the kernel
// does not take).  x: (n, dim) f32 world points, dim 3, or 2 (exact mode
// only); mu, sigma: (dim,) f32 on the device; table (L, T, F) f32 from a
// 16-byte aligned address, F 1 to 8.

// Stochastic (3-D): u (3, L, n) f32 and bits (L, n) uint8, the picked
// corners' offset bits written; exact: both null.
int hbr_hash_forward(const float* x, const float* mu, const float* sigma,
                     const float* table, const float* u, long long n, int dim,
                     int table_size, int features, const HbrLevels* lv, float* out,
                     long long out_stride, unsigned char* bits, void* stream) {
  if (n <= 0) return 0;
  if ((u == nullptr) != (bits == nullptr) || (dim != 2 && dim != 3) ||
      (dim == 2 && u != nullptr))
    return (int)cudaErrorInvalidValue;
  const WorldPoints pts{x, mu, sigma, 1};
  return with_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    const cudaStream_t s = (cudaStream_t)stream;
    if (dim == 2)
      return launch_hash_forward<F, false, 2>(pts, table, u, n, table_size, *lv, out,
                                              out_stride, bits, s);
    if (u != nullptr)
      return launch_hash_forward<F, true, 3>(pts, table, u, n, table_size, *lv, out,
                                             out_stride, bits, s);
    return launch_hash_forward<F, false, 3>(pts, table, u, n, table_size, *lv, out,
                                            out_stride, bits, s);
  });
}

// bits: (L, n) uint8 from the stochastic forward (3-D), or null (exact).
// dtable (L, T, F) f32 must be zeroed.
int hbr_hash_backward(const float* x, const float* mu, const float* sigma,
                      const unsigned char* bits, const float* g, long long g_stride,
                      long long n, int dim, int table_size, int features,
                      const HbrLevels* lv, float* dtable, void* stream) {
  if (n <= 0) return 0;
  if ((dim != 2 && dim != 3) || (dim == 2 && bits != nullptr))
    return (int)cudaErrorInvalidValue;
  const WorldPoints pts{x, mu, sigma, 1};
  return with_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    const cudaStream_t s = (cudaStream_t)stream;
    if (dim == 2)
      return launch_hash_backward<F, false, 2>(pts, bits, g, g_stride, n, table_size,
                                               *lv, dtable, s);
    if (bits != nullptr)
      return launch_hash_backward<F, true, 3>(pts, bits, g, g_stride, n, table_size,
                                              *lv, dtable, s);
    return launch_hash_backward<F, false, 3>(pts, bits, g, g_stride, n, table_size,
                                             *lv, dtable, s);
  });
}

}  // extern "C"
