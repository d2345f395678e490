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
//
// The hash-grid variants (the JAX ops/hash_encoding.py cell, packed,
// packed-exact, int8, gradient-subsampling and scatter-strategy paths, all
// plain jnp there) are built from the same pieces:
//  * hbr_hash_pack: the f32 table as one uint32 word a row, bf16 pairs
//    (__float2bfloat16_rn, feature f in bits [16f, 16f + 16)) or int8 bytes
//    (per-level scale s_l = max|table_l| + 1e-12, then rint(t / s_l * 127)
//    clipped to +-127, feature f in byte f), once a forward as JAX packs
//    once a step.  It must move the table once and the words once (the
//    int8 table of the lpair mode, (6, 2^16, 4): 7.5 MB, 2.3 us of HBM).
//    bf16: a thread packs four rows with 16-byte loads and a 16-byte store.
//    int8 is one launch of one thread-block cluster a level: its blocks
//    hold the level in registers, reduce the max through distributed shared
//    memory and quantise what they hold, so the table is read once and no
//    scale is zeroed, finished or read back by other launches;
//  * hbr_hash_packed_forward: hbr_hash_forward's kernel reading one word a
//    (corner, level) through a row source that unpacks it (bf16: the half
//    shifted into an f32; int8: the signed byte times s_l / 127), in
//    stochastic mode (the same corner bits) or exact (the packed-exact
//    trilerp: f32 weights, the sum over c = 0..7 from 0).  Its backward is
//    hbr_hash_backward's (straight-through: the f32 master table's
//    gradient);
//  * hbr_hash_cell_forward / _backward: the "cell" variant, one hash of the
//    cell's corner 0 and one row of 8F floats a (point, level) (64 B at F
//    2), slot c * F + f holding corner c's feature f; the forward sums row
//    * w_c over c = 0..7, the backward adds w_c * g into the row's slots,
//    merged over a run of points as hbr_hash_backward merges them, and sent
//    as float4 reductions;
//  * the subsampled stochastic backwards (hbr_hash_backward given the
//    draws pick (L, n), lsel (n,), psel (L / 2, n), uint8, made by the
//    caller): each drawn term is (g[pick] * F) * s in feature pick alone
//    (grad_subsample), on the drawn levels alone, one a point
//    (grad_level_subsample, s = L) or one of each consecutive pair
//    (grad_level_pair, s = 2), else s = 1 on every level.  One thread takes
//    a point, the point fastest: it normalises the point once, reads its
//    draws and its gradient row, and sends each drawn term (one under lsel,
//    L / 2 under psel, L under pick alone) as one scalar reduction, reading
//    ROUTED_BATCH terms before it sends them.  The run walk above visited
//    every point of its run at every level to find the drawn ones, one
//    dependent chain of loads after another, for one term in L (lsel) or
//    two (psel); one thread a term read a point's gradient row once a
//    level.  What binds it is those reads, scattered 4-byte values of the
//    gradient's rows (the kernel with its reductions taken out takes most
//    of its time), not the L2's reductions (PERF.md);
//  * hbr_hash_pairs, then hbr_scatter_sorted / hbr_scatter_segsum: the
//    "sorted" and "segsum" strategies of JAX scatter_add_flat.  The pairs
//    (flat index, value) are written in JAX's order ([f][l][n] unsampled,
//    [l][n], [n] or [j][n] subsampled), the caller sorts them by index
//    (torch.sort, stable, as lax.sort), then "sorted" adds a thread's 16
//    consecutive pairs run by run with one atomic a run, and "segsum" gives
//    each run of equal indices to the thread at its start, which sums it in
//    order and stores the total once (no atomics: the index is unique).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "levels.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HASH_FWD_THREADS = 128;
constexpr int HASH_FWD_GROUPS = 4;  // threads a point, stochastic forward
// Percent of the SM's 228 KB of shared memory that the exact forward asks
// for, the rest kept as L1 for the corner gathers (PERF.md: 38 read 1-2%
// faster than 50, and 0.21 against 0.28 ms unset on a serving chunk).
constexpr int HASH_FWD_EXACT_CARVEOUT = 38;
constexpr int HASH_BWD_THREADS = 256;
constexpr int HASH_RUN = 16;           // consecutive points a backward thread walks
constexpr int ROUTED_BATCH = 4;        // terms a routed-backward thread reads at once

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

// Row sources of the forward: load<F>(l, row, v) reads row ``row`` (level l's
// first row at lv.offset[l]) as F f32 features.
struct F32Rows {  // the (L, T, F) f32 table
  const float* __restrict__ table;
  template <int F>
  __device__ __forceinline__ void load(int, long long row, float* v) const {
    load_row<F>(table + row * F, v);
  }
};

struct Bf16Words {  // (L * T,) uint32: feature f in bits [16f, 16f + 16)
  const unsigned* __restrict__ words;
  template <int F>
  __device__ __forceinline__ void load(int, long long row, float* v) const {
    static_assert(F == 2, "bf16 words hold two features");
    const unsigned w = __ldg(words + row);
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xFFFF0000u);
  }
};

struct Int8Words {  // (L * T,) uint32: feature f in byte f; scale (L,)
  const unsigned* __restrict__ words;
  const float* __restrict__ scale;
  template <int F>
  __device__ __forceinline__ void load(int l, long long row, float* v) const {
    static_assert(F <= 4, "int8 words hold at most four features");
    const unsigned w = __ldg(words + row);
    const float m = __fdiv_rn(__ldg(scale + l), 127.0f);  // JAX scale / 127.0
#pragma unroll
    for (int f = 0; f < F; ++f)
      v[f] = __fmul_rn((float)(int)(signed char)((w >> (8 * f)) & 0xFFu), m);
  }
};

// The 2^DIM corner rows of one (point, level), corner c's offset bit d
// being (c >> d) & 1; base is the level's first row.
template <int F, int DIM, class Rows>
__device__ __forceinline__ void load_corners(const Rows& rows, int l, long long base,
                                             const int* x0, unsigned mask,
                                             float (*v)[F]) {
#pragma unroll
  for (int c = 0; c < (1 << DIM); ++c)
    rows.template load<F>(l, base + corner_row<DIM>(x0, c, mask), v[c]);
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

// Writes a block's staged rows s_rows (P points x (C + 1) words) to out[p0 +
// r, c], row stride out_stride, consecutive threads on consecutive columns.
__device__ __forceinline__ void store_rows(const float* s_rows, int C, long long p0,
                                           long long n, int P, float* out,
                                           long long out_stride) {
  const int np = (int)min((long long)P, n - p0);
  for (int k = threadIdx.x; k < np * C; k += blockDim.x) {
    const int r = k / C;
    const int c = k - r * C;
    out[(p0 + r) * out_stride + c] = s_rows[r * (C + 1) + c];
  }
}

// rows: the table's row source (F32Rows, or packed words), level l from row
// lv.offset[l].  out[p, l*F + f], row stride out_stride.  STOCH (3-D only): u
// (3, L, n) picks the corners, and bits (L, n) gets their offset bits.  A
// block takes P points; the G threads of a point take every G-th level.
template <int F, bool STOCH, int DIM, class Rows>
__global__ void __launch_bounds__(HASH_FWD_THREADS)
hash_forward_kernel(WorldPoints pts, Rows rows,
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
        rows.template load<F>(l, (long long)lv.offset[l] + hash3(c[0], c[1], c[2], mask),
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
      load_corners<F, DIM>(rows, 0, lv.offset[0], x0, mask, v);
      for (int l = 0;; ++l) {
        float nfr[DIM], nv[NC][F];
        if (l + 1 < L) {
          level_cell<DIM>(xn, lv.scale[l + 1], x0, nfr);
          load_corners<F, DIM>(rows, l + 1, lv.offset[l + 1], x0, mask, nv);
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
  store_rows(s_rows, C, p0, n, P, out, out_stride);
}

// The cell variant: table (L, T, 8F) f32, row h of level l holding corner c's
// feature f at slot c * F + f, h the hash of the cell's corner 0.  One thread
// a point walks the levels, asking for the next level's row before it sums
// this one's; out[p, l*F + f] = sum over c = 0..7 of row[c*F + f] * w_c from
// 0 (JAX hash_encode_cell).
template <int F>
__global__ void __launch_bounds__(HASH_FWD_THREADS)
cell_forward_kernel(WorldPoints pts, const float* __restrict__ table, long long n, int T,
                    HbrLevels lv, float* __restrict__ out, long long out_stride) {
  constexpr int P = HASH_FWD_THREADS;
  constexpr int W = 8 * F;  // a row's floats
  extern __shared__ float s_rows[];  // (P, L * F + 1)
  const int L = lv.n_levels;
  const int C = L * F;
  const long long p0 = (long long)blockIdx.x * P;
  const long long p = p0 + threadIdx.x;
  const unsigned mask = (unsigned)(T - 1);
  if (p < n) {
    float xn[3];
    pts.at<3>(p, xn);
    float* dst = s_rows + threadIdx.x * (C + 1);
    int x0[3];
    float fr[3], v[W];
    level_cell<3>(xn, lv.scale[0], x0, fr);
    load_row<W>(table + ((long long)lv.offset[0] + corner_row<3>(x0, 0, mask)) * W, v);
    for (int l = 0;; ++l) {
      float nfr[3], nv[W];
      if (l + 1 < L) {
        level_cell<3>(xn, lv.scale[l + 1], x0, nfr);
        load_row<W>(table + ((long long)lv.offset[l + 1] + corner_row<3>(x0, 0, mask)) * W,
                    nv);
      }
      float w[3][2], acc[F];
      axis_weights<3>(fr, w);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float wc = corner_weight<3>(w, c);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(v[c * F + f], wc));
      }
#pragma unroll
      for (int f = 0; f < F; ++f) dst[l * F + f] = acc[f];
      if (l + 1 == L) break;
#pragma unroll
      for (int d = 0; d < 3; ++d) fr[d] = nfr[d];
#pragma unroll
      for (int k = 0; k < W; ++k) v[k] = nv[k];
    }
  }
  __syncthreads();
  store_rows(s_rows, C, p0, n, P, out, out_stride);
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

// The cell variant's gradient: dtable (L, T, 8F) f32, zeroed by the caller;
// g (n, L*F), row stride g_stride.  As hash_backward_kernel's exact mode, a
// thread walks a run of HASH_RUN points for one level and keeps the cell's
// 8 x F partials w_c * g_f in registers, here adding them to the cell's one
// row (slot c * F + f) when the cell changes or the run ends.
template <int F>
__global__ void __launch_bounds__(HASH_BWD_THREADS)
cell_backward_kernel(WorldPoints pts, const float* __restrict__ g, long long g_stride,
                     long long n, int T, HbrLevels lv, float* __restrict__ dtable) {
  constexpr int W = 8 * F;
  const int L = lv.n_levels;
  const unsigned mask = (unsigned)(T - 1);
  const long long units = (n + HASH_RUN - 1) / HASH_RUN * L;
  for (long long unit = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       unit < units; unit += (long long)gridDim.x * blockDim.x) {
    const long long run = unit / L;
    const int l = (int)(unit - run * L);
    float* dl = dtable + (long long)lv.offset[l] * W;
    int cell[3] = {};
    bool have = false;
    float acc[W];
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] = 0.0f;
    const long long p0 = run * HASH_RUN;
    const int np = (int)min((long long)HASH_RUN, n - p0);
    for (int k = 0; k < np; ++k) {
      const long long p = p0 + k;
      float xn[3], fr[3], gf[F];
      int x0[3];
      pts.at<3>(p, xn);
      level_cell<3>(xn, lv.scale[l], x0, fr);
#pragma unroll
      for (int f = 0; f < F; ++f) gf[f] = __ldg(g + p * g_stride + l * F + f);
      if (have && (x0[0] != cell[0] || x0[1] != cell[1] || x0[2] != cell[2])) {
        add_row<W>(dl, corner_row<3>(cell, 0, mask), acc);
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] = 0.0f;
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) cell[d] = x0[d];
      have = true;
      float w[3][2];
      axis_weights<3>(fr, w);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float wc = corner_weight<3>(w, c);
#pragma unroll
        for (int f = 0; f < F; ++f)
          acc[c * F + f] = __fadd_rn(acc[c * F + f], __fmul_rn(gf[f], wc));
      }
    }
    if (have) add_row<W>(dl, corner_row<3>(cell, 0, mask), acc);
  }
}

// The draws of a stochastic backward's terms: pick (L, n), the feature of
// each (point, level), or null (every feature, no subsampling); at most one
// of lsel (n,), a point's one level, and psel (L / 2, n), the level of each
// pair (both null: every level).  A point has one term in each routing
// group j: at level j (L groups), the drawn level (lsel, one group) or the
// drawn level of pair j (psel, L / 2 groups).
struct Routing {
  const unsigned char* __restrict__ pick;
  const unsigned char* __restrict__ lsel;
  const unsigned char* __restrict__ psel;
  float sub_scale, lvl_scale;
  __host__ __device__ __forceinline__ int groups(int L) const {
    return lsel != nullptr ? 1 : psel != nullptr ? L / 2 : L;
  }
  __device__ __forceinline__ int level(int j, long long p, long long n) const {
    if (lsel != nullptr) return __ldg(lsel + p);
    if (psel != nullptr) return 2 * j + __ldg(psel + (long long)j * n + p);
    return j;
  }
};

// The row (lv.offset[l] + hash) of the corner that the point xn picked at
// level l, read from the stochastic forward's offset bits (L, n).
__device__ __forceinline__ long long picked_row(const float* xn,
                                                const unsigned char* __restrict__ bits,
                                                int l, long long p, long long n,
                                                unsigned mask, const HbrLevels& lv) {
  float fr[3];
  int x0[3];
  level_cell<3>(xn, lv.scale[l], x0, fr);
  return (long long)lv.offset[l] + corner_row<3>(x0, __ldg(bits + (long long)l * n + p),
                                                 mask);
}

// Point p's (at xn) term in routing group j of a subsampled backward
// (rt.pick set): returns its value (g[pick] * sub_scale) * lvl_scale and sets
// *flat to its index (row * F + pick) in the (L, T, F) table.
__device__ __forceinline__ float routed_term(const float* xn,
                                             const unsigned char* __restrict__ bits,
                                             const Routing& rt, const float* __restrict__ g,
                                             long long g_stride, long long n, int F, int j,
                                             long long p, unsigned mask,
                                             const HbrLevels& lv, long long* flat) {
  const int l = rt.level(j, p, n);
  const int pk = __ldg(rt.pick + (long long)l * n + p);
  *flat = picked_row(xn, bits, l, p, n, mask, lv) * F + pk;
  return __fmul_rn(__fmul_rn(__ldg(g + p * g_stride + l * F + pk), rt.sub_scale),
                   rt.lvl_scale);
}

// The subsampled stochastic backward: dtable (L, T, F) f32, zeroed by the
// caller, += each drawn term.  A thread takes one point and its drawn terms,
// one (lsel), one a pair (psel) or one a level (pick alone), the point
// fastest, so a warp reads the points, the draws, pick and bits coalesced
// and a point's gradient row once.  It reads ROUTED_BATCH terms' inputs
// before it sends their scalar reductions, so their loads are in flight
// together (zero terms skipped: adding +-0 to a sum that starts at +0
// changes nothing).
__global__ void __launch_bounds__(HASH_BWD_THREADS)
routed_backward_kernel(WorldPoints pts, const unsigned char* __restrict__ bits, Routing rt,
                       const float* __restrict__ g, long long g_stride, long long n,
                       int F, int T, HbrLevels lv, float* __restrict__ dtable) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float xn[3];
  pts.at<3>(p, xn);
  const int groups = rt.groups(lv.n_levels);
  for (int j0 = 0; j0 < groups; j0 += ROUTED_BATCH) {
    long long flat[ROUTED_BATCH];
    float v[ROUTED_BATCH];
#pragma unroll
    for (int k = 0; k < ROUTED_BATCH; ++k) {
      flat[k] = 0;
      v[k] = j0 + k < groups ? routed_term(xn, bits, rt, g, g_stride, n, F, j0 + k, p,
                                           (unsigned)(T - 1), lv, &flat[k])
                             : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < ROUTED_BATCH; ++k)
      if (v[k] != 0.0f) atomicAdd(dtable + flat[k], v[k]);
  }
}

// The (flat index, value) pairs of a stochastic backward, in JAX's order: pick
// null, F a (point, level) at [f][l][n] (value g); pick alone, one a (point,
// level) at [l][n]; with lsel one a point at [n]; with psel one a (pair,
// point) at [j][n] (value (g[pick] * sub_scale) * lvl_scale).  The index is
// (lv.offset[l] + row) * F + f of the picked corner's row.
template <int F>
__global__ void __launch_bounds__(HASH_BWD_THREADS)
pairs_kernel(WorldPoints pts, const unsigned char* __restrict__ bits, Routing rt,
             const float* __restrict__ g, long long g_stride, long long n, int T,
             HbrLevels lv, int* __restrict__ idx, float* __restrict__ val) {
  const unsigned mask = (unsigned)(T - 1);
  const long long items = (long long)rt.groups(lv.n_levels) * n;
  for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x; it < items;
       it += (long long)gridDim.x * blockDim.x) {
    const long long j = it / n;
    const long long p = it - j * n;
    float xn[3];
    pts.at<3>(p, xn);
    if (rt.pick == nullptr) {
      const long long row = picked_row(xn, bits, (int)j, p, n, mask, lv);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        idx[(long long)f * items + it] = (int)(row * F + f);
        val[(long long)f * items + it] = __ldg(g + p * g_stride + j * F + f);
      }
    } else {
      long long flat;
      val[it] = routed_term(xn, bits, rt, g, g_stride, n, F, (int)j, p, mask, lv, &flat);
      idx[it] = (int)flat;
    }
  }
}

constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_RUN = 16;  // sorted pairs a thread merges ("sorted")

// "sorted": out[idx[k]] += val[k] for m pairs sorted by idx; a thread merges
// its SCATTER_RUN consecutive pairs run by run, one atomic a run.
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_sorted_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                      long long m, float* __restrict__ out) {
  const long long k0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * SCATTER_RUN;
  if (k0 >= m) return;
  const long long k1 = min(k0 + SCATTER_RUN, m);
  int cur = __ldg(idx + k0);
  float s = __ldg(val + k0);
  for (long long k = k0 + 1; k < k1; ++k) {
    const int i = __ldg(idx + k);
    if (i != cur) {
      atomicAdd(out + cur, s);
      cur = i;
      s = 0.0f;
    }
    s = __fadd_rn(s, __ldg(val + k));
  }
  atomicAdd(out + cur, s);
}

// "segsum": each run of equal indices in the sorted pairs is summed in order
// from 0 by the thread at its start, which stores the total once.
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_segsum_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                      long long m, float* __restrict__ out) {
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < m;
       k += (long long)gridDim.x * blockDim.x) {
    const int i = __ldg(idx + k);
    if (k > 0 && __ldg(idx + k - 1) == i) continue;
    float s = 0.0f;
    for (long long j = k; j < m && __ldg(idx + j) == i; ++j) s = __fadd_rn(s, __ldg(val + j));
    out[i] = s;
  }
}

constexpr int PACK_THREADS = 256;  // bf16; an int8 block takes PACK_INT8_THREADS
constexpr int PACK_INT8_THREADS = 512;
constexpr int PACK_VALUES = 32;   // table values an int8 pack thread holds
constexpr int PACK_CLUSTER = 16;  // blocks a level (a non-portable cluster size)

__device__ __forceinline__ unsigned bf16_word(float f0, float f1) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f0)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f1)) << 16);
}

// bf16 words: table (R, 2) f32 -> words (R,), feature f in bits [16f, 16f+16).
// A thread packs four rows: two 16-byte loads and one 16-byte store (table
// and words 16-byte aligned); the last R % 4 rows one at a time.
__global__ void __launch_bounds__(PACK_THREADS)
pack_bf16_kernel(const float4* __restrict__ table, long long rows,
                 uint4* __restrict__ words) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * q + 4 <= rows) {
    const float4 a = __ldg(table + 2 * q), b = __ldg(table + 2 * q + 1);
    words[q] = make_uint4(bf16_word(a.x, a.y), bf16_word(a.z, a.w), bf16_word(b.x, b.y),
                          bf16_word(b.z, b.w));
    return;
  }
  const float2* t2 = reinterpret_cast<const float2*>(table);
  for (long long r = 4 * q; r < rows; ++r) {
    const float2 t = __ldg(t2 + r);
    reinterpret_cast<unsigned*>(words)[r] = bf16_word(t.x, t.y);
  }
}

// One row's int8 word: byte f = rint(t[f] / s * 127) clipped to +-127 (rint:
// half to even, as jnp.round).
template <int F>
__device__ __forceinline__ unsigned int8_word(const float* t, float s) {
  unsigned w = 0;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float q = rintf(__fmul_rn(__fdiv_rn(t[f], s), 127.0f));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    w |= ((unsigned)(int)q & 0xFFu) << (8 * f);
  }
  return w;
}

// int8 words: table (L, T, F) f32 -> words (L*T,) and scale (L,), s_l =
// max|table_l| + 1e-12.  One thread-block cluster a level (blockIdx.y): its
// blocks hold the level's rows in registers, VALUES / F rows a thread
// (consecutive threads of the cluster on consecutive rows), reduce max|t| in
// the block, then across the cluster through distributed shared memory, and
// quantise the rows they hold.  A level past the cluster's registers is read
// twice, its rows past the first cap from L2.  The max is taken on the bits
// of |t| (a non-negative float's order is its bits' unsigned order), exact
// in any order.
template <int F, int THREADS = PACK_INT8_THREADS, int VALUES = PACK_VALUES>
__global__ void __launch_bounds__(THREADS)
pack_int8_kernel(const float* __restrict__ table, long long T, float* __restrict__ scale,
                 unsigned* __restrict__ words) {
  constexpr int R = VALUES / F;
  __shared__ unsigned s_warp[THREADS / 32];
  __shared__ unsigned s_block, s_level;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int l = blockIdx.y;
  const float* tl = table + (long long)l * T * F;
  const long long stride = (long long)C * THREADS;  // between a thread's rows
  const long long first = (long long)cluster.block_rank() * THREADS + threadIdx.x;
  const long long cap = stride * R;  // rows the cluster holds
  float v[R][F];
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long r = first + i * stride;
    if (r < T) {
      load_row<F>(tl + r * F, v[i]);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) v[i][f] = 0.0f;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) m = max(m, __float_as_uint(fabsf(v[i][f])));
  }
  for (long long r = cap + first; r < T; r += stride) {
    float t[F];
    load_row<F>(tl + r * F, t);
#pragma unroll
    for (int f = 0; f < F; ++f) m = max(m, __float_as_uint(fabsf(t[f])));
  }
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = __reduce_max_sync(0xFFFFFFFFu,
                          threadIdx.x < THREADS / 32 ? s_warp[threadIdx.x] : 0u);
    if (threadIdx.x == 0) s_block = m;
  }
  cluster.sync();
  if (threadIdx.x < 32) {
    m = __reduce_max_sync(0xFFFFFFFFu, (int)threadIdx.x < C
                                           ? *cluster.map_shared_rank(&s_block, threadIdx.x)
                                           : 0u);
    if (threadIdx.x == 0) s_level = m;
  }
  cluster.sync();  // s_level is set, and no block leaves while another reads it
  const float s = __fadd_rn(__uint_as_float(s_level), 1e-12f);
  if (first == 0) scale[l] = s;
  unsigned* wl = words + (long long)l * T;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long r = first + i * stride;
    if (r < T) wl[r] = int8_word<F>(v[i], s);
  }
  for (long long r = cap + first; r < T; r += stride) {
    float t[F];
    load_row<F>(tl + r * F, t);
    wl[r] = int8_word<F>(t, s);
  }
}

// Blocks of ``threads`` for one thread an item (at least one block).
static unsigned int item_blocks(long long items, int threads) {
  const long long b = (items + threads - 1) / threads;
  return (unsigned int)(b > 0 ? b : 1);
}

template <int F, bool STOCH, int DIM, class Rows>
static int launch_hash_forward(const WorldPoints& pts, const Rows& rows,
                               const float* u, long long n, int T,
                               const HbrLevels& lv, float* out, long long out_stride,
                               unsigned char* bits, cudaStream_t s) {
  constexpr int P = HASH_FWD_THREADS / (STOCH ? HASH_FWD_GROUPS : 1);
  const size_t smem = (size_t)P * (lv.n_levels * F + 1) * sizeof(float);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(hash_forward_kernel<F, STOCH, DIM, Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && !STOCH)
    e = cudaFuncSetAttribute(hash_forward_kernel<F, STOCH, DIM, Rows>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             HASH_FWD_EXACT_CARVEOUT);
  if (e != cudaSuccess) return (int)e;
  const unsigned int blocks = (unsigned int)((n + P - 1) / P);
  hash_forward_kernel<F, STOCH, DIM, Rows><<<blocks, HASH_FWD_THREADS, smem, s>>>(
      pts, rows, u, n, T, lv, out, out_stride, bits);
  return (int)cudaGetLastError();
}

template <int F>
static int launch_cell_forward(const WorldPoints& pts, const float* table, long long n,
                               int T, const HbrLevels& lv, float* out,
                               long long out_stride, cudaStream_t s) {
  constexpr int P = HASH_FWD_THREADS;
  const size_t smem = (size_t)P * (lv.n_levels * F + 1) * sizeof(float);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(cell_forward_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(cell_forward_kernel<F>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             HASH_FWD_EXACT_CARVEOUT);
  if (e != cudaSuccess) return (int)e;
  const unsigned int blocks = (unsigned int)((n + P - 1) / P);
  cell_forward_kernel<F><<<blocks, P, smem, s>>>(pts, table, n, T, lv, out, out_stride);
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

static int launch_routed_backward(const WorldPoints& pts, const unsigned char* bits,
                                  const Routing& rt, const float* g, long long g_stride,
                                  long long n, int F, int T, const HbrLevels& lv,
                                  float* dtable, cudaStream_t s) {
  routed_backward_kernel<<<item_blocks(n, HASH_BWD_THREADS), HASH_BWD_THREADS, 0, s>>>(
      pts, bits, rt, g, g_stride, n, F, T, lv, dtable);
  return (int)cudaGetLastError();
}

template <int F>
static int launch_cell_backward(const WorldPoints& pts, const float* g, long long g_stride,
                                long long n, int T, const HbrLevels& lv, float* dtable,
                                cudaStream_t s) {
  const long long units = (n + HASH_RUN - 1) / HASH_RUN * lv.n_levels;
  int blocks = 0;
  const int err = persistent_blocks(cell_backward_kernel<F>, HASH_BWD_THREADS, 0,
                                    (units + HASH_BWD_THREADS - 1) / HASH_BWD_THREADS,
                                    &blocks);
  if (err) return err;
  cell_backward_kernel<F><<<blocks, HASH_BWD_THREADS, 0, s>>>(pts, g, g_stride, n, T, lv,
                                                              dtable);
  return (int)cudaGetLastError();
}

// fn(std::integral_constant<int, F>()) for F = features, 1 to 4 (a word's
// bytes).
template <typename Fn>
static int with_word_features(int features, Fn fn) {
  switch (features) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 3: return fn(std::integral_constant<int, 3>());
    case 4: return fn(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// The int8 pack: one cluster of PACK_CLUSTER blocks a level.
template <int F, int THREADS = PACK_INT8_THREADS, int VALUES = PACK_VALUES>
static int launch_pack_int8(const float* table, long long L, long long T, float* scale,
                            unsigned* words, cudaStream_t s) {
  const auto kernel = pack_int8_kernel<F, THREADS, VALUES>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PACK_CLUSTER;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(PACK_CLUSTER, (unsigned)L);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, table, T, scale, words);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The level routing of a subsampled backward: (lvl_scale, valid).
static bool level_routing(const unsigned char* lsel, const unsigned char* psel, int L,
                          float* lvl_scale) {
  *lvl_scale = lsel != nullptr ? (float)L : psel != nullptr ? 2.0f : 1.0f;
  return !(lsel != nullptr && psel != nullptr) && !(psel != nullptr && L % 2);
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
  const F32Rows rows{table};
  return with_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    const cudaStream_t s = (cudaStream_t)stream;
    if (dim == 2)
      return launch_hash_forward<F, false, 2>(pts, rows, u, n, table_size, *lv, out,
                                              out_stride, bits, s);
    if (u != nullptr)
      return launch_hash_forward<F, true, 3>(pts, rows, u, n, table_size, *lv, out,
                                             out_stride, bits, s);
    return launch_hash_forward<F, false, 3>(pts, rows, u, n, table_size, *lv, out,
                                            out_stride, bits, s);
  });
}

// bits: (L, n) uint8 from the stochastic forward (3-D), or null (exact).
// pick (L, n) uint8, with bits: the subsampled backward, one thread a point
// and its drawn terms (g[pick] * sub_scale) * s in feature pick, s = L on
// the level lsel (n,) draws, 2 on the level of each pair psel (L / 2, n)
// draws (at most one of the two), else 1 on every level.  dtable (L, T, F)
// f32 must be zeroed.
int hbr_hash_backward(const float* x, const float* mu, const float* sigma,
                      const unsigned char* bits, const unsigned char* pick,
                      const unsigned char* lsel, const unsigned char* psel,
                      const float* g, long long g_stride, long long n, int dim,
                      int table_size, int features, float sub_scale,
                      const HbrLevels* lv, float* dtable, void* stream) {
  if (n <= 0) return 0;
  Routing rt{pick, lsel, psel, sub_scale, 1.0f};
  if ((dim != 2 && dim != 3) || (dim == 2 && bits != nullptr) ||
      (pick != nullptr && bits == nullptr) ||
      (pick == nullptr && (lsel != nullptr || psel != nullptr)) ||
      !level_routing(lsel, psel, lv->n_levels, &rt.lvl_scale) || features < 1 ||
      features > 8)
    return (int)cudaErrorInvalidValue;
  const WorldPoints pts{x, mu, sigma, 1};
  const cudaStream_t s = (cudaStream_t)stream;
  if (pick != nullptr)
    return launch_routed_backward(pts, bits, rt, g, g_stride, n, features, table_size,
                                  *lv, dtable, s);
  return with_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    if (dim == 2)
      return launch_hash_backward<F, false, 2>(pts, bits, g, g_stride, n, table_size, *lv,
                                               dtable, s);
    if (bits != nullptr)
      return launch_hash_backward<F, true, 3>(pts, bits, g, g_stride, n, table_size, *lv,
                                              dtable, s);
    return launch_hash_backward<F, false, 3>(pts, bits, g, g_stride, n, table_size, *lv,
                                             dtable, s);
  });
}

// Packs the table (L, T, F) f32 into words (L * T,) uint32: format 0, bf16
// pairs (F 2); format 1, int8 bytes (F 1 to 4), writing scale (L,) f32 too.
// One launch either way; table and words from 16-byte aligned addresses.
int hbr_hash_pack(const float* table, long long L, long long T, int features,
                  int format, unsigned* words, float* scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long rows = L * T;
  if (rows <= 0) return 0;
  if ((reinterpret_cast<unsigned long long>(table) |
       reinterpret_cast<unsigned long long>(words)) % 16)
    return (int)cudaErrorInvalidValue;
  if (format == 0) {
    if (features != 2) return (int)cudaErrorInvalidValue;
    pack_bf16_kernel<<<item_blocks((rows + 3) / 4, PACK_THREADS), PACK_THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(table), rows, reinterpret_cast<uint4*>(words));
    return (int)cudaGetLastError();
  }
  if (format != 1 || scale == nullptr || L > 65535) return (int)cudaErrorInvalidValue;
  return with_word_features(features, [&](auto f) {
    return launch_pack_int8<decltype(f)::value>(table, L, T, scale, words, s);
  });
}

// The packed forward (3-D): words (L * T,) uint32 from hbr_hash_pack (format
// 0 bf16, F 2; 1 int8, F 1 to 4, with its scale (L,)); stochastic given u (3,
// L, n) and bits (L, n), packed-exact with both null.
int hbr_hash_packed_forward(const float* x, const float* mu, const float* sigma,
                            const unsigned* words, const float* scale, const float* u,
                            long long n, int table_size, int features, int format,
                            const HbrLevels* lv, float* out, long long out_stride,
                            unsigned char* bits, void* stream) {
  if (n <= 0) return 0;
  if ((u == nullptr) != (bits == nullptr) || (format == 0 && features != 2) ||
      (format == 1 && scale == nullptr) || (format != 0 && format != 1))
    return (int)cudaErrorInvalidValue;
  const WorldPoints pts{x, mu, sigma, 1};
  const cudaStream_t s = (cudaStream_t)stream;
  if (format == 0) {
    const Bf16Words rows{words};
    if (u != nullptr)
      return launch_hash_forward<2, true, 3>(pts, rows, u, n, table_size, *lv, out,
                                             out_stride, bits, s);
    return launch_hash_forward<2, false, 3>(pts, rows, u, n, table_size, *lv, out,
                                            out_stride, bits, s);
  }
  const Int8Words rows{words, scale};
  return with_word_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    if (u != nullptr)
      return launch_hash_forward<F, true, 3>(pts, rows, u, n, table_size, *lv, out,
                                             out_stride, bits, s);
    return launch_hash_forward<F, false, 3>(pts, rows, u, n, table_size, *lv, out,
                                            out_stride, bits, s);
  });
}

// The cell variant (3-D): table (L, T, 8 * features) f32 from a 16-byte
// aligned address.
int hbr_hash_cell_forward(const float* x, const float* mu, const float* sigma,
                          const float* table, long long n, int table_size, int features,
                          const HbrLevels* lv, float* out, long long out_stride,
                          void* stream) {
  if (n <= 0) return 0;
  const WorldPoints pts{x, mu, sigma, 1};
  return with_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    return launch_cell_forward<F>(pts, table, n, table_size, *lv, out, out_stride,
                                  (cudaStream_t)stream);
  });
}

// dtable (L, T, 8 * features) f32 must be zeroed.
int hbr_hash_cell_backward(const float* x, const float* mu, const float* sigma,
                           const float* g, long long g_stride, long long n,
                           int table_size, int features, const HbrLevels* lv,
                           float* dtable, void* stream) {
  if (n <= 0) return 0;
  const WorldPoints pts{x, mu, sigma, 1};
  return with_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    return launch_cell_backward<F>(pts, g, g_stride, n, table_size, *lv, dtable,
                                   (cudaStream_t)stream);
  });
}

// The (flat index, value) pairs of a stochastic backward (3-D), for the sorted
// strategies: pick null (then lsel and psel null too), F a (point, level);
// else as hbr_hash_backward routes them.  idx (int32) and val (f32) hold
// F * L * n, L * n, n or L / 2 * n pairs.
int hbr_hash_pairs(const float* x, const float* mu, const float* sigma,
                   const unsigned char* bits, const unsigned char* pick,
                   const unsigned char* lsel, const unsigned char* psel, const float* g,
                   long long g_stride, long long n, int table_size, int features,
                   float sub_scale, const HbrLevels* lv, int* idx, float* val,
                   void* stream) {
  if (n <= 0) return 0;
  Routing rt{pick, lsel, psel, sub_scale, 1.0f};
  if (bits == nullptr || !level_routing(lsel, psel, lv->n_levels, &rt.lvl_scale) ||
      (pick == nullptr && (lsel != nullptr || psel != nullptr)))
    return (int)cudaErrorInvalidValue;
  const WorldPoints pts{x, mu, sigma, 1};
  const long long items = (long long)rt.groups(lv->n_levels) * n;
  return with_word_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    pairs_kernel<F><<<item_blocks(items, HASH_BWD_THREADS), HASH_BWD_THREADS, 0,
                      (cudaStream_t)stream>>>(pts, bits, rt, g, g_stride, n, table_size,
                                              *lv, idx, val);
    return (int)cudaGetLastError();
  });
}

// out (f32, zeroed) += the m pairs (idx, val) sorted by idx: strategy 0
// "sorted" (a thread's 16 consecutive pairs merged run by run, one atomic a
// run), 1 "segsum" (each run summed by the thread at its start, stored once).
int hbr_scatter_sorted(const int* idx, const float* val, long long m, int strategy,
                       float* out, void* stream) {
  if (m <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (strategy == 0) {
    scatter_sorted_kernel<<<item_blocks((m + SCATTER_RUN - 1) / SCATTER_RUN,
                                        SCATTER_THREADS),
                            SCATTER_THREADS, 0, s>>>(idx, val, m, out);
  } else if (strategy == 1) {
    scatter_segsum_kernel<<<item_blocks(m, SCATTER_THREADS), SCATTER_THREADS, 0, s>>>(
        idx, val, m, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
