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
// hash_encode_stochastic: corner c is picked with its trilinear weight).
// hbr_hash_backward: the table gradient, corners recomputed from the points
// (and from u in stochastic mode, which is kept alive by the autograd
// Function in place of an (L, N) index of picked rows): exact mode adds
// w * g into each corner's F entries, stochastic mode adds g into the picked
// corner's.  The sums are f32 atomicAdd, so their order changes from run to
// run; the plain versions use index_add_.
//
// What bounds them: the bytes of the point-major arrays, not the gathers.
// At the training path's 1,024,000 points and 16 levels the forward writes a
// 131 MB (N, 32) f32 feature block and reads the 197 MB of uniforms in
// stochastic mode; the backward reads the same 131 MB gradient block.  The
// gathers (8 or 1 rows of 8 bytes per point and level) hit the L2-resident
// table.  The design answers that with tiles of HASH_POINTS points per block:
// work items are (level, point) with the point fastest, so the uniforms
// (3, L, N) are read coalesced; the features of the tile are staged in shared
// memory and written (forward), or its gradient rows read (backward), as one
// contiguous span of row-strided rows, so that the encoder's dense and hashed
// columns share one (N, out_dim) matrix with no concatenation pass.  The
// staged rows are padded by one word (L * F + 1), so that the point-fastest
// work items touch 32 different shared-memory banks, and the exact sum is
// kept in registers until its one store.
//
// Numerics follow hash_encode step for step, so the forward equals its plain
// version (ops/hash_kernel.py) bit for bit: xn = (x - mu) / sigma as a true
// division, xl = xn * scale_l with the f32 cast of the float64 level scale,
// frac = xl - floor(xl) (no clipping: points outside [0, 1]^3 hash their
// wrapped coordinates, as the JAX uint32 cast does), corner weights
// ((w_0 * w_1) * w_2) and the sum over corners c = 0..7 (offset bit d of c is
// (c >> d) & 1) from 0, each operation a _rn intrinsic so nothing is
// contracted into an FMA.

#include <cuda_runtime.h>

#include "levels.cuh"

namespace {

constexpr int HASH_POINTS = 64;  // points per block (tile)
constexpr int HASH_THREADS = 256;
constexpr int HASH_MAX_F = 8;    // features per level (ops/hash_kernel.py)

__device__ __forceinline__ unsigned hash3(unsigned c0, unsigned c1, unsigned c2,
                                          unsigned mask) {
  return (c0 ^ (c1 * 2654435761u) ^ (c2 * 805459861u)) & mask;
}

// Cell x0 (as int) and frac of one (point, level) for each axis.
__device__ __forceinline__ void level_coords(const float* __restrict__ x,
                                             const float* __restrict__ mu,
                                             const float* __restrict__ sigma,
                                             long long pt, float scale, int x0[3],
                                             float fr[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float xn = __fdiv_rn(__fsub_rn(__ldg(x + pt * 3 + d), __ldg(mu + d)),
                               __ldg(sigma + d));
    const float xl = __fmul_rn(xn, scale);
    const float x0f = floorf(xl);
    fr[d] = __fsub_rn(xl, x0f);
    x0[d] = (int)x0f;
  }
}

// The picked corner's coordinates, from u (3, L, n) at (level l, point pt).
__device__ __forceinline__ unsigned picked_row(const float* __restrict__ u, int L,
                                               int l, long long n, long long pt,
                                               const int x0[3], const float fr[3],
                                               unsigned mask) {
  unsigned c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float ud = __ldg(u + ((long long)d * L + l) * n + pt);
    c[d] = (unsigned)(x0[d] + (ud < fr[d] ? 1 : 0));
  }
  return hash3(c[0], c[1], c[2], mask);
}

// Corner c: its hashed row and its trilinear weight ((w_0 * w_1) * w_2).
__device__ __forceinline__ unsigned corner_row(int c, const int x0[3],
                                               const float fr[3], unsigned mask,
                                               float* w) {
  const int b0 = c & 1, b1 = (c >> 1) & 1, b2 = (c >> 2) & 1;
  const float w0 = b0 ? fr[0] : __fsub_rn(1.0f, fr[0]);
  const float w1 = b1 ? fr[1] : __fsub_rn(1.0f, fr[1]);
  const float w2 = b2 ? fr[2] : __fsub_rn(1.0f, fr[2]);
  *w = __fmul_rn(__fmul_rn(w0, w1), w2);
  return hash3((unsigned)(x0[0] + b0), (unsigned)(x0[1] + b1),
               (unsigned)(x0[2] + b2), mask);
}

// table: (L, T, F) f32; level l's rows start at lv.offset[l] = l * T.
// out[p, l*F + f], row stride out_stride.  u == nullptr: exact mode.
__global__ void __launch_bounds__(HASH_THREADS)
hash_forward_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ sigma, const float* __restrict__ table,
                    const float* __restrict__ u, long long n, int T, int F,
                    HbrLevels lv, float* __restrict__ out, long long out_stride) {
  extern __shared__ float s_feat[];  // (HASH_POINTS, L * F + 1)
  const int L = lv.n_levels;
  const int C = L * F;
  const int row_words = C + 1;
  const long long p0 = (long long)blockIdx.x * HASH_POINTS;
  const int np = (int)min((long long)HASH_POINTS, n - p0);
  const unsigned mask = (unsigned)(T - 1);

  for (int t = threadIdx.x; t < np * L; t += blockDim.x) {
    const int l = t / np;
    const int p = t - l * np;
    const long long pt = p0 + p;
    int x0[3];
    float fr[3];
    level_coords(x, mu, sigma, pt, lv.scale[l], x0, fr);
    const float* tl = table + (long long)lv.offset[l] * F;
    float* dst = s_feat + p * row_words + l * F;
    if (u != nullptr) {
      const float* row = tl + (long long)picked_row(u, L, l, n, pt, x0, fr, mask) * F;
      for (int f = 0; f < F; ++f) dst[f] = __ldg(row + f);
    } else {
      float acc[HASH_MAX_F];
#pragma unroll
      for (int f = 0; f < HASH_MAX_F; ++f) acc[f] = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float w;
        const float* row = tl + (long long)corner_row(c, x0, fr, mask, &w) * F;
#pragma unroll
        for (int f = 0; f < HASH_MAX_F; ++f)
          if (f < F) acc[f] = __fadd_rn(acc[f], __fmul_rn(__ldg(row + f), w));
      }
#pragma unroll
      for (int f = 0; f < HASH_MAX_F; ++f)
        if (f < F) dst[f] = acc[f];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < np * C; t += blockDim.x) {
    const int p = t / C;
    const int c = t - p * C;
    out[(p0 + p) * out_stride + c] = s_feat[p * row_words + c];
  }
}

// dtable: (L, T, F) f32, zeroed by the caller.  g: (n, L*F), row stride
// g_stride.  u == nullptr: exact mode.
__global__ void __launch_bounds__(HASH_THREADS)
hash_backward_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                     const float* __restrict__ sigma, const float* __restrict__ u,
                     const float* __restrict__ g, long long g_stride, long long n,
                     int T, int F, HbrLevels lv, float* __restrict__ dtable) {
  extern __shared__ float s_g[];  // (HASH_POINTS, L * F + 1)
  const int L = lv.n_levels;
  const int C = L * F;
  const int row_words = C + 1;
  const long long p0 = (long long)blockIdx.x * HASH_POINTS;
  const int np = (int)min((long long)HASH_POINTS, n - p0);
  const unsigned mask = (unsigned)(T - 1);

  for (int t = threadIdx.x; t < np * C; t += blockDim.x) {
    const int p = t / C;
    const int c = t - p * C;
    s_g[p * row_words + c] = g[(p0 + p) * g_stride + c];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < np * L; t += blockDim.x) {
    const int l = t / np;
    const int p = t - l * np;
    const long long pt = p0 + p;
    int x0[3];
    float fr[3];
    level_coords(x, mu, sigma, pt, lv.scale[l], x0, fr);
    float* dl = dtable + (long long)lv.offset[l] * F;
    const float* gp = s_g + p * row_words + l * F;
    if (u != nullptr) {
      float* row = dl + (long long)picked_row(u, L, l, n, pt, x0, fr, mask) * F;
      for (int f = 0; f < F; ++f) atomicAdd(row + f, gp[f]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float w;
        float* row = dl + (long long)corner_row(c, x0, fr, mask, &w) * F;
        for (int f = 0; f < F; ++f) atomicAdd(row + f, __fmul_rn(gp[f], w));
      }
    }
  }
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 = ok).
// x: (n, 3) f32; mu, sigma: (3,) f32 on the device; u: (3, L, n) f32 or null.
int hbr_hash_forward(const float* x, const float* mu, const float* sigma,
                     const float* table, const float* u, long long n,
                     int table_size, int features, const HbrLevels* lv, float* out,
                     long long out_stride, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + HASH_POINTS - 1) / HASH_POINTS);
  const size_t smem = (size_t)HASH_POINTS * (lv->n_levels * features + 1) * sizeof(float);
  hash_forward_kernel<<<blocks, HASH_THREADS, smem, (cudaStream_t)stream>>>(
      x, mu, sigma, table, u, n, table_size, features, *lv, out, out_stride);
  return (int)cudaGetLastError();
}

// dtable (L, T, F) f32 must be zeroed.
int hbr_hash_backward(const float* x, const float* mu, const float* sigma,
                      const float* u, const float* g, long long g_stride,
                      long long n, int table_size, int features, const HbrLevels* lv,
                      float* dtable, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + HASH_POINTS - 1) / HASH_POINTS);
  const size_t smem = (size_t)HASH_POINTS * (lv->n_levels * features + 1) * sizeof(float);
  hash_backward_kernel<<<blocks, HASH_THREADS, smem, (cudaStream_t)stream>>>(
      x, mu, sigma, u, g, g_stride, n, table_size, features, *lv, dtable);
  return (int)cudaGetLastError();
}

}  // extern "C"
