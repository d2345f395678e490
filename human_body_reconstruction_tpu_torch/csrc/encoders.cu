// Forward and backward kernels of the two encoders, for Hopper (sm_90a).  The
// forward kernels are described first; the backward ones, with their own
// note, follow them.
//
// hbr_cp_forward replaces human_body_reconstruction_tpu/ops/cp_pallas.py
// _fwd_kernel (and _fwd_kernel_axis, its per-axis split for high ranks):
// every CP level's three factor lines are linearly interpolated at the point
// and multiplied across the axes, giving features (N, L*R) in f32.
//
// hbr_dense_forward replaces human_body_reconstruction_tpu/ops/dense_pallas.py
// _fwd_kernel: trilinear interpolation of each dense coarse grid (G, G, G, F),
// giving features (N, D*F) in f32.
//
// The TPU kernels evaluate both as two-hot matrix products because every
// random read there costs a whole memory tile.  That costs about
// 3 * sum_G * C_pad * 2 = 2.2 MFLOP per point for CP at the flagship
// ladder.  On this card the bf16 factor lines (3 * 2685 * 25 * 2 B, about
// 0.4 MB) and grids (about 0.2 MB) stay resident in the 50 MB L2, so a direct
// gather-and-lerp computes the same function with about 1 kFLOP per point.
// What bounds it is the L2 reads of the gathered rows (1.5 KB per point for
// CP) and the HBM writes of the (N, C) f32 output (500 B per point for CP).
// The design answers that as follows:
//  * the CP kernel gives each block a tile of points.  It first computes every
//    (point, level, axis) cell and lerp weight once, into shared memory.  Then
//    consecutive threads take consecutive output columns, so the output rows
//    of the tile are written as one contiguous, coalesced span and
//    neighbouring threads read neighbouring entries of the same line rows;
//  * the dense kernel gives one thread to a point (D*F is 4 at the flagship);
//  * both write into a caller-given row stride, so that the encoder's dense and
//    CP features land side by side in one (N, D*F + L*R) matrix with no
//    concatenation pass.
//
// Numerics follow the TPU kernels: factor lines and grids are bf16 (with
// bf16 = 1); the CP lerp weights 1-frac and frac and the dense pair weights
// wy*wz are computed in f32 and then rounded to bf16; accumulation is f32.
// With bf16 = 0 nothing is rounded.  Every multiply and add is written with
// the _rn intrinsics so the compiler cannot contract it into an FMA: the plain
// PyTorch versions (ops/cp_kernel.py, ops/dense_kernel.py) do the same
// operations in the same order, and the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "levels.cuh"

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Weight rounding: to bf16 and back when the tables are bf16, none in f32.
template <typename T>
__device__ __forceinline__ float round_w(float w);
template <>
__device__ __forceinline__ float round_w<float>(float w) {
  return w;
}
template <>
__device__ __forceinline__ float round_w<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// x0 = clip(floor(xl), 0, g-2) and frac = clip(xl - floor(xl), 0, 1) for
// xl = xn * scale (cp_pallas.py:416-423).  Points outside the box keep their
// fractional part: the position itself is never clamped.
__device__ __forceinline__ void axis_coord(float xn, float scale, int g,
                                           int* x0, float* frac) {
  const float xl = __fmul_rn(xn, scale);
  const float x0f = floorf(xl);
  *frac = fminf(fmaxf(__fsub_rn(xl, x0f), 0.0f), 1.0f);
  *x0 = (int)fminf(fmaxf(x0f, 0.0f), (float)(g - 2));
}

constexpr int CP_POINTS = 32;    // points per block
constexpr int CP_THREADS = 256;

// lines: (3, total_rows, rank), level l in rows [offset[l], offset[l] + size[l]).
// out[p, l*rank + r] = prod_d lerp(lines[d, offset[l] + x0_d], lines[d, ... + 1]).
template <typename T>
__global__ void __launch_bounds__(CP_THREADS)
cp_forward_kernel(const float* __restrict__ xn, const T* __restrict__ lines,
                  long long n, int total_rows, int rank, HbrLevels lv,
                  float* __restrict__ out, long long out_stride) {
  __shared__ int s_row[CP_POINTS * HBR_MAX_LEVELS * 3];
  __shared__ float s_lo[CP_POINTS * HBR_MAX_LEVELS * 3];
  __shared__ float s_hi[CP_POINTS * HBR_MAX_LEVELS * 3];
  const int L = lv.n_levels;
  const long long p0 = (long long)blockIdx.x * CP_POINTS;
  const int np = (int)min((long long)CP_POINTS, n - p0);

  // Phase 1: one (point, level, axis) cell and its two weights per entry.
  for (int t = threadIdx.x; t < np * L * 3; t += blockDim.x) {
    const int p = t / (L * 3);
    const int l = (t / 3) % L;
    const int d = t % 3;
    int x0;
    float frac;
    axis_coord(xn[(p0 + p) * 3 + d], lv.scale[l], lv.size[l], &x0, &frac);
    s_row[t] = d * total_rows + lv.offset[l] + x0;
    s_lo[t] = round_w<T>(__fsub_rn(1.0f, frac));
    s_hi[t] = round_w<T>(frac);
  }
  __syncthreads();

  // Phase 2: consecutive threads take consecutive output columns.
  const int C = L * rank;
  for (int t = threadIdx.x; t < np * C; t += blockDim.x) {
    const int p = t / C;
    const int c = t - p * C;
    const int l = c / rank;
    const int r = c - l * rank;
    const int base = (p * L + l) * 3;
    float f = 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T* row = lines + (long long)s_row[base + d] * rank + r;
      const float td = __fadd_rn(__fmul_rn(s_lo[base + d], load_f32(row)),
                                 __fmul_rn(s_hi[base + d], load_f32(row + rank)));
      f = d == 0 ? td : __fmul_rn(f, td);
    }
    out[(p0 + p) * out_stride + c] = f;
  }
}

constexpr int DENSE_THREADS = 128;

// grids: each level's (G, G, G, F) grid flattened, level l from offset[l].
// For each x corner a: T_a = sum over the four (y, z) corners of
// round(wy*wz) * grid, then out = round(T_0*wx_0) + round(T_1*wx_1), which is
// dense_pallas.py's pair-weight product followed by its fold over x.
template <typename T>
__global__ void __launch_bounds__(DENSE_THREADS)
dense_forward_kernel(const float* __restrict__ xn, const T* __restrict__ grids,
                     long long n, int F, HbrLevels lv, float* __restrict__ out,
                     long long out_stride) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float pos[3] = {xn[p * 3], xn[p * 3 + 1], xn[p * 3 + 2]};
  for (int l = 0; l < lv.n_levels; ++l) {
    const int g = lv.size[l];
    int i0[3];
    float fr[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) axis_coord(pos[d], lv.scale[l], g, &i0[d], &fr[d]);
    const float wx[2] = {__fsub_rn(1.0f, fr[0]), fr[0]};
    const float wy[2] = {__fsub_rn(1.0f, fr[1]), fr[1]};
    const float wz[2] = {__fsub_rn(1.0f, fr[2]), fr[2]};
    float pair[2][2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c) pair[b][c] = round_w<T>(__fmul_rn(wy[b], wz[c]));
    const T* grid = grids + lv.offset[l];
    for (int f = 0; f < F; ++f) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const long long xrow = (long long)(i0[0] + a) * g;
        float t = 0.0f;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const long long idx = ((xrow + i0[1] + b) * g + i0[2] + c) * F + f;
            const float term = __fmul_rn(pair[b][c], load_f32(grid + idx));
            t = (b == 0 && c == 0) ? term : __fadd_rn(t, term);
          }
        }
        const float folded = round_w<T>(__fmul_rn(t, wx[a]));
        acc = a == 0 ? folded : __fadd_rn(acc, folded);
      }
      out[p * out_stride + l * F + f] = acc;
    }
  }
}

// ---------------------------------------------------------------- backward
//
// hbr_cp_backward replaces cp_pallas.py _bwd_kernel (the VJP
// _cp_matmul_bwd): dM_d = W(x_d)^T @ bf16(dT_d), summed over every point.
// hbr_dense_backward replaces dense_pallas.py _bwd_kernel (the VJP
// _dense_matmul_bwd): dmat = sum W_yz^T @ bf16((dOut @ S^T) * hat_x).
//
// On the TPU both are two-hot matrix products whose (rows, C) accumulator
// stays resident over a sequential sweep of point tiles.  Here each point
// scatters its few non-zero terms directly: per (point, CP level, rank
// column) two rows of each of the three axis lines, per (point, dense level,
// feature) the eight trilinear corners.  Blocks run concurrently, so the
// cross-block sum is f32 atomicAdd (not a split-K partial-then-reduce).  What
// bounds these kernels is atomic throughput and, on the coarse levels,
// address contention: 2M points fold into a few thousand addresses (the
// coarsest CP level is 73 rows x 25 columns x 3 axes, the coarsest dense grid
// 18^3 x 2).  The design answers that with a block-private shared-memory
// accumulator for the leading (coarsest) levels that fit a byte budget the
// caller chooses: blocks are persistent (as many as fit on the card, each
// walking a strided range of point tiles), add into shared memory, and flush
// once at the end with one global atomicAdd per non-zero entry.  The finer
// levels (whose addresses spread the contention anyway) go straight to
// global atomics.  The caller zeroes the f32 output and rounds it to bf16
// afterwards (the .astype(bfloat16) of the Pallas VJP).
//
// Numerics follow the Pallas kernels term by term (with bf16 = 1):
//  * CP: T_d is recomputed by the forward's gather-and-lerp; dT_d = g*T_e*T_f
//    in f32 in the product-rule order of XLA's (T_0*T_1)*T_2 (dT_0 =
//    (g*T_2)*T_1, dT_1 = T_0*(g*T_2), dT_2 = (T_0*T_1)*g), rounded to bf16;
//    rows x0 and x0+1 receive bf16(1-frac)*dT_d and bf16(frac)*dT_d.
//  * dense: bf16(bf16(dout_f) * wx_a) * bf16(wy_b * wz_c) per corner.
// Each term is exact in f32 (a product of two bf16 values); only the order of
// the f32 sums differs from the TPU's and from the plain PyTorch versions'
// (which use index_add_), so results agree to one bf16 ulp after rounding.
// With bf16 = 0 nothing is rounded.

constexpr int BWD_THREADS = 256;

template <typename K>
static int persistent_blocks(K kernel, size_t smem, long long work_blocks,
                             int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      BWD_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = (int)(work_blocks < cap ? work_blocks : cap);
  return 0;
}

__device__ __forceinline__ void add_f32(float* shared_acc, float* global_acc,
                                        bool in_shared, long long idx, float v) {
  if (in_shared) {
    atomicAdd(shared_acc + idx, v);
  } else {
    atomicAdd(global_acc + idx, v);
  }
}

__device__ __forceinline__ void flush_shared(const float* s_acc, int n,
                                             float* out) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = s_acc[i];
    if (v != 0.0f) atomicAdd(out + i, v);
  }
}

// dlines: (3, total_rows, rank) f32, zeroed by the caller.  Rows below
// shared_rows (the leading levels) accumulate in shared memory, laid out as
// (3, shared_rows, rank).  g: (n, L*rank) with row stride g_stride.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
cp_backward_kernel(const float* __restrict__ xn, const T* __restrict__ lines,
                   const float* __restrict__ g, long long g_stride, long long n,
                   int total_rows, int rank, HbrLevels lv, int shared_rows,
                   float* __restrict__ dlines) {
  extern __shared__ float s_acc[];
  __shared__ int s_row[CP_POINTS * HBR_MAX_LEVELS * 3];
  __shared__ float s_lo[CP_POINTS * HBR_MAX_LEVELS * 3];
  __shared__ float s_hi[CP_POINTS * HBR_MAX_LEVELS * 3];
  const int L = lv.n_levels;
  const int C = L * rank;
  const int acc_n = 3 * shared_rows * rank;
  for (int i = threadIdx.x; i < acc_n; i += blockDim.x) s_acc[i] = 0.0f;

  for (long long p0 = (long long)blockIdx.x * CP_POINTS; p0 < n;
       p0 += (long long)gridDim.x * CP_POINTS) {
    const int np = (int)min((long long)CP_POINTS, n - p0);
    __syncthreads();  // the previous tile's phase 2 is done with s_row
    for (int t = threadIdx.x; t < np * L * 3; t += blockDim.x) {
      const int p = t / (L * 3);
      const int l = (t / 3) % L;
      const int d = t % 3;
      int x0;
      float frac;
      axis_coord(xn[(p0 + p) * 3 + d], lv.scale[l], lv.size[l], &x0, &frac);
      s_row[t] = lv.offset[l] + x0;  // row within the axis
      s_lo[t] = round_w<T>(__fsub_rn(1.0f, frac));
      s_hi[t] = round_w<T>(frac);
    }
    __syncthreads();

    for (int t = threadIdx.x; t < np * C; t += blockDim.x) {
      const int p = t / C;
      const int c = t - p * C;
      const int l = c / rank;
      const int r = c - l * rank;
      const int base = (p * L + l) * 3;
      float td[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T* row = lines + ((long long)d * total_rows + s_row[base + d]) * rank + r;
        td[d] = __fadd_rn(__fmul_rn(s_lo[base + d], load_f32(row)),
                          __fmul_rn(s_hi[base + d], load_f32(row + rank)));
      }
      const float gv = g[(p0 + p) * g_stride + c];
      const float dp = __fmul_rn(gv, td[2]);
      const float dtd[3] = {__fmul_rn(dp, td[1]), __fmul_rn(td[0], dp),
                            __fmul_rn(__fmul_rn(td[0], td[1]), gv)};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float dt = round_w<T>(dtd[d]);
        const int row = s_row[base + d];
        const bool sh = row < shared_rows;  // a level is wholly in or out
        const long long idx = sh ? ((long long)d * shared_rows + row) * rank + r
                                 : ((long long)d * total_rows + row) * rank + r;
        add_f32(s_acc, dlines, sh, idx, __fmul_rn(s_lo[base + d], dt));
        add_f32(s_acc, dlines, sh, idx + rank, __fmul_rn(s_hi[base + d], dt));
      }
    }
  }
  __syncthreads();
  for (int d = 0; d < 3; ++d)
    flush_shared(s_acc + (long long)d * shared_rows * rank, shared_rows * rank,
                 dlines + (long long)d * total_rows * rank);
}

// dgrids: every level's (G, G, G, F) grid flattened, level l from offset[l],
// zeroed by the caller.  Elements below shared_elems (the leading levels)
// accumulate in shared memory.  g: (n, D*F) with row stride g_stride.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
dense_backward_kernel(const float* __restrict__ xn, const float* __restrict__ g,
                      long long g_stride, long long n, int F, HbrLevels lv,
                      int shared_elems, float* __restrict__ dgrids) {
  extern __shared__ float s_acc[];
  for (int i = threadIdx.x; i < shared_elems; i += blockDim.x) s_acc[i] = 0.0f;
  __syncthreads();
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const float pos[3] = {xn[p * 3], xn[p * 3 + 1], xn[p * 3 + 2]};
    for (int l = 0; l < lv.n_levels; ++l) {
      const int gs = lv.size[l];
      int i0[3];
      float fr[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) axis_coord(pos[d], lv.scale[l], gs, &i0[d], &fr[d]);
      const float wx[2] = {__fsub_rn(1.0f, fr[0]), fr[0]};
      const float wy[2] = {__fsub_rn(1.0f, fr[1]), fr[1]};
      const float wz[2] = {__fsub_rn(1.0f, fr[2]), fr[2]};
      float pair[2][2];
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) pair[b][c] = round_w<T>(__fmul_rn(wy[b], wz[c]));
      const long long off = lv.offset[l];
      const bool sh = off < shared_elems;  // a level is wholly in or out
      for (int f = 0; f < F; ++f) {
        const float gf = round_w<T>(g[p * g_stride + l * F + f]);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float da = round_w<T>(__fmul_rn(gf, wx[a]));
          const long long xrow = (long long)(i0[0] + a) * gs;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const long long idx = off + ((xrow + i0[1] + b) * gs + i0[2] + c) * F + f;
              add_f32(s_acc, dgrids, sh, idx, __fmul_rn(da, pair[b][c]));
            }
          }
        }
      }
    }
  }
  __syncthreads();
  flush_shared(s_acc, shared_elems, dgrids);
}

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 = ok).
int hbr_cp_forward(const float* xn, const void* lines, int bf16, long long n,
                   int total_rows, int rank, const HbrLevels* lv, float* out,
                   long long out_stride, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + CP_POINTS - 1) / CP_POINTS);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    cp_forward_kernel<__nv_bfloat16><<<blocks, CP_THREADS, 0, s>>>(
        xn, (const __nv_bfloat16*)lines, n, total_rows, rank, *lv, out, out_stride);
  } else {
    cp_forward_kernel<float><<<blocks, CP_THREADS, 0, s>>>(
        xn, (const float*)lines, n, total_rows, rank, *lv, out, out_stride);
  }
  return (int)cudaGetLastError();
}

int hbr_dense_forward(const float* xn, const void* grids, int bf16, long long n,
                      int features, const HbrLevels* lv, float* out,
                      long long out_stride, void* stream) {
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + DENSE_THREADS - 1) / DENSE_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    dense_forward_kernel<__nv_bfloat16><<<blocks, DENSE_THREADS, 0, s>>>(
        xn, (const __nv_bfloat16*)grids, n, features, *lv, out, out_stride);
  } else {
    dense_forward_kernel<float><<<blocks, DENSE_THREADS, 0, s>>>(
        xn, (const float*)grids, n, features, *lv, out, out_stride);
  }
  return (int)cudaGetLastError();
}

// dlines (3, total_rows, rank) f32 must be zeroed; shared_rows rows of each
// axis (whole leading levels) accumulate in shared memory first.
int hbr_cp_backward(const float* xn, const void* lines, int bf16, const float* g,
                    long long g_stride, long long n, int total_rows, int rank,
                    const HbrLevels* lv, int shared_rows, float* dlines,
                    void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)3 * shared_rows * rank * sizeof(float);
  const long long tiles = (n + CP_POINTS - 1) / CP_POINTS;
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0, err = 0;
  if (bf16) {
    err = persistent_blocks(cp_backward_kernel<__nv_bfloat16>, smem, tiles, &blocks);
    if (err) return err;
    cp_backward_kernel<__nv_bfloat16><<<blocks, BWD_THREADS, smem, s>>>(
        xn, (const __nv_bfloat16*)lines, g, g_stride, n, total_rows, rank, *lv,
        shared_rows, dlines);
  } else {
    err = persistent_blocks(cp_backward_kernel<float>, smem, tiles, &blocks);
    if (err) return err;
    cp_backward_kernel<float><<<blocks, BWD_THREADS, smem, s>>>(
        xn, (const float*)lines, g, g_stride, n, total_rows, rank, *lv,
        shared_rows, dlines);
  }
  return (int)cudaGetLastError();
}

// dgrids (sum of G^3 * F) f32 must be zeroed; its first shared_elems
// elements (whole leading levels) accumulate in shared memory first.
int hbr_dense_backward(const float* xn, int bf16, const float* g,
                       long long g_stride, long long n, int features,
                       const HbrLevels* lv, int shared_elems, float* dgrids,
                       void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)shared_elems * sizeof(float);
  const long long tiles = (n + BWD_THREADS - 1) / BWD_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0, err = 0;
  if (bf16) {
    err = persistent_blocks(dense_backward_kernel<__nv_bfloat16>, smem, tiles, &blocks);
    if (err) return err;
    dense_backward_kernel<__nv_bfloat16><<<blocks, BWD_THREADS, smem, s>>>(
        xn, g, g_stride, n, features, *lv, shared_elems, dgrids);
  } else {
    err = persistent_blocks(dense_backward_kernel<float>, smem, tiles, &blocks);
    if (err) return err;
    dense_backward_kernel<float><<<blocks, BWD_THREADS, smem, s>>>(
        xn, g, g_stride, n, features, *lv, shared_elems, dgrids);
  }
  return (int)cudaGetLastError();
}

const char* hbr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int hbr_max_levels(void) { return HBR_MAX_LEVELS; }

}  // extern "C"
