// Forward and backward kernels of the two encoders, for Hopper (sm_90a).  The
// CP factor-line kernels come first, with their note; the dense coarse-grid
// kernels, with theirs, follow.
//
// ------------------------------------------------------------ CP encoder
//
// hbr_cp_forward replaces human_body_reconstruction_tpu/ops/cp_pallas.py
// _fwd_kernel (and _fwd_kernel_axis, its per-axis split for high ranks);
// hbr_cp_backward replaces cp_pallas.py _bwd_kernel (the VJP _cp_matmul_bwd).
// Every CP level's three factor lines (3, G_l, R) are linearly interpolated
// at the point and multiplied across the axes, giving features (N, L*R) in
// f32; the backward scatters dT_d = g * T_e * T_f into rows x0 and x0+1 of
// each line.  The TPU kernels form both as two-hot matrix products, because
// every random read there costs a whole memory tile: 3 * sum_G * C_pad * 2 =
// 2.2 MFLOP a point at the flagship ladder (5 levels, G = 73, 154, 324, 685,
// 1449, sum_G = 2685, R = 25, C = 125).  On this card the lines (0.4 MB in
// bf16) stay in the 50 MB L2, and a gather-and-lerp does the same with about
// 1 kFLOP a point.
//
// Both kernels read the lines as the wrapper packs them, (3, sum_G, RPf) in
// the stored dtype with RPf = R rounded up to 8 and zero columns after R, so
// that every row starts 16-byte aligned and rows x0 and x0+1 are one aligned
// span.
//
// hbr_cp_forward.  What it must move: the points and the (N, C) f32 output,
// 500 B a point (1.05 GB, 0.31 ms of HBM at a 2,097,152-point serving
// chunk).  It also gathers 5 levels x 3 axes x 2 rows a point from L2, 1.5 KB
// of bf16, which one 2-byte column a thread reads in 150 loads.  The design:
//  * persistent blocks of CP_FWD_THREADS threads, two an SM, walk tiles of
//    points;
//  * one thread takes a (point, level, group of 8 columns), computes its
//    cells and weights in registers (no shared coordinate phase), and asks
//    for its 6 rows at once, each with one 16-byte load: 24 loads a point and
//    level;
//  * the products go to a double-buffered shared tile, which a warp a row
//    writes out, consecutive lanes on consecutive columns of the tile's
//    contiguous output span, in the caller's row stride: one barrier a tile.
// What binds it, measured on an H100: not HBM (0.94 ms against a 0.32 ms
// bound), not the gathers (the same points all in one cell take as long);
// by our count the instructions a point (about 4,400) are dispatched at a
// third of the card's peak rate while they wait on L2.  So the lines are read from L2:
// the coarse levels' lines copied into shared memory once a block (48 or
// 112 KB) were measured slower at every budget (PERF.md).
//
// hbr_cp_backward.  What it must move: the (N, C) gradient, 384 MB at 768,000
// points (0.118 ms).  What binds it is L2's atomic units: every (point, level,
// column) adds into 6 line rows, 576M terms at 768,000 points, and L2 applies
// about 230G f32 additions a second, whether they come one or four a request
// (measured: the time follows the rows added).  The design adds fewer of
// them:
//  * one thread walks a run of CP_RUN consecutive points for one (level,
//    group of 4 columns) and keeps, per axis, the two row partials of the
//    current cell in registers.  It adds them only when the cell changes
//    (carrying the shared row along when the cell moves by one) or the run
//    ends.  The trainer's points are a ray's samples in order, so on the
//    coarse levels and the minor axes a cell holds for many points: a
//    guided step's points add 15.1 rows a point where random points add 28.2
//    (1.0 on the coarsest level, 5.1 on the finest);
//  * the f32 accumulator is (3, sum_G, RP), RP = R rounded up to 4, so a
//    group of 4 columns of a row is 16-byte aligned and goes to L2 as one
//    vector reduction (atomicAdd on float4, REDG.E.ADD.F32 on 4 lanes): 7
//    requests a row at R = 25 where there were 25, and the last group's one
//    real column goes alone (no padding is added).
// Every add goes to L2: a block-private shared accumulator of the coarse
// levels (96 or 190 KB) was measured slower on the trainer's points
// (PERF.md), because shared f32 atomics are compare-and-swap loops on this
// card (ATOMS.CAST.SPIN) and a run's merged adds leave them little to save.
// The caller zeroes the accumulator, folds it to (3, sum_G, R) and rounds it
// to bf16 (the .astype(bfloat16) of the Pallas VJP).
//
// Numerics follow the TPU kernels: lines are bf16 (bf16 = 1); the lerp
// weights 1-frac and frac are computed in f32 and rounded to bf16; T_d =
// w_lo * line[x0] + w_hi * line[x0+1]; out = (T_0 * T_1) * T_2; dT_d in the
// product-rule order of XLA's (T_0*T_1)*T_2 (dT_0 = (g*T_2)*T_1, dT_1 =
// T_0*(g*T_2), dT_2 = (T_0*T_1)*g), rounded to bf16; the terms w_lo * dT_d
// and w_hi * dT_d.  With bf16 = 0 nothing is rounded.  Every multiply and add
// is an _rn intrinsic, which the compiler cannot contract into an FMA, and
// the plain PyTorch versions (ops/cp_kernel.py) do the same operations in the
// same order: the forward agrees with them bit for bit, and every term of the
// backward is the same f32 value as theirs (with bf16 = 1 a product of two
// bf16 values, exact in f32).  Only the order in which the backward sums its
// terms differs (the register partials of a run, then L2's atomics, against
// index_add_): that is an f32 sum of the same terms in another
// order, which ops/cuda_lib.sum_order_tolerance bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Two bf16 in one 32-bit word (the lower address in the low half), exactly.
__device__ __forceinline__ void bf16x2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// Four consecutive columns of a packed line row, as f32 (the row pointer is
// 8-byte (bf16) or 16-byte (f32) aligned).
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  bf16x2(raw.x, v);
  bf16x2(raw.y, v + 2);
}
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x;
  v[1] = raw.y;
  v[2] = raw.z;
  v[3] = raw.w;
}

// Eight consecutive columns of a packed line row (16-byte aligned), held as
// loaded (one 16-byte load in bf16, two in f32) and read as f32.
template <typename T>
struct Row8;
template <>
struct Row8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float operator[](int k) const {
    const uint32_t w = k < 2 ? raw.x : k < 4 ? raw.y : k < 6 ? raw.z : raw.w;
    return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
  }
};
template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ float operator[](int k) const {
    const float4& h = k < 4 ? a : b;
    const int i = k & 3;
    return i == 0 ? h.x : i == 1 ? h.y : i == 2 ? h.z : h.w;
  }
};

constexpr int CP_FWD_THREADS = 512;                    // 64 registers a thread
constexpr int CP_FWD_TILE_ITEMS = 2 * CP_FWD_THREADS;  // work items a tile
constexpr long long CP_FWD_STAGE_BYTES = 104 * 1024;   // both output tiles

// lines: (3, total_rows, rpf), level l in rows [offset[l], offset[l] +
// size[l]).  out[p, l*rank + r] = prod_d lerp(lines[d, offset[l] + x0_d],
// lines[d, offset[l] + x0_d + 1]) in column r.  Dynamic shared memory: two
// (tile_points, L*rank) f32 tiles.
template <typename T>
__global__ void __launch_bounds__(CP_FWD_THREADS, 2)
cp_forward_kernel(const float* __restrict__ xn, const T* __restrict__ lines,
                  long long n, int total_rows, int rank, int rpf, HbrLevels lv,
                  int tile_points, float* __restrict__ out, long long out_stride) {
  extern __shared__ float s_tiles[];
  const int L = lv.n_levels;
  const int C = L * rank;
  const int groups = rpf / 8;
  const int W = L * groups;

  const long long tiles = (n + tile_points - 1) / tile_points;
  int buf = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, buf ^= 1) {
    const long long p0 = t * tile_points;
    const int np = (int)min((long long)tile_points, n - p0);
    float* tile = s_tiles + (size_t)buf * tile_points * C;
    for (int i = threadIdx.x; i < np * W; i += blockDim.x) {
      const int p = i / W;
      const int lg = i - p * W;
      const int l = lg / groups;
      const int c0 = (lg - l * groups) * 8;
      const int off = lv.offset[l];
      const float* x = xn + (p0 + p) * 3;
      int x0[3];
      float w_lo[3], w_hi[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float frac;
        axis_coord(__ldg(x + d), lv.scale[l], lv.size[l], &x0[d], &frac);
        w_lo[d] = round_w<T>(__fsub_rn(1.0f, frac));
        w_hi[d] = round_w<T>(frac);
      }
      // all six rows are requested before any is used
      Row8<T> a[3], b[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T* row = lines + ((size_t)d * total_rows + off + x0[d]) * rpf + c0;
        a[d].load(row);
        b[d].load(row + rpf);
      }
      float f[8];
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float td = __fadd_rn(__fmul_rn(w_lo[d], a[d][k]), __fmul_rn(w_hi[d], b[d][k]));
          f[k] = d == 0 ? td : __fmul_rn(f[k], td);
        }
      float* dst = tile + p * C + l * rank + c0;
      const int nc = min(8, rank - c0);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < nc) dst[k] = f[k];
    }
    __syncthreads();
    // a warp a row, consecutive lanes on consecutive columns; the other
    // buffer is written next, so no second barrier is needed
    for (int p = threadIdx.x / 32; p < np; p += blockDim.x / 32) {
      float* row = out + (p0 + p) * out_stride;
      for (int c = threadIdx.x % 32; c < C; c += 32) row[c] = tile[p * C + c];
    }
  }
}

constexpr int CP_BWD_THREADS = 512;
constexpr int CP_RUN = 16;  // consecutive points a thread walks

// Adds the partials v of the nc real columns of a group of 4 into the
// accumulator at idx, to L2: one vector reduction of 4 (idx is a multiple of
// 4: 16-byte aligned), of 2, or one scalar (the group past R's last multiple
// of 4 sends no padding).
__device__ __forceinline__ void add_group(float* acc, size_t idx, const float* v, int nc) {
  if (v[0] == 0.0f && v[1] == 0.0f && v[2] == 0.0f && v[3] == 0.0f) return;
  if (nc == 4) {
    atomicAdd(reinterpret_cast<float4*>(acc + idx), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    if (nc >= 2) atomicAdd(reinterpret_cast<float2*>(acc + idx), make_float2(v[0], v[1]));
    else atomicAdd(acc + idx, v[0]);
    if (nc == 3) atomicAdd(acc + idx + 2, v[2]);
  }
}

// lines: (3, total_rows, rpf) as in the forward.  dacc: (3, total_rows, rp)
// f32, zeroed by the caller.  g: (n, L*rank) with row stride g_stride.  A
// unit is one (run of CP_RUN points, level, group of 4 columns); consecutive
// threads take consecutive units, so a warp reads a point's gradient row in
// order.
template <typename T>
__global__ void __launch_bounds__(CP_BWD_THREADS, 1)
cp_backward_kernel(const float* __restrict__ xn, const T* __restrict__ lines,
                   const float* __restrict__ g, long long g_stride, long long n,
                   int total_rows, int rank, int rpf, int rp, HbrLevels lv,
                   float* __restrict__ dacc) {
  const int groups = rp / 4;
  const int W = lv.n_levels * groups;
  const long long units = (n + CP_RUN - 1) / CP_RUN * W;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += (long long)gridDim.x * blockDim.x) {
    const long long run = u / W;
    const int lg = (int)(u - run * W);
    const int l = lg / groups;
    const int c0 = (lg - l * groups) * 4;
    const int nc = min(4, rank - c0);
    const int size = lv.size[l];
    const int off = lv.offset[l];
    const float scale = lv.scale[l];
    // per axis: the current cell (-1: none yet) and its two rows' partials
    int cell[3] = {-1, -1, -1};
    float lo[3][4], hi[3][4];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int k = 0; k < 4; ++k) lo[d][k] = hi[d][k] = 0.0f;

    // one pass past the run's last point adds what is left
    const long long p_end = min(n, (run + 1) * CP_RUN);
    for (long long p = run * CP_RUN; p <= p_end; ++p) {
      int x0[3] = {-1, -1, -1};
      float w_lo[3], w_hi[3], dt[3][4];
      if (p < p_end) {
        float t[3][4];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float frac;
          axis_coord(__ldg(xn + p * 3 + d), scale, size, &x0[d], &frac);
          w_lo[d] = round_w<T>(__fsub_rn(1.0f, frac));
          w_hi[d] = round_w<T>(frac);
          const T* row = lines + ((size_t)d * total_rows + off + x0[d]) * rpf + c0;
          float a[4], b[4];
          load4(row, a);
          load4(row + rpf, b);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            t[d][k] = __fadd_rn(__fmul_rn(w_lo[d], a[k]), __fmul_rn(w_hi[d], b[k]));
        }
        const float* gp = g + p * g_stride + l * rank + c0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float gv = k < nc ? __ldg(gp + k) : 0.0f;
          const float dp = __fmul_rn(gv, t[2][k]);
          dt[0][k] = round_w<T>(__fmul_rn(dp, t[1][k]));
          dt[1][k] = round_w<T>(__fmul_rn(t[0][k], dp));
          dt[2][k] = round_w<T>(__fmul_rn(__fmul_rn(t[0][k], t[1][k]), gv));
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (x0[d] != cell[d]) {
          if (cell[d] >= 0) {
            const size_t at = ((size_t)d * total_rows + off + cell[d]) * rp + c0;
            if (x0[d] == cell[d] + 1) {  // row cell+1 stays: carry hi
              add_group(dacc, at, lo[d], nc);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                lo[d][k] = hi[d][k];
                hi[d][k] = 0.0f;
              }
            } else if (x0[d] >= 0 && x0[d] == cell[d] - 1) {  // row cell stays: carry lo
              add_group(dacc, at + rp, hi[d], nc);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                hi[d][k] = lo[d][k];
                lo[d][k] = 0.0f;
              }
            } else {
              add_group(dacc, at, lo[d], nc);
              add_group(dacc, at + rp, hi[d], nc);
#pragma unroll
              for (int k = 0; k < 4; ++k) lo[d][k] = hi[d][k] = 0.0f;
            }
          }
          cell[d] = x0[d];
        }
        if (p < p_end) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            lo[d][k] = __fadd_rn(lo[d][k], __fmul_rn(w_lo[d], dt[d][k]));
            hi[d][k] = __fadd_rn(hi[d][k], __fmul_rn(w_hi[d], dt[d][k]));
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ dense grids
//
// hbr_dense_forward replaces human_body_reconstruction_tpu/ops/dense_pallas.py
// _fwd_kernel: trilinear interpolation of each dense coarse grid (G, G, G, F),
// giving features (N, D*F) in f32.  hbr_dense_backward replaces
// dense_pallas.py _bwd_kernel (the VJP _dense_matmul_bwd): dmat = sum W_yz^T
// @ bf16((dOut @ S^T) * hat_x).  The TPU kernels evaluate both as two-hot
// matrix products; here the grids (0.2 MB in bf16 at the flagship, G = 18
// and 35, F = 2) stay resident in L2 and a direct gather-and-lerp, and a
// scatter of the eight trilinear corners, do the same.
//
// Both kernels take the world points and normalise them themselves, with the
// two rounded operations of ops/dense_grid.normalise, so that the wrapper
// launches no normalising pass over the points.  The wrapper lays the grids
// out flat, each level from an offset that is a multiple of 4 elements
// (16-byte aligned), so that the z-pair of an (x, y) corner row, the 2F
// features of corners z0 and z0+1 side by side, is read or added with the
// widest aligned vector the offset allows: at F = 2 one 8-byte (bf16) or
// 16-byte (f32) access when the pair starts on a multiple of 4 elements,
// else two of half the width.
//
// hbr_dense_forward.  What it must move: the points and the (N, D*F) output,
// 28 B a point (0.018 ms at a 2,097,152-point chunk); the grids' reads are L1
// and L2 hits.  One thread takes a point and both levels: per level it asks
// for its four corner rows' z-pairs at once (4 to 8 loads where one 2-byte
// load a feature and corner took 16).  What binds it, measured on an H100:
// the write.  The encoder puts the D*F = 4 dense columns in its (N, 129)
// feature matrix, a 16-byte block on a 516-byte row stride, so each row is a
// partial sector.  Written as each thread's per-level float2 or scalar
// stores, 2 to 4 requests to the same sector, a serving chunk took 0.39 ms
// against 0.038 ms into a contiguous (N, 4).  So a block stages its rows in
// shared memory and writes them with consecutive threads on consecutive
// columns, one request a row: 0.16 ms in the matrix (0.048 contiguous).
//
// hbr_dense_backward.  What it must move: the points and the (N, D*F)
// gradient, plus one write of the grids' gradient.  What binds it is the
// f32 adds: 2^3 * F terms a point and level, 32 at the flagship.  The
// design adds fewer of them, and spreads those that hit the same words:
//  * one thread walks a run of DENSE_RUN consecutive points for one level
//    and keeps the current cell's 8 corners x F partials in registers; it
//    adds them only when the cell changes or the run ends.  The trainer's
//    points are a ray's samples in order: on a guided step's points a run
//    visits 3.2 cells of the 18^3 grid and 5.4 of the 35^3 one, so about 8
//    adds a point remain of 32;
//  * the coarsest levels that fit BWD_SHARED_BYTES (the 18^3 x 2 grid, 47
//    KB) add into a block-private shared-memory copy, flushed once at the
//    block's end; the finer ones add each corner row's z-pair to the f32
//    accumulator in L2 as one float4 reduction where 16-byte aligned, else
//    two float2.  Measured at 768,000 guided path points: 0.147 ms with
//    every level in L2, 0.037 ms with no adds at all.  The coarsest grid's
//    words, hit from every block, serialise in L2; its shared copy takes
//    the kernel to 0.091 ms, though shared f32 atomics are compare-and-swap
//    loops on this card (ATOMS.CAST.SPIN): the merged adds leave few.
// The caller zeroes the f32 accumulator and rounds it to bf16 afterwards.
//
// Numerics follow the Pallas kernels term by term (with bf16 = 1): the pair
// weights wy*wz are computed in f32 and rounded to bf16, the forward sums
// round(T_a * wx_a) over the x corners, and the backward's terms are
// bf16(bf16(dout_f) * wx_a) * bf16(wy_b * wz_c), each exact in f32; only the
// order of the backward's f32 sums differs from the plain version's
// (index_add_).  Every multiply and add is an _rn intrinsic.  With bf16 = 0
// nothing is rounded.

constexpr int DENSE_FWD_THREADS = 256;
constexpr int DENSE_BWD_THREADS = 256;
constexpr int DENSE_RUN = 16;    // consecutive points a backward thread walks
constexpr int DENSE_MAX_F = 8;   // features a level the kernels are built for

// Two consecutive elements as f32 (4-byte (bf16) or 8-byte (f32) aligned).
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* v) {
  bf16x2(*reinterpret_cast<const uint32_t*>(p), v);
}
__device__ __forceinline__ void load2(const float* p, float* v) {
  const float2 raw = *reinterpret_cast<const float2*>(p);
  v[0] = raw.x;
  v[1] = raw.y;
}

// Spans of N consecutive elements in the widest aligned accesses.  A is the
// span's first element index mod 4, from a 16-byte aligned base; N and A
// are compile-time, so v stays in registers.
template <int N, int A, typename T>
__device__ __forceinline__ void load_run(const T* p, float* v) {
  if constexpr (N > 0) {
    if constexpr (A == 0 && N >= 4) {
      load4(p, v);
      load_run<N - 4, 0>(p + 4, v + 4);
    } else if constexpr (A % 2 == 0 && N >= 2) {
      load2(p, v);
      load_run<N - 2, (A + 2) % 4>(p + 2, v + 2);
    } else {
      v[0] = load_f32(p);
      load_run<N - 1, (A + 1) % 4>(p + 1, v + 1);
    }
  }
}

// Atomic adds into L2; all-zero pieces are skipped (adding +-0 to a sum that
// starts at +0 changes nothing).
template <int N, int A>
__device__ __forceinline__ void add_run(float* p, const float* v) {
  if constexpr (N > 0) {
    if constexpr (A == 0 && N >= 4) {
      if (v[0] != 0.0f || v[1] != 0.0f || v[2] != 0.0f || v[3] != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
      add_run<N - 4, 0>(p + 4, v + 4);
    } else if constexpr (A % 2 == 0 && N >= 2) {
      if (v[0] != 0.0f || v[1] != 0.0f)
        atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
      add_run<N - 2, (A + 2) % 4>(p + 2, v + 2);
    } else {
      if (v[0] != 0.0f) atomicAdd(p, v[0]);
      add_run<N - 1, (A + 1) % 4>(p + 1, v + 1);
    }
  }
}

// The N elements from base[e] (e's residue mod 4 picks the access pattern).
template <int N, typename T>
__device__ __forceinline__ void load_span(const T* base, long long e, float* v) {
  switch ((int)(e & 3)) {
    case 0: load_run<N, 0>(base + e, v); break;
    case 1: load_run<N, 1>(base + e, v); break;
    case 2: load_run<N, 2>(base + e, v); break;
    default: load_run<N, 3>(base + e, v); break;
  }
}

template <int N>
__device__ __forceinline__ void add_span(float* base, long long e, const float* v) {
  switch ((int)(e & 3)) {
    case 0: add_run<N, 0>(base + e, v); break;
    case 1: add_run<N, 1>(base + e, v); break;
    case 2: add_run<N, 2>(base + e, v); break;
    default: add_run<N, 3>(base + e, v); break;
  }
}

// Cell and trilinear weights of a point on one dense level: the flat index
// of corner (x0, y0, z0), wx, and pair[b][c] = round(wy_b * wz_c).
template <typename T>
__device__ __forceinline__ long long dense_weights(const float* pos, float scale,
                                                  int g, float* wx,
                                                  float (*pair)[2]) {
  int i0[3];
  float fr[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) axis_coord(pos[d], scale, g, &i0[d], &fr[d]);
  wx[0] = __fsub_rn(1.0f, fr[0]);
  wx[1] = fr[0];
  const float wy[2] = {__fsub_rn(1.0f, fr[1]), fr[1]};
  const float wz[2] = {__fsub_rn(1.0f, fr[2]), fr[2]};
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int c = 0; c < 2; ++c) pair[b][c] = round_w<T>(__fmul_rn(wy[b], wz[c]));
  return ((long long)i0[0] * g + i0[1]) * g + i0[2];
}

// grids: each level's (G, G, G, F) grid flattened, level l from offset[l] (a
// multiple of 4).  For each x corner a: T_a = sum over the four (y, z)
// corners, in the order (0,0), (0,1), (1,0), (1,1), of round(wy*wz) * grid,
// then out = round(T_0*wx_0) + round(T_1*wx_1), which is dense_pallas.py's
// pair-weight product followed by its fold over x.  A block's rows are
// staged in shared memory (dynamic: blockDim x D*F floats) and written by
// consecutive threads on consecutive columns, so that each row's D*F
// columns leave in one request.
template <typename T, int F>
__global__ void __launch_bounds__(DENSE_FWD_THREADS)
dense_forward_kernel(WorldPoints pts, const T* __restrict__ grids,
                     long long n, HbrLevels lv, float* __restrict__ out,
                     long long out_stride) {
  extern __shared__ float s_rows[];
  const int C = lv.n_levels * F;
  const long long p0 = (long long)blockIdx.x * blockDim.x;
  const long long p = p0 + threadIdx.x;
  if (p < n) {
    float pos[3];
    pts.at(p, pos);
    for (int l = 0; l < lv.n_levels; ++l) {
      const int g = lv.size[l];
      float wx[2], pair[2][2];
      const long long cell = dense_weights<T>(pos, lv.scale[l], g, wx, pair);
      const T* grid = grids + lv.offset[l];
      // the four (x, y) rows' z-pairs, all requested before any is used:
      // v[a][b][c * F + f] is corner (x0 + a, y0 + b, z0 + c), feature f
      float v[2][2][2 * F];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          load_span<2 * F>(grid, (cell + ((long long)a * g + b) * g) * F, v[a][b]);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float o = 0.0f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          float t = __fmul_rn(pair[0][0], v[a][0][f]);
          t = __fadd_rn(t, __fmul_rn(pair[0][1], v[a][0][F + f]));
          t = __fadd_rn(t, __fmul_rn(pair[1][0], v[a][1][f]));
          t = __fadd_rn(t, __fmul_rn(pair[1][1], v[a][1][F + f]));
          const float folded = round_w<T>(__fmul_rn(t, wx[a]));
          o = a == 0 ? folded : __fadd_rn(o, folded);
        }
        s_rows[threadIdx.x * C + l * F + f] = o;
      }
    }
  }
  __syncthreads();
  const int np = (int)min((long long)blockDim.x, n - p0);
  for (int i = threadIdx.x; i < np * C; i += blockDim.x)
    out[(p0 + i / C) * out_stride + i % C] = s_rows[i];
}

// dgrids: every level's (G, G, G, F) grid flattened as in the forward,
// zeroed by the caller.  Elements below shared_elems (whole leading levels)
// accumulate in a block-private shared-memory copy, added to dgrids once at
// the block's end.  g: (n, D*F) with row stride g_stride.  A unit is one
// (run of DENSE_RUN points, level); consecutive threads take consecutive
// units, so a warp covers 16 runs of 2 levels.
template <typename T, int F>
__global__ void __launch_bounds__(DENSE_BWD_THREADS)
dense_backward_kernel(WorldPoints pts, const float* __restrict__ g,
                      long long g_stride, long long n, HbrLevels lv,
                      int shared_elems, float* __restrict__ dgrids) {
  extern __shared__ float s_acc[];
  for (int i = threadIdx.x; i < shared_elems; i += blockDim.x) s_acc[i] = 0.0f;
  __syncthreads();
  const int D = lv.n_levels;
  const long long units = (n + DENSE_RUN - 1) / DENSE_RUN * D;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += (long long)gridDim.x * blockDim.x) {
    const long long run = u / D;
    const int l = (int)(u - run * D);
    const int gs = lv.size[l];
    const float scale = lv.scale[l];
    const bool sh = lv.offset[l] < shared_elems;  // a level is wholly in or out
    float* grid = (sh ? s_acc : dgrids) + lv.offset[l];
    // the current cell (-1: none yet) and its corners' partials, laid out
    // as the forward's v: acc[a][b][c * F + f]
    long long cell = -1;
    float acc[2][2][2 * F];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int k = 0; k < 2 * F; ++k) acc[a][b][k] = 0.0f;

    // one pass past the run's last point adds what is left
    const long long p_end = min(n, (run + 1) * DENSE_RUN);
    for (long long p = run * DENSE_RUN; p <= p_end; ++p) {
      long long c = -1;
      float wx[2], pair[2][2], gf[F];
      if (p < p_end) {
        float pos[3];
        pts.at(p, pos);
        c = dense_weights<T>(pos, scale, gs, wx, pair);
        const float* gp = g + p * g_stride + l * F;
#pragma unroll
        for (int f = 0; f < F; ++f) gf[f] = round_w<T>(__ldg(gp + f));
      }
      if (c != cell) {
        if (cell >= 0) {
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const long long e = (cell + ((long long)a * gs + b) * gs) * F;
              if (sh) {
#pragma unroll
                for (int k = 0; k < 2 * F; ++k)
                  if (acc[a][b][k] != 0.0f) atomicAdd(grid + e + k, acc[a][b][k]);
              } else {
                add_span<2 * F>(grid, e, acc[a][b]);
              }
#pragma unroll
              for (int k = 0; k < 2 * F; ++k) acc[a][b][k] = 0.0f;
            }
        }
        cell = c;
      }
      if (p < p_end) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float da = round_w<T>(__fmul_rn(gf[f], wx[a]));
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int k = 0; k < 2; ++k)
                acc[a][b][k * F + f] =
                    __fadd_rn(acc[a][b][k * F + f], __fmul_rn(da, pair[b][k]));
          }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < shared_elems; i += blockDim.x) {
    const float v = s_acc[i];
    if (v != 0.0f) atomicAdd(dgrids + i, v);
  }
}

template <typename T, int F>
static int launch_dense_forward(const WorldPoints& pts, const T* grids, long long n,
                                const HbrLevels& lv, float* out,
                                long long out_stride, cudaStream_t s) {
  const size_t smem = (size_t)DENSE_FWD_THREADS * lv.n_levels * F * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_forward_kernel<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned int blocks =
      (unsigned int)((n + DENSE_FWD_THREADS - 1) / DENSE_FWD_THREADS);
  dense_forward_kernel<T, F><<<blocks, DENSE_FWD_THREADS, smem, s>>>(
      pts, grids, n, lv, out, out_stride);
  return (int)cudaGetLastError();
}

template <typename T, int F>
static int launch_dense_backward(const WorldPoints& pts, const float* g,
                                 long long g_stride, long long n,
                                 const HbrLevels& lv, int shared_elems,
                                 float* dgrids, cudaStream_t s) {
  const long long units = (n + DENSE_RUN - 1) / DENSE_RUN * lv.n_levels;
  const size_t smem = (size_t)shared_elems * sizeof(float);
  int blocks = 0;
  const int err = persistent_blocks(dense_backward_kernel<T, F>, DENSE_BWD_THREADS,
                                    smem, (units + DENSE_BWD_THREADS - 1) / DENSE_BWD_THREADS,
                                    &blocks);
  if (err) return err;
  dense_backward_kernel<T, F><<<blocks, DENSE_BWD_THREADS, smem, s>>>(
      pts, g, g_stride, n, lv, shared_elems, dgrids);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_cp_forward(const float* xn, const T* lines, long long n,
                             int total_rows, int rank, int rpf, const HbrLevels& lv,
                             float* out, long long out_stride, cudaStream_t s) {
  const int c = lv.n_levels * rank;
  const int work = lv.n_levels * (rpf / 8);
  long long tile = CP_FWD_TILE_ITEMS / work;
  if (tile > CP_FWD_STAGE_BYTES / (8LL * c)) tile = CP_FWD_STAGE_BYTES / (8LL * c);
  if (tile < 1) tile = 1;
  const size_t smem = 2 * tile * c * sizeof(float);
  int blocks = 0;
  const int err = persistent_blocks(cp_forward_kernel<T>, CP_FWD_THREADS, smem,
                                    (n + tile - 1) / tile, &blocks);
  if (err) return err;
  cp_forward_kernel<T><<<blocks, CP_FWD_THREADS, smem, s>>>(
      xn, lines, n, total_rows, rank, rpf, lv, (int)tile, out, out_stride);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_cp_backward(const float* xn, const T* lines, const float* g,
                              long long g_stride, long long n, int total_rows,
                              int rank, int rpf, int rp, const HbrLevels& lv,
                              float* dacc, cudaStream_t s) {
  const long long units = (n + CP_RUN - 1) / CP_RUN * lv.n_levels * (rp / 4);
  int blocks = 0;
  const int err = persistent_blocks(cp_backward_kernel<T>, CP_BWD_THREADS, 0,
                                    (units + CP_BWD_THREADS - 1) / CP_BWD_THREADS,
                                    &blocks);
  if (err) return err;
  cp_backward_kernel<T><<<blocks, CP_BWD_THREADS, 0, s>>>(
      xn, lines, g, g_stride, n, total_rows, rank, rpf, rp, lv, dacc);
  return (int)cudaGetLastError();
}

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 = ok),
// or the error of its set-up (cudaErrorInvalidValue for arguments the kernel
// does not take).

// lines: (3, total_rows, rpf), rpf a multiple of 8 and at least rank.
int hbr_cp_forward(const float* xn, const void* lines, int bf16, long long n,
                   int total_rows, int rank, int rpf, const HbrLevels* lv,
                   float* out, long long out_stride, void* stream) {
  if (n <= 0) return 0;
  if (rpf % 8 != 0 || rpf < rank) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_cp_forward(xn, (const __nv_bfloat16*)lines, n, total_rows, rank,
                             rpf, *lv, out, out_stride, s);
  return launch_cp_forward(xn, (const float*)lines, n, total_rows, rank, rpf, *lv,
                           out, out_stride, s);
}

// x: (n, 3) world points, normalised in the kernel by mu (3,) and sigma
// (one, or three with sigma_step 1).  grids: every level's (G, G, G, F) grid
// flattened, each level from an offset that is a multiple of 4 elements; F
// (features) from 1 to DENSE_MAX_F.  out: (n, D*F) with row stride
// out_stride.
int hbr_dense_forward(const float* x, const float* mu, const float* sigma,
                      int sigma_step, const void* grids, int bf16, long long n,
                      int features, const HbrLevels* lv, float* out,
                      long long out_stride, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const WorldPoints pts{x, mu, sigma, sigma_step};
  return with_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    if (bf16)
      return launch_dense_forward<__nv_bfloat16, F>(
          pts, (const __nv_bfloat16*)grids, n, *lv, out, out_stride, s);
    return launch_dense_forward<float, F>(pts, (const float*)grids, n, *lv, out,
                                          out_stride, s);
  });
}

// lines as in hbr_cp_forward; dacc (3, total_rows, rp) f32 must be zeroed, rp
// a multiple of 4 and at least rank.
int hbr_cp_backward(const float* xn, const void* lines, int bf16, const float* g,
                    long long g_stride, long long n, int total_rows, int rank,
                    int rpf, int rp, const HbrLevels* lv, float* dacc, void* stream) {
  if (n <= 0) return 0;
  if (rpf % 8 != 0 || rpf < rank || rp % 4 != 0 || rp < rank)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_cp_backward(xn, (const __nv_bfloat16*)lines, g, g_stride, n,
                              total_rows, rank, rpf, rp, *lv, dacc, s);
  return launch_cp_backward(xn, (const float*)lines, g, g_stride, n, total_rows,
                            rank, rpf, rp, *lv, dacc, s);
}

// x, mu, sigma as in hbr_dense_forward.  dgrids: the f32 gradient of the
// grids in the forward's layout, zeroed by the caller; its first
// shared_elems elements (whole leading levels) accumulate in shared memory
// first.  g: (n, D*F) with row stride g_stride.
int hbr_dense_backward(const float* x, const float* mu, const float* sigma,
                       int sigma_step, int bf16, const float* g,
                       long long g_stride, long long n, int features,
                       const HbrLevels* lv, int shared_elems, float* dgrids,
                       void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const WorldPoints pts{x, mu, sigma, sigma_step};
  return with_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    if (bf16)
      return launch_dense_backward<__nv_bfloat16, F>(pts, g, g_stride, n, *lv,
                                                     shared_elems, dgrids, s);
    return launch_dense_backward<float, F>(pts, g, g_stride, n, *lv, shared_elems,
                                           dgrids, s);
  });
}

const char* hbr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int hbr_max_levels(void) { return HBR_MAX_LEVELS; }

}  // extern "C"
