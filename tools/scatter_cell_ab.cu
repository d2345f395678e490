// Variants of the cell backward and the segsum scatter for
// tools/scatter_cell_ab.py, built beside the tree's kernels (this file
// includes csrc/hash.cu).  The cell backward: the tree's kernel (one bulk
// reduction a row) at a given level group; its rows sent as four float4
// reductions instead (the parent's reductions); the same with its
// reductions taken out (a store that no real input makes, so the loads and
// sums stay); its bulk reductions with neither of its cache hints, with
// each alone, and with g level-major; one warp a run of 32 points at one
// level, merging a run's rows across lanes by a segmented scan, sending
// float4 or bulk reductions; the rows that the kernel sends, recorded, and
// the reductions alone replayed from that record, as float4 reductions or
// as one bulk reduction a row.  segsum with 16 pairs a thread (tiles of
// 4096).

#include <climits>

#include "../human_body_reconstruction_tpu_torch/csrc/hash.cu"

namespace {

constexpr int AB_W = 16;  // a cell row's floats at F 2

// A bulk reduction with no cache policy.
__device__ __forceinline__ void bulk_add_f32_plain(float* dst, const float* src, int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
      "r"((unsigned)__cvta_generic_to_shared(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// MODE 0: float4 reductions (add_row); 1: none (a store no input makes); 3:
// record the row (rows[k * units + unit], -1 where no row is sent); one bulk
// reduction a row as the tree's kernel sends it, but 4: with no cache hint
// (g read through L1, the reductions unmarked), 5: with g alone read as
// streaming loads, 6: with the reductions alone marked evict-last, 7: with
// no hint and g level-major ((L, n, F), the caller's transpose).
template <int MODE>
__global__ void __launch_bounds__(HASH_BWD_THREADS)
cell_variant_kernel(WorldPoints pts, const float* __restrict__ g, long long g_stride,
                    long long n, int T, HbrLevels lv, int group,
                    float* __restrict__ dtable, int* __restrict__ rows) {
  constexpr int F = 2, W = AB_W;
  constexpr bool BULK = MODE >= 4;
  __shared__ __align__(16) float s_slots[BULK ? HASH_BWD_THREADS * 2 * W : 1];
  int turn = 0;
  unsigned long long policy = 0;
  if constexpr (MODE == 6) policy = evict_last_policy();
  const int L = lv.n_levels;
  const unsigned mask = (unsigned)(T - 1);
  const long long runs = (n + HASH_RUN - 1) / HASH_RUN;
  const long long units = runs * L;
  for (long long unit = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       unit < units; unit += (long long)gridDim.x * blockDim.x) {
    long long run;
    int l;
    cell_unit(unit, runs, L, group, &run, &l);
    float* dl = dtable + (long long)lv.offset[l] * W;
    int cell[3] = {};
    bool have = false;
    int sent = 0;
    float acc[W];
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] = 0.0f;
    const long long p0 = run * HASH_RUN;
    const int np = (int)min((long long)HASH_RUN, n - p0);
    auto send = [&]() {
      const unsigned h = corner_row<3>(cell, 0, mask);
      if constexpr (MODE == 0) {
        add_row<W>(dl, h, acc);
      } else if constexpr (MODE == 1) {
        float t = 0.0f;
#pragma unroll
        for (int i = 0; i < W; ++i) t += acc[i];
        if (t == -1.2345e-38f) dl[h] = t;
      } else if constexpr (MODE == 3) {
        rows[(long long)sent * units + unit] = lv.offset[l] + (int)h;
      } else {
        float* slot = s_slots + (threadIdx.x * 2 + turn) * W;
        stage_row<W>(slot, acc);
        if constexpr (MODE == 6) bulk_add_f32(dl + (long long)h * W, slot, W * 4, policy);
        else bulk_add_f32_plain(dl + (long long)h * W, slot, W * 4);
        turn ^= 1;
      }
      ++sent;
    };
    for (int k = 0; k < np; ++k) {
      const long long p = p0 + k;
      float xn[3], fr[3], gf[F];
      int x0[3];
      pts.at<3>(p, xn);
      level_cell<3>(xn, lv.scale[l], x0, fr);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if constexpr (MODE == 5) gf[f] = __ldcs(g + p * g_stride + l * F + f);
        else if constexpr (MODE == 7) gf[f] = __ldg(g + ((long long)l * n + p) * F + f);
        else gf[f] = __ldg(g + p * g_stride + l * F + f);
      }
      if (have && (x0[0] != cell[0] || x0[1] != cell[1] || x0[2] != cell[2])) {
        send();
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
    if (have) send();
    if constexpr (MODE == 3)
      for (int k = sent; k < HASH_RUN; ++k) rows[(long long)k * units + unit] = -1;
  }
  if constexpr (BULK) bulk_wait_read<0>();
}

// One warp a run of 32 consecutive points at one level (warps in
// cell_unit's order of (run of 32, level)); a lane a point; a segmented
// inclusive scan over the lanes joins the rows of consecutive points in one
// cell, and the lane where such a run ends sends it (BULK: as one bulk
// reduction).
template <bool BULK>
__global__ void __launch_bounds__(HASH_BWD_THREADS)
cell_warp_kernel(WorldPoints pts, const float* __restrict__ g, long long g_stride,
                 long long n, int T, HbrLevels lv, int group, float* __restrict__ dtable) {
  constexpr int F = 2, W = AB_W;
  __shared__ __align__(16) float s_slots[BULK ? HASH_BWD_THREADS * 2 * W : 1];
  int turn = 0;
  const int L = lv.n_levels;
  const unsigned mask = (unsigned)(T - 1);
  const int lane = threadIdx.x & 31;
  const long long runs = (n + 31) / 32;
  const long long units = runs * L;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  for (long long unit = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       unit < units; unit += warps) {
    long long run;
    int l;
    cell_unit(unit, runs, L, group, &run, &l);
    const long long p = run * 32 + lane;
    const bool live = p < n;
    int x0[3] = {INT_MIN, INT_MIN, INT_MIN};
    float acc[W];
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] = 0.0f;
    if (live) {
      float xn[3], fr[3], gf[F];
      pts.at<3>(p, xn);
      level_cell<3>(xn, lv.scale[l], x0, fr);
#pragma unroll
      for (int f = 0; f < F; ++f) gf[f] = __ldg(g + p * g_stride + l * F + f);
      float w[3][2];
      axis_weights<3>(fr, w);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float wc = corner_weight<3>(w, c);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[c * F + f] = __fmul_rn(gf[f], wc);
      }
    }
    int same_prev = 1;
#pragma unroll
    for (int d = 0; d < 3; ++d) same_prev &= __shfl_up_sync(0xFFFFFFFFu, x0[d], 1) == x0[d];
    int r = lane == 0 || !same_prev;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int pr = __shfl_up_sync(0xFFFFFFFFu, r, o);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float pv = __shfl_up_sync(0xFFFFFFFFu, acc[k], o);
        if (lane >= o && !r) acc[k] = __fadd_rn(pv, acc[k]);
      }
      if (lane >= o) r |= pr;
    }
    int same_next = 1;
#pragma unroll
    for (int d = 0; d < 3; ++d) same_next &= __shfl_down_sync(0xFFFFFFFFu, x0[d], 1) == x0[d];
    const bool end = live && (lane == 31 || !same_next || p + 1 >= n);
    if (end) {
      float* dl = dtable + (long long)lv.offset[l] * W;
      const unsigned h = corner_row<3>(x0, 0, mask);
      if constexpr (BULK) {
        float* slot = s_slots + (threadIdx.x * 2 + turn) * W;
        stage_row<W>(slot, acc);
        bulk_add_f32_plain(dl + (long long)h * W, slot, W * 4);
        turn ^= 1;
      } else {
        add_row<W>(dl, h, acc);
      }
    }
  }
  if constexpr (BULK) bulk_wait_read<0>();
}

// The reductions alone: thread `unit` sends its recorded rows (rows[k *
// units + unit], k < HASH_RUN, -1 for none), each a row of ones: MODE 0 as
// float4 reductions, 2 as one bulk reduction.
template <int MODE>
__global__ void __launch_bounds__(HASH_BWD_THREADS)
rows_red_kernel(const int* __restrict__ rows, long long units, float* __restrict__ dtable) {
  constexpr int W = AB_W;
  __shared__ __align__(128) float s_ones[W];
  if (threadIdx.x < W) s_ones[threadIdx.x] = 1.0f;
  if constexpr (MODE == 2) fence_async_shared();
  __syncthreads();
  float ones[W];
#pragma unroll
  for (int i = 0; i < W; ++i) ones[i] = 1.0f;
  for (long long unit = (long long)blockIdx.x * blockDim.x + threadIdx.x; unit < units;
       unit += (long long)gridDim.x * blockDim.x) {
    for (int k = 0; k < HASH_RUN; ++k) {
      const int h = __ldcs(rows + (long long)k * units + unit);
      if (h < 0) break;
      if constexpr (MODE == 0) add_row<W>(dtable, (unsigned)h, ones);
      else bulk_add_f32_plain(dtable + (long long)h * W, s_ones, W * 4);
    }
  }
  if constexpr (MODE == 2) bulk_wait_read<0>();
}

template <typename K>
int grid_for(K kernel, long long units, int* blocks) {
  return persistent_blocks(kernel, HASH_BWD_THREADS, 0,
                           (units + HASH_BWD_THREADS - 1) / HASH_BWD_THREADS, blocks);
}

}  // namespace

extern "C" {

// variant 0: float4 reductions; 1: no reductions; 3: record the rows into
// rows (HASH_RUN * units ints); 4: a warp a run of 32, float4; 5: the tree's
// kernel (bulk, g streamed, rows evict-last) at this group; 6: a warp a run
// of 32, bulk; 7 to 10: cell_variant_kernel's MODE 4 to 7 (bulk with no
// hint, g streamed alone, rows evict-last alone; no hint with g level-major,
// (L, n, F) at g).  F 2, L * T rows of 16 floats.
int ab_cell_backward(const float* x, const float* mu, const float* sigma, const float* g,
                     long long g_stride, long long n, int T, const HbrLevels* lv,
                     int variant, int group, float* dtable, int* rows, void* stream) {
  if (n <= 0) return 0;
  const WorldPoints pts{x, mu, sigma, 1};
  const cudaStream_t s = (cudaStream_t)stream;
  const long long units = (n + HASH_RUN - 1) / HASH_RUN * lv->n_levels;
  const long long wblocks = ((n + 31) / 32 * lv->n_levels * 32 + HASH_BWD_THREADS - 1) /
                            HASH_BWD_THREADS;
  int blocks = 0, err = 0;
  switch (variant) {
#define AB_CASE(V, M)                                                                   \
  case V:                                                                               \
    err = grid_for(cell_variant_kernel<M>, units, &blocks);                             \
    if (err) return err;                                                                \
    cell_variant_kernel<M><<<blocks, HASH_BWD_THREADS, 0, s>>>(pts, g, g_stride, n, T, \
                                                               *lv, group, dtable, rows); \
    break;
    AB_CASE(0, 0)
    AB_CASE(1, 1)
    AB_CASE(3, 3)
    AB_CASE(7, 4)
    AB_CASE(8, 5)
    AB_CASE(9, 6)
    AB_CASE(10, 7)
#undef AB_CASE
    case 4:
      err = persistent_blocks(cell_warp_kernel<false>, HASH_BWD_THREADS, 0, wblocks, &blocks);
      if (err) return err;
      cell_warp_kernel<false><<<blocks, HASH_BWD_THREADS, 0, s>>>(pts, g, g_stride, n, T,
                                                                  *lv, group, dtable);
      break;
    case 5:
      return launch_cell_backward<2>(pts, g, g_stride, n, T, *lv, group, dtable, s);
    case 6:
      err = persistent_blocks(cell_warp_kernel<true>, HASH_BWD_THREADS, 0, wblocks, &blocks);
      if (err) return err;
      cell_warp_kernel<true><<<blocks, HASH_BWD_THREADS, 0, s>>>(pts, g, g_stride, n, T,
                                                                 *lv, group, dtable);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The recorded rows' reductions alone: mode 0 float4, 2 bulk.
int ab_rows_red(const int* rows, long long units, int mode, float* dtable, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0, err = 0;
  if (mode == 0) {
    err = grid_for(rows_red_kernel<0>, units, &blocks);
    if (err) return err;
    rows_red_kernel<0><<<blocks, HASH_BWD_THREADS, 0, s>>>(rows, units, dtable);
  } else {
    err = grid_for(rows_red_kernel<2>, units, &blocks);
    if (err) return err;
    rows_red_kernel<2><<<blocks, HASH_BWD_THREADS, 0, s>>>(rows, units, dtable);
  }
  return (int)cudaGetLastError();
}

// Bytes of ab_segsum_items16's workspace.
long long ab_segsum_items16_work_bytes(long long m) {
  return (m + SEG_THREADS * 16 - 1) / (SEG_THREADS * 16) * 12;
}

// segsum with 16 pairs a thread: tiles of 4096 pairs (out zeroed).
int ab_segsum_items16(const int* idx, const float* val, long long m, float* out, void* work,
                      void* stream) {
  if (m <= 0) return 0;
  constexpr int TILE = SEG_THREADS * 16;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (m + TILE - 1) / TILE;
  float* first = static_cast<float*>(work);
  float* last = first + tiles;
  int* flags = reinterpret_cast<int*>(last + tiles);
  const bool vec = ((reinterpret_cast<unsigned long long>(idx) |
                     reinterpret_cast<unsigned long long>(val)) % 16) == 0;
  scatter_tile_kernel<false, 16><<<(unsigned)tiles, SEG_THREADS, 0, s>>>(idx, val, m, vec, out,
                                                                        first, last, flags);
  if (tiles > 1)
    scatter_join_kernel<TILE><<<item_blocks(tiles, SEG_THREADS), SEG_THREADS, 0, s>>>(
        idx, tiles, first, last, flags, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
