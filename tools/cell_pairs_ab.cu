// Variants of the cell forward for tools/cell_pairs_ab.py, built beside the
// tree's kernels (this file includes csrc/hash.cu): the tree's kernel at a
// given level group, with its rows read by cooperating lanes or a thread a
// row, with or without its cache hints; its anatomy (the rows' loads alone,
// and all but the loads); the pairs kernel with the other staging choice in
// each routing; and a read of an L2-resident buffer, for the rate at which
// the L2 serves reads on this card.

#include "../human_body_reconstruction_tpu_torch/csrc/hash.cu"

namespace {

// Reads buf (n float4, L2-resident after the first pass) reps times, a
// grid-stride loop of L2-only loads; writes the sum only if it is exactly
// -1 (never for the caller's data), so the loads stay.
__global__ void __launch_bounds__(256)
l2_read_kernel(const float4* __restrict__ buf, long long n, int reps, float* sink) {
  float t = 0.0f;
  for (int r = 0; r < reps; ++r)
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
      const float4 v = __ldcg(buf + i);
      t += v.x + v.y + v.z + v.w;
    }
  if (t == -1.0f) *sink = t;
}

// The cell forward's anatomy at F 2, cooperative lanes, the tree's level
// groups and order: MODE 0, its rows' loads alone (evict-last, summed into a
// value written only if it is exactly -1); MODE 1, everything but the loads
// (each piece made up from its row index), so the hashes, the sums and the
// stores alone.
template <int MODE>
__global__ void __launch_bounds__(CELL_FWD_THREADS)
cell_anatomy_kernel(WorldPoints pts, const float* __restrict__ table, long long n, int T,
                    HbrLevels lv, int group, long long tiles, float* __restrict__ out,
                    long long out_stride) {
  constexpr int F = 2, P = CELL_FWD_THREADS, W = 8 * F, R = W / 4, RS = W + CELL_ROW_PAD;
  extern __shared__ float4 s_cell[];
  const int L = lv.n_levels;
  const int gi = (int)(blockIdx.x / tiles);
  const long long p0 = (long long)(blockIdx.x - gi * tiles) * P;
  const int l0 = gi * group;
  const int width = min(group, L - l0);
  const int C = width * F;
  float* s_out = reinterpret_cast<float*>(s_cell);
  float* s_rows = s_out + P * (group * F + 1) + (threadIdx.x >> 5) * 32 * RS;
  const int lane = threadIdx.x & 31;
  const long long p = p0 + threadIdx.x;
  const unsigned mask = (unsigned)(T - 1);
  const unsigned long long policy = evict_last_policy();
  float xn[3], t = 0.0f;
  pts.at<3>(p < n ? p : p0, xn);
  for (int l = l0; l < l0 + width; ++l) {
    int x0[3];
    float fr[3], v[W];
    level_cell<3>(xn, lv.scale[l], x0, fr);
    const unsigned row = (unsigned)lv.offset[l] + corner_row<3>(x0, 0, mask);
    float4 piece[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int q = k * 32 + lane;
      const unsigned r = __shfl_sync(0xFFFFFFFFu, row, q / R);
      if constexpr (MODE == 0) {
        piece[k] = load_piece<true>(table + (long long)r * W + (q % R) * 4, policy);
      } else {
        const float f = (float)r;
        piece[k] = make_float4(f, f + 1.0f, f + 2.0f, f + (float)q);
      }
    }
    if constexpr (MODE == 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) t += piece[k].x + piece[k].y + piece[k].z + piece[k].w;
      continue;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int q = k * 32 + lane;
      reinterpret_cast<float4*>(s_rows + (q / R) * RS)[q % R] = piece[k];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float4 q = reinterpret_cast<const float4*>(s_rows + lane * RS)[k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    __syncwarp();
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
    for (int f = 0; f < F; ++f) s_out[threadIdx.x * (C + 1) + (l - l0) * F + f] = acc[f];
  }
  if constexpr (MODE == 0) {
    if (t == -1.0f) out[p0] = t;
    return;
  }
  __syncthreads();
  const int np = (int)min((long long)P, n - p0);
  const int dr = P / C, dc = P - dr * C;
  int r = threadIdx.x / C, c = threadIdx.x - r * C;
  for (; r < np; r += dr, c += dc) {
    if (c >= C) {
      c -= C;
      ++r;
      if (r >= np) break;
    }
    __stcs(out + (p0 + r) * out_stride + l0 * F + c, s_out[r * (C + 1) + c]);
  }
}

}  // namespace

extern "C" {

// The cell forward's anatomy (cell_anatomy_kernel): mode 0, the rows' loads
// alone; 1, all but the loads.  F 2, the given level group.
int ab_cell_anatomy(const float* x, const float* mu, const float* sigma,
                    const float* table, long long n, int T, const HbrLevels* lv,
                    int group, int mode, float* out, long long out_stride, void* stream) {
  if (n <= 0) return 0;
  const WorldPoints pts{x, mu, sigma, 1};
  const size_t smem = cell_forward_smem<2, true>(group);
  const long long tiles = (n + CELL_FWD_THREADS - 1) / CELL_FWD_THREADS;
  const unsigned blocks = (unsigned)(tiles * ((lv->n_levels + group - 1) / group));
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    cell_anatomy_kernel<0><<<blocks, CELL_FWD_THREADS, smem, s>>>(pts, table, n, T, *lv,
                                                                  group, tiles, out,
                                                                  out_stride);
  else
    cell_anatomy_kernel<1><<<blocks, CELL_FWD_THREADS, smem, s>>>(pts, table, n, T, *lv,
                                                                  group, tiles, out,
                                                                  out_stride);
  return (int)cudaGetLastError();
}

// The cell forward at F 2 with `group` levels a block: coop 1, 2F lanes a
// row (0: a thread a row); hints 1, rows evict-last and streaming stores
// (0: neither).
int ab_cell_forward(const float* x, const float* mu, const float* sigma,
                    const float* table, long long n, int T, const HbrLevels* lv,
                    int group, int coop, int hints, float* out, long long out_stride,
                    void* stream) {
  if (n <= 0) return 0;
  const WorldPoints pts{x, mu, sigma, 1};
  const cudaStream_t s = (cudaStream_t)stream;
  if (coop && hints)
    return launch_cell_forward<2, true, true>(pts, table, n, T, *lv, group, out,
                                              out_stride, s);
  if (coop)
    return launch_cell_forward<2, true, false>(pts, table, n, T, *lv, group, out,
                                               out_stride, s);
  if (hints)
    return launch_cell_forward<2, false, true>(pts, table, n, T, *lv, group, out,
                                               out_stride, s);
  return launch_cell_forward<2, false, false>(pts, table, n, T, *lv, group, out,
                                              out_stride, s);
}

// The pairs kernel with the other staging choice than hbr_hash_pairs makes:
// pick alone and pick null reading each drawn value from g (pairs_kernel<F,
// false>), lsel and psel staging the block's gradient rows (<F, true>); its
// arguments as hbr_hash_pairs takes them.
int ab_pairs_other(const float* x, const float* mu, const float* sigma,
                   const unsigned char* bits, const unsigned char* pick,
                   const unsigned char* lsel, const unsigned char* psel, const float* g,
                   long long g_stride, long long n, int T, int features, float sub_scale,
                   const HbrLevels* lv, int* idx, float* val, void* stream) {
  if (n <= 0) return 0;
  Routing rt{pick, lsel, psel, sub_scale, 1.0f};
  if (!level_routing(lsel, psel, lv->n_levels, &rt.lvl_scale))
    return (int)cudaErrorInvalidValue;
  const WorldPoints pts{x, mu, sigma, 1};
  const cudaStream_t s = (cudaStream_t)stream;
  return with_word_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    if (lsel != nullptr || psel != nullptr)
      return launch_pairs<F, true>(pts, bits, rt, g, g_stride, n, T, *lv, idx, val, s);
    return launch_pairs<F, false>(pts, bits, rt, g, g_stride, n, T, *lv, idx, val, s);
  });
}

// reps reads of buf (n float4) by as many blocks as the card holds at once.
int ab_l2_read(const float* buf, long long n, int reps, float* sink, void* stream) {
  int blocks = 0;
  const int err = persistent_blocks(l2_read_kernel, 256, 0, (n + 255) / 256, &blocks);
  if (err) return err;
  l2_read_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(buf), n, reps, sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
