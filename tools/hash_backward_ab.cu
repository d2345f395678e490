// Variants of the subsampled hash backward and the int8 pack for
// tools/hash_backward_ab.py, built beside the tree's kernels (this file
// includes csrc/hash.cu).  Against the tree's one thread a point: one thread
// a term; a warp's terms on one index summed before they are sent; the
// level-pair terms merged over a run of points; the point kernel reading
// and sending one term at a time, and so with its reductions taken out
// (what the rest costs), with its inputs read as streaming loads (evict
// first), or with its reductions marked L2 evict-last; the reductions
// alone, given the pairs; and the int8 pack at other block shapes.

#include "../human_body_reconstruction_tpu_torch/csrc/hash.cu"

namespace {

// One thread a term: blockIdx.y the routing group, the point fastest.
// SUM: a warp's terms that land on one index are summed first
// (__match_any_sync), their lowest lane sending the sum.
template <bool SUM>
__global__ void __launch_bounds__(HASH_BWD_THREADS)
term_kernel(WorldPoints pts, const unsigned char* __restrict__ bits, Routing rt,
            const float* __restrict__ g, long long g_stride, long long n, int F, int T,
            HbrLevels lv, float* __restrict__ dtable) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (!SUM && p >= n) return;
  long long flat = -1 - (long long)(threadIdx.x & 31);
  float v = 0.0f;
  if (p < n) {
    float xn[3];
    pts.at<3>(p, xn);
    v = routed_term(xn, bits, rt, g, g_stride, n, F, (int)blockIdx.y, p,
                    (unsigned)(T - 1), lv, &flat);
  }
  if (!SUM) {
    if (v != 0.0f) atomicAdd(dtable + flat, v);
    return;
  }
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, (unsigned long long)flat);
  float sum = 0.0f;
  for (unsigned m = peers; m != 0; m &= m - 1)
    sum = __fadd_rn(sum, __shfl_sync(peers, v, __ffs(m) - 1));
  if (p < n && (threadIdx.x & 31) == (unsigned)(__ffs(peers) - 1) && sum != 0.0f)
    atomicAdd(dtable + flat, sum);
}

// Level pairs (psel): a thread takes RUN consecutive points of pair
// blockIdx.y and sums the terms that land on the same (level, row, feature)
// in a row, one slot for each level of the pair, sending a slot's sum when
// its index changes and at the run's end.
template <int RUN>
__global__ void __launch_bounds__(HASH_BWD_THREADS)
psel_merge_kernel(WorldPoints pts, const unsigned char* __restrict__ bits, Routing rt,
                  const float* __restrict__ g, long long g_stride, long long n, int F,
                  int T, HbrLevels lv, float* __restrict__ dtable) {
  const long long run = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p0 = run * RUN;
  if (p0 >= n) return;
  const int j = (int)blockIdx.y;
  const int np = (int)min((long long)RUN, n - p0);
  long long at0 = -1, at1 = -1;
  float sum0 = 0.0f, sum1 = 0.0f;
  for (int k = 0; k < np; ++k) {
    const long long p = p0 + k;
    float xn[3];
    pts.at<3>(p, xn);
    long long flat;
    const float v = routed_term(xn, bits, rt, g, g_stride, n, F, j, p, (unsigned)(T - 1),
                                lv, &flat);
    if (rt.level(j, p, n) & 1) {
      if (flat != at1) {
        if (sum1 != 0.0f) atomicAdd(dtable + at1, sum1);
        at1 = flat;
        sum1 = 0.0f;
      }
      sum1 = __fadd_rn(sum1, v);
    } else {
      if (flat != at0) {
        if (sum0 != 0.0f) atomicAdd(dtable + at0, sum0);
        at0 = flat;
        sum0 = 0.0f;
      }
      sum0 = __fadd_rn(sum0, v);
    }
  }
  if (sum0 != 0.0f) atomicAdd(dtable + at0, sum0);
  if (sum1 != 0.0f) atomicAdd(dtable + at1, sum1);
}

template <bool STREAM, class V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (STREAM) return __ldcs(p);
  else return __ldg(p);
}

// routed_backward_kernel's term, spelled out so that its loads can be
// streaming ones (MODE 1: __ldcs), and its reduction dropped (MODE 0: the
// store never runs, no index being negative) or marked L2 evict-last
// (MODE 2); MODE 3 sends each term's reduction before it reads the next
// term (the tree's kernel reads ROUTED_BATCH terms first).
template <int MODE>
__global__ void __launch_bounds__(HASH_BWD_THREADS)
point_variant_kernel(WorldPoints pts, const unsigned char* __restrict__ bits, Routing rt,
                     const float* __restrict__ g, long long g_stride, long long n, int F,
                     int T, HbrLevels lv, float* __restrict__ dtable) {
  constexpr bool STREAM = MODE == 1;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const unsigned mask = (unsigned)(T - 1);
  float xn[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    xn[d] = __fdiv_rn(__fsub_rn(load<STREAM>(pts.x + p * 3 + d), __ldg(pts.mu + d)),
                      __ldg(pts.sigma + d * pts.sigma_step));
  const int groups = rt.groups(lv.n_levels);
  for (int j = 0; j < groups; ++j) {
    const int l = rt.lsel != nullptr   ? (int)load<STREAM>(rt.lsel + p)
                  : rt.psel != nullptr ? 2 * j + load<STREAM>(rt.psel + (long long)j * n + p)
                                       : j;
    const int pk = load<STREAM>(rt.pick + (long long)l * n + p);
    int x0[3];
    float fr[3];
    level_cell<3>(xn, lv.scale[l], x0, fr);
    const long long flat =
        ((long long)lv.offset[l] +
         corner_row<3>(x0, load<STREAM>(bits + (long long)l * n + p), mask)) * F + pk;
    const float v = __fmul_rn(
        __fmul_rn(load<STREAM>(g + p * g_stride + l * F + pk), rt.sub_scale), rt.lvl_scale);
    if (MODE == 0) {
      if (flat < 0) dtable[0] = v;
    } else if (MODE == 2) {
      if (v != 0.0f)
        asm volatile(
            "{\n\t.reg .b64 pol;\n\t"
            "createpolicy.fractional.L2::evict_last.b64 pol, 1.0;\n\t"
            "red.global.add.L2::cache_hint.f32 [%0], %1, pol;\n\t}" ::"l"(dtable + flat),
            "f"(v)
            : "memory");
    } else if (v != 0.0f) {
      atomicAdd(dtable + flat, v);
    }
  }
}

// out[idx[k]] += val[k], a thread a pair: the reductions alone.
__global__ void __launch_bounds__(HASH_BWD_THREADS)
pairs_red_kernel(const long long* __restrict__ idx, const float* __restrict__ val,
                 long long m, float* __restrict__ out) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < m) atomicAdd(out + __ldg(idx + k), __ldg(val + k));
}

}  // namespace

extern "C" {

// As hbr_hash_backward given pick (and lsel or psel), by variant: 0, the
// level-pair merge over runs of `run` points (4 or 16; psel only); 1, one
// thread a term; 2, the same, a warp's terms on one index summed first; 3,
// the point kernel without its reductions; 4, with streaming loads; 5, with
// evict-last reductions; 6, one term read and sent at a time.  dtable
// (L, T, F) f32 zeroed.
int ab_hash_backward(const float* x, const float* mu, const float* sigma,
                     const unsigned char* bits, const unsigned char* pick,
                     const unsigned char* lsel, const unsigned char* psel, const float* g,
                     long long g_stride, long long n, int table_size, int features,
                     float sub_scale, int variant, int run, const HbrLevels* lv,
                     float* dtable, void* stream) {
  Routing rt{pick, lsel, psel, sub_scale, 1.0f};
  if (n <= 0 || pick == nullptr || bits == nullptr ||
      !level_routing(lsel, psel, lv->n_levels, &rt.lvl_scale))
    return (int)cudaErrorInvalidValue;
  const WorldPoints pts{x, mu, sigma, 1};
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned groups = (unsigned)rt.groups(lv->n_levels);
  const dim3 terms(item_blocks(n, HASH_BWD_THREADS), groups);
  const unsigned points = item_blocks(n, HASH_BWD_THREADS);
  const int T = table_size, F = features;
#define AB_ARGS pts, bits, rt, g, g_stride, n, F, T, *lv, dtable
  switch (variant) {
    case 0:
      if (psel == nullptr || (run != 4 && run != 16)) return (int)cudaErrorInvalidValue;
      if (run == 4)
        psel_merge_kernel<4><<<dim3(item_blocks((n + 3) / 4, HASH_BWD_THREADS), groups),
                               HASH_BWD_THREADS, 0, s>>>(AB_ARGS);
      else
        psel_merge_kernel<16><<<dim3(item_blocks((n + 15) / 16, HASH_BWD_THREADS), groups),
                                HASH_BWD_THREADS, 0, s>>>(AB_ARGS);
      break;
    case 1: term_kernel<false><<<terms, HASH_BWD_THREADS, 0, s>>>(AB_ARGS); break;
    case 2: term_kernel<true><<<terms, HASH_BWD_THREADS, 0, s>>>(AB_ARGS); break;
    case 3: point_variant_kernel<0><<<points, HASH_BWD_THREADS, 0, s>>>(AB_ARGS); break;
    case 4: point_variant_kernel<1><<<points, HASH_BWD_THREADS, 0, s>>>(AB_ARGS); break;
    case 5: point_variant_kernel<2><<<points, HASH_BWD_THREADS, 0, s>>>(AB_ARGS); break;
    case 6: point_variant_kernel<3><<<points, HASH_BWD_THREADS, 0, s>>>(AB_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef AB_ARGS
  return (int)cudaGetLastError();
}

// out (f32, zeroed) += the m pairs (idx int64, val).
int ab_pairs_red(const long long* idx, const float* val, long long m, float* out,
                 void* stream) {
  pairs_red_kernel<<<item_blocks(m, HASH_BWD_THREADS), HASH_BWD_THREADS, 0,
                     (cudaStream_t)stream>>>(idx, val, m, out);
  return (int)cudaGetLastError();
}

// The int8 pack with blocks of `threads` threads holding 16384 / threads
// values each (256 x 64; 512 x 32, the tree's; 1024 x 16).
int ab_pack_int8(const float* table, long long L, long long T, int features, int threads,
                 unsigned* words, float* scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return with_word_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    if (threads == 256) return launch_pack_int8<F, 256, 64>(table, L, T, scale, words, s);
    if (threads == 512) return launch_pack_int8<F, 512, 32>(table, L, T, scale, words, s);
    if (threads == 1024) return launch_pack_int8<F, 1024, 16>(table, L, T, scale, words, s);
    return (int)cudaErrorInvalidValue;
  });
}

}  // extern "C"
