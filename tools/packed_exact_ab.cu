// Variants of the packed-exact forward for tools/packed_exact_ab.py, built
// beside the tree's kernels (this file includes tools/cell_pairs_ab.cu, which
// includes csrc/hash.cu, for its L2 read): the tree's kernel with each corner
// pair's load 4, 8 or 16 bytes wide, its words kept raw or unpacked as they
// are asked for, G 1, 2 or 4 threads a point, any level group and carveout;
// the int8 bytes turned into floats through the float's bits in place of a
// conversion; its anatomy at the tree's constants (the loads alone, and all
// but the loads); and random gathers from a buffer, for the rate at which
// L1 and L2 serve scattered requests on this card.

#include "cell_pairs_ab.cu"

namespace {

// Words made up from their row index in place of loads: the packed-exact
// kernel over these is all of its work but the loads.
template <class Words>
struct MadeUpWords : Words {
  __device__ __forceinline__ unsigned word(long long row) const {
    return (unsigned)row * 2654435761u;
  }
  template <class Chunk>
  __device__ __forceinline__ Chunk chunk(long long row) const {
    Chunk c;
    unsigned* w = reinterpret_cast<unsigned*>(&c);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Chunk) / 4); ++i) w[i] = word(row + i);
    return c;
  }
};

__device__ __forceinline__ unsigned fold(uint4 v) { return v.x ^ v.y ^ v.z ^ v.w; }
__device__ __forceinline__ unsigned fold(uint2 v) { return v.x ^ v.y; }
__device__ __forceinline__ unsigned fold(unsigned v) { return v; }

// Int8 words whose bytes become floats through the float's bits: byte b of
// the word, xored with 0x80, is placed under the exponent of 2^23 (0x4B00
// 00xx = 2^23 + b + 128, exact) and 2^23 + 128 taken off, so the value is
// (float)(signed char)b exactly, with a byte permute and an add in place
// of a conversion.
struct MagicInt8Words : Int8Words {
  template <int F>
  __device__ __forceinline__ void unpack(unsigned w, float m, float* v) const {
    const unsigned b = w ^ 0x80808080u;
#pragma unroll
    for (int f = 0; f < F; ++f)
      v[f] = __fmul_rn(
          __fsub_rn(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440u | f)),
                    8388736.0f),
          m);
  }
};

// reps rounds of 8 independent LOAD-byte loads a thread at pseudo-random
// aligned words of buf (words_mask + 1 words, a power of two), folded into a
// value written only if it is 0x9E3779B9.
template <int LOAD>
__global__ void __launch_bounds__(256)
gather_kernel(const unsigned* __restrict__ buf, unsigned words_mask, int reps,
              float* sink) {
  using Chunk = typename CornerWords<LOAD>::Chunk;
  constexpr unsigned Q = LOAD / 4;
  unsigned h = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u, t = 0;
  for (int r = 0; r < reps; ++r) {
    Chunk q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      h = h * 1664525u + 1013904223u;
      q[k] = __ldg(reinterpret_cast<const Chunk*>(buf + ((h >> 7) & words_mask & ~(Q - 1))));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) t ^= fold(q[k]);
  }
  if (t == 0x9E3779B9u) *sink = (float)t;
}

// The packed-exact kernel's loads alone: each point's levels walked as the
// kernel walks them (G threads a point), every corner chunk and far word
// loaded and folded into a value written only if it is 0x9E3779B9 (never
// for the caller's data), so the loads stay.
template <int G, int LOAD, class Words>
__global__ void __launch_bounds__(PX_THREADS)
px_loads_kernel(WorldPoints pts, Words words, long long n, int T, HbrLevels lv,
                float* __restrict__ out) {
  constexpr int P = PX_THREADS / G;
  const long long p = (long long)blockIdx.x * P + threadIdx.x % P;
  if (p >= n) return;
  const unsigned mask = (unsigned)(T - 1);
  float xn[3];
  pts.at<3>(p, xn);
  unsigned t = 0;
  for (int l = threadIdx.x / P; l < lv.n_levels; l += G) {
    int x0[3];
    float fr[3];
    level_cell<3>(xn, lv.scale[l], x0, fr);
    CornerWords<LOAD> cw;
    cw.load(words, lv.offset[l], x0, mask);
#pragma unroll
    for (int k = 0; k < 4; ++k) t ^= fold(cw.q[k]) ^ cw.far[k];
  }
  if (t == 0x9E3779B9u) out[p] = (float)t;
}

// A lockstep packed-exact forward: one block of 1024 threads a SM, each
// block walking its share of the points in chunks of 1024 * PTS (PTS a
// thread), every warp of the block on one level at a time (a barrier after
// each level when BARRIER), so the SM's L1 holds one level's words where
// the tree's blocks walk all levels at once; each chunk's features staged
// `span` levels at a time and stored with store_rows.
template <int F, int PTS, bool BARRIER, class Words>
__global__ void __launch_bounds__(1024, 1)
px_lockstep_kernel(WorldPoints pts, Words words, long long n, int T, HbrLevels lv,
                   int span, long long per_block, float* __restrict__ out,
                   long long out_stride) {
  constexpr int NT = 1024, P = NT * PTS;
  extern __shared__ float s_rows[];  // (P, span * F + 1)
  __shared__ float s_mult[HBR_MAX_LEVELS];
  const int L = lv.n_levels;
  if (threadIdx.x < L) s_mult[threadIdx.x] = words.mult(threadIdx.x);
  __syncthreads();
  const unsigned mask = (unsigned)(T - 1);
  const long long b0 = (long long)blockIdx.x * per_block;
  const long long b1 = min(n, b0 + per_block);
  for (long long p0 = b0; p0 < b1; p0 += P) {
    float xn[PTS][3];
    bool live[PTS];
#pragma unroll
    for (int k = 0; k < PTS; ++k) {
      const long long p = p0 + k * NT + threadIdx.x;
      live[k] = p < b1;
      if (live[k]) pts.at<3>(p, xn[k]);
    }
    for (int l0 = 0; l0 < L; l0 += span) {
      const int l1 = min(l0 + span, L);
      const int C = (l1 - l0) * F;
      for (int l = l0; l < l1; ++l) {
        CornerWords<PX_LOAD> cw[PTS];
        float fr[PTS][3];
#pragma unroll
        for (int k = 0; k < PTS; ++k) {
          if (!live[k]) continue;
          int x0[3];
          level_cell<3>(xn[k], lv.scale[l], x0, fr[k]);
          cw[k].load(words, lv.offset[l], x0, mask);
        }
#pragma unroll
        for (int k = 0; k < PTS; ++k) {
          if (!live[k]) continue;
          float v[8][F], acc[F];
          unpack_corners<F>(words, cw[k], s_mult[l], v);
          exact_sum<F, 3>(v, fr[k], acc);
          float* dst = s_rows + (k * NT + threadIdx.x) * (C + 1) + (l - l0) * F;
#pragma unroll
          for (int f = 0; f < F; ++f) dst[f] = acc[f];
        }
        if constexpr (BARRIER) __syncthreads();
      }
      __syncthreads();
      store_rows(s_rows, C, p0, b1, P, out + l0 * F, out_stride);
      __syncthreads();
    }
  }
}

// fn(integral_constant LOAD) for load 4, 8 or 16 bytes.
template <typename Fn>
static int with_load(int load, Fn fn) {
  switch (load) {
    case 4: return fn(std::integral_constant<int, 4>());
    case 8: return fn(std::integral_constant<int, 8>());
    case 16: return fn(std::integral_constant<int, 16>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// fn(integral_constant G) for 1, 2 or 4 threads a point.
template <typename Fn>
static int with_groups(int groups, Fn fn) {
  switch (groups) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 4: return fn(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// fn(integral_constant F, words) for format 0 (bf16, F 2) or 1 (int8, F 4).
template <typename Fn>
static int with_words(int format, const unsigned* words, const float* scale, Fn fn) {
  if (format == 0) return fn(std::integral_constant<int, 2>(), Bf16Words{{words}});
  if (format == 1) return fn(std::integral_constant<int, 4>(), Int8Words{{words}, scale});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The packed-exact forward with `load`-byte corner loads (4, 8, 16), raw
// words in flight (raw 1) or unpacked floats (0), `groups` threads a point
// (1, 2, 4), `group` levels a block and `carveout` percent of shared memory;
// format 0 bf16 words (F 2), 1 int8 (F 4, scale (L,)).  Arguments as
// hbr_hash_packed_forward's.
int ab_packed_exact(const float* x, const float* mu, const float* sigma,
                    const unsigned* words, const float* scale, long long n, int T,
                    int format, const HbrLevels* lv, int load, int raw, int groups,
                    int group, int carveout, float* out, long long out_stride,
                    void* stream) {
  if (n <= 0) return 0;
  const WorldPoints pts{x, mu, sigma, 1};
  const cudaStream_t s = (cudaStream_t)stream;
  return with_words(format, words, scale, [&](auto f, auto w) {
    constexpr int F = decltype(f)::value;
    return with_load(load, [&](auto ld) {
      constexpr int LOAD = decltype(ld)::value;
      return with_groups(groups, [&](auto g) {
        constexpr int G = decltype(g)::value;
        if (raw)
          return launch_packed_exact<F, G, LOAD, true>(pts, w, n, T, *lv, group, carveout,
                                                       out, out_stride, s);
        return launch_packed_exact<F, G, LOAD, false>(pts, w, n, T, *lv, group, carveout,
                                                      out, out_stride, s);
      });
    });
  });
}

// The packed-exact forward's anatomy at the tree's constants (PX_GROUPS,
// PX_LOAD, raw words, PX_CARVEOUT): mode 0 its loads alone
// (px_loads_kernel), 1 all but the loads (the kernel over MadeUpWords), 2
// (int8) all but the loads with MagicInt8Words' unpacking.
int ab_packed_exact_anatomy(const float* x, const float* mu, const float* sigma,
                            const unsigned* words, const float* scale, long long n,
                            int T, int format, const HbrLevels* lv, int mode, float* out,
                            long long out_stride, void* stream) {
  if (n <= 0) return 0;
  const WorldPoints pts{x, mu, sigma, 1};
  const cudaStream_t s = (cudaStream_t)stream;
  return with_words(format, words, scale, [&](auto f, auto w) {
    constexpr int F = decltype(f)::value;
    using W = decltype(w);
    if (mode == 1)
      return launch_packed_exact<F>(pts, MadeUpWords<W>{w}, n, T, *lv, lv->n_levels,
                                    PX_CARVEOUT, out, out_stride, s);
    if constexpr (std::is_same_v<W, Int8Words>) {
      if (mode == 2)
        return launch_packed_exact<F>(pts, MadeUpWords<MagicInt8Words>{{w}}, n, T, *lv,
                                      lv->n_levels, PX_CARVEOUT, out, out_stride, s);
    }
    if (mode != 0) return (int)cudaErrorInvalidValue;
    constexpr int P = PX_THREADS / PX_GROUPS;
    const auto kernel = px_loads_kernel<PX_GROUPS, PX_LOAD, W>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, PX_CARVEOUT);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)((n + P - 1) / P), PX_THREADS, 0, s>>>(pts, w, n, T, *lv, out);
    return (int)cudaGetLastError();
  });
}

// The packed-exact forward at the tree's constants over int8 words (F 4)
// whose bytes become floats through the float's bits (MagicInt8Words),
// `group` levels a block.
int ab_packed_exact_magic(const float* x, const float* mu, const float* sigma,
                          const unsigned* words, const float* scale, long long n, int T,
                          const HbrLevels* lv, int group, int carveout, float* out,
                          long long out_stride, void* stream) {
  if (n <= 0) return 0;
  const WorldPoints pts{x, mu, sigma, 1};
  return launch_packed_exact<4>(pts, MagicInt8Words{{{words}, scale}}, n, T, *lv, group,
                                carveout, out, out_stride, (cudaStream_t)stream);
}

// The lockstep forward (px_lockstep_kernel): `per_thread` points a thread (1
// or 2), a barrier after each level (barrier 1) or only after each span,
// `span` levels staged at a time; format 0 bf16 (F 2), 1 int8 (F 4), 2 int8
// with MagicInt8Words.
int ab_lockstep(const float* x, const float* mu, const float* sigma,
                const unsigned* words, const float* scale, long long n, int T, int format,
                const HbrLevels* lv, int per_thread, int barrier, int span, int carveout,
                float* out, long long out_stride, void* stream) {
  if (n <= 0) return 0;
  const WorldPoints pts{x, mu, sigma, 1};
  const auto go = [&](auto f, auto w, auto k, auto b) {
    constexpr int F = decltype(f)::value, PTS = decltype(k)::value;
    constexpr bool BARRIER = decltype(b)::value;
    const auto kernel = px_lockstep_kernel<F, PTS, BARRIER, decltype(w)>;
    const size_t smem = (size_t)1024 * PTS * (span * F + 1) * sizeof(float);
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               carveout);
    if (e != cudaSuccess) return (int)e;
    const long long per = (n + sms - 1) / sms;
    kernel<<<sms, 1024, smem, (cudaStream_t)stream>>>(pts, w, n, T, *lv, span, per, out,
                                                        out_stride);
    return (int)cudaGetLastError();
  };
  const auto with_shape = [&](auto f, auto w) {
    using One = std::integral_constant<int, 1>;
    using Two = std::integral_constant<int, 2>;
    using Yes = std::integral_constant<bool, true>;
    using No = std::integral_constant<bool, false>;
    if (per_thread == 1) return barrier ? go(f, w, One(), Yes()) : go(f, w, One(), No());
    if (per_thread == 2) return barrier ? go(f, w, Two(), Yes()) : go(f, w, Two(), No());
    return (int)cudaErrorInvalidValue;
  };
  if (format == 2)
    return with_shape(std::integral_constant<int, 4>(), MagicInt8Words{{{words}, scale}});
  return with_words(format, words, scale, with_shape);
}

// reps rounds of 8 random `load`-byte loads (4 or 16) a thread from buf
// (words, a power of two), as many threads as the card holds at once, the
// carveout at 0 (the most L1).  Writes the threads' count to *threads.
int ab_gather(const unsigned* buf, long long words, int load, int reps, float* sink,
              long long* threads, void* stream) {
  return with_load(load, [&](auto ld) {
    constexpr int LOAD = decltype(ld)::value;
    const auto kernel = gather_kernel<LOAD>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    const int err = persistent_blocks(kernel, 256, 0, 1LL << 30, &blocks);
    if (err) return err;
    *threads = (long long)blocks * 256;
    kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(buf, (unsigned)(words - 1), reps, sink);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
