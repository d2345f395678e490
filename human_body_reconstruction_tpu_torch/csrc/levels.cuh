// What the sources in csrc/ share: the per-level geometry every encoder
// kernel takes by value (mirrored by ops/cuda_lib.py HbrLevels), the world
// points the dense and hash kernels normalise, and two launch helpers.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#define HBR_MAX_LEVELS 16

struct HbrLevels {
  int n_levels;
  int size[HBR_MAX_LEVELS];    // G_l: line length (CP), grid side (dense) or
                               // table size T (hash)
  int offset[HBR_MAX_LEVELS];  // CP: first row of level l in the packed lines;
                               // dense: first element of grid l;
                               // hash: first row l*T of level l in the table
  float scale[HBR_MAX_LEVELS];  // level resolution N_l, as f32
};

// World points and the box that normalises them, xn = (x - mu) / sigma per
// axis with the same two rounded operations as ops/dense_grid.normalise
// (sigma_step 0: one sigma for every axis).  D is the points' dimension: 3,
// or 2 for the hash grid's image points.
struct WorldPoints {
  const float* x;      // (n, D)
  const float* mu;     // (D,)
  const float* sigma;  // (1,) or (D,)
  int sigma_step;
  template <int D = 3>
  __device__ __forceinline__ void at(long long p, float* pos) const {
#pragma unroll
    for (int d = 0; d < D; ++d)
      pos[d] = __fdiv_rn(__fsub_rn(__ldg(x + p * D + d), __ldg(mu + d)),
                         __ldg(sigma + d * sigma_step));
  }
};

// Blocks for a grid-stride kernel: work_blocks, capped at as many as the
// card holds at once (after allowing the dynamic shared memory it asks for).
template <typename K>
static int persistent_blocks(K kernel, int threads, size_t smem,
                             long long work_blocks, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = (int)(work_blocks < cap ? work_blocks : cap);
  return 0;
}

// fn(std::integral_constant<int, F>()) for F = features, 1 to 8.
template <typename Fn>
static int with_features(int features, Fn fn) {
  switch (features) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 3: return fn(std::integral_constant<int, 3>());
    case 4: return fn(std::integral_constant<int, 4>());
    case 5: return fn(std::integral_constant<int, 5>());
    case 6: return fn(std::integral_constant<int, 6>());
    case 7: return fn(std::integral_constant<int, 7>());
    case 8: return fn(std::integral_constant<int, 8>());
    default: return (int)cudaErrorInvalidValue;
  }
}
