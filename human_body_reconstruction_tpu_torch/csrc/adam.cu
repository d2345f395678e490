// Adam's update over a group of parameters in one pass, for Hopper (sm_90a).
//
// hbr_adam_multi_tensor_apply_kernel replaces no TPU kernel: the JAX package
// leaves optax's update to XLA, which fuses it.  It replaces the eleven
// foreach passes (torch._foreach_*) that train/state.py's AdamGroup.update
// made over each group, which read and wrote the parameters, moments and two
// temporaries about 26 times: at the Neuralangelo hash table (2^22 entries x
// 16 levels x F 8, 536,870,912 f32 values, 2.15 GB) some 56 GB a step.
//
// What bounds it: bytes.  Each element needs p, g, m and v read once and p, m
// and v written once, 28 bytes, against about 15 f32 operations (15.0 GB and
// 4.49 ms at 3.35 TB/s for the table; the operations take 0.12 ms at 67
// TFLOP/s).  The design:
//  * one launch a group: the group's tensors travel by value in the kernel's
//    parameter block, (pointer, numel) each, as PyTorch's multi_tensor_apply
//    passes them, so there is no pointer table to copy to the device and a
//    CUDA graph captures the launch with the pointers it was given; a list of
//    more than ADAM_MAX_TENSORS tensors takes one launch a slice;
//  * each thread takes four elements of each array with 16-byte loads and
//    stores (scalar ones in a tensor's last partial quad, or throughout a
//    tensor whose four pointers are not all 16-byte aligned); the group is
//    one concatenation of such quads, walked by a grid-stride loop over as
//    many blocks as the card holds at once, so every tensor, large or small,
//    is spread over the whole grid;
//  * the rate and the two bias corrections are read from device memory (the
//    0-d tensors GroupedOptimizer.step computes), so no value crosses to the
//    host and a replayed graph reads the new ones;
//  * a null gradient reads as zero (a parameter that took no gradient).
//
// The arithmetic is the foreach sequence's, operation for operation, in f32
// with IEEE rounding: the same functors round after each step, and where a
// functor computes a + alpha * b PyTorch's build contracts it to one fused
// multiply-add (__fmaf_rn), so the kernel does too:
//   m = fma(1 - b1, g, m * b1)           _foreach_mul_, _foreach_add_(alpha)
//   v = fma(1 - b2, g * g, v * b2)       _foreach_mul_, _foreach_addcmul_
//   d = sqrt(v / bc2) + eps              _foreach_div, _foreach_sqrt_, _add_
//   u = (m / bc1) / d                    _foreach_div, _foreach_div_
//   u = fma(weight_decay, p, u)          _foreach_add_(alpha), AdamW only
//   p = p + u * -rate                    _foreach_mul_, _foreach_add_
// tests/test_torch_adam.py holds it to the foreach sequence bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ADAM_THREADS = 256;
constexpr int ADAM_MAX_TENSORS = 64;
constexpr int ADAM_MAX_DEVICES = 64;

// One launch's slice of the group, passed by value (2,616 bytes of the
// 4,096 a kernel's parameters may take).
struct AdamList {
  float* p[ADAM_MAX_TENSORS];
  const float* g[ADAM_MAX_TENSORS];  // null: no gradient (zero)
  float* m[ADAM_MAX_TENSORS];
  float* v[ADAM_MAX_TENSORS];
  long long numel[ADAM_MAX_TENSORS];
  const float* rate;
  const float* bc1;
  const float* bc2;
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
  int n;
};

__device__ __forceinline__ void adam_element(float& p, float g, float& m,
                                             float& v, const AdamList& a,
                                             float neg_rate, float bc1,
                                             float bc2) {
  m = __fmaf_rn(a.one_minus_b1, g, __fmul_rn(m, a.b1));
  v = __fmaf_rn(a.one_minus_b2, __fmul_rn(g, g), __fmul_rn(v, a.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps);
  float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
  if (a.weight_decay != 0.0f) u = __fmaf_rn(a.weight_decay, p, u);
  p = __fadd_rn(p, __fmul_rn(u, neg_rate));
}

__global__ void __launch_bounds__(ADAM_THREADS)
hbr_adam_multi_tensor_apply_kernel(const __grid_constant__ AdamList a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float neg_rate = -__ldg(a.rate), bc1 = __ldg(a.bc1), bc2 = __ldg(a.bc2);
  long long first = 0;  // the tensor's first quad in the group's concatenation
  for (int t = 0; t < a.n; ++t) {
    const long long n = a.numel[t];
    const long long quads = (n + 3) / 4;
    float* p = a.p[t];
    const float* g = a.g[t];
    float* m = a.m[t];
    float* v = a.v[t];
    const bool vec = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) &
                      15) == 0;
    // quad q of the concatenation is this thread's when q % stride == gid
    for (long long q = ((gid - first) % stride + stride) % stride; q < quads; q += stride) {
      const long long i = 4 * q;
      if (vec && i + 4 <= n) {
        float4 P = *reinterpret_cast<const float4*>(p + i);
        const float4 G = g ? *reinterpret_cast<const float4*>(g + i)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 M = *reinterpret_cast<const float4*>(m + i);
        float4 V = *reinterpret_cast<const float4*>(v + i);
        adam_element(P.x, G.x, M.x, V.x, a, neg_rate, bc1, bc2);
        adam_element(P.y, G.y, M.y, V.y, a, neg_rate, bc1, bc2);
        adam_element(P.z, G.z, M.z, V.z, a, neg_rate, bc1, bc2);
        adam_element(P.w, G.w, M.w, V.w, a, neg_rate, bc1, bc2);
        *reinterpret_cast<float4*>(p + i) = P;
        *reinterpret_cast<float4*>(m + i) = M;
        *reinterpret_cast<float4*>(v + i) = V;
      } else {
        const long long end = i + 4 < n ? i + 4 : n;
        for (long long j = i; j < end; ++j) {
          float pj = p[j], mj = m[j], vj = v[j];
          adam_element(pj, g ? g[j] : 0.0f, mj, vj, a, neg_rate, bc1, bc2);
          p[j] = pj;
          m[j] = mj;
          v[j] = vj;
        }
      }
    }
    first += quads;
  }
}

// Blocks of ADAM_THREADS the card holds at once, per device (0: not asked).
int resident_blocks[ADAM_MAX_DEVICES];

int grid_limit(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < ADAM_MAX_DEVICES && resident_blocks[dev] > 0) {
    *blocks = resident_blocks[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hbr_adam_multi_tensor_apply_kernel, ADAM_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < ADAM_MAX_DEVICES) resident_blocks[dev] = *blocks;
  return 0;
}

}  // namespace

extern "C" {

// One Adam update of n tensors: p, g (entries may be null), m and v are n
// f32 pointers each, numel their sizes; rate, bc1 and bc2 point to one f32
// each on the device.  Returns cudaGetLastError() after the last launch.
int hbr_adam_update(int n, float* const* p, const float* const* g, float* const* m,
                    float* const* v, const long long* numel, const float* rate,
                    const float* bc1, const float* bc2, float b1, float one_minus_b1,
                    float b2, float one_minus_b2, float eps, float weight_decay,
                    void* stream) {
  int limit = 0;
  const int code = grid_limit(&limit);
  if (code != 0) return code;
  for (int lo = 0; lo < n; lo += ADAM_MAX_TENSORS) {
    AdamList a;
    a.n = n - lo < ADAM_MAX_TENSORS ? n - lo : ADAM_MAX_TENSORS;
    long long quads = 0;
    for (int t = 0; t < a.n; ++t) {
      a.p[t] = p[lo + t];
      a.g[t] = g[lo + t];
      a.m[t] = m[lo + t];
      a.v[t] = v[lo + t];
      a.numel[t] = numel[lo + t];
      quads += (numel[lo + t] + 3) / 4;
    }
    if (quads == 0) continue;
    a.rate = rate;
    a.bc1 = bc1;
    a.bc2 = bc2;
    a.b1 = b1;
    a.one_minus_b1 = one_minus_b1;
    a.b2 = b2;
    a.one_minus_b2 = one_minus_b2;
    a.eps = eps;
    a.weight_decay = weight_decay;
    const long long want = (quads + ADAM_THREADS - 1) / ADAM_THREADS;
    const unsigned int blocks = (unsigned int)(want < limit ? want : limit);
    hbr_adam_multi_tensor_apply_kernel<<<blocks, ADAM_THREADS, 0, (cudaStream_t)stream>>>(a);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
