// Counter-based uniform random bits for the stochastic hash encoder, for
// Hopper (sm_90a).
//
// hbr_uniform_bits replaces human_body_reconstruction_tpu/ops/pallas_rng.py
// _rng_kernel: the TPU kernel seeds the core's hardware generator with
// (seed + block index) and draws uint32 bits into (4096, 128) blocks.  This
// card has no hardware generator reachable from a kernel, so the bits come
// from Philox4x32-10 (Salmon et al., SC'11, the generator of Random123 and of
// cuRAND's Philox), keyed by (seed, 0) with the 128-bit counter
// (i / 4, 0, 0) for output element i: each counter gives four outputs.  The
// stream is fixed by (seed, number of elements) and does not depend on the
// launch configuration; ops/rng_kernel.py computes the same stream in plain
// PyTorch and the two agree bit for bit.  The TPU's bits cannot be
// reproduced here; the tests compare distributions, not bits, with it.
//
// What bounds it: the output write (4 bytes a value; 49,152,000 values, 197
// MB, at the training path's 3 x 16 levels x 1,024,000 points), against about
// 25 integer operations a value for the ten rounds.  The design answers that
// with one thread per counter writing its four values as one 16-byte store,
// neighbouring threads on neighbouring addresses, and the mapping to f32 in
// [0, 1) ((bits >> 8) * 2^-24, pallas_rng.py:66-70) done in the same pass when
// the caller asks for floats.  The seed is read from device memory, as the
// Pallas kernel reads its seed from SMEM, so a seed drawn on the device each
// step costs no host synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kPhiloxM0 = 0xD2511F53u;
constexpr unsigned kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u;
constexpr unsigned kPhiloxW1 = 0xBB67AE85u;
constexpr int RNG_THREADS = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const unsigned hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const unsigned hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ unsigned to_unit_float_bits(unsigned v) {
  return __float_as_uint(__fmul_rn(__uint2float_rn(v >> 8), 5.9604644775390625e-08f));
}

// out: n 32-bit values, uint32 bits or (as_float) f32 in [0, 1).
__global__ void __launch_bounds__(RNG_THREADS)
uniform_bits_kernel(const int* __restrict__ seed, long long n, int as_float,
                    unsigned* __restrict__ out) {
  const long long ctr = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long first = ctr * 4;
  if (first >= n) return;
  uint4 v = philox4x32_10(
      make_uint4((unsigned)ctr, (unsigned)(ctr >> 32), 0u, 0u),
      make_uint2((unsigned)__ldg(seed), 0u));
  if (as_float) {
    v = make_uint4(to_unit_float_bits(v.x), to_unit_float_bits(v.y),
                   to_unit_float_bits(v.z), to_unit_float_bits(v.w));
  }
  if (first + 4 <= n) {
    *reinterpret_cast<uint4*>(out + first) = v;  // 16-byte aligned: first % 4 == 0
  } else {
    const unsigned vals[4] = {v.x, v.y, v.z, v.w};
    for (long long i = first; i < n; ++i) out[i] = vals[i - first];
  }
}

}  // namespace

extern "C" {

// seed: one int32 on the device; out: n 32-bit values (16-byte aligned).
// Returns cudaGetLastError() right after the launch (0 = ok).
int hbr_uniform_bits(const int* seed, long long n, int as_float, void* out,
                     void* stream) {
  if (n <= 0) return 0;
  const long long counters = (n + 3) / 4;
  const unsigned int blocks = (unsigned int)((counters + RNG_THREADS - 1) / RNG_THREADS);
  uniform_bits_kernel<<<blocks, RNG_THREADS, 0, (cudaStream_t)stream>>>(
      seed, n, as_float, (unsigned*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
