// The MLP3D head (models/mlp.py) fused for Hopper (sm_90a): one launch
// forward, one launch backward and a small reduction of the weight
// gradients.
//
// It replaces no TPU kernel: the JAX package leaves its _linear
// (jnp.dot(bf16, bf16, preferred_element_type=f32)) to XLA.  The port's
// composed version (models/mlp.py _linear) rounds every operand to bf16, up-
// casts it and multiplies in f32 with TF32 off, so each layer was an f32 SIMT
// GEMM between two cast passes and a bias, ReLU, cat and reduction pass.  This
// kernel computes the same function layer by layer:
//   z = f32sum(bf16(x) . bf16(W)^T) + bf16(b),  ReLU between layers,
//   colour input bf16(cat(geo, dirs)), LeakyReLU or 2 sigmoid - 1 density,
//   sigmoid or ELU colour.
// Forward, when a gradient follows (training; EXACT_ORDER): the sums run on
// the FP32 pipes, one fmaf a term in ascending k from 0, the order in which
// cuBLAS's f32 GEMM sums them at the training path's shapes (768,000,
// 2,048,000, 262,144 and 98,304 rows; at 2,097,152 it picks another
// kernel), so the outputs and every hidden activation equal the composed
// path's bit for bit.  A product of two bf16 values is exact in f32, so an
// MMA computes the same terms, but it adds them in another order, and after
// a few hundred training steps the loss over the field reads that order:
// one guided step's loss against the composed path moved by up to 1.3e-5 of
// itself with the forward on the tensor cores (a hidden activation rounded to
// the other side of a bf16 boundary moves colours by 1e-4), against 0 for
// the composed path itself.  The benchmark's stage check holds that loss to
// 1e-5, a limit set from runs that were cuBLAS's arithmetic bit for bit, so
// this fork follows a library's choice of kernel (a cuBLAS update may sum
// otherwise) and costs 1.2 ms a guided step; it is to go, and the training
// forward to join the tensor-core one, once that limit is set anew from
// sound runs of another order.  Forward with no gradient to follow (serving,
// the occupancy refresh): the products are mma.sync m16n8k16 of bf16
// operands into f32 accumulators; the frames and refreshed densities stay
// within their comparisons' tolerances.
// Backward: every product is an mma.sync of bf16 operands into f32
// accumulators, rounded where autograd rounds the composed version (the
// backward of .to(bf16).to(f32) rounds each gradient crossing it): dx =
// bf16(dz . W) at every layer input, dW = bf16(sum_n dz^T x), db =
// bf16(sum_n dz).  Every hidden dz is a ReLU mask times a bf16-rounded
// gradient, so those products are plain bf16 x bf16 MMAs.  The only full-f32
// cotangents are the colour output's 3 columns and the density branch's
// output (its density column; all 16 in the density-only form, whose caller
// hands an arbitrary f32 gradient): each is split into three bf16 terms hi +
// mid + lo, which represent an f32 value exactly, and all three are
// multiplied, so those products are exact too at the cost of a few narrow
// extra MMAs.
//
// What bounds it: the bytes the function must move, the f32 (N, in)
// features and (N, d_view) view encodings read, the outputs written and, in
// the backward, their cotangents read and the feature gradient written:
// 1,160 bytes a point at the flagship's 129 columns, 0.27 ms at 768,000
// points at 3.35 TB/s, against 0.09 ms of bf16 MMAs.  This design moves
// 1,732 more: the backward reads the features and view encodings again
// (612) and the training forward writes 560 bytes of activations that the
// backward reads back.
// The training forward's 20,160 FMAs a point on the FP32 pipes (0.52 ms at
// 768,000 points) come from its summation order, not from the function.
// The design keeps everything else on chip:
// - persistent CTAs of 8 warps walk 64-point tiles; all six layers' weights
//   sit in shared memory as bf16 (K padded to 16, rows padded so each
//   ldmatrix row is 16-byte aligned and conflict-free), loaded and rounded
//   from the f32 parameters once per CTA (no packing pass; holding them as
//   f32 for the FP32 forward measured no faster);
// - a tile's f32 features, view encodings and cotangents are read straight
//   from their contiguous (N, width) matrices (a 64-row tile is one
//   contiguous block) into registers one tile ahead, so the next tile's
//   loads are in flight while this one computes, then rounded into bf16
//   tiles in shared memory;
// - each layer is one CTA-wide product over the tile (the FP32 one: a thread
//   sums 4 points by 4 outputs from 8-byte reads of the bf16 tiles); the
//   bias, ReLU, rounding and output activations run in the epilogue, written
//   back as bf16 for the next layer; the view encoding is rounded into the
//   colour layer's input tile beside the 15 geometry columns (no cat, no
//   cast pass);
// - the training forward writes its bf16 activations (544 bytes a point) and
//   f32 pre-activations (16) out for the backward, which reads them with
//   cp.async instead of recomputing the forward on the FP32 pipes (measured
//   at 768,000 points: a backward with the recompute 2.76 ms, without it
//   1.88); each layer's dz overwrites the activation it was masked with;
// - weight gradients without atomics: each warp owns fixed 16x16 blocks of
//   every dW, takes the tile's x^T dz for them with its points as K, and adds
//   them to the CTA's f32 sums in shared memory (a ones column in every
//   input tile gives db in the same product).  Each CTA writes one partial;
//   hbr_mlp_gemm_reduce_kernel sums the partials in block order and rounds
//   them to bf16, so a replayed CUDA graph repeats its sums bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "levels.cuh"

// The C interface's parameter structs (ops/cuda_lib.py HbrMlpWeights and
// HbrMlpGrads): outside the unnamed namespace, so that the functions taking
// them keep external linkage.
struct HbrMlpWeights {
  const float* w[6];   // nn.Linear weights (out, in), f32; sig 0-2, col 0-2
  const float* b[6];
};

struct HbrMlpGrads {
  float* w[6];         // null: not wanted
  float* b[6];
};

namespace {

using MlpWeights = HbrMlpWeights;
using MlpGrads = HbrMlpGrads;
using bf16 = __nv_bfloat16;

constexpr int TM = 64;            // points a tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WIDTH = 64;         // hidden width the kernel is built for
constexpr int NG = WARPS / (TM / 16);   // warps sharing a 16-row m tile
constexpr int NPW_H = WIDTH / 8 / NG;   // column tiles a warp of a hidden layer
constexpr int GEO = 15;           // geo_feat_dim
constexpr int N3 = 1 + GEO;       // density branch output
constexpr int SS = 24;            // row stride of a split cotangent tile
constexpr int MAX_IN = 143;       // the backward's shared memory at 64 points
constexpr int MAX_VIEW = 32;      // GEO + d_view + 1 <= 48
// values a thread prefetches: features, view encodings, cotangents
constexpr int PF = (TM * MAX_IN + THREADS - 1) / THREADS;
constexpr int PD = (TM * MAX_VIEW + THREADS - 1) / THREADS;
constexpr int PG = (TM * 16 + THREADS - 1) / THREADS;
constexpr int MAX_SMEM = 232448;  // a block's limit on sm_90
// The forward's saved activations, a row a point (bf16): X1, X2, the colour
// input's first 16 columns (geometry and the view encoding's first), X4, X5;
// the density-only form saves X1, X2.  Their pre-activation stash, f32 a
// point: z6 (3 columns), raw density.
constexpr int AS_FULL = 4 * WIDTH + 16;
constexpr int AS_DENSITY = 2 * WIDTH;

// mode bits
constexpr int DENSITY_ONLY = 1;
constexpr int RGB_ELU = 2;
constexpr int DENSITY_SDF = 4;
constexpr int EXACT_ORDER = 8;    // forward: sum in cuBLAS's order (a gradient follows)

struct Layout {
  int in[6], out[6];   // real layer widths
  int rows[6];         // output rows padded to 16 (W and dW rows)
  int kdim[6];         // K of the forward product, padded to 16
  int ws[6];           // W row stride (bf16): kdim + 8
  int nt[6];           // dW column tiles (8 wide), the bias column included
  int dws[6];          // dW row stride (f32)
  int w_off[6], dw_off[6];
  int xs[6];           // row stride of the tile feeding layer l
  int w_elems, dw_floats;
};

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline Layout make_layout(int in_dim, int d_view) {
  Layout L;
  const int k1 = pad16(in_dim + 1), k4 = pad16(GEO + d_view + 1);
  const int in_[6] = {in_dim, WIDTH, WIDTH, GEO + d_view, WIDTH, WIDTH};
  const int out_[6] = {WIDTH, WIDTH, N3, WIDTH, WIDTH, 3};
  const int k_[6] = {k1, WIDTH, WIDTH, k4, WIDTH, WIDTH};
  int wo = 0, dwo = 0;
  for (int l = 0; l < 6; ++l) {
    L.in[l] = in_[l];
    L.out[l] = out_[l];
    L.rows[l] = out_[l] <= 16 ? 16 : out_[l];
    L.kdim[l] = k_[l];
    L.ws[l] = k_[l] + 8;
    L.xs[l] = k_[l] + 8;
    L.nt[l] = (k_[l] == WIDTH ? WIDTH + 8 : k_[l]) / 8;
    const int ncols = L.nt[l] * 8;
    L.dws[l] = ncols % 16 == 0 ? ncols + 8 : ncols;
    L.w_off[l] = wo;
    wo += L.rows[l] * L.ws[l];
    L.dw_off[l] = dwo;
    dwo += L.rows[l] * L.dws[l];
  }
  L.w_elems = wo;
  L.dw_floats = dwo;
  return L;
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Shared-memory carve-up (byte offsets); the same arithmetic on host and
// device.
struct Carve {
  size_t w, bias, dw, x[6], sb, zs, gs, total;
};

__host__ __device__ inline Carve make_carve(const Layout& L, bool backward, bool exact) {
  Carve c;
  size_t o = 0;
  c.w = o;
  o += align16(sizeof(bf16) * L.w_elems);
  c.bias = o;
  o += align16(sizeof(float) * 6 * WIDTH);
  c.dw = o;
  if (backward) o += align16(sizeof(float) * L.dw_floats);
  for (int l = 0; l < 6; ++l) {
    c.x[l] = o;
    // the tensor-core forward saves nothing: layers 4 and 5 reuse the first
    // hidden tiles, and two CTAs fit on an SM
    if (!backward && !exact && (l == 4 || l == 5)) {
      c.x[l] = c.x[l - 3];
      continue;
    }
    o += align16(sizeof(bf16) * TM * L.xs[l]);
  }
  c.sb = o;
  if (backward) o += align16(sizeof(bf16) * 3 * TM * SS);
  c.zs = o;
  o += align16(sizeof(float) * TM * 4);
  c.gs = o;
  if (backward) o += align16(sizeof(float) * TM * 4);
  c.total = o;
  return c;
}

struct Smem {
  bf16* w;
  float* bias;
  float* dw;
  bf16* x[6];
  bf16* sb;
  float* zs;   // f32 stash a point: z6 (3 columns), raw density
  float* gs;   // f32 cotangent a point: rgb (3 columns), density
};

__device__ inline Smem carve_smem(unsigned char* base, const Carve& c) {
  Smem s;
  s.w = reinterpret_cast<bf16*>(base + c.w);
  s.bias = reinterpret_cast<float*>(base + c.bias);
  s.dw = reinterpret_cast<float*>(base + c.dw);
  for (int l = 0; l < 6; ++l) s.x[l] = reinterpret_cast<bf16*>(base + c.x[l]);
  s.sb = reinterpret_cast<bf16*>(base + c.sb);
  s.zs = reinterpret_cast<float*>(base + c.zs);
  s.gs = reinterpret_cast<float*>(base + c.gs);
  return s;
}

// ------------------------------------------------------------- primitives

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// v = hi + mid + lo exactly, each a bf16 value.
__device__ __forceinline__ void split3(float v, bf16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

// The activations and their derivatives as ATen computes them in f32.
__device__ __forceinline__ float rgb_act(float z, bool elu) {
  return elu ? (z > 0.0f ? z : expm1f(z)) : sigmoid_f(z);
}
__device__ __forceinline__ float rgb_act_grad(float z, float g, bool elu) {
  if (elu) return z > 0.0f ? g : g * expf(z);
  const float y = sigmoid_f(z);
  return g * (1.0f - y) * y;
}
__device__ __forceinline__ float dens_act(float z, bool sdf) {
  return sdf ? 2.0f * sigmoid_f(z) - 1.0f : (z > 0.0f ? z : z * 0.01f);
}
__device__ __forceinline__ float dens_act_grad(float z, float g, bool sdf) {
  if (sdf) {
    const float s = sigmoid_f(z);
    return (2.0f * g) * (1.0f - s) * s;
  }
  return z > 0.0f ? g : g * 0.01f;
}

// acc[j] += A[m0:m0+16, 16 ksteps] . B[16 ksteps, (n0 + j) * 8 : +8] for
// j < count.  A is [points][k] bf16 (row stride sa); W holds a layer's
// [out][in] weights (stride sw): with BT it is read as B[k][n] (the
// backward's dz . W, k the output), without as B = W^T (the forward's
// x . W^T, k the input).  The fragments of step k + 1 are loaded before the
// MMAs of step k are issued.
template <int NPW, bool BT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NPW][4], const bf16* A,
                                          int sa, int m0, const bf16* W, int sw,
                                          int n0, int count, int ksteps,
                                          int lane) {
  const bf16* arow = A + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * sa + (lane >> 4) * 8;
  auto load = [&](int ks, unsigned (&a)[4], unsigned (&b)[NPW][2]) {
    ldsm_x4(a, arow + ks * 16);
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      if (j < count) {
        const int n = (n0 + j) * 8;
        if (BT)
          ldsm_x2_t(b[j], W + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * sw + n);
        else
          ldsm_x2(b[j], W + (n + (lane & 7)) * sw + ks * 16 + ((lane >> 3) & 1) * 8);
      }
    }
  };
  auto mma = [&](const unsigned (&a)[4], const unsigned (&b)[NPW][2]) {
#pragma unroll
    for (int j = 0; j < NPW; ++j)
      if (j < count) mma_bf16(acc[j], a, b[j]);
  };
  unsigned a0[4], a1[4], b0[NPW][2], b1[NPW][2];
  load(0, a0, b0);
  int ks = 0;
  for (; ks + 2 <= ksteps; ks += 2) {
    load(ks + 1, a1, b1);
    mma(a0, b0);
    if (ks + 2 < ksteps) load(ks + 2, a0, b0);
    mma(a1, b1);
  }
  if (ks < ksteps) mma(a0, b0);
}

// One CTA-wide product over the tile (warp_gemm's): output column tiles [0,
// ntiles) split in NG runs over the warps of each 16-row m tile.
// epi(row, col, v0, v1) gets the f32 sums of (row, col) and (row, col + 1).
template <int NPW, bool BT, typename Epi>
__device__ __forceinline__ void tile_product(const bf16* A, int sa, const bf16* W,
                                             int sw, int ntiles, int ksteps,
                                             int warp, int lane, Epi epi) {
  const int per = (ntiles + NG - 1) / NG, n0 = (warp >> 2) * per;
  const int count = min(per, ntiles - n0);
  if (count <= 0) return;
  const int m0 = (warp & 3) * 16;
  float acc[NPW][4];
#pragma unroll
  for (int j = 0; j < NPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  warp_gemm<NPW, BT>(acc, A, sa, m0, W, sw, n0, count, ksteps, lane);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    if (j < count) {
      const int col = (n0 + j) * 8 + 2 * t;
      epi(m0 + g, col, acc[j][0], acc[j][1]);
      epi(m0 + g + 8, col, acc[j][2], acc[j][3]);
    }
  }
}

// dW[rows, nt * 8] += Z^T X over the tile: Z is [zsteps * 16][mtiles * 16]
// (points, or 3 parts of points, by output column; stride sz), X is
// [TM][nt * 8] (stride sx).  Each warp owns the 16x16 blocks (two column
// tiles; the last alone when nt is odd) blk = warp mod 8, in the same order
// every tile, so the sums need no atomics; even and odd k steps go to two
// sets of accumulators.
__device__ __forceinline__ void dw_update(float* dW, int dws, int mtiles, int ntiles,
                                          const bf16* Z, int sz, int zsteps,
                                          const bf16* X, int sx, int warp,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3, pairs = (ntiles + 1) / 2;
  for (int blk = warp; blk < mtiles * pairs; blk += WARPS) {
    const int mt = blk / pairs, nt = 2 * (blk - mt * pairs);
    const bool two = nt + 1 < ntiles;
    float acc[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.0f;
    const bf16* zcol = Z + (lane & 7) * sz + mt * 16 + ((lane >> 3) & 1) * 8 + (lane >> 4) * 8 * sz;
    const bf16* xcol = X + (lane & 7) * sx + nt * 8;
    auto load = [&](int ks, unsigned (&a)[4], unsigned (&b)[4]) {
      ldsm_x4_t(a, zcol + ks * 16 * sz);
      const bf16* xk = xcol + (ks % (TM / 16)) * 16 * sx;
      if (two) {
        ldsm_x4_t(b, xk + ((lane >> 3) & 1) * 8 * sx + (lane >> 4) * 8);
      } else {
        unsigned b2[2];
        ldsm_x2_t(b2, xk + ((lane >> 3) & 1) * 8 * sx);
        b[0] = b2[0];
        b[1] = b2[1];
        b[2] = b[3] = 0u;
      }
    };
    auto mma = [&](const unsigned (&a)[4], const unsigned (&b)[4], float (&d)[2][4]) {
      const unsigned lo[2] = {b[0], b[1]}, hi[2] = {b[2], b[3]};
      mma_bf16(d[0], a, lo);
      if (two) mma_bf16(d[1], a, hi);
    };
    // two accumulator sets (even and odd k steps); the next step's
    // fragments load before this step's MMAs issue
    unsigned a0[4], b0[4], a1[4], b1[4];
    load(0, a0, b0);
    int ks = 0;
    for (; ks + 2 <= zsteps; ks += 2) {
      load(ks + 1, a1, b1);
      mma(a0, b0, acc[0]);
      if (ks + 2 < zsteps) load(ks + 2, a0, b0);
      mma(a1, b1, acc[1]);
    }
    if (ks < zsteps) mma(a0, b0, acc[0]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && !two) break;
      const int col = (nt + j) * 8 + 2 * t;
      float2* p0 = reinterpret_cast<float2*>(dW + (mt * 16 + g) * dws + col);
      float2* p1 = reinterpret_cast<float2*>(dW + (mt * 16 + g + 8) * dws + col);
      float2 v0 = *p0, v1 = *p1;
      v0.x += acc[0][j][0] + acc[1][j][0];
      v0.y += acc[0][j][1] + acc[1][j][1];
      v1.x += acc[0][j][2] + acc[1][j][2];
      v1.y += acc[0][j][3] + acc[1][j][3];
      *p0 = v0;
      *p1 = v1;
    }
  }
}

// Weights rounded to bf16 into [rows][ws] (zero beyond the layer), biases
// rounded into [6][64]; every tile's constant columns (the ones column of
// each layer's input, zero padding after it).
__device__ void load_constants(const Layout& L, const MlpWeights& W, Smem& s,
                               int layers, bool backward) {
  const int tid = threadIdx.x;
  for (int l = 0; l < 6; ++l) {
    const int ws = L.ws[l];
    const int n = L.rows[l] * ws;
    const bool have = l < layers && W.w[l] != nullptr;
    for (int e = tid; e < n; e += THREADS) {
      const int r = e / ws, k = e - r * ws;
      float v = 0.0f;
      if (have && r < L.out[l] && k < L.in[l]) v = __ldg(W.w[l] + r * L.in[l] + k);
      s.w[L.w_off[l] + e] = __float2bfloat16_rn(v);
    }
    for (int r = tid; r < WIDTH; r += THREADS)
      s.bias[l * WIDTH + r] =
          (have && r < L.out[l]) ? round_bf16(__ldg(W.b[l] + r)) : 0.0f;
  }
  if (backward)
    for (int e = tid; e < L.dw_floats; e += THREADS) s.dw[e] = 0.0f;
  // input tiles: the ones column at the layer's input width, zeros after it
  for (int l = 0; l < 6; ++l) {
    if (l >= layers) break;
    bf16* x = s.x[l];
    const int c0 = L.in[l], span = L.xs[l] - c0;
    for (int e = tid; e < TM * span; e += THREADS) {
      const int r = e / span, c = c0 + e - r * span;
      x[r * L.xs[l] + c] = __float2bfloat16_rn(c == c0 ? 1.0f : 0.0f);
    }
  }
}

// A tile's inputs, read into registers one tile ahead: its features, view
// encodings and (backward) cotangents, each a contiguous block of the
// tile's rows.
struct Prefetch {
  float f[PF];
  float d[PD];
  float g[PG];
};

// Element e = threadIdx.x + THREADS * j of a contiguous block of total values.
template <int K>
__device__ __forceinline__ void load_block(float (&v)[K], const float* src, int total) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (tid + THREADS * j < total) v[j] = __ldg(src + tid + THREADS * j);
}

// g0, g1 null: the forward.  Full form: rgb (N, 3) then density (N,)
// cotangents, one value a thread; density-only: the (N, 16) cotangent.
__device__ __forceinline__ void issue_tile(Prefetch& pf, const Layout& L, const float* feats,
                                           const float* dirs, int d_view, const float* g0,
                                           const float* g1, bool donly, long long p0,
                                           int rows) {
  load_block(pf.f, feats + p0 * L.in[0], rows * L.in[0]);
  if (dirs != nullptr) load_block(pf.d, dirs + p0 * d_view, rows * d_view);
  if (g0 == nullptr) return;
  if (donly) {
    load_block(pf.g, g0 + p0 * N3, rows * N3);
  } else {
    const int tid = threadIdx.x;
    if (tid < 3 * rows)
      pf.g[0] = __ldg(g0 + p0 * 3 + tid);
    else if (tid >= 3 * TM && tid - 3 * TM < rows)
      pf.g[0] = __ldg(g1 + p0 + tid - 3 * TM);
  }
}

// Stores the values of a block of rows x width values, prefetched by
// load_block, through put(row, col, v); zeros fill the rows past rows.
template <int K, typename Put>
__device__ __forceinline__ void scatter_block(const float (&v)[K], int rows, int width,
                                              Put put) {
  const int tid = threadIdx.x;
  int r = tid / width, c = tid - r * width;
  const int dq = THREADS / width, dr = THREADS - dq * width;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (r < TM) put(r, c, r < rows ? v[j] : 0.0f);
    r += dq;
    c += dr;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
}

// Rounds the prefetched features into X0 and the view encoding into the
// colour input's columns [GEO, GEO + d_view), zeroing the rows past the
// last point; stores the cotangents: the full form's into s.gs, the density
// form's split into s.sb.
__device__ __forceinline__ void commit_tile(const Prefetch& pf, const Layout& L, Smem& s,
                                            bool dirs, int d_view, bool grads, bool donly,
                                            int rows) {
  const int in_dim = L.in[0], s0 = L.xs[0], s3 = L.xs[3];
  bf16* x0 = s.x[0];
  bf16* x3 = s.x[3];
  scatter_block(pf.f, rows, in_dim, [&](int r, int c, float v) {
    x0[r * s0 + c] = __float2bfloat16_rn(v);
  });
  if (dirs && d_view > 0)
    scatter_block(pf.d, rows, d_view, [&](int r, int c, float v) {
      x3[r * s3 + GEO + c] = __float2bfloat16_rn(v);
    });
  if (!grads) return;
  if (donly) {
    bf16* sb = s.sb;
    scatter_block(pf.g, rows, N3, [&](int r, int c, float v) {
      bf16 parts[3];
      split3(v, parts);
#pragma unroll
      for (int p = 0; p < 3; ++p) sb[(p * TM + r) * SS + c] = parts[p];
    });
  } else {
    const int tid = threadIdx.x;
    if (tid < 3 * TM) {
      const int r = tid / 3;
      s.gs[r * 4 + tid - 3 * r] = r < rows ? pf.g[0] : 0.0f;
    } else if (tid < 4 * TM) {
      const int r = tid - 3 * TM;
      s.gs[r * 4 + 3] = r < rows ? pf.g[0] : 0.0f;
    }
  }
}

// One forward layer over the tile on the FP32 pipes: for every point p and
// output o, acc = sum over k in ascending order of x[p][k] * w[o][k], each
// step one fmaf from acc = 0 (the bf16 products are exact, so each step is
// the rounded sum), which is how cuBLAS's f32 GEMM (TF32 off) sums them at
// the path's shapes: the outputs equal the composed path's bit for bit.
// The padding columns add exact zeros.  A thread takes PT points and OT
// outputs o = og + j * (outputs / OT); epi(p, o, acc) gets each sum.
template <int PT, int OT, typename Epi>
__device__ __forceinline__ void simt_layer(const bf16* X, int xs, const bf16* W, int ws,
                                           int kdim, int outputs, Epi epi) {
  const int groups = outputs / OT;       // output groups
  const int tid = threadIdx.x;
  const int og = tid % groups, p0 = (tid / groups) * PT;
  if (p0 >= TM) return;
  float acc[PT][OT];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < OT; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < kdim; k += 4) {
    uint2 xv[PT];
    float4 wv[OT];
#pragma unroll
    for (int i = 0; i < PT; ++i) xv[i] = *reinterpret_cast<const uint2*>(X + (p0 + i) * xs + k);
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const uint2 u = *reinterpret_cast<const uint2*>(W + (og + j * groups) * ws + k);
      wv[j] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                          __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float x[PT];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const unsigned u = q < 2 ? xv[i].x : xv[i].y;
        x[i] = __uint_as_float(q % 2 == 0 ? u << 16 : u & 0xffff0000u);
      }
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        const float w = q == 0 ? wv[j].x : q == 1 ? wv[j].y : q == 2 ? wv[j].z : wv[j].w;
#pragma unroll
        for (int i = 0; i < PT; ++i) acc[i][j] = fmaf(x[i], w, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < OT; ++j) epi(p0 + i, og + j * groups, acc[i][j]);
}

// One forward layer l over the tile, epi(p, o, sum) for each point and
// output o < outputs (64, 16, or the colour's 3 of 4): EXACT on the FP32
// pipes in cuBLAS's order, otherwise as bf16 MMAs into f32 (the sums in the
// tensor cores' order).  EXACT: a thread takes one point and OT outputs.
template <bool EXACT, int OT, typename Epi>
__device__ __forceinline__ void forward_layer(const Layout& L, Smem& s, int l, int outputs,
                                              Epi epi) {
  if constexpr (EXACT) {
    simt_layer<1, OT>(s.x[l], L.xs[l], s.w + L.w_off[l], L.ws[l], L.in[l], outputs, epi);
  } else {
    tile_product<NPW_H, false>(s.x[l], L.xs[l], s.w + L.w_off[l], L.ws[l], (outputs + 7) / 8,
                               L.kdim[l] / 16, threadIdx.x >> 5, threadIdx.x & 31,
                               [&](int r, int c, float v0, float v1) {
                                 if (c < outputs) epi(r, c, v0);
                                 if (c + 1 < outputs) epi(r, c + 1, v1);
                               });
  }
}

// The forward over one committed tile: the outputs go to out0/out1, rgb
// (N, 3) and density (N,), or, density-only, z3 (N, 16); raw density and z6
// stay in s.zs.
template <bool EXACT>
__device__ void forward_tile(const Layout& L, Smem& s, int mode, long long p0, int rows,
                             float* out0, float* out1) {
  const bool elu = mode & RGB_ELU, sdf = mode & DENSITY_SDF;
  const bool donly = mode & DENSITY_ONLY;
  // hidden layers: X_{l+1} = bf16(relu(sum + b_l)) (the tensor cores' pairs
  // of columns stored as one word)
  auto hidden = [&](int l) {
    bf16* xo = s.x[l + 1];
    const float* b = s.bias + l * WIDTH;
    const int so = L.xs[l + 1];
    if constexpr (EXACT) {
      simt_layer<4, 4>(s.x[l], L.xs[l], s.w + L.w_off[l], L.ws[l], L.in[l], WIDTH,
                       [&](int r, int c, float v) {
                         xo[r * so + c] = __float2bfloat16_rn(fmaxf(v + b[c], 0.0f));
                       });
    } else {
      tile_product<NPW_H, false>(s.x[l], L.xs[l], s.w + L.w_off[l], L.ws[l], WIDTH / 8,
                                 L.kdim[l] / 16, threadIdx.x >> 5, threadIdx.x & 31,
                                 [&](int r, int c, float v0, float v1) {
                                   *reinterpret_cast<unsigned*>(xo + r * so + c) =
                                       pack_bf16(fmaxf(v0 + b[c], 0.0f), fmaxf(v1 + b[c + 1], 0.0f));
                                 });
    }
    __syncthreads();
  };
  hidden(0);
  hidden(1);
  {  // density branch output: raw density and the geometry features
    const float* b = s.bias + 2 * WIDTH;
    bf16* x3 = s.x[3];
    const int s3 = L.xs[3];
    forward_layer<EXACT, 4>(L, s, 2, N3, [&](int r, int c, float v) {
                       const float z = v + b[c];
                       if (donly) {
                         if (r < rows) out0[(p0 + r) * N3 + c] = z;
                       } else if (c == 0) {
                         s.zs[r * 4 + 3] = z;
                         if (r < rows) out1[p0 + r] = dens_act(z, sdf);
                       } else {
                         x3[r * s3 + c - 1] = __float2bfloat16_rn(z);
                       }
                     });
    __syncthreads();
  }
  if (donly) return;
  hidden(3);
  hidden(4);
  {  // colour output (3 of 4 output groups)
    const float* b = s.bias + 5 * WIDTH;
    forward_layer<EXACT, 1>(L, s, 5, 4, [&](int r, int c, float v) {
                       if (c >= 3) return;
                       const float z = v + b[c];
                       s.zs[r * 4 + c] = z;
                       if (r < rows) out0[(p0 + r) * 3 + c] = rgb_act(z, elu);
                     });
    __syncthreads();
  }
}

// Element q of a point's saved row: its address in the tile (row r).
__device__ __forceinline__ bf16* act_slot(const Layout& L, Smem& s, int r, int q) {
  const int t = q < 2 * WIDTH ? 1 + q / WIDTH : (q < 2 * WIDTH + 16 ? 3 : 4 + (q - 2 * WIDTH - 16) / WIDTH);
  const int c = t == 3 ? q - 2 * WIDTH : (t < 3 ? q - (t - 1) * WIDTH : q - 2 * WIDTH - 16 - (t - 4) * WIDTH);
  return s.x[t] + r * L.xs[t] + c;
}

// The tile's activations and stash out to the saved rows (16 bytes a copy).
__device__ void save_tile(const Layout& L, Smem& s, bf16* acts, float* zsave, bool donly,
                          long long p0, int rows) {
  const int as = donly ? AS_DENSITY : AS_FULL, cpp = as / 8;
  for (int e = threadIdx.x; e < rows * cpp; e += THREADS) {
    const int r = e / cpp, q = (e - r * cpp) * 8;
    *reinterpret_cast<uint4*>(acts + (p0 + r) * as + q) =
        *reinterpret_cast<const uint4*>(act_slot(L, s, r, q));
  }
  if (!donly)
    for (int r = threadIdx.x; r < rows; r += THREADS)
      *reinterpret_cast<float4*>(zsave + (p0 + r) * 4) = *reinterpret_cast<const float4*>(s.zs + r * 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The backward's tile: the saved activations and stash in (asynchronous
// copies, for cp_async_wait_all), the rows past the last point zeroed.
__device__ void load_saved(const Layout& L, Smem& s, const bf16* acts, const float* zsave,
                           bool donly, long long p0, int rows) {
  const int as = donly ? AS_DENSITY : AS_FULL, cpp = as / 8;
  for (int e = threadIdx.x; e < TM * cpp; e += THREADS) {
    const int r = e / cpp, q = (e - r * cpp) * 8;
    if (r < rows)
      cp_async16(act_slot(L, s, r, q), acts + (p0 + r) * as + q);
    else
      *reinterpret_cast<uint4*>(act_slot(L, s, r, q)) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (!donly)
    for (int r = threadIdx.x; r < TM; r += THREADS) {
      if (r < rows)
        cp_async16(s.zs + r * 4, zsave + (p0 + r) * 4);
      else
        *reinterpret_cast<float4*>(s.zs + r * 4) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tensor-core forward saves nothing, and its shared memory leaves room
// for two CTAs an SM: its launch bound asks for two (128 registers a
// thread; 228 bytes spill).  Under a bound of one it took 189 registers and
// ran one CTA an SM: 1.80 ms against 1.58 at a 2,097,152-point serving
// chunk (H100).  The FP32 forward, which saves, asks for one.
template <bool EXACT>
__global__ void __launch_bounds__(THREADS, EXACT ? 1 : 2)
hbr_mlp_gemm_forward_kernel(const float* __restrict__ feats, const float* __restrict__ dirs,
                            long long n, int d_view, int mode, Layout L, Carve C,
                            MlpWeights W, float* __restrict__ out0,
                            float* __restrict__ out1, bf16* __restrict__ acts,
                            float* __restrict__ zsave) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve_smem(smem_raw, C);
  const bool donly = mode & DENSITY_ONLY;
  load_constants(L, W, s, donly ? 3 : 6, false);
  const long long tiles = (n + TM - 1) / TM;
  const float* fd = donly ? nullptr : dirs;
  Prefetch pf;
  long long tile = blockIdx.x;
  if (tile < tiles)
    issue_tile(pf, L, feats, fd, d_view, nullptr, nullptr, donly, tile * TM,
               (int)min((long long)TM, n - tile * TM));
  for (; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * TM;
    const int rows = (int)min((long long)TM, n - p0);
    __syncthreads();
    commit_tile(pf, L, s, fd != nullptr, d_view, false, donly, rows);
    const long long next = tile + gridDim.x;
    if (next < tiles)
      issue_tile(pf, L, feats, fd, d_view, nullptr, nullptr, donly, next * TM,
                 (int)min((long long)TM, n - next * TM));
    __syncthreads();
    forward_tile<EXACT>(L, s, mode, p0, rows, out0, out1);
    if constexpr (EXACT)
      if (acts != nullptr) save_tile(L, s, acts, zsave, donly, p0, rows);
  }
}

// Backward of hidden layer l (1..5, not the split ones): dz_{l} in x[l+1]
// (masked, bf16), activations x[l].  Leaves dz_{l-1} = bf16(dz_l W_l) masked
// by x[l] > 0 in x[l]'s storage and adds dz_l^T x_l to dW_l.  SPLIT: dz_l is
// the split tile s.sb (3 parts of TM rows, 16 columns).
template <bool SPLIT>
__device__ __forceinline__ void backward_hidden(const Layout& L, Smem& s, int l, int warp,
                                                int lane) {
  const bf16* Z = SPLIT ? s.sb : s.x[l + 1];
  const int sz = SPLIT ? SS : L.xs[l + 1];
  const int zk = L.rows[l] / 16;        // K of dz . W: output rows of layer l
  bf16* x = s.x[l];
  const int sx = L.xs[l];
  const bf16* w = s.w + L.w_off[l];
  // dx = dz . W over the tile, masked, rounded: held in registers
  const int per = NPW_H, n0 = (warp >> 2) * per;
  const int m0 = (warp & 3) * 16, g = lane >> 2, t = lane & 3;
  float acc[NPW_H][4];
#pragma unroll
  for (int j = 0; j < NPW_H; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  if (SPLIT) {
#pragma unroll
    for (int p = 0; p < 3; ++p)
      warp_gemm<NPW_H, true>(acc, Z + p * TM * sz, sz, m0, w, L.ws[l], n0, per, zk, lane);
  } else {
    warp_gemm<NPW_H, true>(acc, Z, sz, m0, w, L.ws[l], n0, per, zk, lane);
  }
  unsigned dz[NPW_H][2];
#pragma unroll
  for (int j = 0; j < NPW_H; ++j) {
    const int c = (n0 + j) * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(x + r * sx + c);
      const float d0 = __bfloat162float(a.x) > 0.0f ? acc[j][2 * h] : 0.0f;
      const float d1 = __bfloat162float(a.y) > 0.0f ? acc[j][2 * h + 1] : 0.0f;
      dz[j][h] = pack_bf16(d0, d1);
    }
  }
  dw_update(s.dw + L.dw_off[l], L.dws[l], L.rows[l] / 16, L.nt[l], Z, sz,
            (SPLIT ? 3 : 1) * TM / 16, x, sx, warp, lane);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NPW_H; ++j) {
    const int c = (n0 + j) * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<unsigned*>(x + (m0 + g + 8 * h) * sx + c) = dz[j][h];
  }
  __syncthreads();
}

// The split cotangent tile: row p * TM + r holds part p of the 16 columns
// of point r (columns >= ncols zero).  full(r, c) gives the f32 value.
template <typename Val>
__device__ __forceinline__ void write_split(Smem& s, int ncols, Val val) {
  for (int e = threadIdx.x; e < 3 * TM; e += THREADS) {
    const int p = e / TM, r = e - p * TM;
    unsigned wv[8];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      bf16 parts[3];
      split3(c < ncols ? val(r, c) : 0.0f, parts);
      const unsigned bits =
          __bfloat16_as_ushort(p == 0 ? parts[0] : (p == 1 ? parts[1] : parts[2]));
      if (c % 2 == 0)
        wv[c / 2] = bits;
      else
        wv[c / 2] |= bits << 16;
    }
    uint4* dst = reinterpret_cast<uint4*>(s.sb + e * SS);
    dst[0] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    dst[1] = make_uint4(wv[4], wv[5], wv[6], wv[7]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
hbr_mlp_gemm_backward_kernel(const float* __restrict__ feats, const float* __restrict__ dirs,
                             long long n, int d_view, int mode, Layout L, Carve C,
                             MlpWeights W, const bf16* __restrict__ acts,
                             const float* __restrict__ zsave, const float* __restrict__ g0,
                             const float* __restrict__ g1, float* __restrict__ dfeats,
                             float* __restrict__ ddirs, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s = carve_smem(smem_raw, C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x;
  const bool donly = mode & DENSITY_ONLY, elu = mode & RGB_ELU, sdf = mode & DENSITY_SDF;
  load_constants(L, W, s, donly ? 3 : 6, true);
  const long long tiles = (n + TM - 1) / TM;
  const float* fd = donly ? nullptr : dirs;
  Prefetch pf;
  long long tile = blockIdx.x;
  if (tile < tiles)
    issue_tile(pf, L, feats, fd, d_view, g0, g1, donly, tile * TM,
               (int)min((long long)TM, n - tile * TM));
  for (; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * TM;
    const int rows = (int)min((long long)TM, n - p0);
    __syncthreads();
    commit_tile(pf, L, s, fd != nullptr, d_view, true, donly, rows);
    load_saved(L, s, acts, zsave, donly, p0, rows);
    const long long next = tile + gridDim.x;
    if (next < tiles)
      issue_tile(pf, L, feats, fd, d_view, g0, g1, donly, next * TM,
                 (int)min((long long)TM, n - next * TM));
    cp_async_wait_all();
    __syncthreads();
    if (!donly) {
      // colour output: dz6 = act'(z6) g, split (the density form's dz3 was
      // split into s.sb by commit_tile)
      write_split(s, 3, [&](int r, int c) {
        return rgb_act_grad(s.zs[r * 4 + c], s.gs[r * 4 + c], elu);
      });
      __syncthreads();
      backward_hidden<true>(L, s, 5, warp, lane);
      backward_hidden<false>(L, s, 4, warp, lane);
      {  // colour input layer: dx3 = bf16(dz4 W), its geometry columns and
         // the raw density's f32 cotangent make dz3
        const bf16* Z = s.x[4];
        const int sz = L.xs[4];
        bf16* sb = s.sb;
        tile_product<3, true>(
            Z, sz, s.w + L.w_off[3], L.ws[3], L.kdim[3] / 8, L.rows[3] / 16, warp, lane,
            [&](int r, int c, float v0, float v1) {
              const float v[2] = {round_bf16(v0), round_bf16(v1)};
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int cc = c + i;
                if (cc < GEO) {
                  sb[r * SS + cc + 1] = __float2bfloat16_rn(v[i]);
                  sb[(TM + r) * SS + cc + 1] = __float2bfloat16_rn(0.0f);
                  sb[(2 * TM + r) * SS + cc + 1] = __float2bfloat16_rn(0.0f);
                } else if (cc < GEO + d_view && ddirs != nullptr && r < rows) {
                  ddirs[(p0 + r) * d_view + cc - GEO] = v[i];
                }
              }
            });
        dw_update(s.dw + L.dw_off[3], L.dws[3], L.rows[3] / 16, L.nt[3], Z, sz, TM / 16,
                  s.x[3], L.xs[3], warp, lane);
        if (tid < TM) {
          bf16 parts[3];
          split3(dens_act_grad(s.zs[tid * 4 + 3], s.gs[tid * 4 + 3], sdf), parts);
#pragma unroll
          for (int p = 0; p < 3; ++p) sb[(p * TM + tid) * SS] = parts[p];
        }
        __syncthreads();
      }
    }
    backward_hidden<true>(L, s, 2, warp, lane);
    backward_hidden<false>(L, s, 1, warp, lane);
    {  // first layer: dW0 += dz1^T x0, dfeats = bf16(dz1 W0)
      const bf16* Z = s.x[1];
      const int sz = L.xs[1];
      dw_update(s.dw + L.dw_off[0], L.dws[0], L.rows[0] / 16, L.nt[0], Z, sz, TM / 16,
                s.x[0], L.xs[0], warp, lane);
      if (dfeats != nullptr) {
        const int in_dim = L.in[0], ntiles = L.kdim[0] / 8, per = (ntiles + NG - 1) / NG;
        const int n0 = (warp >> 2) * per, m0 = (warp & 3) * 16;
        const int g = lane >> 2, t = lane & 3;
        for (int j0 = 0; j0 < per; j0 += 3) {
          const int count = min(3, min(per - j0, ntiles - n0 - j0));
          if (count <= 0) break;
          float acc[3][4];
#pragma unroll
          for (int j = 0; j < 3; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
          warp_gemm<3, true>(acc, Z, sz, m0, s.w + L.w_off[0], L.ws[0], n0 + j0, count,
                             L.rows[0] / 16, lane);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            if (j >= count) continue;
            const int c = (n0 + j0 + j) * 8 + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m0 + g + 8 * h;
              if (r >= rows) continue;
              float* dst = dfeats + (p0 + r) * in_dim;
              if (c < in_dim) dst[c] = round_bf16(acc[j][2 * h]);
              if (c + 1 < in_dim) dst[c + 1] = round_bf16(acc[j][2 * h + 1]);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  float* part = partials + (long long)blockIdx.x * L.dw_floats;
  for (int e = tid; e < L.dw_floats; e += THREADS) part[e] = s.dw[e];
}

// dW = bf16(sum of the CTAs' partials, in block order), into each layer's
// (out, in) weight gradient and its bias gradient (the ones column).
__global__ void hbr_mlp_gemm_reduce_kernel(const float* __restrict__ partials, int blocks,
                                           Layout L, MlpGrads G) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= L.dw_floats) return;
  int l = 0;
  while (l < 5 && e >= L.dw_off[l + 1]) ++l;
  if (G.w[l] == nullptr) return;
  const int q = e - L.dw_off[l], r = q / L.dws[l], c = q - r * L.dws[l];
  if (r >= L.out[l] || c > L.in[l]) return;
  float sum = 0.0f;
  for (int b = 0; b < blocks; ++b) sum += partials[(long long)b * L.dw_floats + e];
  sum = round_bf16(sum);
  if (c < L.in[l])
    G.w[l][r * L.in[l] + c] = sum;
  else
    G.b[l][r] = sum;
}

bool supported(int in_dim, int d_view) {
  return in_dim >= 1 && in_dim <= MAX_IN && d_view >= 0 && d_view <= MAX_VIEW;
}

}  // namespace

extern "C" {

// The largest feature width and view-encoding width the kernels take, the
// hidden width they are built for, and the saved activations' row widths.
int hbr_mlp_limits(int* max_in, int* max_view, int* width, int* saved_full,
                   int* saved_density) {
  *max_in = MAX_IN;
  *max_view = MAX_VIEW;
  *width = WIDTH;
  *saved_full = AS_FULL;
  *saved_density = AS_DENSITY;
  return 0;
}

// The backward's CTA count for n points (each CTA writes one partial of
// *partial_floats f32) and its shared memory.
int hbr_mlp_backward_plan(long long n, int in_dim, int d_view, int* blocks,
                          long long* partial_floats) {
  if (!supported(in_dim, d_view)) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(in_dim, d_view);
  const Carve C = make_carve(L, true, false);
  if (C.total > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + TM - 1) / TM;
  const int e = persistent_blocks(hbr_mlp_gemm_backward_kernel, THREADS, C.total,
                                  tiles > 0 ? tiles : 1, blocks);
  *partial_floats = L.dw_floats;
  return e;
}

// feats (n, in_dim) f32 contiguous; dirs (n, d_view) f32 (unused with
// DENSITY_ONLY); out0 rgb (n, 3) and out1 density (n,), or with DENSITY_ONLY
// out0 z3 (n, 16); with EXACT_ORDER (sums in cuBLAS's order), acts (n,
// AS_FULL or AS_DENSITY) bf16 and zsave (n, 4) f32 (full form) receive what
// the backward reads, or are null.  Returns cudaGetLastError() after the
// launch.
int hbr_mlp_forward(const float* feats, const float* dirs, long long n, int in_dim,
                    int d_view, int mode, const HbrMlpWeights* w, float* out0, float* out1,
                    void* acts, float* zsave, void* stream) {
  if (!supported(in_dim, d_view)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const Layout L = make_layout(in_dim, d_view);
  const bool exact = mode & EXACT_ORDER;
  const Carve C = make_carve(L, false, exact);
  auto kernel = exact ? hbr_mlp_gemm_forward_kernel<true> : hbr_mlp_gemm_forward_kernel<false>;
  int blocks = 0;
  const int e = persistent_blocks(kernel, THREADS, C.total, (n + TM - 1) / TM, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, THREADS, C.total, (cudaStream_t)stream>>>(
      feats, dirs, n, d_view, mode, L, C, *w, out0, out1, (bf16*)acts, zsave);
  return (int)cudaGetLastError();
}

// The backward, from the forward's acts and zsave: g0 the cotangent of rgb
// (n, 3) and g1 of density (n,), or with DENSITY_ONLY g0 that of z3 (n, 16); writes dfeats (n, in_dim) and,
// when not null, ddirs (n, d_view); partials holds blocks * partial_floats
// f32 (hbr_mlp_backward_plan); grads the layers' (out, in) and (out,)
// gradients (null pointers skip a layer).
int hbr_mlp_backward(const float* feats, const float* dirs, long long n, int in_dim,
                     int d_view, int mode, const HbrMlpWeights* w, const void* acts,
                     const float* zsave, const float* g0,
                     const float* g1, float* dfeats, float* ddirs, float* partials,
                     int blocks, const HbrMlpGrads* grads, void* stream) {
  if (!supported(in_dim, d_view) || blocks <= 0) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(in_dim, d_view);
  const Carve C = make_carve(L, true, false);
  if (C.total > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(hbr_mlp_gemm_backward_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)C.total);
  if (e != cudaSuccess) return (int)e;
  hbr_mlp_gemm_backward_kernel<<<blocks, THREADS, C.total, (cudaStream_t)stream>>>(
      feats, dirs, n, d_view, mode, L, C, *w, (const bf16*)acts, zsave, g0, g1, dfeats, ddirs,
      partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rthreads = 256;
  hbr_mlp_gemm_reduce_kernel<<<(L.dw_floats + rthreads - 1) / rthreads, rthreads, 0,
                               (cudaStream_t)stream>>>(partials, blocks, L, *grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
