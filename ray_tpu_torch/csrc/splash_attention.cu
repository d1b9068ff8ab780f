// Splash attention for Hopper (sm_90a): kernel K5, block-sparse attention
// driven by a mask table, as three kernels on [B, S, heads, head_dim]
// tensors read through their strides, with grouped-query heads
// (kv_head = h / g).
//
// They replace the TPU kernels that ray_tpu/ops/splash.py:19 reaches through
// JAX's make_splash_mha (jax/experimental/pallas/ops/tpu/splash_attention/
// splash_attention_kernel.py) and compute the same functions:
//
//   K5-fwd  flash_attention_kernel       O = softmax(q_s.K^T) V in fp32 and
//                                        LSE = m + log(l)
//   K5-dQ   _flash_attention_dq_kernel   P = exp(s - LSE),
//                                        dS = (dO.V^T - delta) o P,
//                                        dQ = round(round(dS) K) * scale
//   K5-dKV  _flash_attention_dkv_kernel  dV = round(P)^T dO and
//                                        dK = round(dS)^T q_s, summed over
//                                        the g query heads of a kv head
//
// where q_s = round(q * scale) is q scaled in its own dtype (scale already
// rounded to that dtype by the caller), round() rounds to the input dtype
// (a no-op for fp32), masked scores are -0.7 * FLT_MAX, and
// delta = rowsum(dO o O) is computed outside the kernels, as the JAX
// package does.
//
// The mask table.  The caller reduces the mask to 64 x 64 tiles on the
// host: for each unique head mask u and q tile, the ordered list of its
// non-empty kv tiles (`ptr`/`ent` for K5-fwd and K5-dQ), and for each kv
// tile the transposed list of q tiles (for K5-dKV).  An entry is
// (tile << 1) | partial.  A block walks its list and nothing else: empty
// tiles are never visited, full tiles take no element mask, and partial
// tiles apply the causal rule (key <= query) from the tile's positions, the
// only rule of the masks the port builds (CausalMask; FullMask has no
// partial tiles).  At S = 1024 causal that is 136 of 256 tiles, 16 partial.
//
// K5-fwd on bf16 inputs is splash_fwd_tc_kernel: the tensor-core forward
// of attention_fwd_tc.cuh (bf16 mma.sync tiles, a cp.async ring of K/V
// tiles, the softmax in registers, P.V split into two bf16 products so
// that P keeps ~16 bits as the library's fp32 P does).  Its walk is the
// block's table entries; it stages q_s = bf16(q * scale) from the Q
// fragments, so its products are the library's exactly.  It needs every
// row of q, k and v on 16 bytes.
//
// K5-dKV on bf16 inputs is splash_bwd_dkv_tc_kernel: the tensor-core
// dK/dV of attention_bwd_dkv_tc.cuh (K-stationary bf16 mma.sync tiles, a
// cp.async ring of Q/dO tiles with their LSE and delta, P^T and dS^T in
// registers).  Its walk is the block's transposed table entries for each
// of the g query heads; partial entries take the causal rule.  It scales
// each Q tile to q_s = bf16(q * scale) in shared memory once it lands and
// rounds P and dS to bf16 for their products, as the library does, so
// each product is one bf16 mma.  It needs every row of q, k, v and dout on
// 16 bytes.
//
// K5-dQ on bf16 inputs is splash_bwd_dq_tc_kernel: the tensor-core dQ of
// attention_bwd_dq_tc.cuh (Q-stationary bf16 mma.sync tiles, a cp.async
// ring of K/V tiles, S, dP and dS in registers).  Its walk is the q tile's
// table entries; it scales the Q tile to q_s = bf16(q * scale) in shared
// memory once it lands, rounds dS to bf16 for dS.K as the library does
// (one bf16 mma), and writes dq = bf16(bf16(dS.K) * scale).  It needs
// every row of q, k, v and dout on 16 bytes.
//
// The bf16 kernels take head_dim 32, 64, 128 and 256, as K1-K3 do
// (csrc/flash_attention.cu): at 32 a tile row is 4 chunks of 16 bytes, and
// the swizzle XORs the chunk with (row / 2) % 4 (attention_tc_common.cuh
// swz).
//
// What bounds them on this card: operations.  At the training shapes
// (S = 1024, head_dim 64) each (query, key) pair costs 4-8 * head_dim flops
// against a few bytes, far above the ~295 flops per byte where the tensor
// cores, not the memory, become the limit.  K5-fwd, K5-dQ and K5-dKV on
// fp32 are the first, simple versions: the products run as fp32 FMAs on
// the CUDA cores from shared memory, as K1-K3 on fp32 do
// (csrc/flash_attention.cu), at head_dim 32, 64, 128 and 256.  At 256 a K5-dQ
// block owns a 32-row q tile and a K5-dKV block a 32-row kv tile, as K2
// and K3 do there (64-row fp32 tiles of every operand do not fit a
// block); each walks the table list of the 64-row tile that holds it,
// whose partial entries take the element mask.  Their design:
//   - a thread block holds 64 x 64 fp32 tiles in shared memory (rows padded
//     by one word against bank conflicts), and a loop over the block's
//     table entries replaces the TPU's sequential grid dimension, which
//     the library walks with its own skip tables (data_next, mask_next);
//   - K5-fwd and K5-dQ run one block per (batch, head, q tile), the last q
//     tile (the longest causal list) first; K5-dKV runs one block per
//     (batch, kv head, kv tile) and walks the lists of the g query heads
//     of its group, so dK and dV are written once, with no atomics;
//   - a 16 x 16 grid of threads gives each thread a 4 x 4 patch of every
//     score tile (2 x 4 where the block owns 32 rows) and 4 (2) rows x
//     head_dim / 16 columns of each accumulator;
//     row maxima and sums reduce with shuffles inside 16-lane groups;
//   - q_len and kv_len are multiples of 64 (the library's 128-row blocks),
//     so there is no ragged edge.
// Left for later: TMA loads, wgmma.
//
// Inputs are fp32 or bf16 (dtype 0 or 1); sums are fp32; outputs take the
// input dtype, and LSE is fp32 [B, heads, Sq].
//
// Plain C interface, loaded with ctypes (ray_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <float.h>
#include <stddef.h>

#include <type_traits>

#include "attention_bwd_dkv_tc.cuh"
#include "attention_bwd_dq_tc.cuh"
#include "attention_fwd_tc.cuh"

namespace {

constexpr int kTile = 64;                  // rows of a q tile and a kv tile
constexpr int kThreads = 256;              // a 16 x 16 grid of threads
constexpr int kLP = kTile + 1;             // padded row of a [64, 64] tile
// the library's mask value, -0.7 * FLT_MAX in double as Python computes it
constexpr float kMask =
    static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr unsigned kFull = 0xffffffffu;
// rows of the tile a fp32 K5-dQ (q rows) or K5-dKV (kv rows) block owns:
// 32 at head_dim 256, where two 64-row fp32 tiles of each operand do not
// fit
template <int D>
constexpr int kOwn = D > 128 ? 32 : kTile;

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

struct Params {
  const void* q;        // [B, Sq, H, D], strided, last dim contiguous
  const void* k;        // [B, Skv, KVH, D], strided
  const void* v;        // [B, Skv, KVH, D], strided
  const void* dout;     // [B, Sq, H, D] contiguous (K5-dQ, K5-dKV)
  void* out;            // K5-fwd: o, K5-dQ: dq [B, Sq, H, D] contiguous
  void* dk;             // K5-dKV: [B, Skv, KVH, D] contiguous
  void* dv;             // K5-dKV: [B, Skv, KVH, D] contiguous
  float* lse;           // [B, H, Sq]: written by K5-fwd, read by the others
  const float* delta;   // [B, H, Sq]
  const int* head_map;  // [H]: the unique mask of each head
  const int* ptr;       // [U, tiles + 1]: offsets of each tile's list
  const int* ent;       // entries: (tile << 1) | partial
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, H, KVH, Sq, Skv;
  float scale;          // sm_scale, rounded to the input dtype
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
// x rounded to T and back: what a value of dtype T holds
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// max and sum over the 16 lanes that hold one row of a score tile
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Stage rows [row0, row0 + R) of one head (src points at its row 0) as
// fp32 in a [R, D + 1] tile, each value times `mul` rounded to T (with
// mul = 1 the value itself; with the scale, q scaled in its own dtype).
template <typename T, int D, int R = kTile>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          float mul) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        round_to<T>(to_f(src[(row0 + r) * row_stride + c]) * mul);
  }
}

// s[i][j] = sum_d A[ty*I + i][d] * Bm[tx + 16 j][d] over [16 I, D + 1]
// and [64, D + 1] tiles
template <int D, int I>
__device__ __forceinline__ void mm_nt(const float* A, const float* Bm,
                                      float (&s)[I][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[I], b[4];
#pragma unroll
    for (int i = 0; i < I; ++i) a[i] = A[(ty * I + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][j] += sum_c P[ty*I + i][c] * Bm[c][tx + 16 j]; P is [16 I, 65],
// Bm [64, D + 1]
template <int D, int I>
__device__ __forceinline__ void mm_nn(const float* P, const float* Bm,
                                      float (&acc)[I][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float p[I];
#pragma unroll
    for (int i = 0; i < I; ++i) p[i] = P[(ty * I + i) * kLP + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float b = Bm[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < I; ++i) acc[i][j] = fmaf(p[i], b, acc[i][j]);
    }
  }
}

// K5-fwd on fp32 inputs: grid (B * H, q tiles), the last q tile first.
template <int D>
__global__ void __launch_bounds__(kThreads) splash_fwd_kernel(Params p) {
  using T = float;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int nq = gridDim.y;
  const int qt = nq - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int* list = p.ptr + p.head_map[h] * (nq + 1) + qt;
  const int e0 = list[0], e1 = list[1];

  load_tile<T, D>(Qs, q, p.q_ss, q0, p.scale);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }
  for (int e = e0; e < e1; ++e) {
    const int ent = p.ent[e];
    const int k0 = (ent >> 1) * kTile;
    const bool partial = ent & 1;
    __syncthreads();   // the last tile's reads are done
    load_tile<T, D>(Ks, k, p.k_ss, k0, 1.f);
    load_tile<T, D>(Vs, v, p.v_ss, k0, 1.f);
    __syncthreads();
    float s[4][4];
    mm_nt<D, 4>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (partial && k0 + tx + 16 * j > row) s[i][j] = kMask;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        Ps[(ty * 4 + i) * kLP + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mm_nn<D, 4>(Ps, Vs, acc);
  }
  T* o = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const long long base =
        ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o[base + tx + 16 * j] = from_f<T>(acc[i][j] / l_safe);
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
          m[i] + logf(l_safe);
  }
}

// K5-fwd's walk for attention_fwd_tc.cuh: the q tile's table entries;
// partial tiles take the causal rule.
struct SplashWalk {
  static constexpr float kMaskValue = kMask;
  const int* ent;       // the q tile's entries, (kv tile << 1) | partial
  int n;
  float scale;          // sm_scale rounded to bf16
  __device__ int count() const { return n; }
  __device__ int kv_row(int j) const { return (__ldg(ent + j) >> 1) * kTile; }
  __device__ bool masked(int j, int) const { return __ldg(ent + j) & 1; }
  __device__ bool keep(int row, int col) const { return col <= row; }
  __device__ float logit_scale() const { return 1.f; }
  // q_s = bf16(q * scale), as the library scales q in its own dtype
  template <int N>
  __device__ void prepare_q(uint32_t (&qf)[N][4]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 x = __bfloat1622float2(attn_tc::as_bf162(qf[i][e]));
        qf[i][e] = attn_tc::as_u32(
            __floats2bfloat162_rn(x.x * scale, x.y * scale));
      }
  }
};

// K5-fwd on bf16 inputs: grid (B * H, q tiles), the last q tile first.
template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads)
    splash_fwd_tc_kernel(attn_tc::Args a, const int* head_map,
                         const int* ptr, const int* ent, float scale) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int nq = gridDim.y;
  const int qt = nq - 1 - blockIdx.y;
  const int* list = ptr + head_map[h] * (nq + 1) + qt;
  const SplashWalk walk{ent + list[0], list[1] - list[0], scale};
  attn_tc::forward_block<D>(a, walk, b, h, qt * kTile);
}

// K5-dQ on fp32 inputs: grid (B * H, q tiles of kOwn<D> rows), the last q
// tile first.
template <int D>
__global__ void __launch_bounds__(kThreads) splash_bwd_dq_kernel(Params p) {
  using T = float;
  constexpr int LD = D + 1;
  constexpr int R = kOwn<D>, I = R / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [R, D + 1]
  float* dOs = Qs + R * LD;         // [R, D + 1]
  float* Ks = dOs + R * LD;         // [64, D + 1]
  float* Vs = Ks + kTile * LD;      // [64, D + 1]
  float* dSs = Vs + kTile * LD;     // [R, 65]
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) +
                  (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  const long long vec = (static_cast<long long>(b) * p.H + h) * p.Sq;
  // the list of the 64-row q tile that holds these rows
  const int* list =
      p.ptr + p.head_map[h] * (p.Sq / kTile + 1) + q0 / kTile;
  const int e0 = list[0], e1 = list[1];

  load_tile<T, D, R>(Qs, q, p.q_ss, q0, p.scale);
  load_tile<T, D, R>(dOs, dout, static_cast<long long>(p.H) * D, q0, 1.f);
  float lse[I], delta[I], acc[I][D / 16];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = q0 + ty * I + i;
    lse[i] = p.lse[vec + row];
    delta[i] = p.delta[vec + row];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }
  for (int e = e0; e < e1; ++e) {
    const int ent = p.ent[e];
    const int k0 = (ent >> 1) * kTile;
    const bool partial = ent & 1;
    __syncthreads();
    load_tile<T, D>(Ks, k, p.k_ss, k0, 1.f);
    load_tile<T, D>(Vs, v, p.v_ss, k0, 1.f);
    __syncthreads();
    float s[I][4], dp[I][4];
    mm_nt<D, I>(Qs, Ks, s);
    mm_nt<D, I>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int row = q0 + ty * I + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = partial && k0 + tx + 16 * j > row;
        const float pr = masked ? 0.f : expf(s[i][j] - lse[i]);
        dSs[(ty * I + i) * kLP + tx + 16 * j] =
            round_to<T>((dp[i][j] - delta[i]) * pr);
      }
    }
    __syncthreads();
    mm_nn<D, I>(dSs, Ks, acc);
  }
  T* dq = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = q0 + ty * I + i;
    const long long base =
        ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[base + tx + 16 * j] = from_f<T>(round_to<T>(acc[i][j]) * p.scale);
  }
}

// K5-dQ's walk for attention_bwd_dq_tc.cuh: the q tile's table entries;
// partial tiles take the causal rule.
struct SplashDqWalk {
  static constexpr bool kSplit = false;   // the library rounds dS
  static constexpr bool kScaleQ = true;   // q_s = bf16(q * scale)
  const int* ent;       // the q tile's entries, (kv tile << 1) | partial
  int n;
  float scale;          // sm_scale rounded to bf16
  __device__ int count() const { return n; }
  __device__ int kv_row(int j) const { return (__ldg(ent + j) >> 1) * kTile; }
  __device__ bool masked(int j, int) const { return __ldg(ent + j) & 1; }
  __device__ bool keep(int row, int col) const { return col <= row; }
  __device__ float logit_scale() const { return 1.f; }
  __device__ float q_scale() const { return scale; }
  // dq = bf16(dS.K) * scale, rounded again on the store
  __device__ float dq_value(float x) const {
    return __bfloat162float(__float2bfloat16(x)) * scale;
  }
};

// K5-dQ on bf16 inputs: grid (B * H, q tiles), the last q tile first.
template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads)
    splash_bwd_dq_tc_kernel(attn_tc::BwdArgs a, const int* head_map,
                            const int* ptr, const int* ent, float scale) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int nq = gridDim.y;
  const int qt = nq - 1 - blockIdx.y;
  const int* list = ptr + head_map[h] * (nq + 1) + qt;
  const SplashDqWalk walk{ent + list[0], list[1] - list[0], scale};
  attn_tc::dq_block<D>(a, walk, b, h, qt * kTile);
}

// K5-dKV on fp32 inputs: grid (B * KVH, kv tiles of kOwn<D> rows), the
// first kv tile (the longest causal list) first.  Tiles are transposed
// against K5-dQ: a thread's patch rows are keys and its columns queries.
template <int D>
__global__ void __launch_bounds__(kThreads) splash_bwd_dkv_kernel(Params p) {
  using T = float;
  constexpr int LD = D + 1;
  constexpr int R = kOwn<D>, I = R / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [R, D + 1]
  float* Vs = Ks + R * LD;          // [R, D + 1]
  float* Qs = Vs + R * LD;          // [64, D + 1]
  float* dOs = Qs + kTile * LD;     // [64, D + 1]
  float* Ps = dOs + kTile * LD;     // round(P)^T [key][query], [R, 65]
  float* dSs = Ps + R * kLP;        // round(dS)^T [key][query], [R, 65]
  const int b = blockIdx.x / p.KVH, kvh = blockIdx.x % p.KVH;
  const int g = p.H / p.KVH;
  const int nkv = p.Skv / kTile;
  const int k0 = blockIdx.y * R;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, D, R>(Ks,
                     static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh,
                     p.k_ss, k0, 1.f);
  load_tile<T, D, R>(Vs,
                     static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh,
                     p.v_ss, k0, 1.f);
  float acc_k[I][D / 16], acc_v[I][D / 16];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  for (int gi = 0; gi < g; ++gi) {
    const int h = kvh * g + gi;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) +
                    (static_cast<long long>(b) * p.Sq * p.H + h) * D;
    const long long vec = (static_cast<long long>(b) * p.H + h) * p.Sq;
    // the list of the 64-row kv tile that holds these rows
    const int* list = p.ptr + p.head_map[h] * (nkv + 1) + k0 / kTile;
    const int e0 = list[0], e1 = list[1];
    for (int e = e0; e < e1; ++e) {
      const int ent = p.ent[e];
      const int q0 = (ent >> 1) * kTile;
      const bool partial = ent & 1;
      __syncthreads();
      load_tile<T, D>(Qs, q, p.q_ss, q0, p.scale);
      load_tile<T, D>(dOs, dout, static_cast<long long>(p.H) * D, q0, 1.f);
      __syncthreads();
      float st[I][4], dpt[I][4];
      mm_nt<D, I>(Ks, Qs, st);
      mm_nt<D, I>(Vs, dOs, dpt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qrow = q0 + tx + 16 * j;
        const float lse = p.lse[vec + qrow];
        const float delta = p.delta[vec + qrow];
#pragma unroll
        for (int i = 0; i < I; ++i) {
          const bool masked = partial && k0 + ty * I + i > qrow;
          const float pr = masked ? 0.f : expf(st[i][j] - lse);
          Ps[(ty * I + i) * kLP + tx + 16 * j] = round_to<T>(pr);
          dSs[(ty * I + i) * kLP + tx + 16 * j] =
              round_to<T>((dpt[i][j] - delta) * pr);
        }
      }
      __syncthreads();
      mm_nn<D, I>(Ps, dOs, acc_v);
      mm_nn<D, I>(dSs, Qs, acc_k);   // q is pre-scaled, so dK is exact
    }
  }
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = k0 + ty * I + i;
    const long long base =
        ((static_cast<long long>(b) * p.Skv + row) * p.KVH + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[base + tx + 16 * j] = from_f<T>(acc_k[i][j]);
      dv[base + tx + 16 * j] = from_f<T>(acc_v[i][j]);
    }
  }
}

// K5-dKV's walk for attention_bwd_dkv_tc.cuh: the kv tile's transposed
// table entries (q tile << 1) | partial for each query head of the group
// in turn, heads with an empty list skipped; partial tiles take the causal
// rule.
struct SplashDkvWalk {
  static constexpr bool kSplit = false;   // the library rounds P and dS
  static constexpr bool kScaleQ = true;   // q_s = bf16(q * scale)
  struct Cursor {
    int gi, e, end;
  };
  const int* head_map;
  const int* ptr;       // [U, kv tiles + 1]
  const int* ent;
  int h0, g, nkv, kt;
  float scale;          // sm_scale rounded to bf16
  // the entries [e0, e1) of query head h0 + gi at this kv tile
  __device__ void list(int gi, int& e0, int& e1) const {
    const int* l = ptr + __ldg(head_map + h0 + gi) * (nkv + 1) + kt;
    e0 = __ldg(l);
    e1 = __ldg(l + 1);
  }
  __device__ int count() const {
    int n = 0;
    for (int gi = 0; gi < g; ++gi) {
      int e0, e1;
      list(gi, e0, e1);
      n += e1 - e0;
    }
    return n;
  }
  __device__ void skip_empty(Cursor& c) const {
    while (c.e == c.end && c.gi + 1 < g) list(++c.gi, c.e, c.end);
  }
  __device__ Cursor first() const {
    Cursor c{0, 0, 0};
    list(0, c.e, c.end);
    skip_empty(c);
    return c;
  }
  __device__ void next(Cursor& c) const {
    ++c.e;
    skip_empty(c);
  }
  __device__ int head(const Cursor& c) const { return c.gi; }
  __device__ int q_row(const Cursor& c) const {
    return (__ldg(ent + c.e) >> 1) * kTile;
  }
  __device__ bool masked(const Cursor& c) const { return __ldg(ent + c.e) & 1; }
  __device__ bool keep(int kv, int q) const { return kv <= q; }
  __device__ float logit_scale() const { return 1.f; }
  __device__ float q_scale() const { return scale; }
  __device__ float dk_scale() const { return 1.f; }
};

// K5-dKV on bf16 inputs: grid (B * KVH, kv tiles, column blocks), the
// first kv tile (the longest causal list) first.
template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads)
    splash_bwd_dkv_tc_kernel(attn_tc::BwdArgs a, const int* head_map,
                             const int* ptr, const int* ent, float scale) {
  const int b = blockIdx.x / a.KVH, kvh = blockIdx.x % a.KVH;
  const int g = a.H / a.KVH;
  const int kt = blockIdx.y;
  const SplashDkvWalk walk{head_map, ptr, ent, kvh * g, g,
                           static_cast<int>(gridDim.y), kt, scale};
  // this block's first column of dK and dV: a constant 0 below head_dim
  // 256 (a run-time 0 there made K5-dKV 12% slower on an H100)
  const int dc0 = D > 128 ? blockIdx.z * attn_tc::kDkvCols<D> : 0;
  attn_tc::dkv_block<D>(a, walk, b, kvh, kt * kTile, dc0);
}

size_t smem_bytes(int kind, int dtype, int d) {
  if (kind == kFwd && dtype == 1) return attn_tc::smem_bytes(d);
  if (kind == kDq && dtype == 1) return attn_tc::dq_smem_bytes(d);
  if (kind == kDkv && dtype == 1) return attn_tc::dkv_smem_bytes(d);
  // fp32: [64, d + 1] tiles, and in the backward the block's own tiles
  // and score tiles of own_rows rows (kOwn)
  const size_t own_rows = d > 128 ? 32 : kTile;
  const size_t tile = static_cast<size_t>(kTile) * (d + 1);
  const size_t own = own_rows * (d + 1);
  const size_t score = static_cast<size_t>(kTile) * kLP;
  const size_t own_score = own_rows * kLP;
  switch (kind) {
    case kFwd: return (3 * tile + score) * sizeof(float);
    case kDq: return (2 * own + 2 * tile + own_score) * sizeof(float);
    case kDkv: return (2 * own + 2 * tile + 2 * own_score) * sizeof(float);
  }
  return 0;
}

template <int D>
cudaError_t run_fwd_tc(const Params& p, cudaStream_t stream) {
  attn_tc::Args a;
  if (!attn_tc::make_args(p, a)) return cudaErrorMisalignedAddress;
  return attn_tc::launch(splash_fwd_tc_kernel<D>,
                         dim3(p.B * p.H, p.Sq / kTile), attn_tc::kThreads,
                         attn_tc::smem_bytes(D), stream, a, p.head_map,
                         p.ptr, p.ent, p.scale);
}

template <int D>
cudaError_t run_dq_tc(const Params& p, cudaStream_t stream) {
  attn_tc::BwdArgs a;
  if (!attn_tc::make_bwd_args<D>(p, a)) return cudaErrorMisalignedAddress;
  return attn_tc::launch(splash_bwd_dq_tc_kernel<D>,
                         dim3(p.B * p.H, p.Sq / kTile), attn_tc::kThreads,
                         attn_tc::dq_smem_bytes(D), stream, a, p.head_map,
                         p.ptr, p.ent, p.scale);
}

template <int D>
cudaError_t run_dkv_tc(const Params& p, cudaStream_t stream) {
  attn_tc::BwdArgs a;
  if (!attn_tc::make_bwd_args<D>(p, a)) return cudaErrorMisalignedAddress;
  return attn_tc::launch(splash_bwd_dkv_tc_kernel<D>,
                         dim3(p.B * p.KVH, p.Skv / kTile,
                              D / attn_tc::kDkvCols<D>),
                         attn_tc::kThreads, attn_tc::dkv_smem_bytes(D),
                         stream, a, p.head_map, p.ptr, p.ent, p.scale);
}

template <typename T, int D>
cudaError_t run(int kind, const Params& p, cudaStream_t stream) {
  constexpr int dtype = std::is_same<T, float>::value ? 0 : 1;
  // bf16 takes the tensor-core kernels; fp32 keeps the CUDA-core ones
  if constexpr (dtype == 1) {
    if (kind == kFwd) return run_fwd_tc<D>(p, stream);
    if (kind == kDq) return run_dq_tc<D>(p, stream);
    return run_dkv_tc<D>(p, stream);
  } else {
    const size_t smem = smem_bytes(kind, dtype, D);
    if (kind == kFwd)
      return attn_tc::launch(splash_fwd_kernel<D>,
                             dim3(p.B * p.H, p.Sq / kTile), kThreads, smem,
                             stream, p);
    if (kind == kDq)
      return attn_tc::launch(splash_bwd_dq_kernel<D>,
                             dim3(p.B * p.H, p.Sq / kOwn<D>), kThreads, smem,
                             stream, p);
    return attn_tc::launch(splash_bwd_dkv_kernel<D>,
                           dim3(p.B * p.KVH, p.Skv / kOwn<D>), kThreads,
                           smem, stream, p);
  }
}

// What the CUDA runtime reports of the fp32 kernel of `kind` (0 K5-fwd,
// 1 K5-dQ, 2 K5-dKV) at head_dim D, into out[3] (see rt_splash_fwd_usage).
template <int D>
int fp32_usage(int kind, int* out) {
  const size_t smem = smem_bytes(kind, 0, D);
  if (kind == kFwd)
    return attn_tc::usage(splash_fwd_kernel<D>, smem, out, kThreads);
  if (kind == kDq)
    return attn_tc::usage(splash_bwd_dq_kernel<D>, smem, out, kThreads);
  return attn_tc::usage(splash_bwd_dkv_kernel<D>, smem, out, kThreads);
}

// What the CUDA runtime reports of a bf16 kernel at head_dim hd (see
// rt_splash_fwd_usage): kind 0 K5-fwd, 1 K5-dQ, 2 K5-dKV.
template <int D>
int tc_usage(int kind, int* out) {
  if (kind == kFwd)
    return attn_tc::usage(splash_fwd_tc_kernel<D>, attn_tc::smem_bytes(D),
                          out);
  if (kind == kDq)
    return attn_tc::usage(splash_bwd_dq_tc_kernel<D>,
                          attn_tc::dq_smem_bytes(D), out);
  return attn_tc::usage(splash_bwd_dkv_tc_kernel<D>,
                        attn_tc::dkv_smem_bytes(D), out);
}

int tc_usage(int kind, int hd, int* out) {
  if (hd == 32) return tc_usage<32>(kind, out);
  if (hd == 64) return tc_usage<64>(kind, out);
  if (hd == 128) return tc_usage<128>(kind, out);
  if (hd == 256) return tc_usage<256>(kind, out);
  return cudaErrorInvalidValue;
}

int fp32_usage(int kind, int hd, int* out) {
  if (kind < kFwd || kind > kDkv) return cudaErrorInvalidValue;
  if (hd == 32) return fp32_usage<32>(kind, out);
  if (hd == 64) return fp32_usage<64>(kind, out);
  if (hd == 128) return fp32_usage<128>(kind, out);
  if (hd == 256) return fp32_usage<256>(kind, out);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `kind` (0 K5-fwd, 1 K5-dQ, 2 K5-dKV)
// needs for dtype (0 fp32, 1 bf16) at head_dim hd (every one fits an H100
// block).
size_t rt_splash_smem_bytes(int kind, int dtype, int hd) {
  return smem_bytes(kind, dtype, hd);
}

// Registers per thread, local memory bytes per thread and resident blocks
// per SM of K5-fwd's bf16 kernel at head_dim hd (32, 64, 128 or 256), as the
// CUDA runtime reports them, into out[3]; the cudaError_t of the query.
int rt_splash_fwd_usage(int hd, int* out) { return tc_usage(kFwd, hd, out); }

// The same of K5-dQ's bf16 kernel.
int rt_splash_dq_usage(int hd, int* out) { return tc_usage(kDq, hd, out); }

// The same of K5-dKV's bf16 kernel.
int rt_splash_dkv_usage(int hd, int* out) { return tc_usage(kDkv, hd, out); }

// The same of the fp32 kernel of `kind` (0 K5-fwd, 1 K5-dQ, 2 K5-dKV).
int rt_splash_fp32_usage(int kind, int hd, int* out) {
  return fp32_usage(kind, hd, out);
}

// One launch of K5-fwd (kind 0), K5-dQ (kind 1) or K5-dKV (kind 2).  dtype 0
// is fp32, 1 is bf16, for q, k, v, dout and the outputs alike.  strides
// holds the (batch, seq, head) strides in elements of q, k and v, in that
// order; their head_dim stride is 1.  dout, out, dk and dv are contiguous;
// lse and delta are fp32 [B, H, Sq].  head_map, ptr and ent are the mask
// table on the device: the row lists (q tile -> kv tiles) for kinds 0 and 1,
// the column lists (kv tile -> q tiles) for kind 2.  scale is sm_scale
// rounded to the input dtype.  Pointers a kind does not use may be null.
// head_dim is 32, 64, 128 or 256.  K5-fwd on bf16
// needs the q, k and v pointers and strides on 16 bytes, K5-dQ and K5-dKV
// on bf16 those of q, k, v and dout (cudaErrorMisalignedAddress
// otherwise).  Returns the cudaError_t of the launch.
int rt_splash_attention(int kind, int dtype, const void* q, const void* k,
                        const void* v, const void* dout, void* out, void* dk,
                        void* dv, void* lse, const void* delta,
                        const void* head_map, const void* ptr,
                        const void* ent, const long long* strides, int B,
                        int H, int KVH, int Sq, int Skv, int hd, float scale,
                        void* stream) {
  if (kind < kFwd || kind > kDkv || B < 1 || KVH < 1 || H % KVH != 0 ||
      Sq < kTile || Skv < kTile || Sq % kTile != 0 || Skv % kTile != 0)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.out = out;
  p.dk = dk;
  p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.head_map = static_cast<const int*>(head_map);
  p.ptr = static_cast<const int*>(ptr);
  p.ent = static_cast<const int*>(ent);
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.Sq = Sq;
  p.Skv = Skv;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 32) return run<float, 32>(kind, p, st);
  if (dtype == 0 && hd == 64) return run<float, 64>(kind, p, st);
  if (dtype == 0 && hd == 128) return run<float, 128>(kind, p, st);
  if (dtype == 0 && hd == 256) return run<float, 256>(kind, p, st);
  if (dtype == 1 && hd == 32) return run<__nv_bfloat16, 32>(kind, p, st);
  if (dtype == 1 && hd == 64) return run<__nv_bfloat16, 64>(kind, p, st);
  if (dtype == 1 && hd == 128) return run<__nv_bfloat16, 128>(kind, p, st);
  if (dtype == 1 && hd == 256) return run<__nv_bfloat16, 256>(kind, p, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
