// Flash attention forward and backward for Hopper (sm_90a): three kernels,
// K1 (forward), K2 (dQ) and K3 (dK, dV), on [B, S, heads, head_dim] tensors
// read through their strides, with grouped-query heads (kv_head = h / g).
//
// They replace the Pallas TPU kernels of ray_tpu/ops/flash_attention.py and
// compute the same functions (q scaled by `scale`, scores masked with
// -1e30 on the causal diagonal, fp32 sums):
//
//   K1  _fwd_kernel      O = softmax(q.K^T) V and LSE = m + log(l)
//   K2  _bwd_dq_kernel   P = exp(s - LSE), dS = P o (dO.V^T - delta) * scale,
//                        dQ = dS K
//   K3  _bwd_dkv_kernel  dV = P^T dO and dK = dS^T q_scaled, summed over
//                        the g query heads of a kv head
//
// with delta = rowsum(dO o O) computed outside the kernels, as the JAX
// package does.
//
// K1 on bf16 inputs is flash_fwd_tc_kernel: the tensor-core forward of
// attention_fwd_tc.cuh (bf16 mma.sync tiles, a cp.async ring of K/V tiles,
// the softmax in registers, P.V split into two bf16 products so that P
// keeps ~16 bits as the reference's fp32 P does).  Its walk visits the kv
// tiles up to the causal diagonal, multiplies the fp32 scores by `scale`
// (bf16 products are exact in fp32, so this is the reference's
// (q * scale).k up to fp32 rounding), and masks the diagonal tile and the
// ragged last tile (S not a multiple of 64), whose rows the copies
// zero-fill.  It needs every row of q, k and v on 16 bytes.
//
// K3 on bf16 inputs is flash_bwd_dkv_tc_kernel: the tensor-core dK/dV of
// attention_bwd_dkv_tc.cuh (K-stationary bf16 mma.sync tiles, a cp.async
// ring of Q/dO tiles with their LSE and delta, P^T and dS^T in registers).
// The reference keeps P and dS in fp32 for P^T.dO and dS^T.q, so both are
// split into two bf16 products (hi + lo), as the forward splits P.  Its
// walk visits, for each of the g query heads, the q tiles from the causal
// diagonal on; it masks the diagonal tile and the ragged last q tile,
// multiplies the fp32 scores by `scale` and dK by `scale` once before the
// store.  It needs every row of q, k, v and dout on 16 bytes.
//
// K2 on bf16 inputs is flash_bwd_dq_tc_kernel: the tensor-core dQ of
// attention_bwd_dq_tc.cuh (Q-stationary bf16 mma.sync tiles, a cp.async
// ring of K/V tiles, S, dP and dS in registers).  The reference keeps dS
// in fp32 for dS.K, so dS is split into two bf16 products (hi + lo).  Its
// walk visits the kv tiles up to the causal diagonal, multiplies the fp32
// scores by `scale` and dQ by `scale` once before the store, and masks the
// diagonal tile, the ragged last kv tile and the ragged last q tile.  It
// needs every row of q, k, v and dout on 16 bytes.
//
// The bf16 kernels take head_dim 32, 64, 128 and 256.  At 32 a tile row is
// 4 chunks of 16 bytes, so the swizzle XORs the chunk with (row / 2) % 4
// in place of row % 8 (attention_tc_common.cuh swz), and the products take
// two k-steps of 16.  At 256 K1 and K2
// re-read Q (and dO) from shared memory at each k-step rather than hold
// their fragments, and K3 runs two blocks per kv tile, each accumulating
// half of the columns of dK and dV.
//
// K1, K2 and K3 on fp32 inputs are the first, simple versions: products
// as fp32 FMAs on the CUDA cores (67 TFLOP/s, not the 989 of bf16 tensor
// cores), at head_dim 32, 64, 128 and 256.  Nothing in them assumes 64
// columns: a score tile is always 64 x 64 (queries x keys), whatever the
// head_dim, and a thread's share of an accumulator row is head_dim / 16
// columns (2 at head_dim 32, the Decision Transformer's heads).  At 256 K1 keeps its 64-row tiles
// (214 KB of shared memory), while a K2 block owns a 32-row q tile and a
// K3 block a 32-row kv tile (206 and 214 KB; 64 rows would need 280 and
// 296 KB, over the card's 227 KB per block).  What bounds them on
// this card: operations.  At the training shapes (S = 1024, head_dim 64)
// each (query, key) pair costs 4-8 * head_dim flops against a few bytes,
// far above the ~295 flops per byte where the tensor cores, not the
// memory, become the limit.  Their design keeps the bytes near their
// bound and leaves the rate for later:
//   - the TPU's 1024-row blocks sat in megabytes of VMEM.  Here a thread
//     block holds 64 x 64 tiles in shared memory (fp32, rows padded by one
//     word so that no two threads of a half-warp share a bank), and a loop
//     inside the block replaces the TPU's sequential grid dimension;
//   - K1 and K2 run one block per (batch, head, q tile): 3072 blocks at
//     16 x 12 heads x 16 tiles.  The causal loop stops at the diagonal
//     tile, and the longest q tiles are launched first;
//   - K3 runs one block per (batch, kv head, k tile) and loops over the g
//     query heads of its group and their q tiles, so dK and dV are written
//     once, with no atomics and no expanded copy of K and V;
//   - a 16 x 16 grid of threads gives each thread a 4 x 4 patch of every
//     score tile (2 x 4 where the block owns 32 rows) and 4 (2) rows x
//     head_dim / 16 columns of each accumulator;
//     row maxima and sums reduce with shuffles inside 16-lane groups;
//   - the ragged edge (S not a multiple of 64) is loaded as zeros and
//     masked, and is never stored.
// Left for later: TMA loads, wgmma.
//
// Inputs are fp32 or bf16 (dtype 0 or 1); sums are fp32; outputs take the
// input dtype, and LSE is fp32 [B, heads, Sq].
//
// Plain C interface, loaded with ctypes (ray_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include <type_traits>

#include "attention_bwd_dkv_tc.cuh"
#include "attention_bwd_dq_tc.cuh"
#include "attention_fwd_tc.cuh"

namespace {

constexpr int kTile = 64;                 // rows of a q tile and of a k tile
constexpr int kThreads = 256;             // a 16 x 16 grid of threads
constexpr int kLP = kTile + 1;            // padded row of a [64, 64] tile
constexpr float kNegInf = -1e30f;         // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;
// rows of the tile a fp32 K2 (q rows) or K3 (kv rows) block owns: 32 at
// head_dim 256, where two 64-row fp32 tiles of each operand do not fit
template <int D>
constexpr int kOwn = D > 128 ? 32 : kTile;

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

struct Params {
  const void* q;        // [B, Sq, H, D], strided, last dim contiguous
  const void* k;        // [B, Skv, KVH, D], strided
  const void* v;        // [B, Skv, KVH, D], strided
  const void* dout;     // [B, Sq, H, D] contiguous (K2, K3)
  void* out;            // K1: o, K2: dq [B, Sq, H, D] contiguous
  void* dk;             // K3: [B, Skv, KVH, D] contiguous
  void* dv;             // K3: [B, Skv, KVH, D] contiguous
  float* lse;           // [B, H, Sq]: written by K1, read by K2 and K3
  const float* delta;   // [B, H, Sq]
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, H, KVH, Sq, Skv, causal;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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
// fp32 in a [R, D + 1] tile, times `mul`; rows at or past n are zeros.
template <typename T, int D, int R = kTile>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n, float mul) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < n ? to_f(src[row * row_stride + c]) * mul : 0.f;
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

// number of k tiles the `rows` q rows from q0 on attend to
__device__ __forceinline__ int k_tiles(const Params& p, int q0,
                                       int rows = kTile) {
  const int n = (p.Skv + kTile - 1) / kTile;
  return p.causal ? min(n, (q0 + rows - 1) / kTile + 1) : n;
}

// K1 on fp32 inputs: grid (B * H, q tiles), the last q tile first.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using T = float;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile<T, D>(Qs, q, p.q_ss, q0, p.Sq, p.scale);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = k_tiles(p, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // the last tile's reads are done
    load_tile<T, D>(Ks, k, p.k_ss, k0, p.Skv, 1.f);
    load_tile<T, D>(Vs, v, p.v_ss, k0, p.Skv, 1.f);
    __syncthreads();
    float s[4][4];
    mm_nt<D, 4>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= p.Skv || (p.causal && col > row)) s[i][j] = kNegInf;
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
    if (row >= p.Sq) continue;
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

// K1's walk for attention_fwd_tc.cuh: kv tiles 0 .. n - 1; the tiles that
// cross the causal diagonal or the ragged end take the element mask.
struct FlashWalk {
  static constexpr float kMaskValue = kNegInf;
  int n, Skv, causal;
  float scale;
  __device__ int count() const { return n; }
  __device__ int kv_row(int j) const { return j * kTile; }
  __device__ bool masked(int j, int q0) const {
    const int end = (j + 1) * kTile;
    return end > Skv || (causal && end - 1 > q0);
  }
  __device__ bool keep(int row, int col) const {
    return col < Skv && (!causal || col <= row);
  }
  __device__ float logit_scale() const { return scale; }
  template <int N>
  __device__ void prepare_q(uint32_t (&)[N][4]) const {}
};

// K1 on bf16 inputs: grid (B * H, q tiles), the last q tile first.
template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads)
    flash_fwd_tc_kernel(attn_tc::Args a, int causal, float scale) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int n = (a.Skv + kTile - 1) / kTile;
  const FlashWalk walk{causal ? min(n, q0 / kTile + 1) : n, a.Skv, causal,
                       scale};
  attn_tc::forward_block<D>(a, walk, b, h, q0);
}

// K2 on fp32 inputs: grid (B * H, q tiles of kOwn<D> rows), the last q
// tile first.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
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

  load_tile<T, D, R>(Qs, q, p.q_ss, q0, p.Sq, p.scale);
  load_tile<T, D, R>(dOs, dout, static_cast<long long>(p.H) * D, q0, p.Sq,
                     1.f);
  float lse[I], delta[I], acc[I][D / 16];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = q0 + ty * I + i;
    lse[i] = row < p.Sq ? p.lse[vec + row] : 0.f;
    delta[i] = row < p.Sq ? p.delta[vec + row] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = k_tiles(p, q0, R);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, k, p.k_ss, k0, p.Skv, 1.f);
    load_tile<T, D>(Vs, v, p.v_ss, k0, p.Skv, 1.f);
    __syncthreads();
    float s[I][4], dp[I][4];
    mm_nt<D, I>(Qs, Ks, s);
    mm_nt<D, I>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int row = q0 + ty * I + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool masked = col >= p.Skv || (p.causal && col > row);
        const float pr = masked ? 0.f : expf(s[i][j] - lse[i]);
        dSs[(ty * I + i) * kLP + tx + 16 * j] =
            pr * (dp[i][j] - delta[i]) * p.scale;
      }
    }
    __syncthreads();
    mm_nn<D, I>(dSs, Ks, acc);
  }
  T* dq = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = q0 + ty * I + i;
    if (row >= p.Sq) continue;
    const long long base =
        ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq[base + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// K2's walk for attention_bwd_dq_tc.cuh: kv tiles 0 .. n - 1; the tiles
// that cross the causal diagonal or the ragged kv end, and every tile of
// the ragged last q tile, take the element mask.
struct FlashDqWalk {
  static constexpr bool kSplit = true;    // fp32 dS in the reference
  static constexpr bool kScaleQ = false;
  int n, Sq, Skv, causal;
  float scale;
  __device__ int count() const { return n; }
  __device__ int kv_row(int j) const { return j * kTile; }
  __device__ bool masked(int j, int q0) const {
    const int end = (j + 1) * kTile;
    return end > Skv || (causal && end - 1 > q0) || q0 + kTile > Sq;
  }
  __device__ bool keep(int row, int col) const {
    return row < Sq && col < Skv && (!causal || col <= row);
  }
  __device__ float logit_scale() const { return scale; }
  __device__ float dq_value(float x) const { return x * scale; }
};

// K2 on bf16 inputs: grid (B * H, q tiles), the last q tile first.
template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads)
    flash_bwd_dq_tc_kernel(attn_tc::BwdArgs a, int causal, float scale) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int n = (a.Skv + kTile - 1) / kTile;
  const FlashDqWalk walk{causal ? min(n, q0 / kTile + 1) : n, a.Sq, a.Skv,
                         causal, scale};
  attn_tc::dq_block<D>(a, walk, b, h, q0);
}

// K3 on fp32 inputs: grid (B * KVH, k tiles of kOwn<D> rows), the first
// k tile (the longest causal loop) first.  Tiles are transposed against
// K2: a thread's patch rows are keys and its columns queries.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  using T = float;
  constexpr int LD = D + 1;
  constexpr int R = kOwn<D>, I = R / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [R, D + 1]
  float* Vs = Ks + R * LD;          // [R, D + 1]
  float* Qs = Vs + R * LD;          // [64, D + 1]
  float* dOs = Qs + kTile * LD;     // [64, D + 1]
  float* Ps = dOs + kTile * LD;     // P^T [key][query], [R, 65]
  float* dSs = Ps + R * kLP;        // dS^T [key][query], [R, 65]
  const int b = blockIdx.x / p.KVH, kvh = blockIdx.x % p.KVH;
  const int g = p.H / p.KVH;
  const int k0 = blockIdx.y * R;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, D, R>(Ks,
                     static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh,
                     p.k_ss, k0, p.Skv, 1.f);
  load_tile<T, D, R>(Vs,
                     static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh,
                     p.v_ss, k0, p.Skv, 1.f);
  float acc_k[I][D / 16], acc_v[I][D / 16];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  const int n_qt = (p.Sq + kTile - 1) / kTile;
  const int qt0 = p.causal ? k0 / kTile : 0;
  for (int gi = 0; gi < g; ++gi) {
    const int h = kvh * g + gi;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) +
                    (static_cast<long long>(b) * p.Sq * p.H + h) * D;
    const long long vec = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<T, D>(Qs, q, p.q_ss, q0, p.Sq, p.scale);
      load_tile<T, D>(dOs, dout, static_cast<long long>(p.H) * D, q0, p.Sq,
                      1.f);
      __syncthreads();
      float st[I][4], dpt[I][4];
      mm_nt<D, I>(Ks, Qs, st);
      mm_nt<D, I>(Vs, dOs, dpt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qrow = q0 + tx + 16 * j;
        const bool qvalid = qrow < p.Sq;
        const float lse = qvalid ? p.lse[vec + qrow] : 0.f;
        const float delta = qvalid ? p.delta[vec + qrow] : 0.f;
#pragma unroll
        for (int i = 0; i < I; ++i) {
          const int kcol = k0 + ty * I + i;
          const bool masked = !qvalid || (p.causal && qrow < kcol);
          const float pr = masked ? 0.f : expf(st[i][j] - lse);
          Ps[(ty * I + i) * kLP + tx + 16 * j] = pr;
          dSs[(ty * I + i) * kLP + tx + 16 * j] = pr * (dpt[i][j] - delta);
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
    if (row >= p.Skv) continue;
    const long long base =
        ((static_cast<long long>(b) * p.Skv + row) * p.KVH + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[base + tx + 16 * j] = from_f<T>(acc_k[i][j]);
      dv[base + tx + 16 * j] = from_f<T>(acc_v[i][j]);
    }
  }
}

// K3's walk for attention_bwd_dkv_tc.cuh: for each query head of the
// group, q tiles qt0 .. nq - 1 (qt0 the diagonal tile when causal, else
// 0); the diagonal tile and the ragged last q tile take the element mask.
struct FlashDkvWalk {
  static constexpr bool kSplit = true;    // fp32 P and dS in the reference
  static constexpr bool kScaleQ = false;
  struct Cursor {
    int gi, qt;
  };
  int g, qt0, nq, Sq, causal;
  float scale;
  __device__ int count() const { return g * (nq - qt0); }
  __device__ Cursor first() const { return {0, qt0}; }
  __device__ void next(Cursor& c) const {
    if (++c.qt == nq) {
      c.qt = qt0;
      ++c.gi;
    }
  }
  __device__ int head(const Cursor& c) const { return c.gi; }
  __device__ int q_row(const Cursor& c) const { return c.qt * kTile; }
  __device__ bool masked(const Cursor& c) const {
    return (causal && c.qt == qt0) || (c.qt + 1) * kTile > Sq;
  }
  __device__ bool keep(int kv, int q) const {
    return q < Sq && (!causal || kv <= q);
  }
  __device__ float logit_scale() const { return scale; }
  __device__ float dk_scale() const { return scale; }
};

// K3 on bf16 inputs: grid (B * KVH, kv tiles, column blocks), the first
// kv tile (the longest causal walk) first.
template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads)
    flash_bwd_dkv_tc_kernel(attn_tc::BwdArgs a, int causal, float scale) {
  const int b = blockIdx.x / a.KVH, kvh = blockIdx.x % a.KVH;
  const int kt = blockIdx.y;
  const FlashDkvWalk walk{a.H / a.KVH, causal ? kt : 0,
                          (a.Sq + kTile - 1) / kTile, a.Sq, causal, scale};
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
  return attn_tc::launch(flash_fwd_tc_kernel<D>,
                         dim3(p.B * p.H, (p.Sq + kTile - 1) / kTile),
                         attn_tc::kThreads, attn_tc::smem_bytes(D), stream,
                         a, p.causal, p.scale);
}

template <int D>
cudaError_t run_dq_tc(const Params& p, cudaStream_t stream) {
  attn_tc::BwdArgs a;
  if (!attn_tc::make_bwd_args<D>(p, a)) return cudaErrorMisalignedAddress;
  return attn_tc::launch(flash_bwd_dq_tc_kernel<D>,
                         dim3(p.B * p.H, (p.Sq + kTile - 1) / kTile),
                         attn_tc::kThreads, attn_tc::dq_smem_bytes(D),
                         stream, a, p.causal, p.scale);
}

template <int D>
cudaError_t run_dkv_tc(const Params& p, cudaStream_t stream) {
  attn_tc::BwdArgs a;
  if (!attn_tc::make_bwd_args<D>(p, a)) return cudaErrorMisalignedAddress;
  return attn_tc::launch(flash_bwd_dkv_tc_kernel<D>,
                         dim3(p.B * p.KVH, (p.Skv + kTile - 1) / kTile,
                              D / attn_tc::kDkvCols<D>),
                         attn_tc::kThreads, attn_tc::dkv_smem_bytes(D),
                         stream, a, p.causal, p.scale);
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
      return attn_tc::launch(flash_fwd_kernel<D>,
                             dim3(p.B * p.H, (p.Sq + kTile - 1) / kTile),
                             kThreads, smem, stream, p);
    if (kind == kDq)
      return attn_tc::launch(flash_bwd_dq_kernel<D>,
                             dim3(p.B * p.H, (p.Sq + kOwn<D> - 1) / kOwn<D>),
                             kThreads, smem, stream, p);
    return attn_tc::launch(flash_bwd_dkv_kernel<D>,
                           dim3(p.B * p.KVH, (p.Skv + kOwn<D> - 1) / kOwn<D>),
                           kThreads, smem, stream, p);
  }
}

// What the CUDA runtime reports of the fp32 kernel of `kind` (0 K1, 1 K2,
// 2 K3) at head_dim D, into out[3] (see rt_flash_fwd_usage).
template <int D>
int fp32_usage(int kind, int* out) {
  const size_t smem = smem_bytes(kind, 0, D);
  if (kind == kFwd)
    return attn_tc::usage(flash_fwd_kernel<D>, smem, out, kThreads);
  if (kind == kDq)
    return attn_tc::usage(flash_bwd_dq_kernel<D>, smem, out, kThreads);
  return attn_tc::usage(flash_bwd_dkv_kernel<D>, smem, out, kThreads);
}

// What the CUDA runtime reports of a bf16 kernel at head_dim hd (see
// rt_flash_fwd_usage): kind 0 K1, 1 K2, 2 K3.
template <int D>
int tc_usage(int kind, int* out) {
  if (kind == kFwd)
    return attn_tc::usage(flash_fwd_tc_kernel<D>, attn_tc::smem_bytes(D), out);
  if (kind == kDq)
    return attn_tc::usage(flash_bwd_dq_tc_kernel<D>,
                          attn_tc::dq_smem_bytes(D), out);
  return attn_tc::usage(flash_bwd_dkv_tc_kernel<D>,
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

// Dynamic shared memory one block of `kind` (0 K1, 1 K2, 2 K3) needs for
// dtype (0 fp32, 1 bf16) at head_dim hd (every one fits an H100 block).
size_t rt_flash_smem_bytes(int kind, int dtype, int hd) {
  return smem_bytes(kind, dtype, hd);
}

// Registers per thread, local memory bytes per thread and resident blocks
// per SM of K1's bf16 kernel at head_dim hd (32, 64, 128 or 256), as the CUDA
// runtime reports them, into out[3]; the cudaError_t of the query.
int rt_flash_fwd_usage(int hd, int* out) { return tc_usage(kFwd, hd, out); }

// The same of K2's bf16 kernel.
int rt_flash_dq_usage(int hd, int* out) { return tc_usage(kDq, hd, out); }

// The same of K3's bf16 kernel.
int rt_flash_dkv_usage(int hd, int* out) { return tc_usage(kDkv, hd, out); }

// The same of the fp32 kernel of `kind` (0 K1, 1 K2, 2 K3) at head_dim hd
// (32, 64, 128 or 256).
int rt_flash_fp32_usage(int kind, int hd, int* out) {
  return fp32_usage(kind, hd, out);
}

// One launch of K1 (kind 0), K2 (kind 1) or K3 (kind 2).  dtype 0 is fp32,
// 1 is bf16, for q, k, v, dout and the outputs alike.  strides holds the
// (batch, seq, head) strides in elements of q, k and v, in that order; their
// head_dim stride is 1.  dout, out, dk and dv are contiguous; lse and delta
// are fp32 [B, H, Sq].  Pointers a kind does not use may be null.  head_dim
// is 32, 64, 128 or 256.  K1 on bf16 needs the q, k and
// v pointers and strides on 16 bytes, K2 and K3 on bf16 those of q, k, v
// and dout (cudaErrorMisalignedAddress otherwise).  Returns the
// cudaError_t of the launch.
int rt_flash_attention(int kind, int dtype, const void* q, const void* k,
                       const void* v, const void* dout, void* out, void* dk,
                       void* dv, void* lse, const void* delta,
                       const long long* strides, int B, int H, int KVH,
                       int Sq, int Skv, int hd, int causal, float scale,
                       void* stream) {
  if (kind < kFwd || kind > kDkv || B < 1 || KVH < 1 || H % KVH != 0 ||
      Sq < 1 || Skv < 1 || (causal && Sq != Skv))
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
  p.causal = causal;
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
