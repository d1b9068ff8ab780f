// Primitives of the tensor-core attention kernels for Hopper (sm_90a),
// shared by the forward (attention_fwd_tc.cuh: K1, K5-fwd), the dK/dV
// backward (attention_bwd_dkv_tc.cuh: K3, K5-dKV) and the dQ backward
// (attention_bwd_dq_tc.cuh: K2, K5-dQ): the tile shape, the XOR swizzle
// of bf16 tiles in shared memory, 16-byte cp.async copies, ldmatrix, the
// m16n8k16 bf16 mma with fp32 accumulators, bf16x2 packing, the ex2
// exponent, the hi/lo split of fp32 values into two bf16 terms, and the
// two backward kernels' arguments.  Each kernel header builds its loop
// from these; none holds a kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_tc {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;               // rows of a q tile and of a kv tile
constexpr int kWarps = 4;               // each owns 16 rows of a tile
constexpr int kThreads = 32 * kWarps;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

// Whether every row that the 16-byte copies read starts on 16 bytes:
// the pointer and the (batch, seq, head) strides, in bf16 elements.
inline bool rows_aligned(const void* p, long long sb, long long ss,
                         long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory; the launch's
// error.
template <typename Fn, typename... A>
inline cudaError_t launch(Fn kernel, dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// What the CUDA runtime reports of a kernel of `threads` threads and
// `smem` bytes of dynamic shared memory, into out[3]: registers per thread,
// local memory bytes per thread (spills and stack) and resident blocks per
// SM; the error of the query.
template <typename Fn>
inline cudaError_t usage(Fn kernel, size_t smem, int* out,
                         int threads = kThreads) {
  cudaFuncAttributes fa{};
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                        threads, smem);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col) in a [rows, D] bf16 tile whose 16-byte
// chunks are XOR-permuted (col a multiple of 2): by row % 8 where a row
// holds 8 chunks or more (head_dim 64 up); at head_dim 32, whose 64-byte
// rows lie two to a 128-byte line, by (row / 2) % 4.  Either way the eight
// rows an ldmatrix phase reads at one chunk hit eight bank groups, and
// the permutation repeats every 8 rows.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int kChunks = D / 8;
  static_assert(kChunks >= 8 || kChunks == 4, "head_dim 32 or 64 up");
  const int x = kChunks >= 8 ? (row & 7) : ((row >> 1) & 3);
  return row * D + ((((col >> 3) ^ x)) << 3) + (col & 7);
}

// The byte offset of a lane's ldmatrix row at 16-column step i of a
// swizzled tile, from those of steps 0-3 (o[i] for columns i * 16 on):
// the swizzle permutes 16-byte chunks only within groups of eight, so
// step i + 4 lies 128 bytes past step i.  With i known at compile time
// this is one immediate, and a block keeps four offsets, not D / 16.
__device__ __forceinline__ uint32_t step_off(const uint32_t (&o)[4], int i) {
  return o[i & 3] + (i >> 2) * 128;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes = 0 copies nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  // one 4-byte word; src_bytes = 0 writes a zero
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's newest copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for one m16n8k16 tile: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t x) {
  return *reinterpret_cast<__nv_bfloat162*>(&x);
}

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, where P adds nothing next to the row's max of 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi); x0 in the
// low half, as the fragment wants the lower column there.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Queue the copy of rows [row0, row0 + 64) of one head (src points at its
// row 0, rows row_stride elements apart) into a swizzled [64, D] tile;
// rows at or past n are zero-filled.  Thread t copies 16-byte chunk
// t % (D / 8) of rows t / (D / 8) + i * kPass: a few base addresses and
// fixed steps, and a row test only in a tile that crosses n.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int kChunks = D / 8;              // 16-byte chunks of a row
  constexpr int kPass = kThreads / kChunks;   // rows per pass
  // passes per period of the swizzle (8 rows): 1 up to head_dim 128,
  // where every pass starts on the same swizzle; 2 at head_dim 256
  constexpr int kRep = kPass >= 8 ? 1 : 8 / kPass;
  static_assert(kPass % 8 == 0 || 8 % kPass == 0, "rows per pass");
  const int r = threadIdx.x / kChunks, ch = threadIdx.x % kChunks;
  const bf16* g = src + (row0 + r) * row_stride + ch * 8;
  const long long step = kPass * row_stride;
  uint32_t d[kRep];
#pragma unroll
  for (int i = 0; i < kRep; ++i)
    d[i] = smem_addr(dst + swz<D>(r + i * kPass, ch * 8));
  auto at = [&](int i) {
    return d[i % kRep] + (i / kRep) * kRep * kPass * D * 2;
  };
  if (row0 + kTile <= n) {
#pragma unroll
    for (int i = 0; i < kTile / kPass; ++i) cp_async16(at(i), g + i * step, 16);
  } else {
#pragma unroll
    for (int i = 0; i < kTile / kPass; ++i) {
      const bool valid = row0 + r + i * kPass < n;
      cp_async16(at(i), valid ? g + i * step : src, valid ? 16 : 0);
    }
  }
}

// The arguments of the two backward kernels (dQ; dK and dV).
struct BwdArgs {
  const bf16* q;       // [B, Sq, H, D], strided, last dim contiguous
  const bf16* k;       // [B, Skv, KVH, D], strided
  const bf16* v;       // [B, Skv, KVH, D], strided
  const bf16* dout;    // [B, Sq, H, D] contiguous
  bf16* dq;            // [B, Sq, H, D] contiguous (the dQ kernels)
  bf16* dk;            // [B, Skv, KVH, D] contiguous (the dK/dV kernels)
  bf16* dv;            // [B, Skv, KVH, D] contiguous (the dK/dV kernels)
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, H, KVH, Sq, Skv;
};

// The backward's arguments from a kernel file's launch parameters P
// (fields named as BwdArgs's, out for dq).  False when a row of q, k, v
// or dout would not start on 16 bytes.
template <int D, class P>
inline bool make_bwd_args(const P& p, BwdArgs& a) {
  a = BwdArgs{static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
              static_cast<const bf16*>(p.v),
              static_cast<const bf16*>(p.dout), static_cast<bf16*>(p.out),
              static_cast<bf16*>(p.dk), static_cast<bf16*>(p.dv), p.lse,
              p.delta, p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
              p.v_sb, p.v_ss, p.v_sh, p.B, p.H, p.KVH, p.Sq, p.Skv};
  const long long o_ss = static_cast<long long>(p.H) * D;
  return rows_aligned(p.q, p.q_sb, p.q_ss, p.q_sh) &&
         rows_aligned(p.k, p.k_sb, p.k_ss, p.k_sh) &&
         rows_aligned(p.v, p.v_sb, p.v_ss, p.v_sh) &&
         rows_aligned(p.dout, o_ss * p.Sq, o_ss, D);
}

// Multiply the 16-byte chunks of a [64, D] tile that this thread copied
// with load_tile by s, rounding to bf16 (the splash kernels'
// q_s = bf16(q * scale)).  Call it once this thread's copies have landed
// and before the barrier that publishes the tile.
template <int D>
__device__ __forceinline__ void scale_own_chunks(bf16* tile, float s) {
  constexpr int kChunks = D / 8, kPass = kThreads / kChunks;
  const int r = threadIdx.x / kChunks, ch = threadIdx.x % kChunks;
#pragma unroll
  for (int i = 0; i < kTile / kPass; ++i) {
    uint4* p = reinterpret_cast<uint4*>(tile + swz<D>(r + i * kPass, ch * 8));
    uint4 x = *p;
    uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(as_bf162(w[e]));
      w[e] = as_u32(__floats2bfloat162_rn(f.x * s, f.y * s));
    }
    *p = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace attn_tc
