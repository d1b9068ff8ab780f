// Tensor-core attention forward for Hopper (sm_90a), shared by K1
// (flash_attention.cu, flash_fwd_tc_kernel) and K5-fwd
// (splash_attention.cu, splash_fwd_tc_kernel) for bf16 inputs.
//
// One thread block computes O and the fp32 LSE = m + log(l) of a 64-row q
// tile of one (batch, head) from [B, S, heads, head_dim] tensors read
// through their strides, walking a list of 64-row kv tiles that the
// caller's Walk gives (K1: every tile up to the causal diagonal; K5-fwd:
// its mask table's entries).  The two kernels differ only in the Walk:
// which tiles, which carry an element mask, and where the scale enters
// (K1 multiplies the fp32 scores, K5-fwd stages q_s = bf16(q * bf16(scale))
// as the splash library does).
//
// What bounds it on this card: operations.  Each (query, key) pair costs
// 4 * head_dim flops against a few bytes, far above the ~295 flops per
// byte where the tensor cores, not the memory, are the limit.  So the
// products run on the bf16 tensor cores and everything else stays out of
// their way:
//   - four warps each own 16 q rows; S = Q.K^T and O += P.V are
//     mma.sync.m16n8k16 bf16 products with fp32 accumulators, their
//     operands read by ldmatrix (ldmatrix.trans for V);
//   - Q is copied once; K and V tiles stream through a ring of kStages
//     bf16 tile pairs by 16-byte cp.async, the next kStages - 1 tiles'
//     copies in flight while this tile's products run; rows past the
//     end are zero-filled by the copy itself;
//   - tiles are XOR-swizzled (16-byte chunk ^ row % 8), not padded, so
//     the eight rows an ldmatrix phase reads hit eight bank groups;
//   - the online softmax (running max, sum, rescale) runs on the score
//     fragments in registers with quad shuffles, in units of log2: the
//     max is taken on the raw products (the logit scale is positive) and
//     P = 2^(s c - m c), c = scale x log2(e), costs one FFMA and one ex2
//     per score.  P never goes to shared memory: the m16n8 accumulator
//     fragments are repacked as the A fragments of P.V;
//   - both references keep P in fp32 for P.V (V cast to fp32).  So P is
//     split as P_hi = bf16(P), P_lo = bf16(P - P_hi) and both go through
//     the tensor cores into one fp32 accumulator: ~16 bits of P instead
//     of bf16's 8.  This doubles the P.V products, which the bound
//     (the function's work) does not count.
// The output tile goes back through the Q tile's shared memory so that
// it is stored 16 bytes per thread.  On an H100 the tile loop is bound by
// instruction issue more than by the tensor cores, hence one FFMA per
// exponent and copy and ldmatrix addresses worked out once per block;
// the P_lo products are the price of fp32-faithful P.V.
//
// Left for later: wgmma with TMA loads and a warp-specialised producer.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_tc {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;               // rows of a q tile and of a kv tile
constexpr int kWarps = 4;               // each owns 16 rows of the q tile
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;              // K/V tile pairs in the ring

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const bf16* q;     // [B, Sq, H, D], strided, last dim contiguous
  const bf16* k;     // [B, Skv, KVH, D], strided
  const bf16* v;     // [B, Skv, KVH, D], strided
  bf16* o;           // [B, Sq, H, D] contiguous
  float* lse;        // [B, H, Sq]
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, H, KVH, Sq, Skv;
};

// Dynamic shared memory of one block at head_dim d: the Q tile and
// kStages (K, V) tile pairs, bf16.
inline size_t smem_bytes(int d) {
  return static_cast<size_t>(kTile) * d * sizeof(bf16) * (1 + 2 * kStages);
}

// Whether every row that the 16-byte copies read starts on 16 bytes:
// the pointer and the (batch, seq, head) strides, in bf16 elements.
inline bool rows_aligned(const void* p, long long sb, long long ss,
                         long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

// The forward's arguments from a kernel file's launch parameters P, whose
// fields are named as Args's (out for o).  False when a row of q, k or v
// would not start on 16 bytes.
template <class P>
inline bool make_args(const P& p, Args& a) {
  a = Args{static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
           static_cast<const bf16*>(p.v), static_cast<bf16*>(p.out), p.lse,
           p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh, p.v_sb, p.v_ss,
           p.v_sh, p.B, p.H, p.KVH, p.Sq, p.Skv};
  return rows_aligned(p.q, p.q_sb, p.q_ss, p.q_sh) &&
         rows_aligned(p.k, p.k_sb, p.k_ss, p.k_sh) &&
         rows_aligned(p.v, p.v_sb, p.v_ss, p.v_sh);
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

// What the CUDA runtime reports of a forward kernel at head_dim d, into
// out[3]: registers per thread, local memory bytes per thread (spills and
// stack) and resident blocks per SM; the error of the query.
template <typename Fn>
inline cudaError_t usage(Fn kernel, int d, int* out) {
  const int smem = static_cast<int>(smem_bytes(d));
  cudaFuncAttributes fa{};
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                        kThreads, smem);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col) in a [rows, D] bf16 tile whose 16-byte
// chunks are XOR-permuted by row % 8 (col a multiple of 2).
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes = 0 copies nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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
// t % (D / 8) of rows t / (D / 8) + i * kPass: one base address and fixed
// steps, and a row test only in a tile that crosses n.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int kChunks = D / 8;              // 16-byte chunks of a row
  constexpr int kPass = kThreads / kChunks;   // rows per pass, a multiple
                                              // of 8: the swizzle repeats
  const int r = threadIdx.x / kChunks, ch = threadIdx.x % kChunks;
  const bf16* g = src + (row0 + r) * row_stride + ch * 8;
  const long long step = kPass * row_stride;
  const uint32_t d = smem_addr(dst + swz<D>(r, ch * 8));
  if (row0 + kTile <= n) {
#pragma unroll
    for (int i = 0; i < kTile / kPass; ++i)
      cp_async16(d + i * kPass * D * 2, g + i * step, 16);
  } else {
#pragma unroll
    for (int i = 0; i < kTile / kPass; ++i) {
      const bool valid = row0 + r + i * kPass < n;
      cp_async16(d + i * kPass * D * 2, valid ? g + i * step : src,
                 valid ? 16 : 0);
    }
  }
}

// The forward of one q tile starting at row q0 of head h of batch b.
// Walk provides:
//   kMaskValue                 the reference's masked logit, written as
//                              the LSE of a row that no key reaches;
//   count()                    the number of kv tiles to visit;
//   kv_row(j)                  the first kv row of the j-th tile;
//   masked(j, q0)              whether that tile needs the element mask;
//   keep(row, col)             the element mask;
//   logit_scale()              the logit of a product q.k is q.k times it;
//   prepare_q(qf)              a pass over the Q fragments once loaded.
// A masked score enters the softmax as -inf, so it adds exactly 0; the
// reference's finite mask value gives the same result wherever a row has
// a key, which every row of the masks the port builds has.
// The kernel launches kThreads threads and smem_bytes(D) of dynamic
// shared memory per block.
template <int D, class Walk>
__device__ __forceinline__ void forward_block(const Args& a, const Walk& walk,
                                              int b, int h, int q0) {
  static_assert(D % 16 == 0 && (kTile * D / 8) % kThreads == 0, "head_dim");
  constexpr int kTileElems = kTile * D;
  extern __shared__ __align__(128) unsigned char attn_tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(attn_tc_smem);
  bf16* ring = Qs + kTileElems;     // stage s: K, then V, at 2 s tiles on
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvh = h / (a.H / a.KVH);
  const bf16* q = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* k = a.k + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = a.v + b * a.v_sb + kvh * a.v_sh;
  const int n = walk.count();

  // one copy group per kv tile, tiles 0 .. kStages - 2 ahead of the loop
  // (Q rides with tile 0); a group may be empty, so that the count of
  // groups in flight is the same in every iteration
  load_tile<D>(Qs, q, a.q_ss, q0, a.Sq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n) {
      const int k0 = walk.kv_row(t);
      load_tile<D>(ring + 2 * t * kTileElems, k, a.k_ss, k0, a.Skv);
      load_tile<D>(ring + (2 * t + 1) * kTileElems, v, a.v_ss, k0, a.Skv);
    }
    cp_async_commit();
  }

  // this thread's fragment rows: row0 (c[0], c[1]) and row0 + 8 (c[2],
  // c[3]); its columns are 2 * (lane % 4) and the next, in every n8 tile
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
  // byte offsets of this lane's ldmatrix rows in a tile: K's at k-step kk
  // (n8 pair np adds np * 16 rows), V's at d pair dp (k-step kk adds
  // kk * 16 rows); the rest of each address is a constant
  uint32_t koff[D / 16], voff[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    koff[i] = 2 * swz<D>((lane & 7) + ((lane >> 4) << 3),
                         i * 16 + (((lane >> 3) & 1) << 3));
    voff[i] = 2 * swz<D>((lane & 7) + (((lane >> 3) & 1) << 3),
                         i * 16 + ((lane >> 4) << 3));
  }
  const uint32_t ring_addr = smem_addr(ring);
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // per row: the running max of the raw products, the base m c of the
  // exponentials (0 while no key has been seen, so that no inf - inf
  // arises; the rescale is then 0), and this thread's share of the sum
  const float c = walk.logit_scale() * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};
  float mc[2] = {0.f, 0.f};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile j is in for all, tile j - 1's stage is free
    const int jn = j + kStages - 1;
    if (jn < n) {
      const int k1 = walk.kv_row(jn);
      bf16* st = ring + (jn % kStages) * 2 * kTileElems;
      load_tile<D>(st, k, a.k_ss, k1, a.Skv);
      load_tile<D>(st + kTileElems, v, a.v_ss, k1, a.Skv);
    }
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm4(qf[kk], smem_addr(Qs + swz<D>(warp * 16 + (lane & 15),
                                            kk * 16 + ((lane >> 4) << 3))));
      walk.prepare_q(qf);
    }
    const uint32_t ks = ring_addr + (j % kStages) * 4 * kTileElems;
    const uint32_t vs = ks + 2 * kTileElems;

    // S = Q . K^T: [16, 64] per warp as 8 n8 tiles
    float s[kTile / 8][4];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t kb[4];
        ldsm4(kb, ks + koff[kk] + np * 32 * D);
        mma(s[2 * np], qf[kk], kb[0], kb[1]);
        mma(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // the element mask, where the tile needs it
    if (walk.masked(j, q0)) {
      const int k0 = walk.kv_row(j);
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!walk.keep(row0 + (e >> 1) * 8, k0 + i * 8 + col0 + (e & 1)))
            s[i][e] = -INFINITY;
    }

    // online softmax over the quad that holds each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mc_new = mx == -INFINITY ? 0.f : mx * c;
      // 0 while no key has been seen (acc and l are 0 then): 2^(0 - m c)
      // would overflow to inf, and inf * 0 is NaN, where m c <= -128
      const float alpha = m[r] == -INFINITY ? 0.f : ex2(mc[r] - mc_new);
      m[r] = mx;
      mc[r] = mc_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[i][e] = ex2(fmaf(s[i][e], c, -mc_new));
          sum += s[i][e];
        }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][2 * r] *= alpha;
        acc[i][2 * r + 1] *= alpha;
      }
    }

    // O += P_hi . V + P_lo . V, P's accumulator fragments repacked as A
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm4_t(vb, vs + voff[dp] + kk * 32 * D);
        mma(acc[2 * dp], ph, vb[0], vb[1]);
        mma(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma(acc[2 * dp], pl, vb[0], vb[1]);
        mma(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
  }

  // every copy has landed (with no tile, the Q copy of other threads)
  cp_async_wait<0>();
  __syncthreads();

  // O = acc / l into this warp's own 16 rows of the Q tile, then out
  bf16* Os = Qs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const int lr = warp * 16 + (lane >> 2) + r * 8;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(Os + swz<D>(lr, i * 8 + col0)) =
          __floats2bfloat162_rn(acc[i][2 * r] / l_safe,
                                acc[i][2 * r + 1] / l_safe);
    const int row = row0 + r * 8;
    // LSE = log sum e^logit = m c ln 2 + log l, in natural-log units
    if ((lane & 3) == 0 && row < a.Sq)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + row] =
          m[r] == -INFINITY ? Walk::kMaskValue : mc[r] * kLn2 + logf(l_safe);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, ch = c % kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < a.Sq)
      *reinterpret_cast<uint4*>(
          a.o + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * D +
          ch * 8) =
          *reinterpret_cast<const uint4*>(Os + swz<D>(warp * 16 + r, ch * 8));
  }
}

}  // namespace attn_tc
