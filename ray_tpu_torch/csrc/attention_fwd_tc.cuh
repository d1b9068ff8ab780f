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
//     operands read by ldmatrix (ldmatrix.trans for V).  Q's fragments
//     stay in registers up to head_dim 128; at 256 (a 128-register
//     accumulator) each k-step re-reads them;
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

#include "attention_tc_common.cuh"

namespace attn_tc {

constexpr int kStages = 2;              // K/V tile pairs in the ring

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

// The forward of one q tile starting at row q0 of head h of batch b.
// Walk provides:
//   kMaskValue                 the reference's masked logit, written as
//                              the LSE of a row that no key reaches;
//   count()                    the number of kv tiles to visit;
//   kv_row(j)                  the first kv row of the j-th tile;
//   masked(j, q0)              whether that tile needs the element mask;
//   keep(row, col)             the element mask;
//   logit_scale()              the logit of a product q.k is q.k times it;
//   prepare_q(qf)              a pass over Q fragments as they are loaded
//                              (once, or at each re-read at head_dim 256).
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
  // Q's A fragments stay in registers up to head_dim 128; at 256, where
  // the accumulator alone takes 128 registers, each k-step re-reads them
  constexpr bool kQRegs = D <= 128;
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  float acc[D / 8][4];
  // byte offsets of this lane's ldmatrix rows in a tile (steps 0-3; see
  // step_off): Q's A fragment at k-step kk; K's at k-step kk (n8 pair np
  // adds np * 16 rows), V's at d pair dp (k-step kk adds kk * 16 rows);
  // the rest of each address is a constant
  uint32_t qoff[4], koff[4], voff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qoff[i] = 2 * swz<D>(warp * 16 + (lane & 15), i * 16 + ((lane >> 4) << 3));
    koff[i] = 2 * swz<D>((lane & 7) + ((lane >> 4) << 3),
                         i * 16 + (((lane >> 3) & 1) << 3));
    voff[i] = 2 * swz<D>((lane & 7) + (((lane >> 3) & 1) << 3),
                         i * 16 + ((lane >> 4) << 3));
  }
  const uint32_t qs_addr = smem_addr(Qs);
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
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm4(qf[kk], qs_addr + step_off(qoff, kk));
        walk.prepare_q(qf);
      }
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
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[1][4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[0][e] = qf[kk][e];
      } else {
        ldsm4(qa[0], qs_addr + step_off(qoff, kk));
        walk.prepare_q(qa);
      }
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t kb[4];
        ldsm4(kb, ks + step_off(koff, kk) + np * 32 * D);
        mma(s[2 * np], qa[0], kb[0], kb[1]);
        mma(s[2 * np + 1], qa[0], kb[2], kb[3]);
      }
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
        ldsm4_t(vb, vs + step_off(voff, dp) + kk * 32 * D);
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
