// Tensor-core attention dK/dV backward for Hopper (sm_90a), shared by K3
// (flash_attention.cu, flash_bwd_dkv_tc_kernel) and K5-dKV
// (splash_attention.cu, splash_bwd_dkv_tc_kernel) for bf16 inputs.
//
// One thread block computes dK and dV of a 64-row kv tile of one (batch,
// kv head) from [B, S, heads, head_dim] tensors read through their
// strides: dV = sum P^T dO and dK = sum dS^T q over the (query head, q
// tile) items that the caller's Walk gives, for the g query heads of the
// kv head (K3: every q tile from the causal diagonal on; K5-dKV: its mask
// table's transposed entries).  P = exp(s - LSE) comes from the forward's
// LSE, dS = P o (dP - delta) with dP = dO.V^T and delta = rowsum(dO o O)
// computed outside.  The two kernels differ only in the Walk: which
// items, which carry an element mask, where the scale enters, and how P
// and dS are rounded for their products.
//
// What bounds it on this card: operations (4 products of head_dim per
// (query, key) pair against a few bytes).  So the products run on the
// bf16 tensor cores, K-stationary, and nothing else stays in their way:
//   - four warps each own 16 kv rows.  K and V are copied once as
//     swizzled bf16 tiles by 16-byte cp.async; at head_dim 64 their
//     m16k16 A fragments stay in registers, at head_dim 128 (where the
//     dK and dV accumulators take 128 registers) each k-step re-reads
//     them by ldmatrix.  At head_dim 256 a block accumulates half of the
//     columns of dK and dV (the grid's z index), so that the accumulators
//     stay at 128 registers; both halves compute S^T and dP^T in full;
//   - (Q, dO) tile pairs stream through a ring of kBwdStages stages by
//     16-byte cp.async, each with its 64 LSE and 64 delta values (one
//     4-byte copy per thread); the next pair's copy is in flight while
//     this pair's products run.  Rows past Sq are zero-filled;
//   - per 16 q columns a warp computes S^T = K.Q^T and dP^T = V.dO^T by
//     mma.sync.m16n8k16 (B from the Q and dO rows by ldmatrix), then
//     P^T = 2^(S^T c - LSE log2 e) with c = logit scale x log2 e (one
//     FFMA and one ex2 per element) and dS^T = P^T o (dP^T - delta) in
//     registers.  The two m16n8 accumulator tiles of P^T and dS^T are
//     repacked as the m16k16 A fragments of dV += P^T.dO and
//     dK += dS^T.Q, whose B comes from ldmatrix.trans on dO and Q: P and
//     dS never touch shared memory;
//   - K3's reference keeps P and dS in fp32 for its products, so each is
//     split as hi = bf16(x), lo = bf16(x - hi), two mmas into one fp32
//     accumulator (~16 bits, 6 products per pair); the splash library
//     rounds P and dS to bf16 itself, so K5-dKV does too (4 products).
// GQA: the block walks the g query heads of its kv head in turn and sums
// into the same registers, so dK and dV are written once, with no
// atomics.  dK and dV go back through this warp's rows of the K and V
// tiles so that they are stored 16 bytes per thread.
//
// Left for later: wgmma with TMA loads and a warp-specialised producer.

#pragma once

#include "attention_tc_common.cuh"

namespace attn_tc {

constexpr int kBwdStages = 2;   // (Q, dO, LSE, delta) sets in the ring

// Bytes of one ring stage at head_dim d: the Q and dO tiles (bf16), then
// the tile's 64 LSE and 64 delta values (fp32).
__host__ __device__ constexpr size_t bwd_stage_bytes(int d) {
  return 2 * static_cast<size_t>(kTile) * d * sizeof(bf16) +
         2 * kTile * sizeof(float);
}

// Dynamic shared memory of one block at head_dim d: the K and V tiles and
// the ring.
inline size_t dkv_smem_bytes(int d) {
  return 2 * static_cast<size_t>(kTile) * d * sizeof(bf16) +
         kBwdStages * bwd_stage_bytes(d);
}

// Columns of dK and dV one block accumulates at head_dim D: all of them
// up to 128; half at 256, where the two 16 x 256 fp32 accumulators alone
// would take 256 registers a thread (the grid's z index picks the half,
// and both halves compute S^T and dP^T over the full head_dim).
template <int D>
constexpr int kDkvCols = D > 128 ? D / 2 : D;

// dK and dV, columns [dc0, dc0 + kDkvCols<D>), of the kv tile starting at
// row k0 of kv head kvh of batch b.
// Walk provides:
//   Cursor                     a position in the block's walk;
//   count()                    the (query head, q tile) items to visit;
//   first(), next(c)           the first item's cursor; step to the next;
//   head(c)                    c's query head, 0 .. g - 1 within the group;
//   q_row(c)                   the first q row of c's tile;
//   masked(c)                  whether c's tile needs the element mask;
//   keep(kv, q)                the element mask;
//   kSplit                     P and dS as hi + lo bf16 terms, or rounded;
//   kScaleQ, q_scale()         q enters as bf16(q * q_scale()) if kScaleQ
//                              (q_scale() only then);
//   logit_scale()              the logit of k.q is k.q times it;
//   dk_scale()                 dK is dk_scale() times sum dS^T q.
// A masked score gives P = 0 exactly, and so dS = 0 (a select, not -inf:
// the splash mask value times log2 e overflows fp32).
// The kernel launches kThreads threads and dkv_smem_bytes(D) of dynamic
// shared memory per block, D / kDkvCols<D> blocks along the grid's z.
template <int D, class Walk>
__device__ __forceinline__ void dkv_block(const BwdArgs& a, const Walk& walk,
                                          int b, int kvh, int k0, int dc0) {
  static_assert(D % 16 == 0 && (kTile * D / 8) % kThreads == 0, "head_dim");
  static_assert(kThreads == 2 * kTile, "one LSE or delta word per thread");
  constexpr int kTileElems = kTile * D;
  constexpr int kStageBytes = static_cast<int>(bwd_stage_bytes(D));
  constexpr bool kKVRegs = D <= 64;   // K, V A fragments in registers
  constexpr int kCols = kDkvCols<D>;
  extern __shared__ __align__(128) unsigned char attn_tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(attn_tc_smem);
  bf16* Vs = Ks + kTileElems;
  unsigned char* ring = attn_tc_smem + 4 * kTileElems;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = a.H / a.KVH;
  const int n = walk.count();

  // queue the copies of item c into stage st: its Q and dO tiles, and
  // this thread's word of the tile's LSE (threads 0-63) or delta (64-127)
  auto load_item = [&](int st, const typename Walk::Cursor& c) {
    const int h = kvh * g + walk.head(c);
    const int q0 = walk.q_row(c);
    unsigned char* s = ring + st * kStageBytes;
    load_tile<D>(reinterpret_cast<bf16*>(s), a.q + b * a.q_sb + h * a.q_sh,
                 a.q_ss, q0, a.Sq);
    load_tile<D>(reinterpret_cast<bf16*>(s) + kTileElems,
                 a.dout + (static_cast<long long>(b) * a.Sq * a.H + h) * D,
                 static_cast<long long>(a.H) * D, q0, a.Sq);
    const int t = threadIdx.x, row = q0 + (t & (kTile - 1));
    const float* src = (t < kTile ? a.lse : a.delta) +
                       (static_cast<long long>(b) * a.H + h) * a.Sq;
    const bool valid = row < a.Sq;
    cp_async4(smem_addr(s + 4 * kTileElems + 4 * t), valid ? src + row : src,
              valid ? 4 : 0);
  };

  // one copy group per item, items 0 .. kBwdStages - 2 ahead of the loop
  // (K and V ride with item 0); a group may be empty, so that the count
  // of groups in flight is the same in every iteration
  load_tile<D>(Ks, a.k + b * a.k_sb + kvh * a.k_sh, a.k_ss, k0, a.Skv);
  load_tile<D>(Vs, a.v + b * a.v_sb + kvh * a.v_sh, a.v_ss, k0, a.Skv);
  typename Walk::Cursor lc = walk.first();
#pragma unroll
  for (int t = 0; t < kBwdStages - 1; ++t) {
    if (t < n) {
      load_item(t, lc);
      walk.next(lc);
    }
    cp_async_commit();
  }

  // this thread's fragment rows: kv0 (c[0], c[1]) and kv0 + 8 (c[2],
  // c[3]); its columns are 2 * (lane % 4) and the next, in every n8 tile
  const int kv0 = k0 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  // byte offsets of this lane's ldmatrix rows in a tile (steps 0-3; see
  // step_off): the A fragment of this warp's K or V rows at k-step kk; the
  // B fragment of Q or dO rows for S^T and dP^T at k-step kk (16 q rows ch
  // add ch * 16 rows); the transposed B fragment of dO or Q rows for dV
  // and dK at d pair dp of this block's columns (the k-step ch adds
  // ch * 16 rows; column dc0 adds 2 dc0 bytes, a multiple of 128)
  uint32_t aoff[4], boff[4], toff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    aoff[i] = 2 * swz<D>(warp * 16 + (lane & 15), i * 16 + ((lane >> 4) << 3));
    boff[i] = 2 * swz<D>((lane & 7) + ((lane >> 4) << 3),
                         i * 16 + (((lane >> 3) & 1) << 3));
    toff[i] = 2 * swz<D>((lane & 7) + (((lane >> 3) & 1) << 3),
                         i * 16 + ((lane >> 4) << 3)) + 2 * dc0;
  }
  const uint32_t ks_addr = smem_addr(Ks), vs_addr = smem_addr(Vs);
  const uint32_t ring_addr = smem_addr(ring);
  uint32_t kf[kKVRegs ? D / 16 : 1][4], vf[kKVRegs ? D / 16 : 1][4];
  float dk[kCols / 8][4], dv[kCols / 8][4];
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const float c = walk.logit_scale() * kLog2e;

  typename Walk::Cursor cc = walk.first();
  for (int j = 0; j < n; ++j) {
    cp_async_wait<kBwdStages - 2>();
    const int st = j % kBwdStages;
    unsigned char* stage = ring + st * kStageBytes;
    float* vecs = reinterpret_cast<float*>(stage + 4 * kTileElems);
    // this thread's own copies of item j have landed: its LSE word to
    // log2 units and, where the walk scales q, its chunks of Q to q_s
    if (threadIdx.x < kTile) vecs[threadIdx.x] *= kLog2e;
    if constexpr (Walk::kScaleQ)
      scale_own_chunks<D>(reinterpret_cast<bf16*>(stage), walk.q_scale());
    __syncthreads();   // item j is in for all, item j - 1's stage is free
    const int jn = j + kBwdStages - 1;
    if (jn < n) {
      load_item(jn % kBwdStages, lc);
      walk.next(lc);
    }
    cp_async_commit();
    if constexpr (kKVRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ldsm4(kf[kk], ks_addr + step_off(aoff, kk));
          ldsm4(vf[kk], vs_addr + step_off(aoff, kk));
        }
      }
    }
    const int q0 = walk.q_row(cc);
    const bool masked = walk.masked(cc);
    walk.next(cc);
    const uint32_t qs = ring_addr + st * kStageBytes;
    const uint32_t os = qs + 2 * kTileElems;

#pragma unroll
    for (int ch = 0; ch < kTile / 16; ++ch) {   // 16 q columns at a time
      // S^T = K . Q^T and dP^T = V . dO^T: [16, 16] per warp, 2 n8 tiles
      float s[2][4], dp[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4], qb[4], ob[4];
        if constexpr (kKVRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kk][e];
            va[e] = vf[kk][e];
          }
        } else {
          ldsm4(ka, ks_addr + step_off(aoff, kk));
          ldsm4(va, vs_addr + step_off(aoff, kk));
        }
        ldsm4(qb, qs + step_off(boff, kk) + ch * 32 * D);
        ldsm4(ob, os + step_off(boff, kk) + ch * 32 * D);
        mma(s[0], ka, qb[0], qb[1]);
        mma(s[1], ka, qb[2], qb[3]);
        mma(dp[0], va, ob[0], ob[1]);
        mma(dp[1], va, ob[2], ob[3]);
      }

      // P^T and dS^T in their place, with the element mask where the
      // item needs it (q rows past Sq were zero-filled: their s = 0 would
      // give P = 2^-LSE, so the mask must drop them; kv rows past Skv are
      // never stored, and a row of A reaches only that row of dK and dV)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int qc = ch * 16 + t * 8 + col0;
        const float2 l2 = *reinterpret_cast<const float2*>(vecs + qc);
        const float2 de = *reinterpret_cast<const float2*>(vecs + kTile + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[t][e], c, -((e & 1) ? l2.y : l2.x)));
          if (masked && !walk.keep(kv0 + (e >> 1) * 8, q0 + qc + (e & 1)))
            p = 0.f;
          s[t][e] = p;
          dp[t][e] = p * (dp[t][e] - ((e & 1) ? de.y : de.x));
        }
      }

      // dV += P^T . dO and dK += dS^T . Q at k-step ch, P^T's and dS^T's
      // accumulator fragments repacked as A: (c0, c1) of the first n8 tile
      // -> a0, (c2, c3) -> a1, the second tile's -> a2, a3
      uint32_t ph[4], dh[4], pl[4], dl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = r >> 1, e = 2 * (r & 1);
        if constexpr (Walk::kSplit) {
          split(s[t][e], s[t][e + 1], ph[r], pl[r]);
          split(dp[t][e], dp[t][e + 1], dh[r], dl[r]);
        } else {
          ph[r] = as_u32(__floats2bfloat162_rn(s[t][e], s[t][e + 1]));
          dh[r] = as_u32(__floats2bfloat162_rn(dp[t][e], dp[t][e + 1]));
        }
      }
#pragma unroll
      for (int dpair = 0; dpair < kCols / 16; ++dpair) {
        uint32_t ob[4], qb[4];
        ldsm4_t(ob, os + step_off(toff, dpair) + ch * 32 * D);
        ldsm4_t(qb, qs + step_off(toff, dpair) + ch * 32 * D);
        mma(dv[2 * dpair], ph, ob[0], ob[1]);
        mma(dv[2 * dpair + 1], ph, ob[2], ob[3]);
        mma(dk[2 * dpair], dh, qb[0], qb[1]);
        mma(dk[2 * dpair + 1], dh, qb[2], qb[3]);
        if constexpr (Walk::kSplit) {
          mma(dv[2 * dpair], pl, ob[0], ob[1]);
          mma(dv[2 * dpair + 1], pl, ob[2], ob[3]);
          mma(dk[2 * dpair], dl, qb[0], qb[1]);
          mma(dk[2 * dpair + 1], dl, qb[2], qb[3]);
        }
      }
    }
  }

  // every copy has landed (with no item, the K and V copies)
  cp_async_wait<0>();
  __syncthreads();

  // this block's columns of dK and dV into this warp's own 16 rows of the
  // K and V tiles, then out
  const float sk = walk.dk_scale();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + (lane >> 2) + r * 8;
#pragma unroll
    for (int i = 0; i < kCols / 8; ++i) {
      const int col = dc0 + i * 8 + col0;
      *reinterpret_cast<__nv_bfloat162*>(Ks + swz<D>(lr, col)) =
          __floats2bfloat162_rn(dk[i][2 * r] * sk, dk[i][2 * r + 1] * sk);
      *reinterpret_cast<__nv_bfloat162*>(Vs + swz<D>(lr, col)) =
          __floats2bfloat162_rn(dv[i][2 * r], dv[i][2 * r + 1]);
    }
  }
  __syncwarp();
  constexpr int kChunks = kCols / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, ch = dc0 / 8 + i % kChunks;
    const int row = k0 + warp * 16 + r;
    if (row < a.Skv) {
      const long long off =
          ((static_cast<long long>(b) * a.Skv + row) * a.KVH + kvh) * D +
          ch * 8;
      const int at = swz<D>(warp * 16 + r, ch * 8);
      *reinterpret_cast<uint4*>(a.dk + off) =
          *reinterpret_cast<const uint4*>(Ks + at);
      *reinterpret_cast<uint4*>(a.dv + off) =
          *reinterpret_cast<const uint4*>(Vs + at);
    }
  }
}

}  // namespace attn_tc
