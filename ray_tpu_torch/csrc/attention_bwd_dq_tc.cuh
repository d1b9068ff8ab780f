// Tensor-core attention dQ backward for Hopper (sm_90a), shared by K2
// (flash_attention.cu, flash_bwd_dq_tc_kernel) and K5-dQ
// (splash_attention.cu, splash_bwd_dq_tc_kernel) for bf16 inputs.
//
// One thread block computes dQ of a 64-row q tile of one (batch, head)
// from [B, S, heads, head_dim] tensors read through their strides:
// dQ = sum dS K over the kv tiles that the caller's Walk gives (K2: every
// tile up to the causal diagonal; K5-dQ: its mask table's entries), with
// P = exp(s - LSE) from the forward's LSE, dS = P o (dP - delta),
// dP = dO.V^T and delta = rowsum(dO o O) computed outside.  The two
// kernels differ only in the Walk: which tiles, which carry an element
// mask, where the scale enters, how dS is rounded for dS.K and how dQ is
// rounded on the way out.
//
// What bounds it on this card: operations (3 products of head_dim per
// (query, key) pair against a few bytes).  So the products run on the bf16
// tensor cores, Q-stationary, as the forward (attention_fwd_tc.cuh) runs:
//   - four warps each own 16 q rows.  Q and dO are copied once as
//     swizzled bf16 tiles by 16-byte cp.async; up to head_dim 128 their
//     m16k16 A fragments stay in registers, at 256 (where the dQ
//     accumulator alone takes 128 registers) each k-step re-reads them;
//   - K/V tile pairs stream through a ring of kDqStages stages by 16-byte
//     cp.async; the next pair's copy is in flight while this pair's
//     products run.  Rows past the end are zero-filled by the copy;
//   - LSE (in log2 units) and delta of the thread's two rows sit in
//     registers for the whole walk;
//   - per 16 kv columns a warp computes S = Q.K^T and dP = dO.V^T by
//     mma.sync.m16n8k16 (B from the K and V rows by ldmatrix), then
//     P = 2^(S c - LSE log2 e) with c = logit scale x log2 e (one FFMA and
//     one ex2 per element) and dS = P o (dP - delta) in registers.  The
//     two m16n8 accumulator tiles of dS are the m16k16 A fragment of one
//     k-step of dQ += dS.K, whose B comes from ldmatrix.trans on the same
//     16 K rows: S, dP and dS take 8 registers each and never touch
//     shared memory, and dQ accumulates in registers for the whole walk;
//   - K2's reference keeps dS in fp32 for dS.K, so dS is split as
//     hi = bf16(dS), lo = bf16(dS - hi), two mmas into one fp32
//     accumulator (~16 bits, 4 products per pair); the splash library
//     rounds dS to bf16 itself, so K5-dQ does too (3 products).
// dQ goes back through this warp's rows of the Q tile so that it is
// stored 16 bytes per thread.
//
// Left for later: wgmma with TMA loads and a warp-specialised producer.

#pragma once

#include "attention_tc_common.cuh"

namespace attn_tc {

constexpr int kDqStages = 2;   // K/V tile pairs in the ring

// Dynamic shared memory of one block at head_dim d: the Q and dO tiles and
// kDqStages (K, V) tile pairs, bf16.
inline size_t dq_smem_bytes(int d) {
  return static_cast<size_t>(kTile) * d * sizeof(bf16) * (2 + 2 * kDqStages);
}

// dQ of the q tile starting at row q0 of head h of batch b.
// Walk provides:
//   count()                    the number of kv tiles to visit;
//   kv_row(j)                  the first kv row of the j-th tile;
//   masked(j, q0)              whether that tile needs the element mask;
//   keep(row, col)             the element mask;
//   kSplit                     dS as hi + lo bf16 terms, or rounded;
//   kScaleQ, q_scale()         q enters as bf16(q * q_scale()) if kScaleQ
//                              (q_scale() only then);
//   logit_scale()              the logit of q.k is q.k times it;
//   dq_value(x)                dQ (before its rounding to bf16) from the
//                              fp32 sum x of dS.K.
// A masked score gives P = 0 exactly, and so dS = 0 (a select, not -inf:
// the splash mask value times log2 e overflows fp32).
// The kernel launches kThreads threads and dq_smem_bytes(D) of dynamic
// shared memory per block.
template <int D, class Walk>
__device__ __forceinline__ void dq_block(const BwdArgs& a, const Walk& walk,
                                         int b, int h, int q0) {
  static_assert(D % 16 == 0 && (kTile * D / 8) % kThreads == 0, "head_dim");
  constexpr int kTileElems = kTile * D;
  constexpr bool kQRegs = D <= 128;   // Q, dO A fragments in registers
  extern __shared__ __align__(128) unsigned char attn_tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(attn_tc_smem);
  bf16* dOs = Qs + kTileElems;
  bf16* ring = dOs + kTileElems;    // stage s: K, then V, at 2 s tiles on
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvh = h / (a.H / a.KVH);
  const bf16* k = a.k + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = a.v + b * a.v_sb + kvh * a.v_sh;
  const int n = walk.count();

  // one copy group per kv tile, tiles 0 .. kDqStages - 2 ahead of the
  // loop (Q and dO ride with tile 0); a group may be empty, so that the
  // count of groups in flight is the same in every iteration
  load_tile<D>(Qs, a.q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.Sq);
  load_tile<D>(dOs, a.dout + (static_cast<long long>(b) * a.Sq * a.H + h) * D,
               static_cast<long long>(a.H) * D, q0, a.Sq);
#pragma unroll
  for (int t = 0; t < kDqStages - 1; ++t) {
    if (t < n) {
      const int k0 = walk.kv_row(t);
      load_tile<D>(ring + 2 * t * kTileElems, k, a.k_ss, k0, a.Skv);
      load_tile<D>(ring + (2 * t + 1) * kTileElems, v, a.v_ss, k0, a.Skv);
    }
    cp_async_commit();
  }

  // this thread's fragment rows: row0 (c[0], c[1]) and row0 + 8 (c[2],
  // c[3]); its columns are 2 * (lane % 4) and the next, in every n8 tile.
  // Their LSE in log2 units and delta (0 past Sq: those rows are masked)
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float lse2[2], dlt[2];
  const long long vec = (static_cast<long long>(b) * a.H + h) * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < a.Sq ? __ldg(a.lse + vec + row) * kLog2e : 0.f;
    dlt[r] = row < a.Sq ? __ldg(a.delta + vec + row) : 0.f;
  }
  // byte offsets of this lane's ldmatrix rows in a tile (steps 0-3; see
  // step_off): this warp's Q or dO A fragment at k-step kk; the B
  // fragment of K or V rows for S and dP at k-step kk (16 kv rows ch add
  // ch * 16 rows); the transposed B fragment of K rows for dQ at d pair dp
  // (the k-step ch adds ch * 16 rows)
  uint32_t aoff[4], boff[4], toff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    aoff[i] = 2 * swz<D>(warp * 16 + (lane & 15), i * 16 + ((lane >> 4) << 3));
    boff[i] = 2 * swz<D>((lane & 7) + ((lane >> 4) << 3),
                         i * 16 + (((lane >> 3) & 1) << 3));
    toff[i] = 2 * swz<D>((lane & 7) + (((lane >> 3) & 1) << 3),
                         i * 16 + ((lane >> 4) << 3));
  }
  const uint32_t qs_addr = smem_addr(Qs), os_addr = smem_addr(dOs);
  const uint32_t ring_addr = smem_addr(ring);
  uint32_t qf[kQRegs ? D / 16 : 1][4], of[kQRegs ? D / 16 : 1][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const float c = walk.logit_scale() * kLog2e;

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kDqStages - 2>();
    // this thread's own copies of the Q tile have landed: where the walk
    // scales q, its chunks of Q to q_s
    if constexpr (Walk::kScaleQ) {
      if (j == 0) scale_own_chunks<D>(Qs, walk.q_scale());
    }
    __syncthreads();   // tile j is in for all, tile j - 1's stage is free
    const int jn = j + kDqStages - 1;
    if (jn < n) {
      const int k1 = walk.kv_row(jn);
      bf16* st = ring + (jn % kDqStages) * 2 * kTileElems;
      load_tile<D>(st, k, a.k_ss, k1, a.Skv);
      load_tile<D>(st + kTileElems, v, a.v_ss, k1, a.Skv);
    }
    cp_async_commit();
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ldsm4(qf[kk], qs_addr + step_off(aoff, kk));
          ldsm4(of[kk], os_addr + step_off(aoff, kk));
        }
      }
    }
    const int k0 = walk.kv_row(j);
    const bool masked = walk.masked(j, q0);
    const uint32_t ks = ring_addr + (j % kDqStages) * 4 * kTileElems;
    const uint32_t vs = ks + 2 * kTileElems;

#pragma unroll
    for (int ch = 0; ch < kTile / 16; ++ch) {   // 16 kv columns at a time
      // S = Q . K^T and dP = dO . V^T: [16, 16] per warp, 2 n8 tiles
      float s[2][4], dp[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], oa[4], kb[4], vb[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kk][e];
            oa[e] = of[kk][e];
          }
        } else {
          ldsm4(qa, qs_addr + step_off(aoff, kk));
          ldsm4(oa, os_addr + step_off(aoff, kk));
        }
        ldsm4(kb, ks + step_off(boff, kk) + ch * 32 * D);
        ldsm4(vb, vs + step_off(boff, kk) + ch * 32 * D);
        mma(s[0], qa, kb[0], kb[1]);
        mma(s[1], qa, kb[2], kb[3]);
        mma(dp[0], oa, vb[0], vb[1]);
        mma(dp[1], oa, vb[2], vb[3]);
      }

      // P and dS in their place, with the element mask where the tile
      // needs it (kv rows past Skv were zero-filled: their s = 0 would
      // give P = 2^-LSE, so the mask must drop them)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = k0 + ch * 16 + t * 8 + col0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = ex2(fmaf(s[t][e], c, -lse2[r]));
          if (masked && !walk.keep(row0 + 8 * r, col + (e & 1))) p = 0.f;
          dp[t][e] = p * (dp[t][e] - dlt[r]);
        }
      }

      // dQ += dS . K at k-step ch, dS's accumulator fragments repacked as
      // A: (c0, c1) of the first n8 tile -> a0, (c2, c3) -> a1, the second
      // tile's -> a2, a3
      uint32_t dh[4], dl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = r >> 1, e = 2 * (r & 1);
        if constexpr (Walk::kSplit)
          split(dp[t][e], dp[t][e + 1], dh[r], dl[r]);
        else
          dh[r] = as_u32(__floats2bfloat162_rn(dp[t][e], dp[t][e + 1]));
      }
#pragma unroll
      for (int dpair = 0; dpair < D / 16; ++dpair) {
        uint32_t kt[4];
        ldsm4_t(kt, ks + step_off(toff, dpair) + ch * 32 * D);
        mma(acc[2 * dpair], dh, kt[0], kt[1]);
        mma(acc[2 * dpair + 1], dh, kt[2], kt[3]);
        if constexpr (Walk::kSplit) {
          mma(acc[2 * dpair], dl, kt[0], kt[1]);
          mma(acc[2 * dpair + 1], dl, kt[2], kt[3]);
        }
      }
    }
  }

  // every copy has landed (with no tile, the Q and dO copies)
  cp_async_wait<0>();
  __syncthreads();

  // dQ into this warp's own 16 rows of the Q tile, then out
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + (lane >> 2) + r * 8;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(Qs + swz<D>(lr, i * 8 + col0)) =
          __floats2bfloat162_rn(walk.dq_value(acc[i][2 * r]),
                                walk.dq_value(acc[i][2 * r + 1]));
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, ch = i % kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < a.Sq)
      *reinterpret_cast<uint4*>(
          a.dq + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * D +
          ch * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<D>(warp * 16 + r, ch * 8));
  }
}

}  // namespace attn_tc
