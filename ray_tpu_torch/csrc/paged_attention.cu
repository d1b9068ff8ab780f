// Paged decode attention for Hopper (sm_90a): one query token per row over a
// paged KV pool, grouped-query heads, on the bf16 tensor cores.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py::_tpu_kernel
// (reached through paged_attention_tpu).  It computes the same function:
//
//   out[r, h] = softmax(q[r, h] . K[r, :len]^T * scale) @ V[r, :len]
//
// where row r's keys and values live in the pages block_tables[r, :] of the
// fused pool kv_pages[num_pages, kv_heads, page_size, 2*head_dim]
// (K in [..., :head_dim], V in [..., head_dim:]), and len = lengths[r].  The
// reference works in fp32 (q * scale and both products on fp32 operands),
// masks with -1e30 and divides by max(l, 1e-30).
//
// What bounds it on this card: bytes.  Each (row, kv head) reads its
// occupied K|V positions once and does 4*g*head_dim flops per position
// (g = heads / kv_heads), far below the ~295 flops per byte where the
// tensor cores would become the limit.  So the design reads each needed
// byte once, keeps two chunks of it in flight per block, and spreads the
// reading over enough SMs to keep the memory busy; the arithmetic only has
// to stay out of the way:
//   - a thread block per (row, kv head, group of up to 16 query heads,
//     split).  The group's heads share each K|V chunk, so a GQA group
//     reads the pool once (a group of more than 16 heads, rare, takes
//     several blocks and reads it once each);
//   - the copy stage walks fixed 64-position chunks, not pages: each
//     position goes through the row's table to its (page, offset) (one
//     table entry per chunk where the page size is a multiple of 64), and
//     its 2*head_dim K|V values land as one row of an XOR-swizzled
//     [64, 2*head_dim] bf16 tile (16-byte cp.async; positions past the
//     length are zero-filled).  The compute sees flat position-major tiles
//     whatever the page size, and shared memory does not depend on it
//     (head_dim 256 with 128-token pages fits);
//   - a ring of kStages = 3 chunks: two in flight while one is computed,
//     one __syncthreads per chunk;
//   - four warps each own 16 positions of every chunk.  S = q.K^T is a
//     mma.sync m16n8k16 product whose 16 M-rows are the group's query
//     heads (rows past g are zero); q's fragments are the bf16 q as given,
//     and `scale` multiplies the fp32 scores (bf16 products are exact in
//     fp32, so this is the reference's (q * scale).k up to fp32 rounding;
//     q * scale is never rounded to bf16).  P = 2^(s c - m c) from the
//     score fragments, c = scale log2(e), split into P_hi + P_lo bf16 terms
//     and repacked in registers as the A fragment of P.V: ~16 bits of the
//     reference's fp32 P (bf16 P alone changes ~40% of the outputs).
//     Each warp keeps its own running max, sum and [16, head_dim] fp32
//     accumulator, with row reductions by quad shuffles;
//   - wgmma's 64-row M would pad the 1-16 heads of a group four times
//     over; mma.sync's 16 rows are the right instrument for decode, and
//     the padded rows and the second P.V product cost nothing in a kernel
//     bound by bytes;
//   - the four warps merge once, through shared memory, at the end;
//   - the splits (flash-decoding: 9 rows x 8 kv heads are 72 blocks where
//     the card holds 264 at head_dim 128, so the wrapper splits a grid
//     that does not fill the card) merge in the same launch: each active
//     split writes its fp32 partial and (max, sum), takes a ticket, and
//     the last split of a (row, kv head, head group) merges them, writes
//     the output and resets the ticket for the next launch.  A split past
//     a row's length exits at once; a row with one active split writes
//     its output directly.
// The Pallas kernel's TPU workarounds are gone: q is not zero-padded to
// 2*head_dim, there is no static per-head loop, and no page is staged
// whole.
//
// Left for later: the Hopper bulk copy (cp.async.bulk with an mbarrier),
// which moves a (page, kv head) tile in one request but cannot swizzle.
//
// Plain C interface, loaded with ctypes (ray_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "attention_tc_common.cuh"

namespace {

using attn_tc::bf16;

constexpr int kChunk = 64;            // positions per staged chunk
constexpr int kWarps = attn_tc::kWarps;  // each owns 16 positions of a chunk
constexpr int kThreads = attn_tc::kThreads;
constexpr int kStages = 3;            // chunks in the ring
constexpr int kHeads = 16;            // query heads per block: mma's M rows
constexpr float kMaxDivisor = 1e-30f;  // the reference's max(l, 1e-30)

struct Params {
  const bf16* q;          // [rows, heads, HD]
  const bf16* kv;         // [num_pages, kvh, ps, 2 HD]
  const int* tables;      // [rows, max_pages]
  const int* lengths;     // [rows]
  bf16* out;              // [rows, heads, HD]
  float* part_acc;        // [rows * kvh * m_tiles * n_split, 16, HD]
  float* part_ml;         // [rows * kvh * m_tiles * n_split, 16, 2]
  int* tickets;           // [rows * kvh * m_tiles], zero between launches
  int heads, kvh, ps, num_pages, max_pages, chunks_per_split;
  float scale;
};

// Padded row of a warp's fp32 accumulator in the end-of-block merge: the
// eight rows a half-warp's float2 stores touch fall in distinct banks.
template <int HD>
constexpr int kMergeLd = HD + 8;

// Dynamic shared memory of one block: the ring of K|V chunks and q's tile;
// the end-of-block merge reuses the ring.
template <int HD>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kStages) * kChunk * 2 * HD + kHeads * HD) *
         sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Params p) {
  using namespace attn_tc;
  constexpr int kRow = 2 * HD;                  // a K|V row, elements
  constexpr int kRowChunks = kRow / 8;          // 16-byte pieces of a row
  constexpr int kPass = kThreads / kRowChunks;  // rows per copy pass
  constexpr int kStage = kChunk * kRow;         // elements of one stage
  constexpr bool kQRegs = HD <= 128;            // q's fragments held
  static_assert(kThreads % kRowChunks == 0 && kChunk % kPass == 0, "copy");
  static_assert(kWarps * kHeads * (kMergeLd<HD> + 2) * sizeof(float) <=
                    kStages * kStage * sizeof(bf16),
                "the merge fits in the ring");
  extern __shared__ __align__(128) unsigned char paged_smem[];
  bf16* ring = reinterpret_cast<bf16*>(paged_smem);
  bf16* qs = ring + kStages * kStage;           // [16, HD], swizzled

  const int g = p.heads / p.kvh;
  const int m_tiles = (g + kHeads - 1) / kHeads;
  const int kh = blockIdx.x / m_tiles, mt = blockIdx.x % m_tiles;
  const int r = blockIdx.y, z = blockIdx.z;
  const int nh = min(kHeads, g - mt * kHeads);  // this block's real heads
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int length = __ldg(p.lengths + r);
  // A length past the table's span or a page id outside the pool would
  // read memory the caller does not own: fail the launch loudly.
  if (length < 0 ||
      length > static_cast<long long>(p.max_pages) * p.ps)
    __trap();
  const int n_chunks = (length + kChunk - 1) / kChunk;
  const int n_active =
      max(1, (n_chunks + p.chunks_per_split - 1) / p.chunks_per_split);
  if (z >= n_active) return;
  const int c0 = z * p.chunks_per_split;
  const int n = min(n_chunks - c0, p.chunks_per_split);  // 0 iff length 0
  const int* table = p.tables + static_cast<size_t>(r) * p.max_pages;
  const bf16* pool = p.kv + static_cast<size_t>(kh) * p.ps * kRow;
  const size_t page_elems = static_cast<size_t>(p.kvh) * p.ps * kRow;

  // Queue chunk c's copy into stage s: this thread copies 16-byte piece
  // cc of rows cr + i * kPass.  Where pages hold whole chunks (a page size
  // that is a multiple of 64), one table entry serves the chunk; else
  // each row's position goes through the table.
  const int cr = threadIdx.x / kRowChunks, cc = threadIdx.x % kRowChunks;
  const uint32_t ring_addr = smem_addr(ring);
  const bool whole_pages = p.ps % kChunk == 0;
  auto load_chunk = [&](int c, int s) {
    const int pos0 = c * kChunk;
    const uint32_t dst0 = ring_addr + s * kStage * 2;
    if (whole_pages) {
      const int page = __ldg(table + pos0 / p.ps);
      if (page < 0 || page >= p.num_pages) __trap();
      const bf16* src = pool + page * page_elems +
                        static_cast<size_t>(pos0 % p.ps + cr) * kRow +
                        cc * 8;
      const int n_valid = length - pos0;
#pragma unroll
      for (int i = 0; i < kChunk / kPass; ++i) {
        const bool valid = cr + i * kPass < n_valid;
        cp_async16(dst0 + 2 * swz<kRow>(cr + i * kPass, cc * 8),
                   valid ? src + i * kPass * kRow : p.kv, valid ? 16 : 0);
      }
      return;
    }
    int idx = (pos0 + cr) / p.ps, off = pos0 + cr - idx * p.ps;
#pragma unroll
    for (int i = 0; i < kChunk / kPass; ++i) {
      const uint32_t dst = dst0 + 2 * swz<kRow>(cr + i * kPass, cc * 8);
      if (pos0 + cr + i * kPass < length) {
        const int page = __ldg(table + idx);
        if (page < 0 || page >= p.num_pages) __trap();
        cp_async16(dst,
                   pool + page * page_elems +
                       static_cast<size_t>(off) * kRow + cc * 8,
                   16);
      } else {
        cp_async16(dst, p.kv, 0);
      }
      off += kPass;
      while (off >= p.ps) {
        off -= p.ps;
        ++idx;
      }
    }
  };

  // chunks 0 .. kStages - 2 ahead of the loop, one copy group each (a
  // group may be empty, so that the count in flight is the same in every
  // iteration)
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n) load_chunk(c0 + t, t);
    cp_async_commit();
  }

  // q's tile: the block's heads as rows, zeros past the last one
  const bf16* q_rows =
      p.q + (static_cast<size_t>(r) * p.heads + static_cast<size_t>(kh) * g +
             mt * kHeads) * HD;
  for (int e = threadIdx.x; e < kHeads * HD / 8; e += kThreads) {
    const int hr = e / (HD / 8), ch = e % (HD / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (hr < nh)
      v = *reinterpret_cast<const uint4*>(q_rows + hr * HD + ch * 8);
    *reinterpret_cast<uint4*>(qs + swz<HD>(hr, ch * 8)) = v;
  }
  __syncthreads();

  // byte offsets of this lane's ldmatrix rows (steps 0-3; see step_off):
  // q's A fragment at k-step kk; K's B fragments at k-step kk for the
  // warp's two n8 tiles of positions; V's (transposed) at d pair dp, whose
  // columns start at HD.  wrow is the warp's first position in a stage.
  uint32_t qoff[4], koff[4], voff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qoff[i] = 2 * swz<HD>(lane & 15, i * 16 + ((lane >> 4) << 3));
    koff[i] = 2 * swz<kRow>((lane & 7) + ((lane >> 4) << 3),
                            i * 16 + (((lane >> 3) & 1) << 3));
    voff[i] = 2 * swz<kRow>((lane & 7) + (((lane >> 3) & 1) << 3),
                            i * 16 + ((lane >> 4) << 3));
  }
  const uint32_t qs_addr = smem_addr(qs);
  const uint32_t wrow = warp * 16 * kRow * 2;
  uint32_t qf[kQRegs ? HD / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm4(qf[kk], qs_addr + step_off(qoff, kk));
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // per head row (lane / 4 and lane / 4 + 8): the running max of the raw
  // products, the base m c of the exponentials (0 while no key has been
  // seen, so that no inf - inf arises; the rescale is then 0), and this
  // thread's share of the sum
  const float c = p.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};
  float mc[2] = {0.f, 0.f};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk j is in for all; chunk j - 1's stage is free
    if (j + kStages - 1 < n)
      load_chunk(c0 + j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    const uint32_t st = ring_addr + (j % kStages) * kStage * 2 + wrow;

    // S = q.K^T: [16 heads, 16 positions] as two n8 tiles, the even and
    // the odd k-steps in separate accumulators (two chains of dependent
    // mma where one warp per scheduler has little else to issue)
    float s[2][4], s2[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = s2[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm4(qa, qs_addr + step_off(qoff, kk));
      }
      uint32_t kb[4];
      ldsm4(kb, st + step_off(koff, kk));
      float (&acc_s)[2][4] = kk % 2 ? s2 : s;
      mma(acc_s[0], qa, kb[0], kb[1]);
      mma(acc_s[1], qa, kb[2], kb[3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] += s2[t][e];

    // positions at or past the length (the chunk that crosses it)
    const int pos = (c0 + j) * kChunk + warp * 16 + 2 * (lane & 3);
    if ((c0 + j + 1) * kChunk > length) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (pos + t * 8 + (e & 1) >= length) s[t][e] = -INFINITY;
    }

    // online softmax over the quad that holds each head row
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = fmaxf(m[rr], fmaxf(fmaxf(s[0][2 * rr], s[0][2 * rr + 1]),
                                    fmaxf(s[1][2 * rr], s[1][2 * rr + 1])));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mc_new = mx == -INFINITY ? 0.f : mx * c;
      const float alpha = m[rr] == -INFINITY ? 0.f : ex2(mc[rr] - mc_new);
      m[rr] = mx;
      mc[rr] = mc_new;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          s[t][e] = ex2(fmaf(s[t][e], c, -mc_new));
          sum += s[t][e];
        }
      l[rr] = l[rr] * alpha + sum;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[i][2 * rr] *= alpha;
        acc[i][2 * rr + 1] *= alpha;
      }
    }

    // acc += P_hi.V + P_lo.V, P's accumulator fragments repacked as A
    uint32_t ph[4], pl[4];
    split(s[0][0], s[0][1], ph[0], pl[0]);
    split(s[0][2], s[0][3], ph[1], pl[1]);
    split(s[1][0], s[1][1], ph[2], pl[2]);
    split(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t vb[4];
      ldsm4_t(vb, st + step_off(voff, HD / 16 + dp));
      mma(acc[2 * dp], ph, vb[0], vb[1]);
      mma(acc[2 * dp + 1], ph, vb[2], vb[3]);
      mma(acc[2 * dp], pl, vb[0], vb[1]);
      mma(acc[2 * dp + 1], pl, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring

  // the warps' partials into the ring: acc [warp][head][HD], then
  // (m c, or -inf for a warp that saw no key; l) [warp][head]
  constexpr int kLd = kMergeLd<HD>;
  float* macc = reinterpret_cast<float*>(paged_smem);
  float* mml = macc + kWarps * kHeads * kLd;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(kFull, l[rr], 1);
    l[rr] += __shfl_xor_sync(kFull, l[rr], 2);
    const int hr = (lane >> 2) + 8 * rr;
    float* a = macc + (warp * kHeads + hr) * kLd + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(a + i * 8) =
          make_float2(acc[i][2 * rr], acc[i][2 * rr + 1]);
    if ((lane & 3) == 0) {
      mml[(warp * kHeads + hr) * 2] = m[rr] == -INFINITY ? -INFINITY : mc[rr];
      mml[(warp * kHeads + hr) * 2 + 1] = l[rr];
    }
  }
  __syncthreads();

  const size_t tix = (static_cast<size_t>(r) * p.kvh + kh) * m_tiles + mt;
  const size_t part = tix * gridDim.z + z;
  bf16* o = p.out + (static_cast<size_t>(r) * p.heads +
                     static_cast<size_t>(kh) * g + mt * kHeads) * HD;
  // this block's softmax over its warps, per (head, column pair): the
  // output, or with several active splits the split's partial
  for (int e = threadIdx.x; e < nh * (HD / 2); e += kThreads) {
    const int hr = e / (HD / 2), d = 2 * (e % (HD / 2));
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, mml[(w * kHeads + hr) * 2]);
    float sum = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = mml[(w * kHeads + hr) * 2];
      const float wt = mw == -INFINITY ? 0.f : ex2(mw - mx);
      const float2 a =
          *reinterpret_cast<const float2*>(macc + (w * kHeads + hr) * kLd + d);
      sum += mml[(w * kHeads + hr) * 2 + 1] * wt;
      a0 += a.x * wt;
      a1 += a.y * wt;
    }
    if (n_active == 1) {
      const float inv = 1.f / fmaxf(sum, kMaxDivisor);
      *reinterpret_cast<__nv_bfloat162*>(o + hr * HD + d) =
          __floats2bfloat162_rn(a0 * inv, a1 * inv);
    } else {
      *reinterpret_cast<float2*>(p.part_acc + (part * kHeads + hr) * HD + d) =
          make_float2(a0, a1);
      if (d == 0) {
        p.part_ml[(part * kHeads + hr) * 2] = mx;
        p.part_ml[(part * kHeads + hr) * 2 + 1] = sum;
      }
    }
  }
  if (n_active == 1) return;

  // the last of the row's active splits to finish merges them
  __shared__ int last;
  __threadfence();   // this thread's partial is visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.tickets + tix, 1) == n_active - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t part0 = tix * gridDim.z;
  for (int e = threadIdx.x; e < nh * (HD / 2); e += kThreads) {
    const int hr = e / (HD / 2), d = 2 * (e % (HD / 2));
    float mx = -INFINITY;
    for (int zz = 0; zz < n_active; ++zz)
      mx = fmaxf(mx, __ldcg(p.part_ml + ((part0 + zz) * kHeads + hr) * 2));
    float sum = 0.f, a0 = 0.f, a1 = 0.f;
    for (int zz = 0; zz < n_active; ++zz) {
      const size_t pz = (part0 + zz) * kHeads + hr;
      const float wt = ex2(__ldcg(p.part_ml + pz * 2) - mx);
      const float2 a =
          __ldcg(reinterpret_cast<const float2*>(p.part_acc + pz * HD + d));
      sum += __ldcg(p.part_ml + pz * 2 + 1) * wt;
      a0 += a.x * wt;
      a1 += a.y * wt;
    }
    const float inv = 1.f / fmaxf(sum, kMaxDivisor);
    *reinterpret_cast<__nv_bfloat162*>(o + hr * HD + d) =
        __floats2bfloat162_rn(a0 * inv, a1 * inv);
  }
  if (threadIdx.x == 0) p.tickets[tix] = 0;   // ready for the next launch
}

template <int HD>
cudaError_t launch(const Params& p, int rows, int n_split,
                   cudaStream_t stream) {
  const int m_tiles = (p.heads / p.kvh + kHeads - 1) / kHeads;
  return attn_tc::launch(paged_attention_kernel<HD>,
                         dim3(p.kvh * m_tiles, rows, n_split), kThreads,
                         smem_bytes<HD>(), stream, p);
}

template <int HD>
int usage(int* out) {
  out[3] = static_cast<int>(smem_bytes<HD>());
  return attn_tc::usage(paged_attention_kernel<HD>, smem_bytes<HD>(), out);
}

}  // namespace

extern "C" {

// Registers per thread, local memory bytes per thread, resident blocks per
// SM and dynamic shared memory bytes per block of the kernel at head_dim hd
// (64, 128 or 256), as the CUDA runtime reports them, into out[4]; the
// cudaError_t of the query.
int rt_paged_attention_usage(int hd, int* out) {
  if (hd == 64) return usage<64>(out);
  if (hd == 128) return usage<128>(out);
  if (hd == 256) return usage<256>(out);
  return cudaErrorInvalidValue;
}

// q [rows, heads, hd] bf16, kv [num_pages, kvh, ps, 2*hd] bf16,
// tables [rows, max_pages] int32, lengths [rows] int32, out [rows, heads, hd]
// bf16, with hd 64, 128 or 256; all contiguous on one device, q and kv on
// 16 bytes.  Split z of a row takes its 64-position chunks
// [z * chunks_per_split, (z + 1) * chunks_per_split); n_split splits must
// cover max_pages * ps positions.  With n_split > 1, with m_tiles =
// ceil(heads / kvh / 16), part_acc holds rows*kvh*m_tiles*n_split*16*hd
// floats and part_ml rows*kvh*m_tiles*n_split*16*2 floats of scratch, and
// tickets rows*kvh*m_tiles ints that are 0 (each launch leaves them 0);
// with n_split == 1 all three may be null.  Returns the cudaError_t of
// the launch.
int rt_paged_attention_bf16(const void* q, const void* kv, const void* tables,
                            const void* lengths, void* out, void* part_acc,
                            void* part_ml, void* tickets, int rows,
                            int heads, int kvh, int hd, int ps,
                            int num_pages, int max_pages,
                            int chunks_per_split, int n_split, float scale,
                            void* stream) {
  if (rows < 1 || kvh < 1 || heads % kvh != 0 || ps < 1 || max_pages < 1 ||
      n_split < 1 || chunks_per_split < 1 ||
      static_cast<long long>(n_split) * chunks_per_split * kChunk <
          static_cast<long long>(max_pages) * ps ||
      (n_split > 1 &&
       (part_acc == nullptr || part_ml == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  Params p{static_cast<const bf16*>(q),
           static_cast<const bf16*>(kv),
           static_cast<const int*>(tables),
           static_cast<const int*>(lengths),
           static_cast<bf16*>(out),
           static_cast<float*>(part_acc),
           static_cast<float*>(part_ml),
           static_cast<int*>(tickets),
           heads, kvh, ps, num_pages, max_pages, chunks_per_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(p, rows, n_split, st);
  if (hd == 128) return launch<128>(p, rows, n_split, st);
  if (hd == 256) return launch<256>(p, rows, n_split, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
