// Paged decode attention for Hopper (sm_90a): one query token per row over a
// paged KV pool, grouped-query heads, online softmax.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py::_tpu_kernel
// (reached through paged_attention_tpu).  It computes the same function:
//
//   out[r, h] = softmax(q[r, h] . K[r, :len]^T * scale) @ V[r, :len]
//
// where row r's keys and values live in the pages block_tables[r, :] of the
// fused pool kv_pages[num_pages, kv_heads, page_size, 2*head_dim]
// (K in [..., :head_dim], V in [..., head_dim:]), and len = lengths[r].
//
// What bounds it on this card: bytes.  Each (row, kv head) reads its
// occupied K|V positions once and does 4*g*head_dim flops per position
// (g = heads / kv_heads), far below the ~295 flops per byte where the
// tensor cores would become the limit.  So the design reads each needed
// byte once, and spreads the reading over enough SMs to keep the memory
// busy:
//   - a thread block per (row, kv head, split): the block loads its own
//     table entries and walks only its share of the row's
//     cdiv(length, page_size) occupied pages, staging only their valid
//     positions in shared memory;
//   - the splits (flash-decoding) put a long row's pages on several SMs:
//     a decode batch of 9 rows x 8 kv heads is only 72 blocks for 132
//     SMs.  Each split keeps its own running max, sum and accumulator,
//     and a second small kernel merges them;
//   - the block's g query heads share each K|V tile, so a GQA group reads
//     the pool once instead of g times;
//   - pages are double-buffered with 16-byte cp.async: page i+1 is in
//     flight while page i is scored;
//   - scores, the running max and sum and the [g, head_dim] accumulator
//     stay in fp32; only the output (and, when split, one fp32 partial per
//     block) is written.
// The Pallas kernel's TPU workarounds are gone: q is not zero-padded to
// 2*head_dim (the K and V halves of a tile are read directly), there is no
// 128-lane fallback and no static per-head loop.
//
// Left for later: tensor-core (mma/wgmma) dot products and TMA.
//
// Plain C interface, loaded with ctypes (ray_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerPos = 4;                 // lanes sharing one K row
constexpr int kPosPerPass = kThreads / kLanesPerPos;
constexpr float kNegInf = -1e30f;               // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Shared memory of one block: two K|V tiles, then fp32 q, accumulator,
// scores, and the running max, sum and rescale factor of each head.
size_t smem_bytes(int g, int hd, int ps) {
  return 2 * static_cast<size_t>(ps) * 2 * hd * sizeof(__nv_bfloat16) +
         (2 * static_cast<size_t>(g) * hd + static_cast<size_t>(g) * ps +
          3 * static_cast<size_t>(g)) * sizeof(float);
}

// Stage the first n positions of one (page, kv head) tile [ps, 2*HD].
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int n) {
  constexpr int kChunksPerPos = 2 * HD * sizeof(__nv_bfloat16) / 16;
  const int total = n * kChunksPerPos;
  for (int c = threadIdx.x; c < total; c += kThreads)
    cp_async16(dst + c * 8, src + c * 8);
}

// grid (kv_heads, rows, n_split).  Split z walks pages
// [z * pages_per_split, min(n_pg, (z + 1) * pages_per_split)).  With one
// split the block writes the output; with more it writes its unnormalised
// accumulator and its (max, sum) per head for combine_kernel.
template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kv,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int heads, int kvh,
                       int ps, int num_pages, int max_pages,
                       int pages_per_split, float scale) {
  constexpr int kChunks = HD / 8;               // 16-byte chunks of a K row
  constexpr int kChunksPerLane = kChunks / kLanesPerPos;
  constexpr int kPairs = HD / 2;
  const int kh = blockIdx.x;
  const int r = blockIdx.y;
  const int split = blockIdx.z;
  const int g = heads / kvh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const size_t tile_elems = static_cast<size_t>(ps) * 2 * HD;
  float* q_s = reinterpret_cast<float*>(tiles + 2 * tile_elems);  // [g, HD]
  float* acc = q_s + g * HD;                                      // [g, HD]
  float* s = acc + g * HD;                                        // [g, ps]
  float* m = s + g * ps;                                          // [g]
  float* l = m + g;                                               // [g]
  float* alpha = l + g;                                           // [g]

  const int length = lengths[r];
  const int n_pg = (length + ps - 1) / ps;
  // A length past the table's span or a page id outside the pool would
  // read memory the caller does not own: fail the launch loudly.
  if (length < 0 || n_pg > max_pages) __trap();
  const int p0 = split * pages_per_split;
  const int p1 = min(n_pg, p0 + pages_per_split);
  const int* row_table = tables + static_cast<size_t>(r) * max_pages;
  auto tile_src = [&](int i) {
    const int page = row_table[i];
    if (page < 0 || page >= num_pages) __trap();
    return kv + (static_cast<size_t>(page) * kvh + kh) * tile_elems;
  };

  if (p0 < p1) load_tile<HD>(tiles, tile_src(p0), min(ps, length - p0 * ps));
  cp_async_commit();

  const __nv_bfloat16* q_row =
      q + (static_cast<size_t>(r) * heads + static_cast<size_t>(kh) * g) * HD;
  for (int i = threadIdx.x; i < g * HD; i += kThreads) {
    q_s[i] = __bfloat162float(q_row[i]) * scale;
    acc[i] = 0.f;
  }
  for (int h = threadIdx.x; h < g; h += kThreads) {
    m[h] = kNegInf;
    l[h] = 0.f;
  }

  // scores: 4 lanes per position; lane `sub` holds chunks sub, sub+4, ...
  const int grp = lane / kLanesPerPos;
  const int sub = lane % kLanesPerPos;
  for (int i = p0; i < p1; ++i) {
    const int n = min(ps, length - i * ps);   // valid positions of page i
    const int buf = (i - p0) & 1;
    if (i + 1 < p1) {
      load_tile<HD>(tiles + (buf ^ 1) * tile_elems, tile_src(i + 1),
                    min(ps, length - (i + 1) * ps));
    }
    cp_async_commit();
    cp_async_wait<1>();   // page i has landed (page i+1 may be in flight)
    __syncthreads();
    const __nv_bfloat16* t = tiles + buf * tile_elems;

    // Scores: each position's K row is read once, as 16-byte chunks, for
    // all g heads; the 4 lanes of a position reduce with two shuffles.
    for (int j0 = warp * (32 / kLanesPerPos); j0 < n; j0 += kPosPerPass) {
      const int j = j0 + grp;
      const bool valid = j < n;
      float kf[kChunksPerLane][8];
#pragma unroll
      for (int c = 0; c < kChunksPerLane; ++c) {
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (valid)
          raw = *reinterpret_cast<const uint4*>(
              t + j * 2 * HD + (sub + kLanesPerPos * c) * 8);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(b2[e]);
          kf[c][2 * e] = f.x;
          kf[c][2 * e + 1] = f.y;
        }
      }
      for (int h = 0; h < g; ++h) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < kChunksPerLane; ++c) {
          const float4* qp = reinterpret_cast<const float4*>(
              q_s + h * HD + (sub + kLanesPerPos * c) * 8);
          const float4 a = qp[0], b = qp[1];
          d += a.x * kf[c][0] + a.y * kf[c][1] + a.z * kf[c][2] +
               a.w * kf[c][3] + b.x * kf[c][4] + b.y * kf[c][5] +
               b.z * kf[c][6] + b.w * kf[c][7];
        }
        d += __shfl_xor_sync(kFull, d, 1);
        d += __shfl_xor_sync(kFull, d, 2);
        if (valid && sub == 0) s[h * ps + j] = d;
      }
    }
    __syncthreads();

    // Online softmax over this page: one warp per head.
    for (int h = warp; h < g; h += kWarps) {
      float* sh = s + h * ps;
      float pmax = kNegInf;
      for (int j = lane; j < n; j += 32) pmax = fmaxf(pmax, sh[j]);
      pmax = warp_max(pmax);
      const float m_prev = m[h];
      const float m_new = fmaxf(m_prev, pmax);
      float psum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sh[j] - m_new);
        sh[j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[h] = a;
        l[h] = l[h] * a + psum;
        m[h] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V: each thread owns fixed (head, dim pair)
    // cells; a warp reads 32 neighbouring V pairs of one position.
    for (int c = threadIdx.x; c < g * kPairs; c += kThreads) {
      const int h = c / kPairs;
      const float* ph = s + h * ps;
      const __nv_bfloat162* vcol =
          reinterpret_cast<const __nv_bfloat162*>(t + HD) + c % kPairs;
      float2 a = reinterpret_cast<float2*>(acc)[c];
      const float al = alpha[h];
      a.x *= al;
      a.y *= al;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float p = ph[j];
        const float2 v = __bfloat1622float2(vcol[j * HD]);
        a.x += p * v.x;
        a.y += p * v.y;
      }
      reinterpret_cast<float2*>(acc)[c] = a;
    }
    __syncthreads();   // the tile and the scores are reused two pages on
  }
  cp_async_wait<0>();
  __syncthreads();

  if (gridDim.z == 1) {
    __nv_bfloat16* o = out + (static_cast<size_t>(r) * heads +
                              static_cast<size_t>(kh) * g) * HD;
    for (int idx = threadIdx.x; idx < g * HD; idx += kThreads)
      o[idx] = __float2bfloat16(acc[idx] / fmaxf(l[idx / HD], 1e-30f));
    return;
  }
  const size_t part = (static_cast<size_t>(r) * kvh + kh) * gridDim.z + split;
  for (int idx = threadIdx.x; idx < g * HD; idx += kThreads)
    part_acc[part * g * HD + idx] = acc[idx];
  for (int h = threadIdx.x; h < g; h += kThreads) {
    part_ml[(part * g + h) * 2] = m[h];
    part_ml[(part * g + h) * 2 + 1] = l[h];
  }
}

// grid (kv_heads, rows): merge the n_split partial softmaxes of each
// (row, kv head).  A split that held no pages has max -1e30 and sum 0, so
// its weight is 0.
template <int HD>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml,
               __nv_bfloat16* __restrict__ out, int heads, int kvh,
               int n_split) {
  const int kh = blockIdx.x;
  const int r = blockIdx.y;
  const int g = heads / kvh;
  const size_t base = (static_cast<size_t>(r) * kvh + kh) * n_split;
  __nv_bfloat16* o =
      out + (static_cast<size_t>(r) * heads + static_cast<size_t>(kh) * g) * HD;
  for (int idx = threadIdx.x; idx < g * HD; idx += kThreads) {
    const int h = idx / HD;
    float mx = kNegInf;
    for (int z = 0; z < n_split; ++z)
      mx = fmaxf(mx, part_ml[((base + z) * g + h) * 2]);
    float sum = 0.f, a = 0.f;
    for (int z = 0; z < n_split; ++z) {
      const float w = expf(part_ml[((base + z) * g + h) * 2] - mx);
      sum += part_ml[((base + z) * g + h) * 2 + 1] * w;
      a += part_acc[(base + z) * g * HD + idx] * w;
    }
    o[idx] = __float2bfloat16(a / fmaxf(sum, 1e-30f));
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* kv, const int* tables,
                   const int* lengths, void* out, float* part_acc,
                   float* part_ml, int rows, int heads, int kvh, int ps,
                   int num_pages, int max_pages, int pages_per_split,
                   int n_split, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(heads / kvh, HD, ps);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  paged_attention_kernel<HD><<<dim3(kvh, rows, n_split), kThreads, smem,
                               stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv), tables, lengths, o, part_acc,
      part_ml, heads, kvh, ps, num_pages, max_pages, pages_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  combine_kernel<HD><<<dim3(kvh, rows), kThreads, 0, stream>>>(
      part_acc, part_ml, o, heads, kvh, n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses shapes whose
// need exceeds the card's per-block limit.
size_t rt_paged_attention_smem_bytes(int g, int hd, int ps) {
  return smem_bytes(g, hd, ps);
}

// q [rows, heads, hd] bf16, kv [num_pages, kvh, ps, 2*hd] bf16,
// tables [rows, max_pages] int32, lengths [rows] int32, out [rows, heads, hd]
// bf16, with hd 64, 128 or 256; all contiguous on one device.  With
// n_split > 1, part_acc holds rows*kvh*n_split*g*hd floats and part_ml
// rows*kvh*n_split*g*2 floats of scratch; with n_split == 1 both may be
// null.  Returns the cudaError_t of the launches.
int rt_paged_attention_bf16(const void* q, const void* kv, const void* tables,
                            const void* lengths, void* out, void* part_acc,
                            void* part_ml, int rows, int heads, int kvh,
                            int hd, int ps, int num_pages, int max_pages,
                            int pages_per_split, int n_split, float scale,
                            void* stream) {
  const int* t = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || pages_per_split < 1 ||
      static_cast<long long>(n_split) * pages_per_split < max_pages ||
      (n_split > 1 && (pa == nullptr || pm == nullptr)))
    return cudaErrorInvalidValue;
  if (hd == 64)
    return launch<64>(q, kv, t, len, out, pa, pm, rows, heads, kvh, ps,
                      num_pages, max_pages, pages_per_split, n_split, scale,
                      st);
  if (hd == 128)
    return launch<128>(q, kv, t, len, out, pa, pm, rows, heads, kvh, ps,
                       num_pages, max_pages, pages_per_split, n_split, scale,
                       st);
  if (hd == 256)
    return launch<256>(q, kv, t, len, out, pa, pm, rows, heads, kvh, ps,
                       num_pages, max_pages, pages_per_split, n_split, scale,
                       st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
