// Paged decode attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_attention
// (the Pallas body _paged_kernel): one-token GQA attention over a paged KV
// pool, online softmax in fp32, positions >= seq_len masked, scale
// 1/sqrt(hd), the denominator clamped at 1e-30.
//
// Layouts (all contiguous):
//   q            (B, Hq, hd)                 float or bf16
//   k/v pages    (P, page_size, KVH, hd)     same type as q
//   block_tables (B, pages_per_seq)          int32
//   seq_lens     (B,)                        int32
//   out          (B, Hq, hd)                 same type as q
// Query head kvh * G + g reads KV head kvh (G = Hq / KVH).
//
// Design.  The TPU grid (B, KVH, pages) carried m/l/acc across its
// sequential page axis; on Hopper one thread block per (KV head, sequence)
// walks that sequence's tokens itself, kTile tokens at a time.  For each
// tile it first reads the tokens' page ids from block_tables into shared
// memory (no scalar prefetch), only for positions < seq_len, so table
// entries past ceil(seq_len / page_size) -- trash page 0 in the serving
// engine -- are never read.  Then every thread issues all of its 16-byte
// K and V loads for the tile at once (independent loads: one memory
// latency per tile, not one per element) and stages the rows in shared
// memory as fp32, padded by one word so the score loop is free of bank
// conflicts.  The G query rows, the running max m and sum l live in shared
// memory; each thread keeps its slice of the (G, hd) fp32 accumulator in
// registers.  The output is written once.  Tokens are addressed one by
// one, so any page_size works; rows must start 16-byte aligned (the
// wrapper checks the slabs' base addresses).
//
// Bound.  The kernel must read sum_b seq_len_b * KVH * hd * 2 (K and V) *
// itemsize bytes of KV pages and does 4 * sum_b seq_len_b * Hq * hd flops,
// so it is bound by HBM bytes (3.35 TB/s on the H100 SXM).  At the serving
// engine's sizes (B <= 16, seq_len <= 256: about 1.6 MB per call) the time
// is set by launch latency, not by bytes.  Simple and right first: no
// split-KV across SMs, no cp.async/TMA pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kTile = 32;       // tokens staged per iteration (= warp size)
constexpr int kMaxG = 16;       // query heads per KV head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int G, int KVH, int page_size, int pages_per_seq,
                       float sm_scale) {
  constexpr int kRow = HD + 1;  // padded shared-memory row
  constexpr int kAcc = (kMaxG * HD + kThreads - 1) / kThreads;
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int kChunks = HD / kVec;         // 16-byte chunks per K/V row
  constexpr int kLoads = kTile * kChunks / kThreads;  // per thread, per tile
  static_assert(kTile * kChunks % kThreads == 0, "tile must split evenly");
  __shared__ float q_s[kMaxG * HD];
  __shared__ float k_s[kTile * kRow];
  __shared__ float v_s[kTile * kRow];
  __shared__ float p_s[kMaxG * kTile];
  __shared__ int page_s[kTile];
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float alpha_s[kMaxG];

  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // sequence
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = G * HD;
  const int seq_len = seq_lens[b];
  const int* table = block_tables + (size_t)b * pages_per_seq;
  const size_t tok_stride = (size_t)KVH * HD;
  const size_t head_off = (size_t)h * HD;

  const size_t q_off = ((size_t)b * KVH * G + (size_t)h * G) * HD;
  for (int i = tid; i < rows; i += kThreads) q_s[i] = to_float(q[q_off + i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < seq_len; t0 += kTile) {
    // page ids of this tile's tokens (never past seq_len)
    if (tid < kTile) {
      const int pos = t0 + tid;
      page_s[tid] = pos < seq_len ? table[pos / page_size] : 0;
    }
    __syncthreads();
    // stage K/V rows t0 .. t0+kTile of this head (zeros past seq_len):
    // all of a thread's 16-byte loads are issued before any is used
    uint4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int c = tid + j * kThreads;
      const int t = c / kChunks;
      const int pos = t0 + t;
      kr[j] = make_uint4(0u, 0u, 0u, 0u);
      vr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (pos < seq_len) {
        const size_t off =
            ((size_t)page_s[t] * page_size + pos % page_size) * tok_stride +
            head_off + (size_t)(c % kChunks) * kVec;
        kr[j] = *reinterpret_cast<const uint4*>(k_pages + off);
        vr[j] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int c = tid + j * kThreads;
      const int row = (c / kChunks) * kRow + (c % kChunks) * kVec;
      const T* ke = reinterpret_cast<const T*>(&kr[j]);
      const T* ve = reinterpret_cast<const T*>(&vr[j]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[row + e] = to_float(ke[e]);
        v_s[row + e] = to_float(ve[e]);
      }
    }
    __syncthreads();

    // scores s[g][t] = (q_g . k_t) * scale, masked past seq_len
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      const int t = i % kTile;
      float s = kNegInf;
      if (t0 + t < seq_len) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot += q_s[g * HD + d] * k_s[t * kRow + d];
        s = dot * sm_scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row, one lane per token
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = p_s[g * kTile + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha_g + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < rows) {
        const int g = i / HD;
        const int d = i % HD;
        float a = acc[j] * alpha_s[g];
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) a += p_s[g * kTile + t] * v_s[t * kRow + d];
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < rows) {
      const int g = i / HD;
      out[q_off + i] = from_float<T>(acc[j] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k_pages, const void* v_pages,
            const int* block_tables, const int* seq_lens, void* out, int B,
            int G, int KVH, int page_size, int pages_per_seq, float sm_scale,
            cudaStream_t stream) {
  const dim3 grid(KVH, B);
  paged_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, seq_lens,
      static_cast<T*>(out), G, KVH, page_size, pages_per_seq, sm_scale);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k_pages, const void* v_pages,
                const int* block_tables, const int* seq_lens, void* out, int B,
                int G, int KVH, int page_size, int pages_per_seq,
                float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      launch<T, 32>(q, k_pages, v_pages, block_tables, seq_lens, out, B, G,
                    KVH, page_size, pages_per_seq, sm_scale, stream);
      return 0;
    case 64:
      launch<T, 64>(q, k_pages, v_pages, block_tables, seq_lens, out, B, G,
                    KVH, page_size, pages_per_seq, sm_scale, stream);
      return 0;
    case 128:
      launch<T, 128>(q, k_pages, v_pages, block_tables, seq_lens, out, B, G,
                     KVH, page_size, pages_per_seq, sm_scale, stream);
      return 0;
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape or type the kernel does not
// take (the Python wrapper checks these first and raises).
int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                        const void* block_tables, const void* seq_lens, void* out,
                        int B, int Hq, int KVH, int hd, int page_size,
                        int pages_per_seq, float sm_scale, int dtype,
                        void* stream) {
  if (B <= 0 || KVH <= 0 || Hq % KVH != 0 || Hq / KVH > kMaxG || page_size <= 0 ||
      pages_per_seq <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = Hq / KVH;
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch_hd<float>(hd, q, k_pages, v_pages, bt, sl, out, B, G, KVH,
                            page_size, pages_per_seq, sm_scale, s);
  } else if (dtype == 1) {
    rc = dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, bt, sl, out, B, G,
                                    KVH, page_size, pages_per_seq, sm_scale, s);
  } else {
    rc = -1;
  }
  if (rc != 0) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
