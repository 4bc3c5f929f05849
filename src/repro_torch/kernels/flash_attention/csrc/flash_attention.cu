// Flash attention forward (GQA, causal or not) for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:73
// flash_attention_fwd (the Pallas body _flash_kernel): fp32 online softmax,
// the scale applied after the q.k dot, masked scores at NEG_INF = -1e30,
// the denominator clamped at 1e-30, and, when causal, KV tiles that lie
// wholly above the diagonal skipped.
//
// Layouts: q (B, Hq, S, hd), k/v (B, KVH, S, hd), out (B, Hq, S, hd), each
// given by its element strides over (batch, head, position) with the last
// dimension contiguous, so the serving path's (B, S, H, hd) tensors are
// read through transposed views with no copy.  Rows must start 16-byte
// aligned (the wrapper checks base addresses and strides).  Query head
// kvh * G + g reads KV head kvh (G = Hq / KVH).  float32 or bfloat16, the
// same for all four tensors.
//
// Design.  The TPU grid (B, Hq, S/bq, S/bk) carried m/l/acc across its
// sequential kv axis in VMEM.  Here one thread block per (batch, KV head,
// query tile) walks the KV tiles itself.  A query tile is kRows = 64 query
// rows drawn from P = 64 / G consecutive positions times all G query heads
// of the KV head, so every K/V tile staged in shared memory serves the G
// heads at once.  Per KV tile of 64 keys, each of the 128 threads computes
// an 8 x 4 block of scores from shared memory (SIMT, fp32), the rows'
// max and sum are reduced over the 16 lanes that share them, P is kept in
// fp32 in shared memory, and each thread accumulates an 8 x (hd / 16)
// block of P @ V in registers.  The output is written once, rounded once.
// Tiles are launched heaviest first (the causal diagonal's far end).
//
// Any S.  Unlike the Pallas kernel (S % bq == 0), positions at or past S
// are masked (keys) or not written (queries).  KV tiles are fixed 64-key
// tiles from position 0 and the query tiles fixed P-position tiles from 0,
// so a row's summation order does not depend on where S ends: a prefill of
// a prefix at its unpadded length gives bitwise the rows that a longer,
// padded prefill gives for the same positions (the serving engine relies
// on this when it recomputes a preempted request's KV at readmission).
//
// Bound.  Causal work is about 2 * B * Hq * hd * S * (S + 1) flops (both
// products, half the score matrix), over 989 TFLOP/s (bf16 tensor cores)
// or 67 TFLOP/s (fp32 CUDA cores); at B = 4, S = 2048 and TinyLlama's heads
// (Hq = 32, hd = 64) that is 68.7 GFLOP, 0.069 ms in bf16.  The q/k/v/o
// bytes (75 MB there, 0.023 ms at 3.35 TB/s) are less, so prefill sizes are
// bound by operations.  This first version computes on the CUDA cores in
// fp32, so it stays far from that bound: wgmma and TMA staging (and P
// rounded to bf16 for a tensor-core P @ V) are queued work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 8 row groups x 16 lanes
constexpr int kRows = 64;      // query rows per block: positions x G heads
constexpr int kKeys = 64;      // keys per KV tile
constexpr int kRowsPer = 8;    // rows per thread (kRows / 8 row groups)
constexpr int kKeysPer = 4;    // scores per row per thread (kKeys / 16)
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

// max / sum over the 16 lanes of a row group (a half warp); every lane
// ends with the same value (the butterfly adds the same pairs everywhere)
__device__ __forceinline__ float group_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {
  long long b, h, s;  // elements per batch, head, position
};

// Stage `rows` rows of HD elements into shared memory as fp32 (row pitch
// `pitch`).  row_ptr(i) gives row i's first element or nullptr for a row
// to zero.  Loads are 16 bytes each, all issued before any is stored.
template <typename T, int HD, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int pitch, int rows,
                                           RowPtr row_ptr) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  constexpr int kLoads = (kRows * kChunks + kThreads - 1) / kThreads;
  uint4 buf[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int c = threadIdx.x + j * kThreads;
    buf[j] = make_uint4(0u, 0u, 0u, 0u);
    if (c < rows * kChunks) {
      const T* src = row_ptr(c / kChunks);
      if (src != nullptr)
        buf[j] = *reinterpret_cast<const uint4*>(src + (c % kChunks) * kVec);
    }
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < rows * kChunks) {
      const T* e = reinterpret_cast<const T*>(&buf[j]);
      float* d = dst + (c / kChunks) * pitch + (c % kChunks) * kVec;
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = to_float(e[x]);
    }
  }
}

template <int HD>
constexpr int smem_floats() {
  return kRows * (HD + 1) + kKeys * (HD + 1) + kKeys * HD + kRows * (kKeys + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int S, int G, int P, Strides qs, Strides ks,
                       Strides vs, Strides os, float sm_scale, int causal) {
  constexpr int kQP = HD + 1;      // padded pitch of q and k rows
  constexpr int kDPer = HD / 16;   // output dims per thread
  extern __shared__ float smem[];
  float* q_s = smem;                        // [kRows][HD + 1]
  float* k_s = q_s + kRows * kQP;           // [kKeys][HD + 1]
  float* v_s = k_s + kKeys * kQP;           // [kKeys][HD]
  float* p_s = v_s + kKeys * HD;            // [kRows][kKeys + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group
  const int tx = tid & 15;  // lane in the group
  const int rows = P * G;   // <= kRows
  const int q0 = qt * P;    // first position of the tile

  stage_rows<T, HD>(q_s, kQP, rows, [&](int r) -> const T* {
    const int pos = q0 + r / G;
    if (pos >= S) return nullptr;
    return q + b * qs.b + (long long)(kvh * G + r % G) * qs.h + pos * qs.s;
  });

  int row_pos[kRowsPer];
  bool row_ok[kRowsPer];
  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][kDPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = ty * kRowsPer + i;
    row_pos[i] = q0 + r / G;
    row_ok[i] = r < rows && row_pos[i] < S;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPer; ++c) acc[i][c] = 0.f;
  }

  const int last = min(S - 1, q0 + P - 1);
  const int kv_end = causal ? last + 1 : S;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, HD>(k_s, kQP, kKeys, [&](int j) -> const T* {
      return k0 + j < S ? kb + (k0 + j) * ks.s : nullptr;
    });
    stage_rows<T, HD>(v_s, HD, kKeys, [&](int j) -> const T* {
      return k0 + j < S ? vb + (k0 + j) * vs.s : nullptr;
    });
    __syncthreads();

    // scores of rows ty*8+i against keys tx + 16*c
    float s[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPer], kv[kKeysPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) qv[i] = q_s[(ty * kRowsPer + i) * kQP + d];
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) kv[c] = k_s[(tx + 16 * c) * kQP + d];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int c = 0; c < kKeysPer; ++c) s[i][c] += qv[i] * kv[c];
    }

    // online softmax over this tile, fp32
    float alpha[kRowsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool keep = row_ok[i] && kp < S && (!causal || kp <= row_pos[i]);
        s[i][c] = keep ? s[i][c] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const float p = expf(s[i][c] - m_new);
        p_s[(ty * kRowsPer + i) * (kKeys + 1) + tx + 16 * c] = p;
        sum += p;
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + group_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + P @ V over dims tx + 16*c, P kept in fp32
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int c = 0; c < kDPer; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pj[kRowsPer], vj[kDPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        pj[i] = p_s[(ty * kRowsPer + i) * (kKeys + 1) + j];
#pragma unroll
      for (int c = 0; c < kDPer; ++c) vj[c] = v_s[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int c = 0; c < kDPer; ++c) acc[i][c] += pj[i] * vj[c];
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    if (!row_ok[i]) continue;
    const int r = ty * kRowsPer + i;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* dst = out + b * os.b + (long long)(kvh * G + r % G) * os.h +
             (long long)row_pos[i] * os.s;
#pragma unroll
    for (int c = 0; c < kDPer; ++c) dst[tx + 16 * c] = from_float<T>(acc[i][c] * inv_l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int KVH, int S, int G, Strides qs, Strides ks, Strides vs,
           Strides os, float sm_scale, int causal, cudaStream_t stream) {
  const int P = kRows / G;
  const size_t smem = smem_floats<HD>() * sizeof(float);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + P - 1) / P, KVH, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, G, P, qs, ks, vs,
      os, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int B, int KVH, int S, int G, Strides qs,
                Strides ks, Strides vs, Strides os, float sm_scale,
                int causal, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                           sm_scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                           sm_scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                            sm_scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, over
// (batch, head, position); the head dimension is contiguous.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape or type the kernel does not take (the Python wrapper checks these
// first and raises).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int Hq, int KVH, int S, int hd,
                        long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss,
                        float sm_scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || Hq % KVH != 0 || Hq / KVH > kRows ||
      B > 65535 || KVH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = Hq / KVH;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                              sm_scale, causal, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, KVH, S, G, qs, ks,
                                      vs, os, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
