// Segment-aligned batched LoRA for NVIDIA Hopper (sm_90a), plain C
// interface:  y[t] = x[t] @ W + s * (x[t] @ A[g]) @ B[g],  g = tile_groups[t / bt].
//
// Replaces src/repro/kernels/batched_lora/kernel.py:46 batched_lora_matmul
// (the Pallas body _lora_kernel): the base product, the down projection
// x @ A[g] and the up projection by B[g] all accumulate in fp32, and the
// sum base + s * delta is rounded once, to the output's type.  The base
// product x @ W is computed here, in the kernel's own body, as the TPU
// kernel computes it in its body.
//
// Layouts (all row-major, rows 16-byte aligned; the wrapper checks):
//   x (T, D), W (D, F), A (G, D, r), B (G, r, F), out (T, F): float or bf16
//   tile_groups (ceil(T / bt),) int32: the adapter of each row tile
//
// Design.  The TPU grid (T/bt, F/bf) took each tile's adapter id by scalar
// prefetch.  Here each block reads its rows' adapter id from tile_groups
// itself, and two paths share one summation order:
//
//   order: a row's x @ W and x @ A[g] are sums over D taken in chunks of
//   kKC = 128: each chunk's partial sum is a chain of fp32 FMAs in order of
//   d, starting from 0, and the chunks' partials are added in order,
//   starting from 0.  (x @ A) @ B[g] is a chain of r FMAs, and the output
//   is fma(s, delta, base), rounded once.  Every step is an explicit
//   __fmaf_rn / __fadd_rn, so the compiler contracts nothing differently in
//   the two paths: a row gives the same bits whichever path computes it and
//   wherever it sits in its tile, so a decode batch and a prefill agree.
//
//   tiled (T > kSplitT, long prefills): one block of 256 threads computes a
//   64 x 64 output tile (bt is a multiple of 64, so one block's rows share
//   one adapter).  It walks D in steps of 32: each step stages the x tile
//   (transposed) and the W tile in shared memory as fp32, with the next
//   step's 16-byte loads already in flight in registers, and each thread
//   accumulates a 4 x 4 block of x @ W (SIMT, fp32).  The same x tile feeds
//   the down projection: the block keeps its 64 rows' x @ A[g] (r <= 64
//   values a row) in registers while it walks D, then stages them in
//   shared memory with the B[g] columns of its tile and adds
//   s * (x @ A) @ B to its outputs.  Rows at or past T and columns at or
//   past F are masked, so T need not be a multiple of bt.
//
//   split (T <= kSplitT = 256: decode and short prefills): at decode a
//   64-row tile would leave >= 75% of its rows masked, and F / 64 blocks
//   walking all of D leave most of the card idle, so D is split instead.
//   Pass 1 runs one block per (128 columns, D chunk, 16 rows): each thread
//   keeps one column's 16 row sums of its chunk and writes them to an fp32
//   workspace, and the blocks of the first column tile also write their
//   rows' x @ A[g] chunk partials.  Pass 2 adds the chunks in order and
//   applies the low-rank term.  A 16-row group lies in one row tile (bt is
//   a multiple of 64), so it has one adapter.  The workspace grows with T
//   (ceil(D / 128) * T * (F + r) floats: 34 MB at T = 256, D = F = 2048),
//   which is what bounds this path to T <= 256.
//
// Bound.  2 * T * D * F flops for the base product (the low-rank terms add
// 2 * T * r * (D + F)) against reading W once (D * F * itemsize bytes),
// x, A, B and writing y.  At decode (T <= 16, D = F = 2048, bf16) reading
// W is 8.4 MB, 2.5 us at 3.35 TB/s: bound by bytes.  At prefill
// (T = 8192) the flops are 68.7 GFLOP, 0.069 ms at 989 TFLOP/s in bf16:
// bound by operations.  Both paths compute on the CUDA cores in fp32, so
// they stay far from the prefill bound: wgmma with TMA staging is queued
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16, a 4 x 4 output block each
constexpr int kBM = 64;        // rows per block
constexpr int kBN = 64;        // columns per block
constexpr int kBK = 32;        // depth per step
constexpr int kMaxR = 64;      // LoRA rank
constexpr int kKC = 128;       // D chunk of the summation order
constexpr int kSplitT = 256;   // calls with T <= kSplitT take the split path
constexpr int kRG = 16;        // rows per split block
constexpr int kSN = 128;       // columns per split block, one per thread
constexpr int kMaxPairs = kBM * kMaxR / kThreads;  // (row, rank) pairs per thread
constexpr int kALoads = kBK * kMaxR / kThreads;    // A elements per thread per step

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

template <typename T>
struct Tiles {
  static constexpr int kVec = 16 / sizeof(T);            // elements per load
  static constexpr int kXL = kBM * kBK / kVec / kThreads;  // x loads per thread
  static constexpr int kWL = kBK * kBN / kVec / kThreads;  // W loads per thread
  uint4 x[kXL];
  uint4 w[kWL];
  float a[kALoads];
};

// Issue the 16-byte loads of step d0 into registers (zeros where masked).
template <typename T>
__device__ __forceinline__ void load_step(Tiles<T>& t, const T* __restrict__ x,
                                          const T* __restrict__ w,
                                          const T* __restrict__ a_g, int T_,
                                          int D, int F, int r, int m0, int n0,
                                          int d0) {
  constexpr int kVec = Tiles<T>::kVec;
  constexpr int kXC = kBK / kVec;  // x chunks per row
  constexpr int kWC = kBN / kVec;  // W chunks per row
#pragma unroll
  for (int j = 0; j < Tiles<T>::kXL; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int row = m0 + c / kXC;
    const int col = d0 + (c % kXC) * kVec;
    t.x[j] = make_uint4(0u, 0u, 0u, 0u);
    if (row < T_ && col < D)
      t.x[j] = *reinterpret_cast<const uint4*>(x + (size_t)row * D + col);
  }
#pragma unroll
  for (int j = 0; j < Tiles<T>::kWL; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int row = d0 + c / kWC;
    const int col = n0 + (c % kWC) * kVec;
    t.w[j] = make_uint4(0u, 0u, 0u, 0u);
    if (row < D && col < F)
      t.w[j] = *reinterpret_cast<const uint4*>(w + (size_t)row * F + col);
  }
  // A[g] rows d0 .. d0+kBK are kBK * r contiguous elements
#pragma unroll
  for (int j = 0; j < kALoads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    t.a[j] = (e < kBK * r && d0 + e / r < D) ? to_float(a_g[(size_t)d0 * r + e])
                                             : 0.f;
  }
}

// Write the registers of one step to shared memory as fp32.
template <typename T>
__device__ __forceinline__ void store_step(const Tiles<T>& t, float* xs,
                                           float* ws, float* as, int r) {
  constexpr int kVec = Tiles<T>::kVec;
  constexpr int kXC = kBK / kVec;
  constexpr int kWC = kBN / kVec;
#pragma unroll
  for (int j = 0; j < Tiles<T>::kXL; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int row = c / kXC;
    const int k0 = (c % kXC) * kVec;
    const T* e = reinterpret_cast<const T*>(&t.x[j]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) xs[(k0 + i) * kBM + row] = to_float(e[i]);
  }
#pragma unroll
  for (int j = 0; j < Tiles<T>::kWL; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int row = c / kWC;
    const int c0 = (c % kWC) * kVec;
    const T* e = reinterpret_cast<const T*>(&t.w[j]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) ws[row * kBN + c0 + i] = to_float(e[i]);
  }
#pragma unroll
  for (int j = 0; j < kALoads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < kBK * r) as[e] = t.a[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
batched_lora_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ a, const T* __restrict__ b,
                    const int* __restrict__ tile_groups, T* __restrict__ out,
                    int T_, int D, int F, int r, int bt, float scaling) {
  // the walk over D uses the x, W and A tiles; the epilogue reuses the
  // same memory for x @ A[g] and B[g]'s columns (33 KB, under the 48 KB
  // of static shared memory)
  constexpr int kWalk = kBK * kBM + kBK * kBN + kBK * kMaxR;
  constexpr int kEpi = kBM * (kMaxR + 1) + kMaxR * kBN;
  __shared__ __align__(16) float smem[kWalk > kEpi ? kWalk : kEpi];
  float* xs = smem;                  // x tile, transposed [k][m]
  float* ws = xs + kBK * kBM;        // W tile [k][n]
  float* as = ws + kBK * kBN;        // A[g] rows [k][r]
  float* xa_s = smem;                // x @ A[g] [m][r], padded
  float* bs = xa_s + kBM * (kMaxR + 1);  // B[g] columns [r][n]

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int g = tile_groups[m0 / bt];
  const T* a_g = a + (size_t)g * D * r;
  const T* b_g = b + (size_t)g * r * F;

  // acc / xa: the current D chunk's partial sums; base / xa_sum: the
  // chunks done so far, added in order
  float acc[4][4], base[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = base[i][j] = 0.f;
  float xa[kMaxPairs], xa_sum[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) xa[p] = xa_sum[p] = 0.f;
  const int pairs = kBM * r;

  Tiles<T> t;
  load_step<T>(t, x, w, a_g, T_, D, F, r, m0, n0, 0);
  for (int d0 = 0; d0 < D; d0 += kBK) {
    __syncthreads();  // the previous step's readers are done
    store_step<T>(t, xs, ws, as, r);
    __syncthreads();
    if (d0 + kBK < D)  // the next step's loads fly during this step's math
      load_step<T>(t, x, w, a_g, T_, D, F, r, m0, n0, d0 + kBK);
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[k * kBM + ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&ws[k * kBN + tx * 4]);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(xr[i], wr[j], acc[i][j]);
    }
#pragma unroll
    for (int p = 0; p < kMaxPairs; ++p) {
      const int pi = tid + p * kThreads;
      if (pi < pairs) {
        const int row = pi / r;
        const int rk = pi % r;
        float s = xa[p];
        for (int k = 0; k < kBK; ++k)
          s = __fmaf_rn(xs[k * kBM + row], as[k * r + rk], s);
        xa[p] = s;
      }
    }
    if ((d0 + kBK) % kKC == 0 || d0 + kBK >= D) {  // a chunk ends here
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          base[i][j] = __fadd_rn(base[i][j], acc[i][j]);
          acc[i][j] = 0.f;
        }
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        xa_sum[p] = __fadd_rn(xa_sum[p], xa[p]);
        xa[p] = 0.f;
      }
    }
  }

  // stage x @ A[g] and B[g]'s columns of this tile, then add s * delta
  __syncthreads();  // the walk's last readers are done with its tiles
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int pi = tid + p * kThreads;
    if (pi < pairs) xa_s[(pi / r) * (kMaxR + 1) + pi % r] = xa_sum[p];
  }
  for (int e = tid; e < r * kBN; e += kThreads) {
    const int col = n0 + e % kBN;
    bs[e] = col < F ? to_float(b_g[(size_t)(e / kBN) * F + col]) : 0.f;
  }
  __syncthreads();
  float delta[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) delta[i][j] = 0.f;
  for (int k = 0; k < r; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xv = xa_s[(ty * 4 + i) * (kMaxR + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        delta[i][j] = __fmaf_rn(xv, bs[k * kBN + tx * 4 + j], delta[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= T_) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < F)
        out[(size_t)row * F + col] =
            from_float<T>(__fmaf_rn(scaling, delta[i][j], base[i][j]));
    }
  }
}

// Split path, pass 1: block (column tile, D chunk c, row group).  Each
// thread sums its column over the chunk for the group's kRG rows (rows at
// or past T see x = 0 and are not written); the first column tile's
// blocks also sum the chunk's x @ A[g].  part is (chunks, T, F), xa_part
// (chunks, T, r).
template <typename T>
__global__ void __launch_bounds__(kSN)
batched_lora_kernel_split(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ a,
                          const int* __restrict__ tile_groups,
                          float* __restrict__ part,
                          float* __restrict__ xa_part, int T_, int D, int F,
                          int r, int bt) {
  __shared__ float xs[kKC][kRG + 1];  // x chunk, [k][t], padded
  __shared__ float as[kKC * kMaxR];   // A[g] rows [k][r]
  const int c = blockIdx.y;
  const int k0 = c * kKC;
  const int kn = min(kKC, D - k0);
  const int t0 = blockIdx.z * kRG;
  const int rows = min(kRG, T_ - t0);
  const int tid = threadIdx.x;
  const bool first = blockIdx.x == 0;
  const T* a_g = a + (size_t)tile_groups[t0 / bt] * D * r;
  for (int e = tid; e < kKC * kRG; e += kSN) {
    const int t = e / kKC;
    const int k = e % kKC;
    xs[k][t] = (t < rows && k < kn)
                   ? to_float(x[(size_t)(t0 + t) * D + k0 + k]) : 0.f;
  }
  if (first)
    for (int e = tid; e < kn * r; e += kSN)
      as[e] = to_float(a_g[(size_t)k0 * r + e]);
  __syncthreads();

  const int col = blockIdx.x * kSN + tid;
  if (col < F) {
    float acc[kRG];
#pragma unroll
    for (int t = 0; t < kRG; ++t) acc[t] = 0.f;
    const T* wp = w + (size_t)k0 * F + col;
#pragma unroll 16
    for (int k = 0; k < kn; ++k) {
      const float wv = to_float(wp[(size_t)k * F]);
#pragma unroll
      for (int t = 0; t < kRG; ++t) acc[t] = __fmaf_rn(xs[k][t], wv, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < kRG; ++t)
      if (t < rows) part[((size_t)c * T_ + t0 + t) * F + col] = acc[t];
  }
  if (first) {
    for (int p = tid; p < rows * r; p += kSN) {
      const int t = p / r;
      const int rk = p % r;
      float s = 0.f;
      for (int k = 0; k < kn; ++k) s = __fmaf_rn(xs[k][t], as[k * r + rk], s);
      xa_part[((size_t)c * T_ + t0 + t) * r + rk] = s;
    }
  }
}

// Split path, pass 2: block (column tile, row t).  Adds the chunks'
// partials in order, then y = fma(s, (x @ A) @ B[g], x @ W), rounded once.
template <typename T>
__global__ void __launch_bounds__(kSN)
batched_lora_kernel_sum(const float* __restrict__ part,
                        const float* __restrict__ xa_part,
                        const T* __restrict__ b,
                        const int* __restrict__ tile_groups,
                        T* __restrict__ out, int T_, int F, int r, int chunks,
                        int bt, float scaling) {
  __shared__ float xa_s[kMaxR];
  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid < r) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c)
      s = __fadd_rn(s, xa_part[((size_t)c * T_ + t) * r + tid]);
    xa_s[tid] = s;
  }
  __syncthreads();
  const int col = blockIdx.x * kSN + tid;
  if (col >= F) return;
  const T* b_g = b + (size_t)tile_groups[t / bt] * r * F;
  float base = 0.f;
  for (int c = 0; c < chunks; ++c)
    base = __fadd_rn(base, part[((size_t)c * T_ + t) * F + col]);
  float delta = 0.f;
  for (int k = 0; k < r; ++k)
    delta = __fmaf_rn(xa_s[k], to_float(b_g[(size_t)k * F + col]), delta);
  out[(size_t)t * F + col] = from_float<T>(__fmaf_rn(scaling, delta, base));
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b,
           const int* tile_groups, void* out, float* work, int T_, int D,
           int F, int r, int bt, float scaling, cudaStream_t stream) {
  if (T_ <= kSplitT) {
    const int chunks = (D + kKC - 1) / kKC;
    float* part = work;
    float* xa_part = work + (size_t)chunks * T_ * F;
    const int col_tiles = (F + kSN - 1) / kSN;
    const dim3 grid(col_tiles, chunks, (T_ + kRG - 1) / kRG);
    batched_lora_kernel_split<T><<<grid, kSN, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(a), tile_groups, part, xa_part, T_, D, F, r,
        bt);
    batched_lora_kernel_sum<T><<<dim3(col_tiles, T_), kSN, 0, stream>>>(
        part, xa_part, static_cast<const T*>(b), tile_groups,
        static_cast<T*>(out), T_, F, r, chunks, bt, scaling);
    return (int)cudaGetLastError();
  }
  const dim3 grid((F + kBN - 1) / kBN, (T_ + kBM - 1) / kBM);
  batched_lora_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b), tile_groups,
      static_cast<T*>(out), T_, D, F, r, bt, scaling);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  work: for T <= 256 (the split path),
// ceil(D / 128) * T * (F + r) floats of scratch; unused otherwise.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// or type the kernel does not take (the Python wrapper checks these first
// and raises).
int batched_lora_fwd(const void* x, const void* w, const void* a,
                     const void* b, const void* tile_groups, void* out,
                     void* work, int T, int D, int F, int r, int bt,
                     float scaling, int dtype, void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || r <= 0 || r > kMaxR || bt <= 0 ||
      bt % kBM != 0 || (T + kBM - 1) / kBM > 65535 ||
      (T <= kSplitT && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int* tg = static_cast<const int*>(tile_groups);
  float* ws = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, a, b, tg, out, ws, T, D, F, r, bt, scaling, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, a, b, tg, out, ws, T, D, F, r, bt,
                                 scaling, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
