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
// itself.  Two paths, chosen by the wrapper (split = T <= SPLIT_T in
// kernel.py, set from a measurement of both on the card), and two bodies
// per path, by dtype, all share one summation order:
//
//   order: a row's x @ W and x @ A[g] are sums over D taken in chunks of
//   kKC = 128: each chunk's partial sum starts from 0 and runs in order of
//   d, and the chunks' partials are added in order, starting from 0, with
//   explicit __fadd_rn.  In fp32 a chunk is a chain of __fmaf_rn in order
//   of d.  In bf16 a chunk is eight mma.sync.m16n8k16 steps (bf16 in, fp32
//   accumulate) in order of k from a zero accumulator, k16 steps that lie
//   wholly past D skipped; both paths issue the same instruction on the
//   same 16-deep slices, and an mma's output element depends only on its
//   row of x, its column of W and its accumulator, so it does not matter
//   which tile, warp or lane holds the row.  (That is why both bf16 paths
//   use mma.sync: wgmma is not documented to accumulate in the same
//   internal order, so one path on each would break this.)  (x @ A) @ B[g]
//   is an fp32 chain of r __fmaf_rn, and the output is
//   fma(s, delta, base), rounded once.  So a row gives the same bits
//   whichever path computes it and wherever it sits in its tile: a decode
//   batch and a prefill agree.
//
//   tiled (long prefills), bf16: one block of 8 warps computes a 128 x 128
//   output tile; each warp owns 64 x 32 of it.  The block's two 64-row
//   halves may hold two adapters (bt is a multiple of 64).  Thread 0 keeps
//   a 4-stage ring of loads in flight, 64 deep in D per stage: the x and W
//   tiles by TMA (tensor maps made per call; zero fill past T, D and F;
//   128-byte swizzle, which ldmatrix undoes in its addressing) and A[g]'s
//   rows of each half by a bulk copy (a raw span, so r need not be a
//   multiple of 8), each stage completing on its mbarrier.  No warp spends
//   issue slots on copies: with per-thread cp.async the copies' issue took
//   as long as the mma work and the two ran one after the other (a clock64
//   breakdown on the card).  x is read with ldmatrix, W (row-major
//   (D, F)) with ldmatrix.trans.  The same x fragments feed the down
//   projection: each warp takes its half's m16 tile wn for every rank
//   tile.  The epilogue stages x @ A[g] and B[g]'s columns in shared
//   memory as fp32 and adds s * (x @ A) @ B to each output.
//
//   tiled, fp32: one block of 256 threads computes a 64 x 64 output tile,
//   walking D in steps of 32 staged in shared memory as fp32 with the next
//   step's 16-byte loads in flight in registers; each thread accumulates a
//   4 x 4 block (SIMT) and keeps its rows' x @ A[g] in registers.  TF32
//   tensor cores would lose the fp32 tolerance, so this body stays on the
//   CUDA cores.
//
//   split (decode and short prefills): a 64-row tile would leave most of
//   its rows masked and F / 128 blocks walking all of D leave most of the
//   card idle, so D is split instead.  Pass 1 runs one block per (128
//   columns, D chunk, 16 rows) and writes each row's chunk partial sums to
//   an fp32 workspace; the blocks of the first column tile also write
//   their rows' x @ A[g] partials.  In bf16 each of the block's 4 warps
//   computes 16 rows x 32 columns with mma.sync on x, W and A[g] tiles
//   staged by cp.async in two halves of the chunk; in fp32 each thread
//   sums one column for the 16 rows.  Pass 2 adds the chunks in order and
//   applies the low-rank term.  A 16-row group lies in one row tile, so
//   it has one adapter.  The workspace grows with T
//   (ceil(D / 128) * T * (F + r) floats: 34 MB at T = 256, D = F = 2048).
//
// Bound.  2 * T * D * F flops for the base product (the low-rank terms add
// 2 * T * r * (D + F)) against reading W once (D * F * itemsize bytes),
// x, A, B and writing y.  At decode (T <= 16, D = F = 2048, bf16) reading
// W is 8.4 MB, 2.5 us at 3.35 TB/s: bound by bytes.  At prefill
// (T = 4096) the flops are 34.4 GFLOP, 0.035 ms at 989 TFLOP/s in bf16:
// bound by operations.  mma.sync reaches a fraction of Hopper's wgmma
// peak, and the 32 x 32 warp tiles (kept small because each output needs
// a chunk accumulator beside its running sum) read shared memory once per
// two mma; wgmma fed by TMA, in both paths at once, is the next step.  The
// fp32 body is capped by the CUDA cores' 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16, a 4 x 4 output block each
constexpr int kBM = 64;        // rows per block
constexpr int kBN = 64;        // columns per block
constexpr int kBK = 32;        // depth per step
constexpr int kMaxR = 64;      // LoRA rank
constexpr int kKC = 128;       // D chunk of the summation order
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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using namespace sm90;
constexpr int kPad = 8;          // bf16 row padding: 16 bytes, so the 8 rows
                                 // an ldmatrix reads hit distinct banks
constexpr int kTM = 2 * kBM;     // tiled: rows per block, two 64-row halves
constexpr int kTN = 128;         // tiled: columns per block
constexpr int kTK = 64;          // tiled: depth per ring stage (four k16)
constexpr int kStages = 4;       // tiled: TMA ring depth
constexpr int kTThreads = 256;   // tiled: 2 x 4 warps of 64 x 32 outputs
constexpr int kBox = 64;         // tiled: TMA box width, 128 bytes of bf16
// tiled stage layout, in bytes: the x box (kTM rows x kTK), the two W
// boxes (kTK rows x kBox), and one A[g] span per 64-row half; every TMA
// box is 128 bytes a row with the 128-byte swizzle, so 1024-byte aligned
constexpr int kXBytes = kTM * kTK * 2;
constexpr int kWBytes = kTK * kBox * 2;
constexpr int kASpanBytes = 8320;  // (kTK * kMaxR + 8) bf16, rounded to 128
constexpr int kStageBytes =
    (kXBytes + 2 * kWBytes + 2 * kASpanBytes + 1023) / 1024 * 1024;
constexpr size_t kTiledSmem = (size_t)kStages * kStageBytes + 1024 + 64;
// split path: chunk-deep tiles padded by 16 bytes a row
constexpr int kASpanS = kKC * kMaxR + 8;
constexpr int kSXP = kKC + kPad;  // split: x tile pitch
constexpr int kSWP = kSN + kPad;  // split: W tile pitch
constexpr size_t kSplitSmem =
    (size_t)(kRG * kSXP + kKC * kSWP + kASpanS) * sizeof(bf16);
static_assert(kKC % kTK == 0 && kTK == kBox && 2 * kBox == kTN,
              "a stage is one 128-byte box wide; stages tile the chunks");
static_assert((kTK * kMaxR + 8) * 2 <= kASpanBytes, "the A span fits");
static_assert(kASpanS % 8 == 0 && (kRG * kSXP) % 8 == 0 &&
                  (kKC * kSWP) % 8 == 0,
              "every staged tile starts 16-byte aligned");
static_assert((kTM * (kMaxR + 1) + 2 * kMaxR * kTN) * 4 <=
                  kStages * kStageBytes,
              "the epilogue's fp32 tiles fit in the ring");

// Copy the A[g] rows [d0, d0 + n_rows) as raw 16-byte pieces from the
// aligned address below their first element (a_al = a_g - shift).
__device__ __forceinline__ void stage_a_span(bf16* dst, const bf16* a_al,
                                             int shift, int d0, int n_rows,
                                             int r, int tid, int threads) {
  const int copies = (shift + n_rows * r + 7) / 8;
  for (int c = tid; c < copies; c += threads)
    cp_async16(dst + 8 * c, a_al + (size_t)d0 * r + 8 * c, true);
}

// The B fragment of x @ A[g] for the k16 step at span row kb and rank
// tile nt, from the raw span (element shift + k * r + n); ranks >= r and
// rows at or past D (d_base + k >= D) read as 0.
__device__ __forceinline__ void a_frag(const bf16* span, int shift, int kb,
                                       int nt, int r, int d_base, int D,
                                       int lane, uint32_t& b0, uint32_t& b1) {
  const unsigned short* e = reinterpret_cast<const unsigned short*>(span);
  const int n = nt * 8 + (lane >> 2);
  const int k = kb + 2 * (lane & 3);
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k + (i & 1) + 8 * (i >> 1);
    v[i] = (n < r && d_base + kk < D) ? e[shift + kk * r + n] : 0u;
  }
  b0 = v[0] | (v[1] << 16);
  b1 = v[2] | (v[3] << 16);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a box whose rows are
// 128 bytes, written by TMA with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return swizzled<128>(row * 128 + chunk * 16);
}

// Tiled path, bf16: one block per 128 x 128 output tile, 8 warps of
// 64 x 32.  Thread 0 keeps a kStages-deep ring of TMA loads in flight (x
// and W boxes, zero-filled past T, D and F, plus one A[g] span per 64-row
// half as a bulk copy), each stage signalled by its mbarrier, so the warps
// spend no issue slots on copies.  The block's two 64-row halves may hold
// two adapters (bt is a multiple of 64).  Warp (wm, wn) also computes the
// down projection of its half's m16 tile wn for every rank tile (RT of
// them at most: r <= 8 * RT).
template <int RT>
__global__ void __launch_bounds__(kTThreads, 1)
batched_lora_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const bf16* __restrict__ a, const bf16* __restrict__ b,
                       const int* __restrict__ tile_groups,
                       bf16* __restrict__ out, int T_, int D, int F, int r,
                       int bt, float scaling) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * kTM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> 2;  // rows 64 * wm .. (half wm)
  const int wn = warp & 3;   // columns 32 * wn ..; rank rows 16 * wn ..
  const int halves = m0 + kBM < T_ ? 2 : 1;
  const bf16* a_g[2];
  const bf16* b_g[2];
  int shift[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = tile_groups[(m0 + kBM * (h < halves ? h : 0)) / bt];
    a_g[h] = a + (size_t)g * D * r;
    b_g[h] = b + (size_t)g * r * F;
    shift[h] = (int)(((uintptr_t)a_g[h] & 15) >> 1);
  }
  const int my_shift = wm ? shift[1] : shift[0];
  const int steps = (D + kTK - 1) / kTK;
  const int r_tiles = (r + 7) / 8;

  auto issue = [&](int step) {  // thread 0 only
    unsigned char* st = ring + (step % kStages) * kStageBytes;
    uint64_t* bar = full + step % kStages;
    const int d0 = step * kTK;
    const int n_rows = min(kTK, D - d0);
    uint32_t span[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < halves) span[h] = (shift[h] + n_rows * r + 7) / 8 * 16;
    mbar_expect_tx(bar, kXBytes + 2 * kWBytes + span[0] + span[1]);
    tma_load_2d(st, &x_map, d0, m0, bar);
    tma_load_2d(st + kXBytes, &w_map, n0, d0, bar);
    tma_load_2d(st + kXBytes + kWBytes, &w_map, n0 + kBox, d0, bar);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < halves)
        bulk_load(st + kXBytes + 2 * kWBytes + h * kASpanBytes,
                  a_g[h] - shift[h] + (size_t)d0 * r, span[h], bar);
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(full + st, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int st = 0; st < kStages - 1 && st < steps; ++st) issue(st);

  // acc / xa: the current D chunk's partial sums; base / xa_sum: the
  // chunks done so far, added in order
  float acc[4][4][4], base[4][4][4], xa[RT][4], xa_sum[RT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = base[i][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xa[j][e] = xa_sum[j][e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    mbar_wait(full + step % kStages, (step / kStages) & 1);
    __syncthreads();  // every warp is done with the previous step's stage
    if (tid == 0 && step + kStages - 1 < steps) {
      fence_proxy_async();
      issue(step + kStages - 1);  // into the stage the previous step read
    }
    __syncwarp();  // warp 0 reconverges before its ldmatrix
    const unsigned char* xs = ring + (step % kStages) * kStageBytes;
    const unsigned char* ws = xs + kXBytes + (wn >> 1) * kWBytes;
    const bf16* as = reinterpret_cast<const bf16*>(xs + kXBytes + 2 * kWBytes +
                                                   wm * kASpanBytes);
    const int d0 = step * kTK;
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      if (d0 + kk * 16 >= D) break;  // wholly past D: skipped in both paths
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + (lane & 15);
        ldsm_x4(af[mi], xs + swz(row, kk * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bw[4];
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(bw, ws + swz(row, (wn & 1) * 4 + np * 2 + (lane >> 4)));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bw[0], bw[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bw[2], bw[3]);
        }
      }
      uint32_t ax[4];  // x rows of this warp's down-projection tile
      {
        const int row = wm * 64 + wn * 16 + (lane & 15);
        ldsm_x4(ax, xs + swz(row, kk * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int nt = 0; nt < RT; ++nt) {
        if (nt < r_tiles) {
          uint32_t b0, b1;
          a_frag(as, my_shift, kk * 16, nt, r, d0, D, lane, b0, b1);
          mma_bf16(xa[nt], ax, b0, b1);
        }
      }
    }
    if ((d0 + kTK) % kKC == 0 || d0 + kTK >= D) {  // a chunk ends here
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            base[i][j][e] = __fadd_rn(base[i][j][e], acc[i][j][e]);
            acc[i][j][e] = 0.f;
          }
#pragma unroll
      for (int j = 0; j < RT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xa_sum[j][e] = __fadd_rn(xa_sum[j][e], xa[j][e]);
          xa[j][e] = 0.f;
        }
    }
  }

  // stage x @ A[g] and each half's B[g] columns of this tile, then add
  // s * delta
  __syncthreads();  // the ring's last readers are done (every load landed)
  float* xa_s = reinterpret_cast<float*>(ring);  // [kTM][kMaxR + 1]
  float* bs = xa_s + kTM * (kMaxR + 1);          // [2][r][kTN]
#pragma unroll
  for (int nt = 0; nt < RT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wm * 64 + wn * 16 + gid + 8 * (e >> 1);
      const int rk = nt * 8 + 2 * tig + (e & 1);
      if (rk < r) xa_s[row * (kMaxR + 1) + rk] = xa_sum[nt][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h >= halves) continue;
    for (int e = tid; e < r * kTN; e += kTThreads) {
      const int col = n0 + e % kTN;
      bs[h * kMaxR * kTN + e] =
          col < F ? __bfloat162float(b_g[h][(size_t)(e / kTN) * F + col]) : 0.f;
    }
  }
  __syncthreads();
  const float* bh = bs + wm * kMaxR * kTN;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row_l = wm * 64 + mi * 16 + gid + 8 * h;
      if (m0 + row_l >= T_) continue;
      const float* xr = xa_s + row_l * (kMaxR + 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col_l = wn * 32 + j * 8 + 2 * tig;
        if (n0 + col_l >= F) continue;  // F % 8 == 0: col + 1 < F too
        float d0 = 0.f, d1 = 0.f;
        for (int k = 0; k < r; ++k) {
          d0 = __fmaf_rn(xr[k], bh[k * kTN + col_l], d0);
          d1 = __fmaf_rn(xr[k], bh[k * kTN + col_l + 1], d1);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + (size_t)(m0 + row_l) * F + n0 + col_l) =
            __floats2bfloat162_rn(__fmaf_rn(scaling, d0, base[mi][j][2 * h]),
                                  __fmaf_rn(scaling, d1, base[mi][j][2 * h + 1]));
      }
    }
}

// Split path, pass 1, bf16: block (column tile, D chunk c, row group) of
// 4 warps, each 16 rows x 32 columns; the first column tile's blocks also
// compute the rows' x @ A[g] chunk partial (rank tiles warp, warp + 4).
// The chunk is staged in two cp.async groups of 64 rows so the first
// half's products start while the second half lands.
__global__ void __launch_bounds__(kSN)
batched_lora_split_tc_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ w,
                             const bf16* __restrict__ a,
                             const int* __restrict__ tile_groups,
                             float* __restrict__ part,
                             float* __restrict__ xa_part, int T_, int D,
                             int F, int r, int bt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kRG][kSXP]
  bf16* ws = xs + kRG * kSXP;                    // [kKC][kSWP]
  bf16* as = ws + kKC * kSWP;                    // raw span
  const int c = blockIdx.y;
  const int k0 = c * kKC;
  const int kn = min(kKC, D - k0);
  const int t0 = blockIdx.z * kRG;
  const int rows = min(kRG, T_ - t0);
  const int col0 = blockIdx.x * kSN;
  const bool first = blockIdx.x == 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const bf16* a_g = a + (size_t)tile_groups[t0 / bt] * D * r;
  const int shift = (int)(((uintptr_t)a_g & 15) >> 1);
  const int r_tiles = (r + 7) / 8;

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kh = half * (kKC / 2);
    for (int e = tid; e < kRG * (kKC / 16); e += kSN) {
      const int t = e / (kKC / 16);
      const int col = kh + (e % (kKC / 16)) * 8;
      const bool ok = t < rows && col < kn;
      cp_async16(xs + t * kSXP + col,
                 ok ? x + (size_t)(t0 + t) * D + k0 + col : x, ok);
    }
    for (int e = tid; e < (kKC / 2) * (kSN / 8); e += kSN) {
      const int row = kh + e / (kSN / 8);
      const int col = (e % (kSN / 8)) * 8;
      const bool ok = row < kn && col0 + col < F;
      cp_async16(ws + row * kSWP + col,
                 ok ? w + (size_t)(k0 + row) * F + col0 + col : w, ok);
    }
    if (half == 0 && first)
      stage_a_span(as, a_g - shift, shift, k0, kn, r, tid, kSN);
    cp_async_commit();
  }

  float acc[4][4], xa[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xa[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKC / 16; ++kk) {
    if (kk == 0) cp_async_wait<1>();
    if (kk == kKC / 32) cp_async_wait<0>();
    if (kk == 0 || kk == kKC / 32) __syncthreads();
    if (kk * 16 >= kn) break;  // wholly past D: skipped in both paths
    uint32_t af[4];
    ldsm_x4(af, xs + (lane & 15) * kSXP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bw[4];
      ldsm_x4_t(bw, ws + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kSWP +
                        warp * 32 + np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], af, bw[0], bw[1]);
      mma_bf16(acc[2 * np + 1], af, bw[2], bw[3]);
    }
    if (first) {
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int nt = warp + 4 * sl;
        if (nt < r_tiles) {
          uint32_t b0, b1;
          a_frag(as, shift, kk * 16, nt, r, k0, D, lane, b0, b1);
          mma_bf16(xa[sl], af, b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (kn <= 64 skips half 1)

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + warp * 32 + j * 8 + 2 * tig;
    if (col >= F) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = gid + 8 * h;
      if (t < rows)
        *reinterpret_cast<float2*>(part + ((size_t)c * T_ + t0 + t) * F + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  if (first) {
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = gid + 8 * (e >> 1);
        const int rk = (warp + 4 * sl) * 8 + 2 * tig + (e & 1);
        if (t < rows && rk < r)
          xa_part[((size_t)c * T_ + t0 + t) * r + rk] = xa[sl][e];
      }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b,
           const int* tile_groups, void* out, float* work, int T_, int D,
           int F, int r, int bt, float scaling, bool split,
           cudaStream_t stream) {
  constexpr bool tc = sizeof(T) == 2;  // bf16: the tensor-core bodies
  if (split) {
    const int chunks = (D + kKC - 1) / kKC;
    float* part = work;
    float* xa_part = work + (size_t)chunks * T_ * F;
    const int col_tiles = (F + kSN - 1) / kSN;
    const dim3 grid(col_tiles, chunks, (T_ + kRG - 1) / kRG);
    if constexpr (tc) {
      static bool configured = false;
      const cudaError_t err =
          allow_smem(batched_lora_split_tc_kernel, kSplitSmem, configured);
      if (err != cudaSuccess) return (int)err;
      batched_lora_split_tc_kernel<<<grid, kSN, kSplitSmem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<const bf16*>(a), tile_groups, part, xa_part, T_, D, F,
          r, bt);
    } else {
      batched_lora_kernel_split<T><<<grid, kSN, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const T*>(a), tile_groups, part, xa_part, T_, D, F, r,
          bt);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    batched_lora_kernel_sum<T><<<dim3(col_tiles, T_), kSN, 0, stream>>>(
        part, xa_part, static_cast<const T*>(b), tile_groups,
        static_cast<T*>(out), T_, F, r, chunks, bt, scaling);
    return (int)cudaGetLastError();
  }
  if constexpr (tc) {
    CUtensorMap x_map, w_map;  // x (T, D) and W (D, F), 128-byte boxes
    const cuuint64_t x_dims[2] = {(cuuint64_t)D, (cuuint64_t)T_};
    const cuuint64_t w_dims[2] = {(cuuint64_t)F, (cuuint64_t)D};
    const cuuint64_t x_stride[1] = {(cuuint64_t)D * sizeof(bf16)};
    const cuuint64_t w_stride[1] = {(cuuint64_t)F * sizeof(bf16)};
    const cuuint32_t x_box[2] = {kTK, kTM}, w_box[2] = {kBox, kTK};
    cudaError_t err = encode_map(&x_map, x, 2, x_dims, x_stride, x_box);
    if (err == cudaSuccess)
      err = encode_map(&w_map, w, 2, w_dims, w_stride, w_box);
    if (err != cudaSuccess) return (int)err;
    // two instantiations: ranks to 16 (the serving path's 8) keep fewer
    // down-projection accumulators in registers than ranks to 64
    const auto kernel = r <= 16 ? batched_lora_tc_kernel<2>
                                : batched_lora_tc_kernel<kMaxR / 8>;
    static bool configured[2] = {false, false};
    err = allow_smem(kernel, kTiledSmem, configured[r <= 16 ? 0 : 1]);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((F + kTN - 1) / kTN, (T_ + kTM - 1) / kTM);
    kernel<<<grid, kTThreads, kTiledSmem, stream>>>(
        x_map, w_map, static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        tile_groups, static_cast<bf16*>(out), T_, D, F, r, bt, scaling);
  } else {
    const dim3 grid((F + kBN - 1) / kBN, (T_ + kBM - 1) / kBM);
    batched_lora_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(a), static_cast<const T*>(b), tile_groups,
        static_cast<T*>(out), T_, D, F, r, bt, scaling);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  split: 1 takes the split-D path (the
// wrapper's choice, T <= SPLIT_T), which needs work: ceil(D / 128) * T *
// (F + r) floats of scratch; unused otherwise.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape or type the
// kernel does not take (the Python wrapper checks these first and raises).
int batched_lora_fwd(const void* x, const void* w, const void* a,
                     const void* b, const void* tile_groups, void* out,
                     void* work, int T, int D, int F, int r, int bt,
                     float scaling, int split, int dtype, void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || r <= 0 || r > kMaxR || bt <= 0 ||
      bt % kBM != 0 || (T + kBM - 1) / kBM > 65535 ||
      (split && ((T + kRG - 1) / kRG > 65535 || work == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int* tg = static_cast<const int*>(tile_groups);
  float* ws = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, a, b, tg, out, ws, T, D, F, r, bt, scaling,
                         split != 0, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, a, b, tg, out, ws, T, D, F, r, bt,
                                 scaling, split != 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
