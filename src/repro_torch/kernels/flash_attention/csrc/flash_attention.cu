// Flash attention forward (GQA, causal or not, with an optional sliding
// window) for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:73
// flash_attention_fwd (the Pallas body _flash_kernel): fp32 online softmax,
// the scale applied after the q.k dot, masked scores at NEG_INF = -1e30,
// the denominator clamped at 1e-30, and, when causal, KV tiles that lie
// wholly above the diagonal skipped.  The sliding window is the reference
// prefill's (src/repro/models/layers.py causal_attention(window=W), which
// the Pallas kernel does not take): with W > 0, causal only, row i keeps
// key j iff i - W < j <= i, and KV tiles that lie wholly before a query
// tile's window are skipped too.
//
// Layouts: q (B, Hq, S, hd), k/v (B, KVH, S, hd), out (B, Hq, S, hd), each
// given by its element strides over (batch, head, position) with the last
// dimension contiguous, so the serving path's (B, S, H, hd) tensors are
// read through transposed views with no copy.  Rows must start 16-byte
// aligned (the wrapper checks base addresses and strides).  Query head
// kvh * G + g reads KV head kvh (G = Hq / KVH).  float32 or bfloat16, the
// same for all four tensors.  Head dims 32, 64, 80, 128 and 160.
//
// Design.  The TPU grid (B, Hq, S/bq, S/bk) carried m/l/acc across its
// sequential kv axis in VMEM.  Here one thread block per (batch, KV head,
// query tile) walks the KV tiles itself.  A query tile is kRows = 64 query
// rows drawn from P = 64 / G consecutive positions times all G query heads
// of the KV head, so every K/V tile staged in shared memory serves the G
// heads at once.  The block walks fixed 64-key tiles, from tile 0 or,
// under a window, from the tile holding its first row's first key
// (max(0, q0 - W + 1) / 64), to the causal end, and writes its output once.
// Tiles are launched heaviest first (the causal diagonal's far end); under
// a window every tile past the first W positions does the same work, so
// that order is only approximate there.  The two dtypes take two bodies:
//
//   bfloat16, tensor cores (the serving dtype).  Four warps, each owning
//   16 of the 64 query rows.  The q tile is staged once in shared memory
//   by 16-byte cp.async copies, rows padded by 16 bytes so ldmatrix reads
//   no bank twice.  K and V tiles come by TMA into a two-stage ring of
//   bf16 tiles: thread 0 asks for the next tile (4-D tensor maps over the
//   strided (B, KVH, S, hd) views, made per call; zero fill past S; boxes
//   of 64, 32 or 16 columns that cover hd exactly, each with the 128-, 64-
//   or 32-byte swizzle of its row width, which ldmatrix undoes in its
//   addressing) and
//   the tile completes on its stage's mbarrier, so no warp stalls on
//   issuing copies before its products, as it did with per-thread
//   cp.async (a clock64 breakdown on the card).  A warp loads
//   its q fragments once; per KV tile it computes its 16 x 64
//   scores with mma.sync m16n8k16 (bf16 in, fp32 accumulate, K read by
//   ldmatrix), masks (only tiles that reach past S or a row's position, or
//   whose first key lies before the window of the tile's last row) and
//   scales them, and runs the online softmax on the accumulator
//   fragments in registers (row max and sum over the quad of lanes that
//   share a row; exp by the hardware's ex2, __expf).  P goes from the
//   score registers straight into the A fragments of P @ V, with V read
//   by ldmatrix.trans.  P is not rounded to bf16: each P fragment is split
//   into a bf16 pair, hi = bf16(p) and lo = bf16(p - hi), and both go
//   through the tensor cores, so P @ V keeps p to about 2^-17 and the
//   output is still rounded once, at the end, like the plain version's
//   fp32 P (the price is a third more tensor-core work).
//
//   float32, CUDA cores (SIMT).  Each of the 128 threads computes an
//   8 x 4 block of scores from fp32 tiles in shared memory, the rows' max
//   and sum are reduced over the 16 lanes that share them, P is kept in
//   fp32 in shared memory, and each thread accumulates an 8 x (hd / 16)
//   block of P @ V in registers.  TF32 tensor cores would lose the fp32
//   tolerance, so this route stays on the CUDA cores.
//
// Any S.  Unlike the Pallas kernel (S % bq == 0), positions at or past S
// are masked (keys) or not written (queries).  KV tiles are fixed 64-key
// tiles from position 0 and the query tiles fixed P-position tiles from 0;
// a block's first tile depends on its q0 and W alone, and a row's products
// and sums run in an order fixed by those tiles alone.  Masked keys give
// p = 0 exactly: exp(-1e30 - m) underflows to 0 once the row has kept a
// key, and a row that has kept none yet (m still -1e30, as under a window
// the first walked tile can be for the rows whose window starts a tile
// later than the first row's) takes its exponentials against 0 instead of
// m, so they underflow too (p = 0, alpha = 1).  So a tile wholly masked for
// a row leaves its m, l and acc unchanged, and a prefill of a prefix at
// its unpadded length gives bitwise the rows that a longer, padded prefill
// gives for the same positions, in either dtype and with or without a
// window (the serving engine relies on this when it recomputes a preempted
// request's KV at readmission).
//
// Bound.  The work is 4 * B * Hq * hd flops per query-key pair kept (both
// products): S * (S + 1) / 2 pairs when causal, sum_i min(i + 1, W) under a
// window, over 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (fp32 CUDA
// cores).  At B = 4, S = 2048 and TinyLlama's heads (Hq = 32, hd = 64) that
// is 68.7 GFLOP, 0.069 ms in bf16, and the q/k/v/o bytes (75 MB, 0.023 ms
// at 3.35 TB/s) are less, so prefill sizes are bound by operations.  At
// B = 1, S = 8192, W = 4096 and mixtral-8x22b's heads (Hq = 48, hd = 128)
// it is 0.62 TFLOP (25.2 M pairs, 0.75 of causal), 0.625 ms.  Past the
// first window a block walks at most (W + P - 1) / 64 + 2 tiles of 64 keys
// for rows that keep W keys each, so the kernel does the window's work,
// not causal work, up to the masked parts of its edge tiles.  The bf16
// body issues mma.sync, whose peak on Hopper is below wgmma's, its softmax
// runs between the two products on the same warps, and each warp reads
// the whole K/V tile from shared memory for its 16 rows; wgmma with warp
// specialisation, where the softmax of one tile overlaps the products of
// the next, is the next step toward the bound.  The fp32 body is capped by
// the CUDA cores' 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/sm90.cuh"

namespace {

constexpr int kThreads = 128;  // 8 row groups x 16 lanes
constexpr int kRows = 64;      // query rows per block: positions x G heads
constexpr int kKeys = 64;      // keys per KV tile
constexpr int kRowsPer = 8;    // rows per thread (kRows / 8 row groups)
constexpr int kKeysPer = 4;    // scores per row per thread (kKeys / 16)
constexpr float kNegInf = -1e30f;

// the fp32 body's conversions (T = float: the bf16 route is below)
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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
                       Strides vs, Strides os, float sm_scale, int causal,
                       int window) {
  constexpr int kQP = HD + 1;      // padded pitch of q and k rows
  constexpr int kDPer = HD / 16;   // output dims per thread
  static_assert(HD % 16 == 0, "16 lanes share a row's output dims");
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
  // under a window, from the KV tile that holds the first row's first key
  const int kv_begin = window ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kKeys) {
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
        const bool keep = row_ok[i] && kp < S &&
                          (!causal || (kp <= row_pos[i] &&
                                       (!window || kp > row_pos[i] - window)));
        s[i][c] = keep ? s[i][c] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      // no key kept yet: every score is kNegInf, and exp(s - 0) = 0
      const float m_use = m_new == kNegInf ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const float p = expf(s[i][c] - m_use);
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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using namespace sm90;
constexpr int kWarps = kThreads / 32;  // 16 query rows each
constexpr int kPad = 8;  // bf16 row padding: 16 bytes, so the 8 rows an
                         // ldmatrix reads fall in 8 distinct bank groups
static_assert(kWarps * 16 == kRows, "one m16 row tile per warp");

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (x0, x1) -> the bf16 pairs hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                                 x1 - __high2float(h));
  hi = pack_bf16(h.x, h.y);
  lo = pack_bf16(l.x, l.y);
}

// bf16 staging: K and V tiles of kKeys rows by TMA in boxes kBoxW(HD)
// elements wide, the widest of 64, 32 and 16 that divides HD (128-, 64- or
// 32-byte rows, swizzled to match: hd 80 takes five boxes of 16, hd 160
// five of 32), a two-stage ring each completing on its mbarrier; the q
// tile once by cp.async, rows padded by 16 bytes.
template <int HD>
constexpr int kBoxW = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
// the boxes cover every column of a row: a head dim that no box width
// divides would otherwise leave its last columns unstaged
template <int HD>
constexpr bool kBoxesCover = HD % 16 == 0 && HD / kBoxW<HD> * kBoxW<HD> == HD;
template <int HD>
constexpr int kTileBytes = kKeys * HD * (int)sizeof(bf16);  // K or V tile
template <int HD>
constexpr int kQOffset = 4 * kTileBytes<HD>;  // after two stages of K, V
template <int HD>
constexpr int tc_smem_bytes() {  // 1024 of slack to align the ring
  return 1024 + kQOffset<HD> + kRows * (HD + kPad) * (int)sizeof(bf16) + 16;
}

// Byte offset of 16-byte chunk c (of HD / 8) of row j in a K or V tile
template <int HD>
__device__ __forceinline__ uint32_t kv_off(int j, int c) {
  constexpr int kChunks = kBoxW<HD> / 8;  // chunks per box row
  return (c / kChunks) * (kKeys * kBoxW<HD> * 2) +
         swizzled<kBoxW<HD> * 2>(j * kBoxW<HD> * 2 + (c % kChunks) * 16);
}

// No __launch_bounds__: with it ptxas held hd = 64 to 128 registers and
// spilled, and the kernel ran 1-15% slower on the card.
template <int HD>
__global__ void flash_attention_tc_kernel(
    const bf16* __restrict__ q, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out, int S,
    int G, int P, Strides qs, Strides os, float sm_scale, int causal,
    int window) {
  constexpr int kPitch = HD + kPad;      // q tile row pitch
  constexpr int kChunks = HD / 8;        // 16-byte pieces per row
  constexpr int kKS = HD / 16;           // k16 steps of q . k
  constexpr int kDT = HD / 8;            // n8 tiles of the output
  constexpr int kNT = kKeys / 8;         // n8 tiles of the scores
  constexpr int kBoxes = HD / kBoxW<HD>;
  static_assert(kBoxesCover<HD>, "the TMA boxes must cover the head dim");
  static_assert(kKS * 16 == HD && kDT % 2 == 0,
                "the k16 steps and the n8 pairs must cover the head dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(ring + kQOffset<HD>);  // [kRows][kPitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + kQOffset<HD> + kRows * kPitch * (int)sizeof(bf16));

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // fragment row (and row + 8)
  const int tig = lane & 3;   // fragment column pair
  const int rows = P * G;     // <= kRows
  const int q0 = qt * P;      // first position of the tile
  const int last = min(S - 1, q0 + P - 1);
  const int kv_end = causal ? last + 1 : S;
  // under a window, from the KV tile that holds the first row's first key
  const int t_lo = window ? max(0, q0 - window + 1) / kKeys : 0;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys - t_lo;

  auto issue = [&](int it) {  // thread 0 only: K and V of walk step it
    const int tile = t_lo + it;
    unsigned char* st = ring + (it & 1) * 2 * kTileBytes<HD>;
    uint64_t* bar = full + (it & 1);
    mbar_expect_tx(bar, 2 * kTileBytes<HD>);
#pragma unroll
    for (int i = 0; i < kBoxes; ++i) {
      const int off = i * kKeys * kBoxW<HD> * 2;
      tma_load_4d(st + off, &k_map, i * kBoxW<HD>, tile * kKeys, kvh, b, bar);
      tma_load_4d(st + kTileBytes<HD> + off, &v_map, i * kBoxW<HD>,
                  tile * kKeys, kvh, b, bar);
    }
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_init_fence();
  }
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int x = (c % kChunks) * 8;
    const int pos = q0 + r / G;
    const bool ok = r < rows && pos < S;
    cp_async16(q_s + r * kPitch + x,
               ok ? q + b * qs.b + (long long)(kvh * G + r % G) * qs.h +
                        (long long)pos * qs.s + x
                  : q,
               ok);
  }
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  if (tid == 0) issue(0);
  cp_async_wait<0>();
  __syncthreads();  // the q tile landed

  // this thread's two rows: fragment rows gid and gid + 8 of the warp's 16
  int pos[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gid + 8 * h;
    pos[h] = q0 + r / G;
    ok[h] = r < rows && pos[h] < S;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
    ldsm_x4(qf[kk],
            q_s + (warp * 16 + (lane & 15)) * kPitch + kk * 16 + (lane >> 4) * 8);

  for (int it = 0; it < n_tiles; ++it) {
    if (tid == 0 && it + 1 < n_tiles) {
      fence_proxy_async();
      issue(it + 1);  // into the stage the previous tile read
    }
    __syncwarp();  // warp 0 reconverges before its ldmatrix
    mbar_wait(full + (it & 1), (it >> 1) & 1);
    const unsigned char* kt = ring + (it & 1) * 2 * kTileBytes<HD>;
    const unsigned char* vt = kt + kTileBytes<HD>;

    // scores: 16 rows x 64 keys, the k16 steps over hd in order
    float s[kNT][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + kv_off<HD>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                    kk * 2 + ((lane >> 3) & 1)));
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // online softmax on the fragments, fp32.  A tile below every row's
    // position, inside S and, under a window, inside the window of the
    // tile's last row (so of every row) needs no mask: it keeps every key
    // of every valid row (rows not written see zeros from their
    // zero-filled q).
    const int k0 = (t_lo + it) * kKeys;
    const bool interior =
        k0 + kKeys <= S &&
        (!causal || (k0 + kKeys - 1 <= q0 && (!window || k0 > last - window)));
    float mx[2] = {kNegInf, kNegInf};
    if (interior) {
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] *= sm_scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
        }
    } else {
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int kp = k0 + t * 8 + 2 * tig + (e & 1);
          const bool keep = ok[h] && kp < S &&
                            (!causal || (kp <= pos[h] &&
                                         (!window || kp > pos[h] - window)));
          s[t][e] = keep ? s[t][e] * sm_scale : kNegInf;
          mx[h] = fmaxf(mx[h], s[t][e]);
        }
    }
    float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = __expf(m[h] - m_new);
      m[h] = m_new;
      // no key kept yet: every score is kNegInf, and exp(s - 0) = 0
      m_use[h] = m_new == kNegInf ? 0.f : m_new;
    }
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = __expf(s[t][e] - m_use[e >> 1]);
        sum[e >> 1] += s[t][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // o += P @ V: per 16 keys, P's hi and lo fragments from the scores
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vt + kv_off<HD>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                      dp * 2 + (lane >> 4)));
        mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
    const int r = warp * 16 + gid + 8 * h;
    const float inv_l = 1.f / fmaxf(l[h], 1e-30f);
    bf16* dst = out + b * os.b + (long long)(kvh * G + r % G) * os.h +
                (long long)pos[h] * os.s + 2 * tig;
#pragma unroll
    for (int t = 0; t < kDT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8) = __floats2bfloat162_rn(
          o[t][2 * h] * inv_l, o[t][2 * h + 1] * inv_l);
  }
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int B, int KVH, int S, int G, Strides qs, Strides ks, Strides vs,
           Strides os, float sm_scale, int causal, int window,
           cudaStream_t stream) {
  const int P = kRows / G;
  const dim3 grid((S + P - 1) / P, KVH, B);
  if (dtype == 1) {
    // K and V as 4-D tensors (hd, S, KVH, B) over their strided views
    CUtensorMap k_map, v_map;
    const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)S,
                                (cuuint64_t)KVH, (cuuint64_t)B};
    const cuuint64_t k_str[3] = {(cuuint64_t)ks.s * 2, (cuuint64_t)ks.h * 2,
                                 (cuuint64_t)ks.b * 2};
    const cuuint64_t v_str[3] = {(cuuint64_t)vs.s * 2, (cuuint64_t)vs.h * 2,
                                 (cuuint64_t)vs.b * 2};
    const cuuint32_t box[4] = {kBoxW<HD>, kKeys, 1, 1};
    cudaError_t err = encode_map(&k_map, k, 4, dims, k_str, box);
    if (err == cudaSuccess) err = encode_map(&v_map, v, 4, dims, v_str, box);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = tc_smem_bytes<HD>();
    static bool configured = false;
    err = allow_smem(flash_attention_tc_kernel<HD>, smem, configured);
    if (err != cudaSuccess) return (int)err;
    flash_attention_tc_kernel<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), k_map, v_map, static_cast<bf16*>(out), S,
        G, P, qs, os, sm_scale, causal, window);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_floats<HD>() * sizeof(float);
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_attention_kernel<float, HD>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<float, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, G, P, qs, ks,
      vs, os, sm_scale, causal, window);
  return (int)cudaGetLastError();
}

int dispatch_hd(int hd, int dtype, const void* q, const void* k,
                const void* v, void* out, int B, int KVH, int S, int G,
                Strides qs, Strides ks, Strides vs, Strides os,
                float sm_scale, int causal, int window,
                cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32>(dtype, q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                        sm_scale, causal, window, stream);
    case 64:
      return launch<64>(dtype, q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                        sm_scale, causal, window, stream);
    case 80:
      return launch<80>(dtype, q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                        sm_scale, causal, window, stream);
    case 128:
      return launch<128>(dtype, q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                         sm_scale, causal, window, stream);
    case 160:
      return launch<160>(dtype, q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                         sm_scale, causal, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, over
// (batch, head, position); the head dimension is contiguous.  window: 0 for
// none, else W > 0 with causal (row i keeps keys i - W < j <= i).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape or type the kernel does not take (the Python wrapper checks these
// first and raises).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int B, int Hq, int KVH, int S, int hd,
                        long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss,
                        float sm_scale, int causal, int window, int dtype,
                        void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || Hq % KVH != 0 || Hq / KVH > kRows ||
      B > 65535 || KVH > 65535 || window < 0 || (window > 0 && !causal)) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = Hq / KVH;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return dispatch_hd(hd, dtype, q, k, v, out, B, KVH, S, G, qs, ks, vs, os,
                     sm_scale, causal, window,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
