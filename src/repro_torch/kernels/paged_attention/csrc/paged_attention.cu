// Paged decode attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_attention
// (the Pallas body _paged_kernel) together with the jnp one-token page
// scatter of src/repro/kernels/paged_attention/ops.py::paged_decode_step,
// which the reference lowers into the same computation under its jit:
// one-token GQA attention over a paged KV pool, online softmax in fp32,
// positions >= seq_len masked, scale 1/sqrt(hd), the denominator clamped at
// 1e-30.
//
// Layouts (all contiguous):
//   q            (B, Hq, hd)                 float or bf16
//   k/v pages    (P, page_size, KVH, hd)     same type as q
//   block_tables (B, pages_per_seq)          int32
//   seq_lens     (B,)                        int32 (attend only)
//   k/v new      (B, KVH, hd)                same type as q (fused step)
//   kv_len       (B,)                        int32 (fused step)
//   out          (B, Hq, hd)                 same type as q
// Query head kvh * G + g reads KV head kvh (G = Hq / KVH <= 16).  Head dims
// 32, 64, 80, 128 and 160.
//
// Two modes, one kernel.  Attend only: attend over seq_lens[b] positions.
// Fused decode step: first store the new token's k/v row at position
// kv_len[b] (page block_tables[b, kv_len / page_size], slot
// kv_len % page_size, in place), then attend over kv_len[b] + 1 positions.
// Only the block whose split holds kv_len[b] touches that slot: it stores
// the row to the page and puts the same bits into its shared-memory tile
// instead of reading the slot back, so there is no race and no grid-wide
// barrier.
//
// Design.  The TPU grid (B, KVH, pages) carried m/l/acc across its
// sequential page axis.  Here the grid is (KVH, B, n_splits): each block
// attends over one split, a fixed run of split_tokens positions starting
// at split * split_tokens (flash-decoding), so a decode batch of a few
// sequences still fills the card's 132 SMs.  n_splits comes from the
// table's width (the host reads no lengths); a block whose split starts at
// or past seq_len exits at once.  Each block writes its split's fp32
// partial (m, l, acc[G, hd]) to a workspace and bumps a per-(b, KV head)
// counter; the block that brings the counter to the row's number of live
// splits rescales the partials by their maxima, sums them in split order,
// writes the output and sets the counter back to 0 for the next launch.
// A row with one live split writes its output directly.  Split boundaries
// are fixed positions and every sum runs in a fixed order, so a row's bits
// depend only on its own q, K/V and seq_len: not on B, the table's width
// or the other rows.  Positions are addressed one by one (any page_size),
// and each thread reads only the table entries of positions below seq_len,
// so entries past them (trash page 0 in the serving engine) are never read.
// The two dtypes take two bodies:
//
//   bfloat16, tensor cores (the serving dtype).  Four warps; a 64-position
//   tile gives each warp 16 keys.  The split's page ids are read once into
//   shared memory, so no copy waits on a table read; K/V rows are staged
//   in bf16 by 16-byte cp.async copies into a three-stage ring of tiles
//   (rows padded by 16 bytes so ldmatrix reads no bank twice), so two
//   tiles are in flight while one is computed.  The G query rows, padded to 16 with zeros, are
//   the A operand of mma.sync m16n8k16 for q.k^T (K read by ldmatrix; at
//   G = 1, zamba2's shared attention, 15 of the 16 rows are padding, which
//   wastes tensor-core work, not bytes);
//   each warp runs its own online softmax on the accumulator fragments
//   (p = expf(s - m)), and P @ V takes P as a bf16 hi/lo pair,
//   hi = bf16(p), lo = bf16(p - hi), so P keeps about 2^-17 and the output
//   is rounded once, at the end, like the fp32 plain version's.  After the
//   split the four warps' (m, l, acc) are merged in warp order.
//
//   float32, CUDA cores.  The body of the first port of this kernel: 32-
//   token tiles staged as fp32 in (dynamic) shared memory, all 16-byte
//   loads of a tile issued before any is used, scores and P @ V from
//   shared memory.
//   TF32 tensor cores would lose the fp32 tolerance.
//
// Bound.  The kernel must read sum_b seq_len_b * KVH * hd * 2 (K and V) *
// itemsize bytes of KV pages and does 4 * sum_b seq_len_b * Hq * hd flops,
// so it is bound by HBM bytes (3.35 TB/s on the H100 SXM).  What sets its
// time on the card is latency instead: each block waits on three dependent
// reads (the row's length, its split's page ids, the K/V rows) before its
// first tile, and a row with more than one live split then waits for its
// last block and one more round of L2 reads (the combine).  The split grid
// puts every row's splits on different SMs at once, the ring keeps two
// tiles of a block in flight, and the combine loads its partials in
// groups, so those waits are paid about once per call, not once per tile
// or per split (scripts/paged_attention_trace.py times them per block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 128;   // four warps
constexpr int kMaxG = 16;       // query heads per KV head
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  void* k_pages;  // written only at kv_len (fused step)
  void* v_pages;
  const int* tables;
  const int* seq_lens;  // attend only; nullptr in the fused step
  const void* k_new;    // fused step only
  const void* v_new;
  const int* kv_len;    // fused step only; nullptr when attending only
  void* out;
  float* part;          // (B * KVH * n_splits) partials of G * (hd + 2)
  int* counters;        // (B * KVH), zero between launches
  int G, KVH, page_size, pages_per_seq, split_tokens, n_splits;
  float sm_scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }

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

// What every block of the grid first works out: its row's length, how many
// splits of it hold positions, and its own run [t_begin, t_end).
struct Split {
  int seq_len, n_live, t_begin, t_end;
  int write_pos;  // kv_len in the fused step when this split holds it, else -1
};

__device__ __forceinline__ Split locate(const Params& p, int b, int split) {
  Split s;
  const bool fused = p.kv_len != nullptr;
  const int kv = fused ? p.kv_len[b] : 0;
  s.seq_len = fused ? kv + 1 : p.seq_lens[b];
  s.n_live = max(1, (s.seq_len + p.split_tokens - 1) / p.split_tokens);
  s.t_begin = split * p.split_tokens;
  s.t_end = min(s.seq_len, s.t_begin + p.split_tokens);
  s.write_pos = fused && kv >= s.t_begin && kv < s.t_end ? kv : -1;
  return s;
}

// The block's split partial is in shared memory: m_s[G], l_s[G],
// acc_s[G * HD] (fp32).  With one live split it is the output; otherwise
// it goes to the workspace, and the last of the row's live split blocks to
// arrive combines them all, in split order.
template <typename T, int HD>
__device__ void finish(const Params& p, int b, int h, int split,
                       const Split& sp, const float* m_s, const float* l_s,
                       const float* acc_s) {
  __shared__ int last;
  const int tid = threadIdx.x;
  const int G = p.G;
  const int rows = G * HD;
  T* out = static_cast<T*>(p.out) + ((size_t)b * p.KVH + h) * rows;
  if (sp.n_live == 1) {
    for (int i = tid; i < rows; i += kThreads)
      out[i] = from_float<T>(acc_s[i] / fmaxf(l_s[i / HD], 1e-30f));
    return;
  }
  const int bh = b * p.KVH + h;
  const int stride = G * (HD + 2);
  float* base = p.part + (size_t)bh * p.n_splits * stride;
  float* mine = base + (size_t)split * stride;
  for (int i = tid; i < rows; i += kThreads) mine[i] = acc_s[i];
  if (tid < G) {
    mine[rows + tid] = m_s[tid];
    mine[rows + G + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int done = atomicAdd(p.counters + bh, 1);
    last = done == sp.n_live - 1;
    if (last) p.counters[bh] = 0;  // every live block has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Combine, over the live splits in order.  The rows' maxima first (lanes
  // over splits), then chunks of kChunk splits: their weights
  // w = exp(m - M) and sums l into shared memory (one load each, all in
  // flight together), each row's sum L added up in split order by one
  // thread, and every element's rescaled sum, a group of splits'
  // partials loaded before any is used (a loop that waited on each split's
  // loads in turn paid a round trip to L2 per split).
  constexpr int kChunk = 32;
  constexpr int kElems = kMaxG * HD / kThreads;
  constexpr int kGroup = 64 / kElems;  // splits loaded at once: 64 registers
  static_assert(kElems * kThreads == kMaxG * HD && kGroup >= 1,
                "the combine's elements split evenly over the threads");
  __shared__ float M_s[kMaxG], L_s[kMaxG];
  __shared__ float w_s[kChunk][kMaxG], ls_s[kChunk][kMaxG];
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int g = warp; g < G; g += kThreads / 32) {
    float M = kNegInf;
    for (int s = lane; s < sp.n_live; s += 32)
      M = fmaxf(M, __ldcg(base + (size_t)s * stride + rows + g));
    M = warp_max(M);
    if (lane == 0) {
      M_s[g] = M;
      L_s[g] = 0.f;
    }
  }
  float A[kElems];
#pragma unroll
  for (int j = 0; j < kElems; ++j) A[j] = 0.f;
  for (int c0 = 0; c0 < sp.n_live; c0 += kChunk) {
    const int n = min(kChunk, sp.n_live - c0);
    __syncthreads();  // M_s is set; the last chunk's weights are used
    for (int t = tid; t < n * G; t += kThreads) {
      const int s = t / G;
      const int g = t % G;
      const float* part = base + (size_t)(c0 + s) * stride;
      const float ms = __ldcg(part + rows + g);
      // a partial with no live key takes no part (exp(0) would be 1)
      w_s[s][g] = ms == kNegInf ? 0.f : expf(ms - M_s[g]);
      ls_s[s][g] = __ldcg(part + rows + G + g);
    }
    __syncthreads();
    if (tid < G) {
      float L = L_s[tid];
      for (int s = 0; s < n; ++s) L += ls_s[s][tid] * w_s[s][tid];
      L_s[tid] = L;
    }
    for (int s = 0; s < n; s += kGroup) {
      float a[kGroup][kElems];
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
#pragma unroll
        for (int j = 0; j < kElems; ++j) {
          const int i = tid + j * kThreads;
          a[u][j] = s + u < n && i < rows
                        ? __ldcg(base + (size_t)(c0 + s + u) * stride + i)
                        : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (s + u >= n) break;
#pragma unroll
        for (int j = 0; j < kElems; ++j) {
          const int i = tid + j * kThreads;
          if (i < rows) A[j] += a[u][j] * w_s[s + u][i / HD];
        }
      }
    }
  }
  __syncthreads();  // L_s is complete
#pragma unroll
  for (int j = 0; j < kElems; ++j) {
    const int i = tid + j * kThreads;
    if (i < rows) out[i] = from_float<T>(A[j] / fmaxf(L_s[i / HD], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int kTile = 64;    // positions per tile: 16 per warp
constexpr int kStages = 3;   // tiles in the ring
constexpr int kPad = 8;      // bf16 row padding: 16 bytes

template <int HD>
constexpr int kPitch = HD + kPad;
template <int HD>
constexpr int kStageElems = 2 * kTile * kPitch<HD>;  // K tile, then V tile
// the ring, the q tile, then the split's page ids (tab_slots ints)
template <int HD>
constexpr int tc_smem_bytes(int tab_slots) {
  return (kStages * kStageElems<HD> + kMaxG * kPitch<HD>) * (int)sizeof(bf16) +
         tab_slots * (int)sizeof(int);
}

// page ids a split of split_tokens positions can touch
inline int table_slots(int split_tokens, int page_size) {
  return (split_tokens - 1) / page_size + 2;
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (x0, x1) -> the bf16 pairs hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 c = __floats2bfloat162_rn(x0 - __low2float(a),
                                                 x1 - __high2float(a));
  hi = pack_bf16(a.x, a.y);
  lo = pack_bf16(c.x, c.y);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_tc_kernel(const Params p) {
  constexpr int kChunks = HD / 8;  // 16-byte pieces per row
  constexpr int kKS = HD / 16;     // k16 steps of q . k
  constexpr int kDT = HD / 8;      // n8 tiles of the output
  static_assert(kKS * 16 == HD && kDT % 2 == 0,
                "the k16 steps and the n8 pairs must cover the head dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* q_s = ring + kStages * kStageElems<HD>;  // [16][kPitch]
  int* tab_s = reinterpret_cast<int*>(q_s + kMaxG * kPitch<HD>);
  __shared__ float m_s[kMaxG], l_s[kMaxG];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const Split sp = locate(p, b, split);
  if (split >= sp.n_live) return;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int G = p.G;
  const int* table = p.tables + (size_t)b * p.pages_per_seq;
  const bf16* k_pages = static_cast<const bf16*>(p.k_pages);
  const bf16* v_pages = static_cast<const bf16*>(p.v_pages);
  const size_t new_off = ((size_t)b * p.KVH + h) * HD;
  const int n_tiles = (sp.t_end - sp.t_begin + kTile - 1) / kTile;
  const int page0 = sp.t_begin / p.page_size;

  // q rows kvh * G .. + G, zero rows up to 16
  const bf16* q = static_cast<const bf16*>(p.q) + ((size_t)b * p.KVH + h) * G * HD;
  for (int c = tid; c < kMaxG * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int x = (c % kChunks) * 8;
    cp_async16(q_s + r * kPitch<HD> + x, r < G ? q + r * HD + x : q, r < G);
  }
  // the split's page ids, once (only those of positions below seq_len), so
  // no copy waits on a table read; q's copies fly meanwhile
  const int n_pages =
      sp.t_end > sp.t_begin ? (sp.t_end - 1) / p.page_size - page0 + 1 : 0;
  for (int t = tid; t < n_pages; t += kThreads) tab_s[t] = table[page0 + t];
  __syncthreads();
  auto offset = [&](int pos) {  // element offset of position pos, head h
    return ((size_t)tab_s[pos / p.page_size - page0] * p.page_size +
            pos % p.page_size) * p.KVH * HD + (size_t)h * HD;
  };

  // K and V rows of tile t into its stage; zeros past the split's end.  The
  // fused step's new row is stored to its page and into the tile directly.
  auto issue = [&](int t) {
    bf16* st = ring + (t % kStages) * kStageElems<HD>;
    const int pos0 = sp.t_begin + t * kTile;
    for (int c = tid; c < 2 * kTile * kChunks; c += kThreads) {
      const int which = c / (kTile * kChunks);  // 0: K, 1: V
      const int r = (c / kChunks) % kTile;
      const int x = (c % kChunks) * 8;
      const int pos = pos0 + r;
      bf16* dst = st + (which * kTile + r) * kPitch<HD> + x;
      const bf16* pages = which ? v_pages : k_pages;
      if (pos >= sp.t_end) {
        cp_async16(dst, pages, false);
      } else if (pos == sp.write_pos) {
        const bf16* src = static_cast<const bf16*>(which ? p.v_new : p.k_new);
        const uint4 val = *reinterpret_cast<const uint4*>(src + new_off + x);
        *reinterpret_cast<uint4*>(dst) = val;
        *reinterpret_cast<uint4*>(static_cast<bf16*>(which ? p.v_pages
                                                           : p.k_pages) +
                                  offset(pos) + x) = val;
      } else {
        cp_async16(dst, pages + offset(pos) + x, true);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();  // the first group also holds q
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  uint32_t qf[kKS][4];

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        ldsm_x4(qf[kk], q_s + (lane & 15) * kPitch<HD> + kk * 16 + (lane >> 4) * 8);
    }
    const int k0 = sp.t_begin + it * kTile + warp * 16;
    if (k0 >= sp.t_end) continue;  // this warp's 16 keys are all past the end
    const bf16* kt = ring + (it % kStages) * kStageElems<HD> + warp * 16 * kPitch<HD>;
    const bf16* vt = kt + kTile * kPitch<HD>;

    // scores: 16 rows x 16 keys, the k16 steps over hd in order
    float s[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, kt + ((lane & 7) + ((lane >> 4) << 3)) * kPitch<HD> + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qf[kk], bk[0], bk[1]);
      mma_bf16(s[1], qf[kk], bk[2], bk[3]);
    }
    // online softmax on the fragments, fp32: rows gid and gid + 8
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + t * 8 + 2 * tig + (e & 1);
        s[t][e] = kp < sp.t_end ? s[t][e] * p.sm_scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = expf(s[t][e] - m[e >> 1]);
        sum[e >> 1] += s[t][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }
    // o += P @ V, P as its hi and lo bf16 fragments
    uint32_t ph[4], pl[4];
    split_pair(s[0][0], s[0][1], ph[0], pl[0]);
    split_pair(s[0][2], s[0][3], ph[1], pl[1]);
    split_pair(s[1][0], s[1][1], ph[2], pl[2]);
    split_pair(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < kDT / 2; ++dp) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch<HD> +
                        (dp * 2 + (lane >> 4)) * 8);
      mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
      mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
    }
  }

  // merge the four warps' (m, l, acc) in warp order, through the ring:
  // each row's max, weights and sum by one thread, then the elements
  constexpr int kOP = HD + 4;  // wo row pitch, off the 32-bank period
  static_assert((3 * 4 * kMaxG + 4 * kMaxG * kOP + kMaxG * HD) * 4 <=
                    kStages * kStageElems<HD> * (int)sizeof(bf16),
                "the merge fits in the ring");
  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(ring);  // [4][16]
  float* wl = wm + 4 * kMaxG;                  // [4][16]
  float* ww = wl + 4 * kMaxG;                  // [4][16]
  float* wo = ww + 4 * kMaxG;                  // [4][16][kOP]
  float* acc_s = wo + 4 * kMaxG * kOP;         // [G][HD]
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wm[warp * kMaxG + gid + 8 * r] = m[r];
      wl[warp * kMaxG + gid + 8 * r] = l[r];
    }
  }
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wo[(warp * kMaxG + gid + 8 * (e >> 1)) * kOP + t * 8 + 2 * tig + (e & 1)] =
          o[t][e];
  __syncthreads();
  if (tid < G) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, wm[w * kMaxG + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mw = wm[w * kMaxG + tid];
      // a warp that saw no live key takes no part (its l and acc are 0)
      const float wgt = mw == kNegInf ? 0.f : expf(mw - M);
      ww[w * kMaxG + tid] = wgt;
      L += wl[w * kMaxG + tid] * wgt;
    }
    m_s[tid] = M;
    l_s[tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      A += wo[(w * kMaxG + g) * kOP + i % HD] * ww[w * kMaxG + g];
    acc_s[i] = A;
  }
  __syncthreads();
  finish<bf16, HD>(p, b, h, split, sp, m_s, l_s, acc_s);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTile32 = 32;  // tokens staged per iteration (= warp size)

// q, K, V and P tiles in dynamic shared memory: 53.5 KB at hd 160, past
// the 48 KB a block may hold statically
template <int HD>
constexpr int f32_smem_bytes() {
  return (kMaxG * HD + 2 * kTile32 * (HD + 1) + kMaxG * kTile32) *
         (int)sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_f32_kernel(const Params p) {
  using T = float;
  constexpr int kRow = HD + 1;  // padded shared-memory row
  constexpr int kAcc = (kMaxG * HD + kThreads - 1) / kThreads;
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int kChunks = HD / kVec;         // 16-byte chunks per K/V row
  constexpr int kLoads = kTile32 * kChunks / kThreads;  // per thread, per tile
  static_assert(kTile32 * kChunks % kThreads == 0, "tile must split evenly");
  static_assert(kTile32 * kRow >= kMaxG * HD, "k_s holds the partial");
  extern __shared__ __align__(16) float smem_f32[];
  float* q_s = smem_f32;                  // [kMaxG * HD]
  float* k_s = q_s + kMaxG * HD;          // [kTile32 * kRow]
  float* v_s = k_s + kTile32 * kRow;      // [kTile32 * kRow]
  float* p_s = v_s + kTile32 * kRow;      // [kMaxG * kTile32]
  __shared__ int page_s[kTile32];
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float alpha_s[kMaxG];

  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // sequence
  const int split = blockIdx.z;
  const Split sp = locate(p, b, split);
  if (split >= sp.n_live) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = p.G;
  const int rows = G * HD;
  const int* table = p.tables + (size_t)b * p.pages_per_seq;
  const T* k_pages = static_cast<const T*>(p.k_pages);
  const T* v_pages = static_cast<const T*>(p.v_pages);
  const size_t tok_stride = (size_t)p.KVH * HD;
  const size_t head_off = (size_t)h * HD;
  const size_t new_off = ((size_t)b * p.KVH + h) * HD;

  const T* q = static_cast<const T*>(p.q) + ((size_t)b * p.KVH + h) * rows;
  for (int i = tid; i < rows; i += kThreads) q_s[i] = to_float(q[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = sp.t_begin; t0 < sp.t_end; t0 += kTile32) {
    // page ids of this tile's tokens (never past seq_len)
    if (tid < kTile32) {
      const int pos = t0 + tid;
      page_s[tid] = pos < sp.t_end ? table[pos / p.page_size] : 0;
    }
    __syncthreads();
    // stage K/V rows t0 .. t0+kTile32 of this head (zeros past the end):
    // all of a thread's 16-byte loads are issued before any is used; the
    // fused step's new row comes from k_new/v_new and is stored to its page
    uint4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int c = tid + j * kThreads;
      const int t = c / kChunks;
      const int pos = t0 + t;
      const size_t x = (size_t)(c % kChunks) * kVec;
      kr[j] = make_uint4(0u, 0u, 0u, 0u);
      vr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (pos >= sp.t_end) continue;
      const size_t off =
          ((size_t)page_s[t] * p.page_size + pos % p.page_size) * tok_stride +
          head_off + x;
      if (pos == sp.write_pos) {
        kr[j] = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.k_new) +
                                                new_off + x);
        vr[j] = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.v_new) +
                                                new_off + x);
        *reinterpret_cast<uint4*>(static_cast<T*>(p.k_pages) + off) = kr[j];
        *reinterpret_cast<uint4*>(static_cast<T*>(p.v_pages) + off) = vr[j];
      } else {
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

    // scores s[g][t] = (q_g . k_t) * scale, masked past the end
    for (int i = tid; i < G * kTile32; i += kThreads) {
      const int g = i / kTile32;
      const int t = i % kTile32;
      float s = kNegInf;
      if (t0 + t < sp.t_end) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot += q_s[g * HD + d] * k_s[t * kRow + d];
        s = dot * p.sm_scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row, one lane per token
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = p_s[g * kTile32 + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float pr = expf(s - m_new);
      const float sum = warp_sum(pr);
      p_s[g * kTile32 + lane] = pr;
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
        for (int t = 0; t < kTile32; ++t)
          a += p_s[g * kTile32 + t] * v_s[t * kRow + d];
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  float* acc_s = k_s;  // free after the last tile's barrier
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < rows) acc_s[i] = acc[j];
  }
  __syncthreads();
  finish<float, HD>(p, b, h, split, sp, m_s, l_s, acc_s);
}

template <int HD>
int launch(int dtype, const Params& p, int B, cudaStream_t stream) {
  const dim3 grid(p.KVH, B, p.n_splits);
  if (dtype == 1) {
    // the opt-in above 48 KB, raised whenever a call needs more
    static size_t allowed = 48 << 10;
    const size_t smem =
        tc_smem_bytes<HD>(table_slots(p.split_tokens, p.page_size));
    if (smem > allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          paged_attention_tc_kernel<HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      allowed = smem;
    }
    paged_attention_tc_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  } else {
    const size_t smem = f32_smem_bytes<HD>();
    static bool configured = false;
    const cudaError_t err =
        allow_smem(paged_attention_f32_kernel<HD>, smem, configured);
    if (err != cudaSuccess) return (int)err;
    paged_attention_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch: attend only (kv_len == NULL: attend over seq_lens) or the
// fused decode step (kv_len != NULL: store k_new/v_new at kv_len, attend
// over kv_len + 1; seq_lens is not read).  split_tokens is a multiple of
// 64; n_splits = ceil(pages_per_seq * page_size / split_tokens).  part is
// an fp32 workspace of B * KVH * n_splits * G * (hd + 2) floats (not read
// when n_splits is 1); counters holds B * KVH ints that are zero before the
// launch and are left zero after it.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape or type the kernel does not take (the Python wrapper checks
// these first and raises).
int paged_attention_split_fwd(const void* q, void* k_pages, void* v_pages,
                              const void* block_tables, const void* seq_lens,
                              const void* k_new, const void* v_new,
                              const void* kv_len, void* out, void* part,
                              void* counters, int B, int Hq, int KVH, int hd,
                              int page_size, int pages_per_seq,
                              int split_tokens, float sm_scale, int dtype,
                              void* stream) {
  if (B <= 0 || B > 65535 || KVH <= 0 || Hq % KVH != 0 || Hq / KVH > kMaxG ||
      page_size <= 0 || pages_per_seq <= 0 || split_tokens <= 0 ||
      split_tokens % kTile != 0 || (dtype != 0 && dtype != 1) ||
      counters == nullptr ||
      (kv_len == nullptr ? seq_lens == nullptr
                         : (k_new == nullptr || v_new == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long positions = (long long)pages_per_seq * page_size;
  const long long n_splits = (positions + split_tokens - 1) / split_tokens;
  if (n_splits > 65535 || (n_splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.tables = static_cast<const int*>(block_tables);
  p.seq_lens = static_cast<const int*>(seq_lens);
  p.k_new = k_new;
  p.v_new = v_new;
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.G = Hq / KVH;
  p.KVH = KVH;
  p.page_size = page_size;
  p.pages_per_seq = pages_per_seq;
  p.split_tokens = split_tokens;
  p.n_splits = (int)n_splits;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(dtype, p, B, s);
    case 64:
      return launch<64>(dtype, p, B, s);
    case 80:
      return launch<80>(dtype, p, B, s);
    case 128:
      return launch<128>(dtype, p, B, s);
    case 160:
      return launch<160>(dtype, p, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
