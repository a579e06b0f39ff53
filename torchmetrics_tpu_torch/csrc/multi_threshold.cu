// Binned multi-threshold confusion tensor for every binned curve metric, for Hopper.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/multi_threshold.py:_kernel, launched by
// _counts_pallas, together with the arithmetic of the JAX package's
// _binned_multi_threshold_confmat around it. For every threshold t and class c:
//   tp[t, c]      = #{n : preds[n, c] >= thr[t] and positive[n, c] and valid[n, c]}
//   predpos[t, c] = #{n : preds[n, c] >= thr[t] and valid[n, c]}
// and with P[c] = #{positive and valid}, V[c] = #{valid} it writes the (T, C, 2, 2) int32
// tensor [[tn, fp], [fn, tp]], fp = predpos - tp, fn = P - tp, tn = V - P - fp.
// Thresholds come sorted (with the permutation `order` that sorted them, NaN last).
// A NaN score falls below every threshold; a NaN threshold lies above every score.
//
// Bound: every input is read once and the output written once. At 8192 x 10, T = 200
// that is ~0.43 MB (0.13 us of HBM time), so one launch sets the floor. At 8192 x 1000,
// T = 200 it is ~42 MB: 32.8 MB of float32 scores and 8.2 MB of bool one-hot for the
// valid elements plus the 3.2 MB tensor, ~12.6 us at 3.35 TB/s.
//
// Design: one launch, O(N*C) work. Grid: (class tiles) x (row chunks). A class tile
// is 1-16 classes (a power of two, `tw`), so a block's shared histogram is tw*(T+1)
// packed 64-bit entries ((positive << 32) | valid), small beside the rows it bins;
// the wrapper picks tw and the chunking so the grid fills the card (up to ~4 blocks
// per SM) at small C as at wide C. Threads map to (row, class-in-tile) with shifts:
// 32-bit index arithmetic, no division, and a thread's class never changes. Flag
// element sizes (1, 4, 8 bytes) are template parameters; flags are read through
// strides, so the broadcast (N, 1) row mask costs N bytes. Loads come in batches of
// four rows, the score beside its flags, the first batch issued before the block's
// set-up and each next one before the current is binned. The bin of a score is
// #{sorted thresholds <= score}: a guess from a shared table over a uniform grid of
// [first finite, last finite threshold], then corrected against the neighbouring
// thresholds until thr[b-1] <= v < thr[b] -- exact whatever the rounding, with
// duplicated, infinite or NaN thresholds, in expected O(1) for evenly spread
// thresholds. Scores crowd into a few bins (a trained classifier's near 0 and 1, and
// any wide-C softmax near 0), so same-address atomics must not serialise: where >= 8
// lanes of a warp share a class (tw <= 4) lanes of one bin merge with
// __match_any_sync into one packed shared atomic; otherwise each thread carries a run
// of equal bins in a register and adds it once the bin changes. Each block flushes
// its non-zero entries into a global (C, T+1) histogram, fences, and takes a ticket
// for its class tile; the last block of a tile copies the tile's bins and the order
// to shared memory, takes prefix sums (one warp per class, 32 bins per shuffle scan)
// and writes the tile's (T, tw, 2, 2) slice at the unsorted thresholds' positions
// with all its threads. The wrapper zeroes the global histograms and tickets with one
// memset. When even one class's histogram exceeds the shared memory a block may opt
// in to (T above ~20k), the SMEM=false variant counts and scans in the global
// histogram.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): ~9 us at 8192 x 10 (a
// chain of set-up, one batch, flush, ticket and scan, each a memory round trip) and
// ~50 us at 8192 x 1000, where each thread bins ~57 elements one after another and
// neither the loads nor the binning alone sets the pace; see PERF.md.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

template <int ES>
__device__ __forceinline__ bool load_flag(const void* base, int off) {
  if constexpr (ES == 1) {
    return static_cast<const unsigned char*>(base)[off] != 0;
  } else if constexpr (ES == 4) {
    return static_cast<const int*>(base)[off] != 0;
  } else {
    return static_cast<const long long*>(base)[off] != 0;
  }
}

// #{k < tn : thr[k] <= v}
__device__ __forceinline__ int upper_bound(const float* thr, int tn, float v) {
  int lo = 0, hi = tn;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (thr[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A histogram entry of the scan: shared memory, or global memory that other blocks
// filled with atomics (read from L2).
template <bool SMEM>
__device__ __forceinline__ u64 load_bin(const u64* p) {
  if constexpr (SMEM) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

// The uniform grid over the finite thresholds [lo, hi] that seeds the bin lookup.
struct BinGrid {
  float lo;      // first finite threshold (+inf when there is none)
  float inv_w;   // cells per unit (0 when the grid is degenerate)
  int n_neginf;  // thresholds equal to -inf: the bin of any score below lo
  int tn;        // thresholds that are not NaN
  int cells;     // grid cells; tab has cells + 1 entries
};

// #{sorted thresholds <= v}, NaN scores in bin 0. tab[g] is the count at cell g's lower
// edge (tab[cells] at hi); the two loops make the guess exact.
__device__ __forceinline__ int find_bin(const float* thr, const int* tab, const BinGrid& gr, float v) {
  if (v != v) return 0;
  if (v < gr.lo) return gr.n_neginf;
  const float x = (v - gr.lo) * gr.inv_w;  // NaN for v = +inf on a degenerate grid
  int b = tab[x < (float)gr.cells ? (int)x : gr.cells];
  while (b < gr.tn && thr[b] <= v) ++b;
  while (b > 0 && thr[b - 1] > v) --b;
  return b;
}

template <bool SMEM, int PES, int VES>
__global__ void __launch_bounds__(kThreads)
multi_threshold_confmat_kernel(const float* __restrict__ preds, int n, int c, const void* __restrict__ pos,
                               int pos_sn, int pos_sc, const void* __restrict__ val, int val_sn, int val_sc,
                               const float* __restrict__ thr_g, const long long* __restrict__ order, int t,
                               int cells, int tw_log, int rows_per_chunk, u64* __restrict__ ghist,
                               unsigned* __restrict__ tickets, int4* __restrict__ confmat) {
  extern __shared__ u64 smem[];
  __shared__ BinGrid gr;
  __shared__ int counts[3];  // NaN, -inf, +inf thresholds
  __shared__ bool last;
  const int bins = t + 1;
  const int tw = 1 << tw_log;
  const int c0 = blockIdx.x << tw_log;
  const int cw = min(tw, c - c0);
  const int lane = threadIdx.x & 31;
  const int cc = threadIdx.x & (tw - 1);
  const int col = c0 + cc;
  const bool col_ok = cc < cw;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, n);
  const int step = kUnroll * (kThreads >> tw_log);  // rows per pass of the block
  const int lane_row = lane >> tw_log;

  // A batch: kUnroll rows of this thread's class. Score and flags load side by side
  // (not the score after the mask), so one round trip serves the batch.
  struct Batch {
    float s[kUnroll];
    bool v[kUnroll], p[kUnroll];
  };
  auto load = [&](Batch& bt, int first) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = first + u * (kThreads >> tw_log) + lane_row;
      const bool in = col_ok && row < r1;
      bt.v[u] = in && load_flag<VES>(val, row * val_sn + col * val_sc);
      bt.p[u] = in && load_flag<PES>(pos, row * pos_sn + col * pos_sc);
      bt.s[u] = in ? __ldcs(preds + row * c + col) : 0.0f;
    }
  };
  // warp-uniform trip count, so the warp's collectives see every lane
  int base = r0 + ((threadIdx.x >> 5) << (5 - tw_log));
  Batch cur;
  load(cur, base);  // in flight during the set-up below

  // shared layout: [histograms (SMEM only)] [thresholds (SMEM only)] [grid table]
  float* s_thr = reinterpret_cast<float*>(smem + (SMEM ? tw * bins : 0));
  int* tab = reinterpret_cast<int*>(s_thr + (SMEM ? t : 0));
  u64* g_tile = ghist + c0 * bins;
  u64* hist = SMEM ? smem : g_tile;
  const float* thr = SMEM ? s_thr : thr_g;
  if constexpr (SMEM) {
    for (int i = threadIdx.x; i < cw * bins; i += kThreads) hist[i] = 0;
  }
  if (threadIdx.x < 3) counts[threadIdx.x] = 0;
  __syncthreads();
  int nan_k = 0, ninf_k = 0, pinf_k = 0;
  for (int i = threadIdx.x; i < t; i += kThreads) {
    const float x = thr_g[i];
    if constexpr (SMEM) s_thr[i] = x;
    nan_k += x != x;
    ninf_k += x == -CUDART_INF_F;
    pinf_k += x == CUDART_INF_F;
  }
  if (nan_k) atomicAdd(&counts[0], nan_k);
  if (ninf_k) atomicAdd(&counts[1], ninf_k);
  if (pinf_k) atomicAdd(&counts[2], pinf_k);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int tn = t - counts[0];
    const int f0 = counts[1], f1 = tn - counts[2] - 1;  // first and last finite threshold
    const float lo = f0 <= f1 ? thr[f0] : CUDART_INF_F;
    const float hi = f0 <= f1 ? thr[f1] : CUDART_INF_F;
    gr.lo = lo;
    gr.inv_w = hi > lo ? (float)cells / (hi - lo) : 0.0f;  // 0 too when hi - lo overflows
    gr.n_neginf = f0;
    gr.tn = tn;
    gr.cells = cells;
  }
  __syncthreads();
  for (int g = threadIdx.x; g <= cells; g += kThreads) {
    // cell g's lower edge, and for g = cells every finite threshold; any edge is exact,
    // since every guess is corrected
    float edge = gr.lo;
    if (gr.inv_w > 0.0f) edge = g == cells ? FLT_MAX : gr.lo + (float)g / gr.inv_w;
    tab[g] = upper_bound(thr, gr.tn, edge);
  }
  __syncthreads();
  const BinGrid grid = gr;

  // Where >= 8 lanes of a warp share each class (tw <= 4), lanes of one bin merge with
  // __match_any_sync. Otherwise a thread, whose class never changes, carries a run of
  // equal bins in a register and adds it when the bin changes: scores crowded into a
  // few bins cost a few atomics per thread, not one per element.
  const bool aggregate = tw_log <= 2;
  unsigned run_key = kFull;
  u64 run = 0;
  while (true) {
    const int next = base + step;
    Batch nxt;
    if (next < r1) load(nxt, next);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool v = cur.v[u];
      const bool p = v && cur.p[u];
      const unsigned key = v ? (unsigned)(cc * bins + find_bin(thr, tab, grid, cur.s[u])) : kFull;
      if (aggregate) {
        const unsigned peers = __match_any_sync(kFull, key);
        const unsigned positives = __ballot_sync(kFull, p);
        if (v && lane == __ffs(peers) - 1) {
          atomicAdd(&hist[key], ((u64)__popc(peers & positives) << 32) | (u64)__popc(peers));
        }
      } else if (v) {
        const u64 add = ((u64)p << 32) | 1ull;
        if (key == run_key) {
          run += add;
        } else {
          if (run) atomicAdd(&hist[run_key], run);
          run_key = key;
          run = add;
        }
      }
    }
    if (next >= r1) break;
    cur = nxt;
    base = next;
  }
  if (run) atomicAdd(&hist[run_key], run);

  __syncthreads();
  if constexpr (SMEM) {
    for (int i = threadIdx.x; i < cw * bins; i += kThreads) {
      const u64 x = hist[i];
      if (x) atomicAdd(&g_tile[i], x);
    }
  }
  // every thread's global atomics land before the block's ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last block of the tile. With bin b = #{sorted thresholds <= score},
  // score >= sorted_thr[k] <=> b > k, so count[k] = total - inclusive prefix up to bin k.
  // (1) the tile's histograms and the order into shared memory (the thresholds are no
  //     longer read), four loads in flight per thread; in place in global memory otherwise,
  u64* buf = hist;
  int* s_order = reinterpret_cast<int*>(s_thr);
  if constexpr (SMEM) {
    const int entries = cw * bins;
    for (int i0 = threadIdx.x; i0 < max(entries, t); i0 += 4 * kThreads) {
      u64 x[4];
      long long o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * kThreads;
        x[j] = i < entries ? __ldcg(g_tile + i) : 0;
        o[j] = i < t ? order[i] : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * kThreads;
        if (i < entries) buf[i] = x[j];
        if (i < t) s_order[i] = (int)o[j];
      }
    }
    __syncthreads();
  }
  // (2) inclusive prefix sums over bins, one warp per class, 32 bins at a time,
  for (int k = threadIdx.x >> 5; k < cw; k += kWarps) {
    u64* h = buf + k * bins;
    u64 carry = 0;
    for (int b0 = 0; b0 < bins; b0 += 32) {
      const int b = b0 + lane;
      u64 x = b < bins ? load_bin<SMEM>(h + b) : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const u64 y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      x += carry;
      if (b < bins) h[b] = x;
      carry = __shfl_sync(kFull, x, 31);
    }
  }
  __syncthreads();
  // (3) every (threshold, class) of the tile, written at the unsorted threshold's row.
  for (int i = threadIdx.x; i < t << tw_log; i += kThreads) {
    const int k = i & (tw - 1);
    if (k >= cw) continue;
    const int b = i >> tw_log;
    const u64* h = buf + k * bins;
    const u64 incl = load_bin<SMEM>(h + b);
    const u64 total = load_bin<SMEM>(h + bins - 1);
    const int pos_total = (int)(total >> 32), tot_total = (int)(unsigned)total;
    const int tp = pos_total - (int)(incl >> 32);
    const int fp = tot_total - (int)(unsigned)incl - tp;
    const int fn = pos_total - tp;
    const int tn = tot_total - pos_total - fp;
    const int row = SMEM ? s_order[b] : (int)order[b];
    confmat[row * c + c0 + k] = make_int4(tn, fp, fn, tp);
  }
}

template <bool SMEM, int PES, int VES>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s, const float* preds, int n, int c, const void* pos,
                   int pos_sn, int pos_sc, const void* val, int val_sn, int val_sc, const float* thr,
                   const long long* order, int t, int cells, int tw_log, int rows_per_chunk, u64* ghist,
                   unsigned* tickets, int4* confmat) {
  auto kernel = multi_threshold_confmat_kernel<SMEM, PES, VES>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, s>>>(preds, n, c, pos, pos_sn, pos_sc, val, val_sn, val_sc, thr, order, t, cells,
                                      tw_log, rows_per_chunk, ghist, tickets, confmat);
  return cudaGetLastError();
}

template <bool SMEM, int PES>
cudaError_t launch_val(int val_es, dim3 grid, size_t smem, cudaStream_t s, const float* preds, int n, int c,
                       const void* pos, int pos_sn, int pos_sc, const void* val, int val_sn, int val_sc,
                       const float* thr, const long long* order, int t, int cells, int tw_log, int rows_per_chunk,
                       u64* ghist, unsigned* tickets, int4* confmat) {
#define TM_LAUNCH(VES)                                                                                       \
  return launch<SMEM, PES, VES>(grid, smem, s, preds, n, c, pos, pos_sn, pos_sc, val, val_sn, val_sc, thr, \
                                order, t, cells, tw_log, rows_per_chunk, ghist, tickets, confmat)
  switch (val_es) {
    case 1: TM_LAUNCH(1);
    case 4: TM_LAUNCH(4);
    case 8: TM_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef TM_LAUNCH
}

template <bool SMEM>
cudaError_t launch_flags(int pos_es, int val_es, dim3 grid, size_t smem, cudaStream_t s, const float* preds, int n,
                         int c, const void* pos, int pos_sn, int pos_sc, const void* val, int val_sn, int val_sc,
                         const float* thr, const long long* order, int t, int cells, int tw_log, int rows_per_chunk,
                         u64* ghist, unsigned* tickets, int4* confmat) {
#define TM_LAUNCH(PES)                                                                                           \
  return launch_val<SMEM, PES>(val_es, grid, smem, s, preds, n, c, pos, pos_sn, pos_sc, val, val_sn, val_sc, \
                               thr, order, t, cells, tw_log, rows_per_chunk, ghist, tickets, confmat)
  switch (pos_es) {
    case 1: TM_LAUNCH(1);
    case 4: TM_LAUNCH(4);
    case 8: TM_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef TM_LAUNCH
}

}  // namespace

// preds: contiguous float32 (N, C). positive / valid: element strides and element sizes
// in bytes (1, 4 or 8). thr_sorted: float32 (T,), NaN last; order: int64 (T,) with
// thr_sorted[k] = thresholds[order[k]]. Every element offset fits in 31 bits.
// scratch: zeroed, C*(T+1) uint64 histograms then one uint32 ticket per class tile.
// Grid: ceil(C / 2^tw_log) class tiles x row_chunks chunks of rows_per_chunk rows.
// smem: 1 to keep the tile's histograms in shared memory (smem_bytes in all).
// Output: confmat int32 (T, C, 2, 2), every entry written.
extern "C" int tm_multi_threshold_confmat(const void* preds, int n, int c, const void* pos, int pos_sn, int pos_sc,
                                          int pos_es, const void* val, int val_sn, int val_sc, int val_es,
                                          const void* thr_sorted, const void* order, int t, int cells, int tw_log,
                                          int rows_per_chunk, int row_chunks, int smem, int smem_bytes,
                                          void* scratch, void* confmat, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((c + (1 << tw_log) - 1) >> tw_log, row_chunks);
  u64* ghist = static_cast<u64*>(scratch);
  unsigned* tickets = reinterpret_cast<unsigned*>(ghist + (size_t)c * (t + 1));
  const auto* p = static_cast<const float*>(preds);
  const auto* th = static_cast<const float*>(thr_sorted);
  const auto* ord = static_cast<const long long*>(order);
  auto* out = static_cast<int4*>(confmat);
  if (smem) {
    return (int)launch_flags<true>(pos_es, val_es, grid, smem_bytes, s, p, n, c, pos, pos_sn, pos_sc, val, val_sn,
                                   val_sc, th, ord, t, cells, tw_log, rows_per_chunk, ghist, tickets, out);
  }
  return (int)launch_flags<false>(pos_es, val_es, grid, smem_bytes, s, p, n, c, pos, pos_sn, pos_sc, val, val_sn,
                                  val_sc, th, ord, t, cells, tw_log, rows_per_chunk, ghist, tickets, out);
}
