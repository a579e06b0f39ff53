// Multi-threshold counts for every binned curve metric, for Hopper.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/multi_threshold.py:_kernel, launched by
// _counts_pallas. For every threshold t and class c:
//   tp[t, c]      = #{n : preds[n, c] >= thr[t] and positive[n, c] and valid[n, c]}
//   predpos[t, c] = #{n : preds[n, c] >= thr[t] and valid[n, c]}
// Thresholds come sorted (with the permutation `order` that sorted them); NaN scores
// fall below every threshold. As by-products it writes the per-class totals
// pos_total[c] = #{positive and valid} and tot_total[c] = #{valid}.
//
// Bound: the inputs are read once (at 8192 x 10 and T = 200 about 0.4 MB, a fraction
// of a microsecond of HBM time), so two launches set the floor. Design: O(N*C*log T)
// instead of the TPU's O(N*C*T) compare-and-multiply. Kernel A (grid: row chunks x
// class tiles) loads the sorted thresholds into shared memory, bins each valid element
// by binary search (bin = #thresholds <= score) and adds it to shared histograms
// pos/tot[class][T+1], which the block flushes into global int32 (C, T+1) histograms
// with one atomicAdd per non-zero entry. Kernel B (one block per class) turns the
// histograms into suffix sums with a block scan and writes tp / predpos at the
// thresholds' original positions. `positive` and `valid` are read through strides and
// element sizes (1, 4 or 8 bytes), so a broadcast (stride 0) mask costs N bytes, not
// N*C. When even one class's histograms exceed the shared memory a block may opt in
// to, the SMEM=false variant bins against global memory.

#include <cuda_runtime.h>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool load_flag(const unsigned char* base, long long off, int elem_size) {
  switch (elem_size) {
    case 1:
      return base[off] != 0;
    case 4:
      return reinterpret_cast<const int*>(base)[off] != 0;
    default:
      return reinterpret_cast<const long long*>(base)[off] != 0;
  }
}

// #{k : thr[k] <= v}; a NaN score fails every comparison and lands in bin 0, NaN
// thresholds (sorted last) count as above every score.
__device__ __forceinline__ int upper_bound(const float* thr, int t, float v) {
  int lo = 0, hi = t;
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

template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
multi_threshold_hist_kernel(const float* __restrict__ preds, long long n, int c, const unsigned char* pos,
                            long long pos_sn, long long pos_sc, int pos_es, const unsigned char* val,
                            long long val_sn, long long val_sc, int val_es, const float* __restrict__ thr, int t,
                            int class_tile, int rows_per_chunk, int* __restrict__ hist_pos,
                            int* __restrict__ hist_tot) {
  extern __shared__ int smem[];
  const int bins = t + 1;
  const int c0 = blockIdx.y * class_tile;
  const int cw = min(class_tile, c - c0);
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long rw = min((long long)rows_per_chunk, n - r0);
  int* g_pos = hist_pos + (long long)c0 * bins;
  int* g_tot = hist_tot + (long long)c0 * bins;
  const float* s_thr = thr;
  int* h_pos = g_pos;
  int* h_tot = g_tot;
  if constexpr (SMEM) {
    float* st = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < t; i += blockDim.x) st[i] = thr[i];
    h_pos = smem + t;
    h_tot = h_pos + cw * bins;
    for (int i = threadIdx.x; i < 2 * cw * bins; i += blockDim.x) h_pos[i] = 0;
    s_thr = st;
    __syncthreads();
  }
  const long long total = rw * cw;
  for (long long e = threadIdx.x; e < total; e += blockDim.x) {
    const long long row = r0 + e / cw;
    const int cc = (int)(e % cw);
    const int col = c0 + cc;
    if (!load_flag(val, row * val_sn + col * val_sc, val_es)) continue;
    const int b = upper_bound(s_thr, t, __ldcs(preds + row * c + col));
    atomicAdd(&h_tot[cc * bins + b], 1);
    if (load_flag(pos, row * pos_sn + col * pos_sc, pos_es)) atomicAdd(&h_pos[cc * bins + b], 1);
  }
  if constexpr (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < cw * bins; i += blockDim.x) {
      const int vp = h_pos[i];
      if (vp) atomicAdd(&g_pos[i], vp);
      const int vt = h_tot[i];
      if (vt) atomicAdd(&g_tot[i], vt);
    }
  }
}

// One block per class: suffix sums over bins, scattered to the unsorted thresholds.
// With bin b = #{sorted thresholds <= score}, score >= sorted_thr[k] <=> b > k, so
// count[k] = (sum of all bins) - (inclusive prefix sum up to bin k).
__global__ void __launch_bounds__(kThreads)
multi_threshold_scan_kernel(const int* __restrict__ hist_pos, const int* __restrict__ hist_tot, int c, int t,
                            const long long* __restrict__ order, int* __restrict__ tp, int* __restrict__ predpos,
                            int* __restrict__ pos_total, int* __restrict__ tot_total) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scratch;
  const int cls = blockIdx.x;
  const int bins = t + 1;
  const int* hp = hist_pos + (long long)cls * bins;
  const int* ht = hist_tot + (long long)cls * bins;
  const int per = (bins + kThreads - 1) / kThreads;
  const int b0 = min((int)threadIdx.x * per, bins);
  const int b1 = min(b0 + per, bins);
  int sp = 0, st = 0;
  for (int b = b0; b < b1; ++b) {
    sp += hp[b];
    st += ht[b];
  }
  int ex_p, agg_p, ex_t, agg_t;
  Scan(scratch).ExclusiveSum(sp, ex_p, agg_p);
  __syncthreads();
  Scan(scratch).ExclusiveSum(st, ex_t, agg_t);
  int run_p = ex_p, run_t = ex_t;
  for (int b = b0; b < min(b1, t); ++b) {
    run_p += hp[b];
    run_t += ht[b];
    const long long dst = order[b] * c + cls;
    tp[dst] = agg_p - run_p;
    predpos[dst] = agg_t - run_t;
  }
  if (threadIdx.x == 0) {
    pos_total[cls] = agg_p;
    tot_total[cls] = agg_t;
  }
}

}  // namespace

// preds: contiguous float32 (N, C). positive / valid: element strides and sizes in
// bytes (1, 4 or 8). thr_sorted: float32 (T,); order: int64 (T,) with
// thr_sorted[k] = thresholds[order[k]]. hist_pos / hist_tot: zeroed int32 (C, T+1).
// Outputs: tp / predpos int32 (T, C), pos_total / tot_total int32 (C,).
extern "C" int tm_multi_threshold_counts(const void* preds, long long n, int c, const void* pos, long long pos_sn,
                                         long long pos_sc, int pos_es, const void* val, long long val_sn,
                                         long long val_sc, int val_es, const void* thr_sorted, const void* order,
                                         int t, int class_tile, int rows_per_chunk, int row_chunks, int smem,
                                         void* hist_pos, void* hist_tot, void* tp, void* predpos, void* pos_total,
                                         void* tot_total, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(row_chunks, (c + class_tile - 1) / class_tile);
  const float* p = static_cast<const float*>(preds);
  const auto* pb = static_cast<const unsigned char*>(pos);
  const auto* vb = static_cast<const unsigned char*>(val);
  const float* th = static_cast<const float*>(thr_sorted);
  int* hp = static_cast<int*>(hist_pos);
  int* ht = static_cast<int*>(hist_tot);
  if (smem) {
    const size_t bytes = (size_t)t * sizeof(float) + (size_t)2 * class_tile * (t + 1) * sizeof(int);
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(multi_threshold_hist_kernel<true>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    multi_threshold_hist_kernel<true><<<grid, kThreads, bytes, s>>>(
        p, n, c, pb, pos_sn, pos_sc, pos_es, vb, val_sn, val_sc, val_es, th, t, class_tile, rows_per_chunk, hp, ht);
  } else {
    multi_threshold_hist_kernel<false><<<grid, kThreads, 0, s>>>(
        p, n, c, pb, pos_sn, pos_sc, pos_es, vb, val_sn, val_sc, val_es, th, t, class_tile, rows_per_chunk, hp, ht);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  multi_threshold_scan_kernel<<<c, kThreads, 0, s>>>(hp, ht, c, t, static_cast<const long long*>(order),
                                                     static_cast<int*>(tp), static_cast<int*>(predpos),
                                                     static_cast<int*>(pos_total), static_cast<int*>(tot_total));
  return (int)cudaGetLastError();
}
