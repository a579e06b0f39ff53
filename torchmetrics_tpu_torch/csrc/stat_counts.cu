// Fused logits -> per-class stat counts (tp, pred_count, tgt_count) for Hopper.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/stat_counts.py:_kernel, launched by
// _fused_counts_pallas. For each valid row n (target in [0, C) and not ignore_index):
//   pred_count[argmax(logits[n])] += 1
//   tgt_count[target[n]]          += 1
//   tp[c]                         += (argmax == target[n] == c)
// argmax: the first index attaining the max wins, NaN is maximal (the first NaN wins),
// -0.0 == 0.0, an all -inf row gives 0. A row with an invalid target counts nowhere.
//
// Bound: reading the logits once (8192 x 1000 f32 = 32.8 MB, about 9.8 us at
// 3.35 TB/s); the comparisons are ~N*C, far below any compute peak. Design: one warp
// per row (grid-stride over rows), coalesced 16-byte loads where C % 4 == 0 and the
// row is aligned, a running (value, index) pair per lane and a shuffle argmax per
// warp, so the logits are read exactly once. Lane 0 adds the row into a block-wide
// shared histogram int32[3][C] that the block flushes with one global atomicAdd per
// non-zero entry. When 3*C*4 bytes exceed the shared memory a block may opt in to,
// the SMEM=false variant adds straight into global memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<double> {
  using type = double;
};

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

// Whether (v, i) replaces (best, best_i): NaN is maximal, ties go to the lower index.
template <typename A>
__device__ __forceinline__ bool takes(A best, int best_i, A v, int i) {
  const bool bn = isnan(best), vn = isnan(v);
  if (bn || vn) return vn && (!bn || i < best_i);
  return v > best || (v == best && i < best_i);
}

template <typename T, bool VEC, bool SMEM, typename TT>
__global__ void __launch_bounds__(kThreads)
stat_counts_kernel(const T* __restrict__ logits, const TT* __restrict__ target, long long n, int c,
                   bool has_ignore, long long ignore_index, int* __restrict__ counts) {
  using A = typename Acc<T>::type;
  extern __shared__ int s_hist[];
  int* hist = counts;
  if constexpr (SMEM) {
    for (int i = threadIdx.x; i < 3 * c; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    hist = s_hist;
  }
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long nwarps = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + (threadIdx.x >> 5); row < n; row += nwarps) {
    const T* p = logits + row * c;
    A best = -INFINITY;
    int bi = INT_MAX;  // sentinel for a lane that sees no element; loses every tie
    if constexpr (VEC) {
      const float4* p4 = reinterpret_cast<const float4*>(p);
      const int c4 = c >> 2;
#pragma unroll 4
      for (int j = lane; j < c4; j += 32) {
        const float4 v = __ldcs(p4 + j);
        const int i = j << 2;
        if (takes(best, bi, v.x, i)) { best = v.x; bi = i; }
        if (takes(best, bi, v.y, i + 1)) { best = v.y; bi = i + 1; }
        if (takes(best, bi, v.z, i + 2)) { best = v.z; bi = i + 2; }
        if (takes(best, bi, v.w, i + 3)) { best = v.w; bi = i + 3; }
      }
    } else {
#pragma unroll 4
      for (int i = lane; i < c; i += 32) {
        const A v = to_acc(p[i]);
        if (takes(best, bi, v, i)) { best = v; bi = i; }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const A ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (takes(best, bi, ov, oi)) { best = ov; bi = oi; }
    }
    if (lane == 0) {
      const long long t = (long long)target[row];
      if (t >= 0 && t < c && !(has_ignore && t == ignore_index)) {
        atomicAdd(&hist[c + bi], 1);
        atomicAdd(&hist[2 * c + (int)t], 1);
        if (bi == (int)t) atomicAdd(&hist[bi], 1);
      }
    }
  }
  if constexpr (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * c; i += blockDim.x) {
      const int v = s_hist[i];
      if (v) atomicAdd(&counts[i], v);
    }
  }
}

template <typename T, bool VEC, bool SMEM, typename TT>
cudaError_t launch(const void* logits, const void* target, long long n, int c, bool has_ignore,
                   long long ignore_index, int grid, int* counts, cudaStream_t stream) {
  auto kernel = stat_counts_kernel<T, VEC, SMEM, TT>;
  const size_t smem = SMEM ? (size_t)3 * c * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(logits), static_cast<const TT*>(target), n, c,
                                           has_ignore, ignore_index, counts);
  return cudaGetLastError();
}

template <typename T, typename TT>
cudaError_t dispatch_layout(bool vec, bool smem, const void* logits, const void* target, long long n, int c,
                            bool has_ignore, long long ignore_index, int grid, int* counts, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      return smem ? launch<T, true, true, TT>(logits, target, n, c, has_ignore, ignore_index, grid, counts, s)
                  : launch<T, true, false, TT>(logits, target, n, c, has_ignore, ignore_index, grid, counts, s);
    }
  }
  return smem ? launch<T, false, true, TT>(logits, target, n, c, has_ignore, ignore_index, grid, counts, s)
              : launch<T, false, false, TT>(logits, target, n, c, has_ignore, ignore_index, grid, counts, s);
}

template <typename T>
cudaError_t dispatch_target(bool target_is64, bool vec, bool smem, const void* logits, const void* target,
                            long long n, int c, bool has_ignore, long long ignore_index, int grid, int* counts,
                            cudaStream_t s) {
  return target_is64
             ? dispatch_layout<T, long long>(vec, smem, logits, target, n, c, has_ignore, ignore_index, grid, counts, s)
             : dispatch_layout<T, int>(vec, smem, logits, target, n, c, has_ignore, ignore_index, grid, counts, s);
}

}  // namespace

// logits_dtype: 0 float32, 1 float16, 2 bfloat16, 3 float64. counts: zeroed int32 [3][C]
// (tp, pred_count, tgt_count). vec: 16-byte loads (float32 only). smem: shared histogram.
extern "C" int tm_stat_counts(const void* logits, int logits_dtype, const void* target, int target_is64,
                              long long n, long long c, int has_ignore, long long ignore_index, int vec,
                              int grid, int smem, void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(counts);
  const int ci = (int)c;
  switch (logits_dtype) {
    case 0:
      return dispatch_target<float>(target_is64, vec, smem, logits, target, n, ci, has_ignore, ignore_index, grid,
                                    out, s);
    case 1:
      return dispatch_target<__half>(target_is64, false, smem, logits, target, n, ci, has_ignore, ignore_index,
                                     grid, out, s);
    case 2:
      return dispatch_target<__nv_bfloat16>(target_is64, false, smem, logits, target, n, ci, has_ignore,
                                            ignore_index, grid, out, s);
    case 3:
      return dispatch_target<double>(target_is64, false, smem, logits, target, n, ci, has_ignore, ignore_index,
                                     grid, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Largest dynamic shared memory per block that a kernel may opt in to on `device`.
extern "C" int tm_max_shared_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
