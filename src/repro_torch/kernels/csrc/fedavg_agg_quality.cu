// Fused FedAvg aggregation + quality pass for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/fedavg_agg.py::fedavg_agg_quality of the
// JAX package. From the stacked client updates U (K, P), f32 or bf16, and
// the FedAvg weights w (K,), f32, it computes
//   agg[p]  = sum_k w_k U[k, p]          (P,)  in U's dtype
//   dots[k] = <U[k], agg_f32>            (K,)  f32
//   sq[k]   = ||U[k]||^2                 (K,)  f32
//   asq     = ||agg_f32||^2              ()    f32
// with every sum in f32 and U read from device memory once.
//
// Bound: bandwidth. At the main path's shape (K = 13, P = 1,070,794, f32)
// the pass reads 55.7 MB and writes 4.3 MB, about 18 us at 3.35 TB/s; it
// does about 6KP flops, 1.5 per byte read, far below the card's ridge.
//
// Design. The TPU kernel walked the P-blocks in order and carried the sums
// in its outputs. Here the blocks run in parallel: each thread owns one
// column at a time, holds that column's K values in registers (so its agg
// entry is complete and U is not read again), and keeps per-client partial
// dots and squares in registers across a grid-stride loop. Each block then
// reduces its threads' partials (warp shuffles, then warps in a fixed
// order) into partial_dots/partial_sq (nblocks, K) and partial_asq
// (nblocks,). A second kernel sums the partials in a fixed order. No float
// atomics, so results repeat bit for bit from run to run. The grid depends
// on P only. The ragged tail is masked by the column bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int KB>
__global__ void __launch_bounds__(kThreads)
agg_quality_partials(const T* __restrict__ u, const float* __restrict__ w,
                     T* __restrict__ agg, float* __restrict__ part_dots,
                     float* __restrict__ part_sq, float* __restrict__ part_asq,
                     int K, long long P) {
  __shared__ float s_w[KB];
  __shared__ float s_red[kWarps][2 * KB + 1];
  for (int k = threadIdx.x; k < KB; k += kThreads) s_w[k] = k < K ? w[k] : 0.f;
  __syncthreads();

  float dacc[KB], qacc[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    dacc[k] = 0.f;
    qacc[k] = 0.f;
  }
  float aacc = 0.f;

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x; c < P;
       c += stride) {
    float x[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) x[k] = k < K ? load_f32(u + (long long)k * P + c) : 0.f;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < KB; ++k) a = fmaf(s_w[k], x[k], a);
    store_from_f32(agg + c, a);
    aacc = fmaf(a, a, aacc);
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      dacc[k] = fmaf(x[k], a, dacc[k]);
      qacc[k] = fmaf(x[k], x[k], qacc[k]);
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float d = warp_sum(dacc[k]);
    const float q = warp_sum(qacc[k]);
    if (lane == 0) {
      s_red[warp][k] = d;
      s_red[warp][KB + k] = q;
    }
  }
  const float a = warp_sum(aacc);
  if (lane == 0) s_red[warp][2 * KB] = a;
  __syncthreads();

  const int t = threadIdx.x;
  if (t <= 2 * KB) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += s_red[i][t];
    const long long b = blockIdx.x;
    if (t < K) {
      part_dots[b * K + t] = s;
    } else if (t >= KB && t < KB + K) {
      part_sq[b * K + (t - KB)] = s;
    } else if (t == 2 * KB) {
      part_asq[b] = s;
    }
  }
}

// One block per output (K dots, K squares, 1 agg square); each sums its
// nblocks partials in a fixed order.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ part_dots,
                const float* __restrict__ part_sq,
                const float* __restrict__ part_asq, float* __restrict__ out,
                int K, int nblocks) {
  const int o = blockIdx.x;
  const float* src;
  int step;
  if (o < K) {
    src = part_dots + o;
    step = K;
  } else if (o < 2 * K) {
    src = part_sq + (o - K);
    step = K;
  } else {
    src = part_asq;
    step = 1;
  }
  float s = 0.f;
  for (int i = threadIdx.x; i < nblocks; i += kThreads) s += src[(long long)i * step];
  __shared__ float red[kThreads];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = red[0];
}

template <typename T>
int launch(const void* u, const void* w, void* agg, void* part_dots,
           void* part_sq, void* part_asq, void* out, int K, long long P,
           int nblocks, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || P < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const T* uu = static_cast<const T*>(u);
  const float* ww = static_cast<const float*>(w);
  T* aa = static_cast<T*>(agg);
  float* pd = static_cast<float*>(part_dots);
  float* pq = static_cast<float*>(part_sq);
  float* pa = static_cast<float*>(part_asq);
  if (K <= 16) {
    agg_quality_partials<T, 16><<<nblocks, kThreads, 0, stream>>>(uu, ww, aa, pd, pq, pa, K, P);
  } else if (K <= 32) {
    agg_quality_partials<T, 32><<<nblocks, kThreads, 0, stream>>>(uu, ww, aa, pd, pq, pa, K, P);
  } else {
    agg_quality_partials<T, 64><<<nblocks, kThreads, 0, stream>>>(uu, ww, aa, pd, pq, pa, K, P);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<2 * K + 1, kThreads, 0, stream>>>(pd, pq, pa, static_cast<float*>(out), K,
                                                      nblocks);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. `out` holds dots (K), sq (K) and asq (1)
// back to back. Returns 0 or the CUDA error code of the failed launch.
extern "C" int fedavg_agg_quality_f32(const void* u, const void* w, void* agg,
                                      void* part_dots, void* part_sq, void* part_asq,
                                      void* out, int K, long long P, int nblocks,
                                      void* stream) {
  return launch<float>(u, w, agg, part_dots, part_sq, part_asq, out, K, P, nblocks,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int fedavg_agg_quality_bf16(const void* u, const void* w, void* agg,
                                       void* part_dots, void* part_sq, void* part_asq,
                                       void* out, int K, long long P, int nblocks,
                                       void* stream) {
  return launch<__nv_bfloat16>(u, w, agg, part_dots, part_sq, part_asq, out, K, P, nblocks,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int fedavg_agg_quality_max_k() { return kMaxK; }
