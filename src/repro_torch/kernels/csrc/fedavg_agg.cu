// Weighted column sum of the client updates for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/fedavg_agg.py::fedavg_agg:
// from the stacked client updates U (K, P), f32 or bf16, and the FedAvg
// weights w (K,), f32, it computes the paper's aggregate
//   agg[p] = sum_k w_k U[k, p]        (P,)  in U's dtype, summed in f32.
// The host-loop round (fl.round.make_fl_round with use_agg_kernel=True)
// launches it once per parameter leaf.
//
// Bound: bandwidth. It reads K*P*itemsize + 4K bytes and writes
// P*itemsize, and does 2KP flops: half a flop per byte in f32, far below
// the card's ridge. At K = 13, P = 1,070,794 f32 that is 59.97 MB, about
// 17.9 us at 3.35 TB/s.
//
// Design. Each thread owns VEC adjacent columns at a time in a grid-stride
// loop and reads them with one VEC-wide load per client row (16, 8 or 4
// bytes: the binding picks the widest that P and the base address allow,
// so no vector straddles a row end). It walks k from 0 to K-1 in order
// with one f32 accumulator per column (fmaf from 0), so the sum repeats
// bit for bit and does not depend on the grid. The weights sit in shared
// memory: loaded once per block when K <= kTile (every round of the
// service), else a tile at a time, with loop bounds uniform over the block
// so every thread reaches each barrier. One accumulator per column needs
// no register tile over K, so K has no upper limit. Columns past P are
// masked by the bound on the column group.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // weights staged per pass (8 KB)

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc[i] += w * U[k, g*VEC + i] for one row; `row` points at U[k, g*VEC].
template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const T* __restrict__ row, float w, float* acc) {
  const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(row);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w, to_f32(p.v[i]), acc[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* __restrict__ out, const float* acc) {
  Pack<T, VEC> p;
#pragma unroll
  for (int i = 0; i < VEC; ++i) from_f32(&p.v[i], acc[i]);
  *reinterpret_cast<Pack<T, VEC>*>(out) = p;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_kernel(const T* __restrict__ u, const float* __restrict__ w, T* __restrict__ agg,
                  int K, long long P) {
  __shared__ float s_w[kTile];
  const long long G = P / VEC;  // column groups; the binding makes VEC divide P
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads;

  if (K <= kTile) {
    for (int k = threadIdx.x; k < K; k += kThreads) s_w[k] = w[k];
    __syncthreads();
    for (long long g = first + threadIdx.x; g < G; g += stride) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      const T* col = u + g * VEC;
#pragma unroll 4
      for (int k = 0; k < K; ++k) accumulate<T, VEC>(col + (long long)k * P, s_w[k], acc);
      store<T, VEC>(agg + g * VEC, acc);
    }
    return;
  }

  for (long long g0 = first; g0 < G; g0 += stride) {
    const long long g = g0 + threadIdx.x;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    const T* col = u + g * VEC;
    for (int k0 = 0; k0 < K; k0 += kTile) {
      const int kn = K - k0 < kTile ? K - k0 : kTile;
      __syncthreads();
      for (int k = threadIdx.x; k < kn; k += kThreads) s_w[k] = w[k0 + k];
      __syncthreads();
      if (g < G) {
#pragma unroll 4
        for (int k = 0; k < kn; ++k)
          accumulate<T, VEC>(col + (long long)(k0 + k) * P, s_w[k], acc);
      }
    }
    if (g < G) store<T, VEC>(agg + g * VEC, acc);
  }
}

template <typename T, int VEC>
int launch_vec(const void* u, const void* w, void* agg, int K, long long P, int nblocks,
               cudaStream_t stream) {
  fedavg_agg_kernel<T, VEC><<<nblocks, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(w), static_cast<T*>(agg), K, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* u, const void* w, void* agg, int K, long long P, int vec, int nblocks,
           cudaStream_t stream) {
  if (K < 1 || P < 1 || nblocks < 1 || vec < 1 || P % vec != 0 ||
      vec * (int)sizeof(T) > 16)
    return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 1: return launch_vec<T, 1>(u, w, agg, K, P, nblocks, stream);
    case 2: return launch_vec<T, 2>(u, w, agg, K, P, nblocks, stream);
    case 4: return launch_vec<T, 4>(u, w, agg, K, P, nblocks, stream);
    case 8:
      if constexpr (sizeof(T) <= 2) return launch_vec<T, 8>(u, w, agg, K, P, nblocks, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, bound with ctypes. `vec` is the number of columns a thread
// loads at once: it must divide P, and U and agg must be aligned to
// vec * itemsize bytes. Returns 0 or the CUDA error code of the launch.
extern "C" int fedavg_agg_f32(const void* u, const void* w, void* agg, int K, long long P,
                              int vec, int nblocks, void* stream) {
  return launch<float>(u, w, agg, K, P, vec, nblocks, static_cast<cudaStream_t>(stream));
}

extern "C" int fedavg_agg_bf16(const void* u, const void* w, void* agg, int K, long long P,
                               int vec, int nblocks, void* stream) {
  return launch<__nv_bfloat16>(u, w, agg, K, P, vec, nblocks, static_cast<cudaStream_t>(stream));
}
