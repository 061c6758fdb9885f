// Weighted column sum of the client updates for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/fedavg_agg.py::fedavg_agg:
// from the stacked client updates U (K, P), f32 or bf16, and the FedAvg
// weights w (K,), f32, it computes the paper's aggregate
//   agg[p] = sum_k w_k U[k, p]        (P,)  in U's dtype, summed in f32.
// fedavg_agg_leaves takes the same sum over every leaf of stacked
// parameters in one launch: the host-loop round (fl.round.make_fl_round with
// use_agg_kernel=True) launches it once a round.
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
//
// Leaves. A round's 8 CIFAR_CNN leaves hold 10 to 1,048,576 columns; launched
// one by one, seven of them are one latency-bound block each. The leaves
// kernel takes a table of up to kMaxLeaves leaves (input and output pointers,
// P, vector width and first chunk of each) as one __grid_constant__
// parameter, so no table lives in device memory and nothing is copied to the
// card per round. Blocks walk the concatenated column space in chunks of
// kThreads column groups; each leaf starts on a chunk boundary, so a chunk
// lies in one leaf, found by a scan of the table that is uniform over the
// block. Every column group then runs the same loop as above (fmaf over k
// from 0), so each output is bit-equal to the leaf's own launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Stage the weights in shared memory once per block when they fit (every
// round of the service); returns whether they were staged.
__device__ __forceinline__ bool stage_weights(const float* __restrict__ w, float* s_w, int K) {
  if (K > kTile) return false;
  for (int k = threadIdx.x; k < K; k += kThreads) s_w[k] = w[k];
  __syncthreads();
  return true;
}

// Column group g (VEC columns) of one (K, P) matrix: sum over k from 0 to
// K-1, one fmaf a term. Unstaged weights go through s_w a tile at a time;
// every thread of the block calls this together (the barriers), and a group
// past P only takes part in them.
template <typename T, int VEC>
__device__ __forceinline__ void column_group(const T* __restrict__ u, T* __restrict__ agg,
                                             long long P, long long g,
                                             const float* __restrict__ w, float* s_w, int K,
                                             bool staged) {
  const bool on = g < P / VEC;  // the binding makes VEC divide P
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  const T* col = u + g * VEC;
  if (staged) {
    if (!on) return;
#pragma unroll 4
    for (int k = 0; k < K; ++k) accumulate<T, VEC>(col + (long long)k * P, s_w[k], acc);
  } else {
    for (int k0 = 0; k0 < K; k0 += kTile) {
      const int kn = K - k0 < kTile ? K - k0 : kTile;
      __syncthreads();
      for (int k = threadIdx.x; k < kn; k += kThreads) s_w[k] = w[k0 + k];
      __syncthreads();
      if (on) {
#pragma unroll 4
        for (int k = 0; k < kn; ++k)
          accumulate<T, VEC>(col + (long long)(k0 + k) * P, s_w[k], acc);
      }
    }
    if (!on) return;
  }
  store<T, VEC>(agg + g * VEC, acc);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_kernel(const T* __restrict__ u, const float* __restrict__ w, T* __restrict__ agg,
                  int K, long long P) {
  __shared__ float s_w[kTile];
  const bool staged = stage_weights(w, s_w, K);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g0 = (long long)blockIdx.x * kThreads; g0 < P / VEC; g0 += stride)
    column_group<T, VEC>(u, agg, P, g0 + threadIdx.x, w, s_w, K, staged);
}

// ------------------------------------------------------ every leaf at once
constexpr int kMaxLeaves = 32;

template <typename T>
struct Leaves {
  const T* u[kMaxLeaves];
  T* agg[kMaxLeaves];
  long long P[kMaxLeaves];
  int vec[kMaxLeaves];
  int chunk0[kMaxLeaves + 1];  // each leaf's first chunk, then the total
  int n;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_leaves_kernel(const __grid_constant__ Leaves<T> t, const float* __restrict__ w,
                         int K) {
  __shared__ float s_w[kTile];
  const bool staged = stage_weights(w, s_w, K);
  for (int c = blockIdx.x; c < t.chunk0[t.n]; c += gridDim.x) {
    int i = 0;
    while (i + 1 < t.n && t.chunk0[i + 1] <= c) ++i;
    const long long g = (long long)(c - t.chunk0[i]) * kThreads + threadIdx.x;
    switch (t.vec[i]) {
      case 1: column_group<T, 1>(t.u[i], t.agg[i], t.P[i], g, w, s_w, K, staged); break;
      case 2: column_group<T, 2>(t.u[i], t.agg[i], t.P[i], g, w, s_w, K, staged); break;
      case 4: column_group<T, 4>(t.u[i], t.agg[i], t.P[i], g, w, s_w, K, staged); break;
      default:
        if constexpr (sizeof(T) <= 2)
          column_group<T, 8>(t.u[i], t.agg[i], t.P[i], g, w, s_w, K, staged);
    }
  }
}

template <typename T>
int launch_leaves(const void* const* u, void* const* agg, const long long* P, const int* vec,
                  const int* chunk0, int n, const void* w, int K, int nblocks,
                  cudaStream_t stream) {
  if (n < 1 || n > kMaxLeaves || K < 1 || nblocks < 1 || chunk0[0] != 0)
    return (int)cudaErrorInvalidValue;
  Leaves<T> t;
  t.n = n;
  for (int i = 0; i < n; ++i) {
    const int v = vec[i];
    const unsigned long long align = (unsigned long long)v * sizeof(T);
    if (P[i] < 1 || !(v == 1 || v == 2 || v == 4 || v == 8) || v * (int)sizeof(T) > 16 ||
        P[i] % v != 0 || reinterpret_cast<uintptr_t>(u[i]) % align ||
        reinterpret_cast<uintptr_t>(agg[i]) % align ||
        (long long)chunk0[i + 1] - chunk0[i] != (P[i] / v + kThreads - 1) / kThreads)
      return (int)cudaErrorInvalidValue;
    t.u[i] = static_cast<const T*>(u[i]);
    t.agg[i] = static_cast<T*>(agg[i]);
    t.P[i] = P[i];
    t.vec[i] = v;
    t.chunk0[i] = chunk0[i];
  }
  t.chunk0[n] = chunk0[n];
  fedavg_agg_leaves_kernel<T><<<nblocks, kThreads, 0, stream>>>(t, static_cast<const float*>(w),
                                                                 K);
  return (int)cudaGetLastError();
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

// Every leaf of a table in one launch. Leaf i is a (K, P[i]) matrix at u[i]
// into agg[i], read vec[i] columns at a time (vec[i] divides P[i]; u[i] and
// agg[i] aligned to vec[i] * itemsize bytes); chunk0[i] is its first chunk
// of 256 column groups and chunk0[n] the total (host arrays, n + 1 of them).
// Returns 0 or the CUDA error code of the launch.
extern "C" int fedavg_agg_leaves_f32(const void* const* u, void* const* agg, const long long* P,
                                     const int* vec, const int* chunk0, int n, const void* w,
                                     int K, int nblocks, void* stream) {
  return launch_leaves<float>(u, agg, P, vec, chunk0, n, w, K, nblocks,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int fedavg_agg_leaves_bf16(const void* const* u, void* const* agg, const long long* P,
                                      const int* vec, const int* chunk0, int n, const void* w,
                                      int K, int nblocks, void* stream) {
  return launch_leaves<__nv_bfloat16>(u, agg, P, vec, chunk0, n, w, K, nblocks,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int fedavg_agg_max_leaves() { return kMaxLeaves; }
