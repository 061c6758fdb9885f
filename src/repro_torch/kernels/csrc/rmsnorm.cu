// RMSNorm for Hopper (sm_90a): out = (x * rsqrt(mean(x^2) + eps)) cast to
// the input type, times scale, for x (M, D) and scale (D,) of one type (f32
// or bf16). Replaces the TPU kernel kernels/rmsnorm.py::rmsnorm of the JAX
// package, with the rounding of its oracle kernels/ref.py::rmsnorm_ref
// (normalise, round to the input type, then multiply by the scale): the
// Pallas kernel rounds once after the scale, and in bf16 the two can differ
// by an ulp. The sum of squares, the mean and the rsqrt are in f32.
//
// Bound: bytes. It must read M*D + D elements and write M*D: at the serve
// path's prefill shape (8 x 1,024 rows, D = 960, bf16) that is 31.5 MB, about
// 9.4 us at 3.35 TB/s; at a decode step's (8, 960) it is 32 KB, well under a
// microsecond, so there the launch and the memory round trips the kernel
// waits on are the cost.
//
// Design: one warp per row, eight rows a block. Where D and the row start
// allow 16-byte loads (8 bf16 or 4 f32 a lane, neighbouring lanes on
// neighbouring addresses) and the row fits in R <= 8 such vectors a lane
// (2,048 bf16 or 1,024 f32, which covers SmolLM's D of 960 and Hymba's
// 1,600), the warp loads its row's vectors of x and the matching vectors of
// the scale in one pass into registers (rmsnorm_regs_kernel<T, R>, R the
// smallest power of two that holds the row), sums the squares, reduces with
// a butterfly of shuffles and writes from the same registers: x is read
// once and the warp waits on one round trip to memory, not two. Other rows
// take the loop (rmsnorm_kernel): pass 1 sums the squares (16-byte loads
// where allowed, element loads otherwise), pass 2 reads the row again (from
// L1/L2) and writes it. Both sum each lane's squares in the same order, so
// the two give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// out = T(T(x * r) * scale): the plain version's two roundings.
template <typename T>
__device__ __forceinline__ T norm_one(T x, float r, T s) {
  const float y = to_f32(from_f32<T>(__fmul_rn(to_f32(x), r)));
  return from_f32<T>(__fmul_rn(y, to_f32(s)));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out, int M,
               int D, float eps, int vec) {
  constexpr int kVec = 16 / sizeof(T);  // elements in a 16-byte load
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  T* orow = out + (size_t)row * D;
  float ss = 0.0f;
  if (vec) {
    for (int c = lane * kVec; c < D; c += 32 * kVec) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + c));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float f = to_f32(v[e]);
        ss = __fmaf_rn(f, f, ss);
      }
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      const float f = to_f32(xr[c]);
      ss = __fmaf_rn(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xFFFFFFFFu, ss, o);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)D), eps));
  if (vec) {
    for (int c = lane * kVec; c < D; c += 32 * kVec) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + c));
      const uint4 sraw = __ldg(reinterpret_cast<const uint4*>(scale + c));
      const T* v = reinterpret_cast<const T*>(&raw);
      const T* s = reinterpret_cast<const T*>(&sraw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = norm_one(v[e], r, s[e]);
      *reinterpret_cast<uint4*>(orow + c) = res;
    }
  } else {
    for (int c = lane; c < D; c += 32) orow[c] = norm_one(xr[c], r, scale[c]);
  }
}


template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_regs_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                    int M, int D, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  T* orow = out + (size_t)row * D;
  uint4 xv[R], sv[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {  // every load of the row issued before any use
    const int c = (i * 32 + lane) * kVec;
    if (c < D) {
      xv[i] = __ldg(reinterpret_cast<const uint4*>(xr + c));
      sv[i] = __ldg(reinterpret_cast<const uint4*>(scale + c));
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if ((i * 32 + lane) * kVec < D) {
      const T* v = reinterpret_cast<const T*>(&xv[i]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float f = to_f32(v[e]);
        ss = __fmaf_rn(f, f, ss);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xFFFFFFFFu, ss, o);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)D), eps));
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = (i * 32 + lane) * kVec;
    if (c < D) {
      const T* v = reinterpret_cast<const T*>(&xv[i]);
      const T* s = reinterpret_cast<const T*>(&sv[i]);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = norm_one(v[e], r, s[e]);
      *reinterpret_cast<uint4*>(orow + c) = res;
    }
  }
}

template <typename T>
int run(const void* x, const void* scale, void* out, int M, int D, float eps, int vec, int regs,
        void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (M < 1 || D < 1 || (regs && (!vec || D > 32 * regs * kVec)))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xx = static_cast<const T*>(x);
  const T* ss = static_cast<const T*>(scale);
  T* oo = static_cast<T*>(out);
  switch (regs) {
    case 0: rmsnorm_kernel<T><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps, vec); break;
    case 1: rmsnorm_regs_kernel<T, 1><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps); break;
    case 2: rmsnorm_regs_kernel<T, 2><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps); break;
    case 4: rmsnorm_regs_kernel<T, 4><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps); break;
    case 8: rmsnorm_regs_kernel<T, 8><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. x and out (M, D) row-major, scale (D,), all
// f32 (rmsnorm_f32) or all bf16 (rmsnorm_bf16). vec != 0 asks for 16-byte
// loads: the caller sets it only when D is a multiple of 16 / itemsize and
// x, scale and out start on 16-byte boundaries. regs in {1, 2, 4, 8} takes
// the register kernel with that many 16-byte vectors a lane (needs vec and
// D <= 32 * regs * 16 / itemsize); 0 takes the loop. Returns 0 or the CUDA
// error code of a failed launch.
extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out, int M, int D, float eps,
                           int vec, int regs, void* stream) {
  return run<float>(x, scale, out, M, D, eps, vec, regs, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out, int M, int D,
                            float eps, int vec, int regs, void* stream) {
  return run<__nv_bfloat16>(x, scale, out, M, D, eps, vec, regs, stream);
}
