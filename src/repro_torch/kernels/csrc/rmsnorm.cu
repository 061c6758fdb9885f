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
// Three routes; the caller (kernels/rmsnorm.py::plan) picks one and its
// shape. Where 16-byte loads are allowed (D a multiple of 16 / itemsize, x,
// scale and out on 16-byte boundaries: 8 bf16 or 4 f32 a load, neighbouring
// lanes on neighbouring addresses) x is read once, every load of a row is
// issued before any use, and a row's squares are summed in a fixed order,
// so a repeat gives the same bits.
//
// - Split route (rmsnorm_split_kernel<T, R>), every row of up to 32 x 32 x
//   4 vectors at prefill and rows past the register route at a decode step:
//   a row is split over a group of G warps, each lane holding R vectors of
//   x in registers. Each warp sums its squares by shuffles; the G sums meet
//   in shared memory and every thread adds them in warp order, so the bits
//   do not depend on scheduling; the output is written from the same
//   registers, the row never re-read. Rows past 2,048 bf16 or 1,024 f32
//   (Llama 4's 5,120, InternVL2's 6,144) take the fewest warps with R <= 4
//   at prefill and R <= 2 at a decode step, so a row's loads go out over
//   more lanes at once; narrower rows take G = 1 with the register route's
//   vectors, so their bits are the register route's. A block holds `rows`
//   rows (G x rows <= 32 warps), at 56-64 registers a thread so that an SM
//   holds 32 warps or more, and is persistent over row groups where they
//   outnumber what the card holds at once. It stages its share of the scale
//   in shared memory once (cp.async, each lane the vectors it will use),
//   not once a row from L2.
// - Register route (rmsnorm_regs_kernel<T, R>), a decode step's rows of up
//   to 2,048 bf16 or 1,024 f32 values (SmolLM's 960, Hymba's 1,600,
//   Qwen1.5-MoE's 2,048): one warp a row, eight rows a block. The warp
//   loads its row's vectors of x and of the scale into registers, R <= 8 a
//   lane, sums the squares, reduces with a butterfly of shuffles and
//   writes from the same registers: one round trip to memory. Holding the
//   scale in registers too (80 registers a thread at R = 4 in bf16, 151 at
//   R = 8) it keeps too few warps on an SM to stream a prefill.
// - Loop route (rmsnorm_kernel): rows without 16-byte loads, and rows past
//   the split route's 32 x 32 x 4 vectors. One warp a row: pass 1 sums the
//   squares (16-byte loads where allowed, element loads otherwise), pass 2
//   reads the row again (from L1/L2) and writes it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // rows a block on the loop and register routes
constexpr int kMaxWarps = 32;      // warps a block on the split route
enum Route { kLoop = 0, kRegs = 1, kSplit = 2 };

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

// A block of G x rows warps: row slot `slot` of each row group takes warps
// slot * G .. slot * G + G - 1, and lane `lane` of the slot's warp w holds
// vectors (i * G + w) * 32 + lane, i < R, of the row (a warp's load is 512
// contiguous bytes; at G = 1 a lane holds the register route's vectors and
// sums them in its order). The block is persistent over row groups.
// Dynamic shared memory: the block's share of the scale, G x R x 32
// vectors.
template <typename T, int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_split_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                     int M, int D, float eps, int G, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ uint4 s_scale[];
  __shared__ float part[2][kMaxWarps];  // each warp's sum of squares, by iteration parity
  const int V = D / kVec;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / G, w = warp - slot * G;
  if (slot == 0) {  // the scale, staged once a block, lands with the first rows
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = (i * G + w) * 32 + lane;
      if (c < V) cp_async16(&s_scale[c], scale + (size_t)c * kVec);
    }
  }
  const int groups = (M + rows - 1) / rows;
  int it = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x, ++it) {
    const int row = g * rows + slot;
    const bool live = row < M;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
    uint4 xv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {  // every load of the row issued before any use
      const int c = (i * G + w) * 32 + lane;
      if (live && c < V) xv[i] = __ldg(xr + c);
    }
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (live && (i * G + w) * 32 + lane < V) {
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
    float* p = part[it & 1];
    if (lane == 0) p[warp] = ss;
    if (it == 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the warps' sums (and, the first time, the scale) are in place
    float tot = p[slot * G];
    for (int k = 1; k < G; ++k) tot += p[slot * G + k];  // in warp order
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(tot, (float)D), eps));
    if (live) {
      uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int c = (i * G + w) * 32 + lane;
        if (c < V) {
          const uint4 sv = s_scale[c];
          const T* v = reinterpret_cast<const T*>(&xv[i]);
          const T* sc = reinterpret_cast<const T*>(&sv);
          uint4 res;
          T* o = reinterpret_cast<T*>(&res);
#pragma unroll
          for (int e = 0; e < kVec; ++e) o[e] = norm_one(v[e], r, sc[e]);
          orow[c] = res;
        }
      }
    }
  }
}

int sm_count(int& sms) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, int R>
int launch_split(const T* x, const T* scale, T* out, int M, int D, float eps, int G, int rows,
                 cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      rmsnorm_split_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxWarps * R * 512);
  if (attr != cudaSuccess) return (int)attr;
  const int groups = (M + rows - 1) / rows, smem = G * R * 512;
  int grid = groups, sms = 0;
  if (const int rc = sm_count(sms)) return rc;
  if (groups > sms) {  // persistent over row groups where they outnumber what the card holds
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rmsnorm_split_kernel<T, R>,
                                                      G * rows * 32, smem) != cudaSuccess ||
        per_sm < 1)
      return (int)cudaErrorInvalidConfiguration;
    if ((long long)grid > (long long)per_sm * sms) grid = per_sm * sms;
  }
  rmsnorm_split_kernel<T, R><<<grid, G * rows * 32, smem, st>>>(x, scale, out, M, D, eps, G, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* scale, void* out, int M, int D, float eps, int vec, int route,
        int vectors, int warps, int rows, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (M < 1 || D < 1 || (route != kLoop && !vec)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xx = static_cast<const T*>(x);
  const T* ss = static_cast<const T*>(scale);
  T* oo = static_cast<T*>(out);
  if (route == kLoop) {
    rmsnorm_kernel<T><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps, vec);
    return (int)cudaGetLastError();
  }
  if (route == kRegs) {
    if (D > 32 * vectors * kVec) return (int)cudaErrorInvalidValue;
    switch (vectors) {
      case 1: rmsnorm_regs_kernel<T, 1><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps); break;
      case 2: rmsnorm_regs_kernel<T, 2><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps); break;
      case 4: rmsnorm_regs_kernel<T, 4><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps); break;
      case 8: rmsnorm_regs_kernel<T, 8><<<blocks, kWarps * 32, 0, st>>>(xx, ss, oo, M, D, eps); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  if (route != kSplit || warps < 1 || rows < 1 || warps * rows > kMaxWarps ||
      32LL * warps * vectors * kVec < D)
    return (int)cudaErrorInvalidValue;
  switch (vectors) {
    case 1: return launch_split<T, 1>(xx, ss, oo, M, D, eps, warps, rows, st);
    case 2: return launch_split<T, 2>(xx, ss, oo, M, D, eps, warps, rows, st);
    case 3: return launch_split<T, 3>(xx, ss, oo, M, D, eps, warps, rows, st);
    case 4: return launch_split<T, 4>(xx, ss, oo, M, D, eps, warps, rows, st);
    case 8:
      if (warps != 1) return (int)cudaErrorInvalidValue;
      return launch_split<T, 8>(xx, ss, oo, M, D, eps, warps, rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, bound with ctypes. x and out (M, D) row-major, scale (D,), all
// f32 (rmsnorm_f32) or all bf16 (rmsnorm_bf16). vec != 0 says 16-byte loads
// are allowed: D a multiple of 16 / itemsize and x, scale and out on 16-byte
// boundaries. route 0 takes the loop (vec or not); 1 the register route with
// `vectors` in {1, 2, 4, 8} 16-byte vectors a lane (D <= 32 * vectors * 16 /
// itemsize); 2 the split route, which needs vec: `warps` (G) warps a row,
// `vectors` in {1, 2, 3, 4} (or 8 at G = 1), 32 x G x vectors vectors
// covering D, `rows` rows a block (G x rows <= 32). Returns 0 or the CUDA
// error code of a refused or failed launch.
extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out, int M, int D, float eps,
                           int vec, int route, int vectors, int warps, int rows, void* stream) {
  return run<float>(x, scale, out, M, D, eps, vec, route, vectors, warps, rows, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out, int M, int D,
                            float eps, int vec, int route, int vectors, int warps, int rows,
                            void* stream) {
  return run<__nv_bfloat16>(x, scale, out, M, D, eps, vec, route, vectors, warps, rows, stream);
}
