// Per-chunk symmetric int8 quantization and its inverse for Hopper (sm_90a):
// the int8 codec of the compressed update plane.
//
// Replaces two TPU kernels of the JAX package:
// - kernels/compression.py::quantize_i8: x (K, P) f32 -> values (K, P)
//   int8 and scales (K, nc) f32, nc = ceil(P / chunk). For each chunk,
//   scale = amax(|x|) * fl(1/127) (the Pallas kernel's and the jitted
//   oracle's rule: XLA folds the constant division into a multiply by the
//   f32 reciprocal) and value = rint(x / scale) clipped to +-127, a true
//   IEEE division rounded half to even; an all-zero chunk keeps scale 0
//   and values 0. The ragged tail is read as zeros (they cannot raise
//   amax and are not written). Every step is one correctly rounded f32
//   operation, so the result equals the plain version bit for bit; this
//   file must not be built with --use_fast_math, and the division must
//   stay a division (x * (1 / scale) is not correctly rounded in every
//   case, and one flipped rounding changes an int8 value). Non-finite
//   input keeps the JAX package's semantics: the chunk max propagates NaN
//   (as jnp.max does), so a chunk holding a NaN gets scale NaN and values
//   0 (NaN > 0 is false); a chunk holding +-inf gets scale inf, its finite
//   values quantize to 0 and its +-inf values give inf / inf = NaN, which
//   converts to 0 as XLA's float-to-int8 conversion does. (A NaN scale is
//   the canonical NaN; only its payload bits may differ from the plain
//   version's.)
// - kernels/compression.py::dequantize_i8: values (K, P) int8 and scales
//   -> (K, P) f32, float(v) * scale of its chunk, one rounding.
//
// Bound: bytes. quantize reads 4 B and writes 1 B per element plus 4 B a
// chunk: at (13, 1,070,794) with chunks of 256, 55.7 MB in and 14.1 MB
// out, 20.8 us at 3.35 TB/s; at the top-k values (13, 53,540), 1.0 us.
// dequantize at (13, 53,540): 0.70 MB in, 2.8 MB out, 1.0 us. At that
// small shape a launch costs more than the bytes.
//
// Design. One warp per (row, chunk), eight warps a block, no shared
// memory and no block barrier; the grid is one block per eight chunks (at
// (13, 53,540) with chunks of 256, 342 blocks: one wave of the card).
// For a full chunk of 128, 256 or 512 values (kernel template G = chunk /
// 128) a lane holds G groups of 4 consecutive values in registers, group
// lane + 32 t, so each of the warp's accesses covers one contiguous span:
// - quantize issues every load of its chunk (two 16-byte loads a lane at
//   chunk 256: 1 KB in flight a warp, some 64 KB an SM at full occupancy,
//   where Little's law asks about 18 KB) before the first max, reduces
//   amax over its registers and by five shuffles, and quantizes the same
//   registers: x is read once. It writes each group's 4 values as one
//   char4. The earlier kernel strided the chunk twice: its first pass
//   already had eight loads in flight (the compiler unrolled it), but its
//   second re-read each value inside the scale branch, behind the previous
//   value's division and its one-byte store.
// - dequantize reads the chunk's scale once, each group's 4 int8 values
//   as one char4, and writes one float4: no division by P or by the
//   chunk anywhere (the earlier grid-stride loop divided twice in 64 bits
//   for every element before it could gather its scale), one wave.
// The access width comes from the chunk's actual address, not from P: a
// row of P = 1,070,794 f32 starts 16- or 8-byte aligned and its int8 row
// 4- or 2-byte aligned, the int8 rows of P = 53,540 start at 0, 4, 8 or
// 12 mod 16, and a view at a storage offset can start anywhere. A group
// is then read or written as 4, 2 or 1 elements at a time, warp-uniform,
// with the same register layout. Any other chunk, and a row's ragged last
// chunk, take the general loop of the same kernel (a lane strides the
// chunk 32 values at a time; quantize reads it twice).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// fl(1/127) = 0x3C010204, spelled as bits so no compiler rounds it again.
#define INV_127 __uint_as_float(0x3C010204u)

// max that keeps NaN, as jnp.max does (fmaxf drops it): one max.NaN
// instruction (sm_80 and later), as cheap as fmaxf
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float warp_amax(float amax) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return amax;
}

// One value's int8: round half to even into an int (a NaN quotient,
// inf / inf, converts to 0 as XLA's cast does), then the clip on
// integers; 0 where the scale is not positive (all-zero or NaN chunk).
__device__ __forceinline__ int quantize_one(float x, float scale) {
  return scale > 0.f ? min(max(__float2int_rn(__fdiv_rn(x, scale)), -127), 127) : 0;
}

// Elements of `bytes` each that one access at p may move: 4, 2 or 1.
__device__ __forceinline__ int width(const void* p, int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return a % (4 * bytes) == 0 ? 4 : a % (2 * bytes) == 0 ? 2 : 1;
}

// v[4 t + i] = p[4 (lane + 32 t) + i]: G groups of 4 consecutive values.
template <int G, typename T>
__device__ __forceinline__ void load_groups(const T* __restrict__ p, int lane, int w,
                                            T (&v)[4 * G]) {
  if (w == 4) {
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int j = 4 * (lane + 32 * t);
      if constexpr (sizeof(T) == 4) {
        const float4 a = *reinterpret_cast<const float4*>(p + j);
        v[4 * t] = a.x, v[4 * t + 1] = a.y, v[4 * t + 2] = a.z, v[4 * t + 3] = a.w;
      } else {
        const char4 a = *reinterpret_cast<const char4*>(p + j);
        v[4 * t] = a.x, v[4 * t + 1] = a.y, v[4 * t + 2] = a.z, v[4 * t + 3] = a.w;
      }
    }
  } else if (w == 2) {
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int j = 4 * (lane + 32 * t);
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        if constexpr (sizeof(T) == 4) {
          const float2 a = *reinterpret_cast<const float2*>(p + j + h);
          v[4 * t + h] = a.x, v[4 * t + h + 1] = a.y;
        } else {
          const char2 a = *reinterpret_cast<const char2*>(p + j + h);
          v[4 * t + h] = a.x, v[4 * t + h + 1] = a.y;
        }
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < G; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * t + i] = p[4 * (lane + 32 * t) + i];
  }
}

// The f32 vector stores are written in PTX: with plain float4 and float2
// stores, the compiler merged the first group's stores of the three width
// branches into four 4-byte stores.
__device__ __forceinline__ void st_v4(float* p, float a, float b, float c, float d) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(a), "f"(b), "f"(c),
               "f"(d) : "memory");
}

__device__ __forceinline__ void st_v2(float* p, float a, float b) {
  asm volatile("st.global.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a), "f"(b) : "memory");
}

// p[4 (lane + 32 t) + i] = v[4 t + i], the inverse of load_groups.
template <int G, typename T>
__device__ __forceinline__ void store_groups(T* __restrict__ p, int lane, int w,
                                             const T (&v)[4 * G]) {
  if (w == 4) {
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int j = 4 * (lane + 32 * t);
      if constexpr (sizeof(T) == 4)
        st_v4(p + j, v[4 * t], v[4 * t + 1], v[4 * t + 2], v[4 * t + 3]);
      else
        *reinterpret_cast<char4*>(p + j) =
            make_char4(v[4 * t], v[4 * t + 1], v[4 * t + 2], v[4 * t + 3]);
    }
  } else if (w == 2) {
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int j = 4 * (lane + 32 * t);
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        if constexpr (sizeof(T) == 4)
          st_v2(p + j + h, v[4 * t + h], v[4 * t + h + 1]);
        else
          *reinterpret_cast<char2*>(p + j + h) = make_char2(v[4 * t + h], v[4 * t + h + 1]);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < G; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[4 * (lane + 32 * t) + i] = v[4 * t + i];
  }
}

// G = chunk / 128 for chunks of 128, 256 and 512 (the unrolled path of a
// full chunk); G = 0 takes the general loop for every chunk.
template <int G>
__global__ void __launch_bounds__(kThreads)
quantize_i8_kernel(const float* __restrict__ x, signed char* __restrict__ vals,
                   float* __restrict__ scales, long long P, int chunk, long long nc,
                   long long n_chunks) {
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= n_chunks) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long row = g / nc, c0 = (g - row * nc) * chunk;
  const long long rest = P - c0;
  const int n = rest < chunk ? (int)rest : chunk;
  const float* xr = x + row * P + c0;
  signed char* vr = vals + row * P + c0;
  if constexpr (G > 0) {
    if (n == chunk) {
      float v[4 * G];
      load_groups<G>(xr, lane, width(xr, 4), v);  // every load before the first max
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) amax = nan_max(amax, fabsf(v[i]));
      const float scale = __fmul_rn(warp_amax(amax), INV_127);
      signed char q[4 * G];
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) q[i] = (signed char)quantize_one(v[i], scale);
      store_groups<G>(vr, lane, width(vr, 1), q);
      if (lane == 0) scales[g] = scale;  // g == row * nc + chunk index
      return;
    }
  }
  float amax = 0.f;
  for (int i = lane; i < n; i += 32) amax = nan_max(amax, fabsf(xr[i]));
  const float scale = __fmul_rn(warp_amax(amax), INV_127);
  for (int i = lane; i < n; i += 32) vr[i] = (signed char)quantize_one(xr[i], scale);
  if (lane == 0) scales[g] = scale;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
dequantize_i8_kernel(const signed char* __restrict__ vals, const float* __restrict__ scales,
                     float* __restrict__ out, long long P, int chunk, long long nc,
                     long long n_chunks) {
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= n_chunks) return;
  const int lane = threadIdx.x & 31;
  const long long row = g / nc, c0 = (g - row * nc) * chunk;
  const long long rest = P - c0;
  const int n = rest < chunk ? (int)rest : chunk;
  const float scale = scales[g];  // one word, broadcast to the warp
  const signed char* vr = vals + row * P + c0;
  float* orow = out + row * P + c0;
  if constexpr (G > 0) {
    if (n == chunk) {
      signed char v[4 * G];
      load_groups<G>(vr, lane, width(vr, 1), v);
      float f[4 * G];
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) f[i] = __fmul_rn((float)v[i], scale);
      store_groups<G>(orow, lane, width(orow, 4), f);
      return;
    }
  }
  for (int i = lane; i < n; i += 32) orow[i] = __fmul_rn((float)vr[i], scale);
}

unsigned blocks_for(long long n_chunks) {
  return (unsigned)((n_chunks + kWarps - 1) / kWarps);
}

}  // namespace

// C interface, bound with ctypes. x (K, P) f32; vals (K, P) int8; scales
// (K, nc) f32 with nc = ceil(P / chunk); any addresses of their types'
// alignment. Returns 0 or the CUDA error code of the failed launch.
extern "C" int quantize_i8_f32(const void* x, void* vals, void* scales, int K, long long P,
                               int chunk, long long nc, void* stream) {
  if (K < 1 || P < 1 || chunk < 1 || nc != (P + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  // the unrolled path for chunks of 128, 256 and 512, else the general loop
  const auto kernel = chunk == 128   ? quantize_i8_kernel<1>
                      : chunk == 256 ? quantize_i8_kernel<2>
                      : chunk == 512 ? quantize_i8_kernel<4>
                                     : quantize_i8_kernel<0>;
  const long long n_chunks = (long long)K * nc;
  kernel<<<blocks_for(n_chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(vals),
      static_cast<float*>(scales), P, chunk, nc, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int dequantize_i8_f32(const void* vals, const void* scales, void* out, int K,
                                 long long P, int chunk, long long nc, void* stream) {
  if (K < 1 || P < 1 || chunk < 1 || nc != (P + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  const auto kernel = chunk == 128   ? dequantize_i8_kernel<1>
                      : chunk == 256 ? dequantize_i8_kernel<2>
                      : chunk == 512 ? dequantize_i8_kernel<4>
                                     : dequantize_i8_kernel<0>;
  const long long n_chunks = (long long)K * nc;
  kernel<<<blocks_for(n_chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(vals), static_cast<const float*>(scales),
      static_cast<float*>(out), P, chunk, nc, n_chunks);
  return (int)cudaGetLastError();
}
