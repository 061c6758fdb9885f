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
//   file must not be built with --use_fast_math. Non-finite input keeps
//   the JAX package's semantics: the chunk max propagates NaN (as jnp.max
//   does), so a chunk holding a NaN gets scale NaN and values 0 (NaN > 0
//   is false); a chunk holding +-inf gets scale inf, its finite values
//   quantize to 0 and its +-inf values give inf / inf = NaN, which casts
//   to 0 as XLA's float-to-int8 conversion does. (A NaN scale is the
//   canonical NaN; only its payload bits may differ from the plain
//   version's.)
// - kernels/compression.py::dequantize_i8: values (K, P) int8 and scales
//   -> (K, P) f32, float(v) * scale of its chunk, one rounding.
//
// Bound: bytes. quantize reads 4 B and writes 1 B per element plus 4 B a
// chunk: at (13, 1,070,794) with chunks of 256, 55.7 MB in and 14.1 MB
// out, 20.8 us at 3.35 TB/s. dequantize at (13, 53,540): 0.70 MB in,
// 2.8 MB out, about 1 us.
//
// Design. quantize: one warp per (row, chunk), eight warps a block. The
// warp strides its chunk 32 lanes at a time (coalesced), reduces amax by
// shuffles, and walks the chunk again to write the values (the second read
// hits L1 or L2). No shared memory and no block barrier. Any positive
// chunk works; at 256 each lane handles 8 values. dequantize: a grid-stride
// loop, one element a thread.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 4096;
// fl(1/127) = 0x3C010204, spelled as bits so no compiler rounds it again.
#define INV_127 __uint_as_float(0x3C010204u)

// max that keeps NaN, as jnp.max does (fmaxf drops it): one max.NaN
// instruction (sm_80 and later), as cheap as fmaxf
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__global__ void __launch_bounds__(kThreads)
quantize_i8_kernel(const float* __restrict__ x, signed char* __restrict__ vals,
                   float* __restrict__ scales, long long P, int chunk, long long nc,
                   long long n_chunks) {
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= n_chunks) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long row = g / nc, c0 = (g % nc) * chunk;
  const long long rest = P - c0;
  const int n = rest < chunk ? (int)rest : chunk;
  const float* xr = x + row * P + c0;
  float amax = 0.f;
  for (int i = lane; i < n; i += 32) amax = nan_max(amax, fabsf(xr[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fmul_rn(amax, INV_127);
  signed char* vr = vals + row * P + c0;
  for (int i = lane; i < n; i += 32) {
    // round half to even into an int: NaN (inf / inf) converts to 0, as
    // XLA's cast does; the clip is then on integers
    int q = 0;
    if (scale > 0.f) q = min(max(__float2int_rn(__fdiv_rn(xr[i], scale)), -127), 127);
    vr[i] = (signed char)q;
  }
  if (lane == 0) scales[g] = scale;  // g == row * nc + chunk index
}

__global__ void __launch_bounds__(kThreads)
dequantize_i8_kernel(const signed char* __restrict__ vals, const float* __restrict__ scales,
                     float* __restrict__ out, long long P, int chunk, long long nc,
                     long long total) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const long long row = i / P, c = i - row * P;
    out[i] = __fmul_rn((float)vals[i], scales[row * nc + c / chunk]);
  }
}

unsigned blocks_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

// C interface, bound with ctypes. x (K, P) f32; vals (K, P) int8; scales
// (K, nc) f32 with nc = ceil(P / chunk). Returns 0 or the CUDA error code
// of the failed launch.
extern "C" int quantize_i8_f32(const void* x, void* vals, void* scales, int K, long long P,
                               int chunk, long long nc, void* stream) {
  if (K < 1 || P < 1 || chunk < 1 || nc != (P + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (long long)K * nc;
  quantize_i8_kernel<<<blocks_for(n_chunks, kWarps), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(vals),
      static_cast<float*>(scales), P, chunk, nc, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int dequantize_i8_f32(const void* vals, const void* scales, void* out, int K,
                                 long long P, int chunk, long long nc, void* stream) {
  if (K < 1 || P < 1 || chunk < 1 || nc != (P + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)K * P;
  const unsigned blocks = blocks_for(total, kThreads);
  dequantize_i8_kernel<<<blocks < kMaxBlocks ? blocks : kMaxBlocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(vals), static_cast<const float*>(scales),
      static_cast<float*>(out), P, chunk, nc, total);
  return (int)cudaGetLastError();
}
