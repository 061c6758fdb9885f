// Toyoda pseudo-utility for Hopper (sm_90a): the inner step of stage 2's
// device MKP greedy (paper §VI-B).
//
// Replaces the TPU kernel kernels/mkp_utility.py::mkp_utility of the JAX
// package. For values v (n,), weights w (n, m), residual capacities r (m,)
// and a selectable mask (n,) it computes, all in f32,
//   s_k    = 1 / max(r_k, 1e-12)
//   util_j = v_j / max(sum_k w_jk s_k, 1e-12)
// and -inf where item j is not selectable or some w_jk > r_k + 1e-12.
//
// Bound: bytes, and in practice launches. The function reads n*(m+2)*4 +
// n bytes plus r and writes n*4; for one stage-2 MKP over a 3,846-client
// pool with m = 10 classes that is about 0.2 MB, under 0.1 us at
// 3.35 TB/s, far less than a launch. The MKP greedy launches it once per
// pick, so its launch count matters more than its time.
//
// Design. One thread per item; the block stages r + 1e-12 and s in shared
// memory, a tile of columns at a time, so any m works. The penalty is
// summed in column order with separately rounded products and sums
// (__fmul_rn, __fadd_rn: no contracted FMA) and the two divisions are
// IEEE divisions, so the result is bit-equal to the plain PyTorch version,
// which sums the columns left to right. No atomics.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColTile = 256;
constexpr float kEps = 1e-12f;

__global__ void __launch_bounds__(kThreads)
mkp_utility_kernel(const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ r, const unsigned char* __restrict__ sel,
                   float* __restrict__ out, long long n, int m) {
  __shared__ float s_lim[kColTile];  // r_k + eps: the fit limit
  __shared__ float s_inv[kColTile];  // 1 / max(r_k, eps): the scarcity
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  bool fits = true;
  for (int k0 = 0; k0 < m; k0 += kColTile) {
    const int cnt = m - k0 < kColTile ? m - k0 : kColTile;
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      const float rk = r[k0 + t];
      s_lim[t] = __fadd_rn(rk, kEps);
      s_inv[t] = __fdiv_rn(1.0f, fmaxf(rk, kEps));
    }
    __syncthreads();
    if (j < n) {
      const float* wj = w + j * m + k0;
      for (int t = 0; t < cnt; ++t) {
        const float wk = wj[t];
        acc = __fadd_rn(acc, __fmul_rn(wk, s_inv[t]));
        fits = fits && (wk <= s_lim[t]);
      }
    }
    __syncthreads();
  }
  if (j < n) {
    const float util = __fdiv_rn(v[j], fmaxf(acc, kEps));
    out[j] = (fits && sel[j] != 0) ? util : -INFINITY;
  }
}

}  // namespace

// C interface, bound with ctypes. v (n,) f32, w (n, m) f32 row-major,
// r (m,) f32, sel (n,) bool as bytes, out (n,) f32. Returns 0 or the CUDA
// error code of the launch.
extern "C" int mkp_utility_f32(const void* v, const void* w, const void* r, const void* sel,
                               void* out, long long n, int m, void* stream) {
  if (n < 1 || m < 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  mkp_utility_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(w), static_cast<const float*>(r),
      static_cast<const unsigned char*>(sel), static_cast<float*>(out), n, m);
  return (int)cudaGetLastError();
}
