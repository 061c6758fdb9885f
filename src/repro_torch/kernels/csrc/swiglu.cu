// Fused SwiGLU for Hopper (sm_90a): out = silu(x @ Wg) * (x @ Wu) for x (M, D)
// and Wg, Wu (D, F), all f32 or all bf16, out (M, F) in the same type.
// Replaces the TPU kernel kernels/swiglu.py::swiglu of the JAX package: both
// products are taken from the same x tile in shared memory into two f32
// accumulators per output element, and the gate g / (1 + exp(-g)) * u is
// applied in the epilogue, so neither product goes to device memory.
//
// Bound. Prefill (M = 8,192 tokens, D = 960, F = 2,560, bf16): 2 * 2*M*D*F =
// 80.5 GFLOP, about 81 us at 989 TFLOP/s on the tensor cores; its bytes (36 MB)
// take 11 us. A decode step (M = 8): the two weight matrices, 9.8 MB, about
// 2.9 us at 3.35 TB/s.
//
// Design, bf16 (swiglu_bf16): 64 x 64 output tiles, four warps in a 2 x 2
// grid, each warp 32 x 32 outputs as 2 x 4 tiles of mma.sync.m16n8k16 (bf16
// in, f32 accumulate) for each of the two products. The K loop stages a
// 64 x 32 x tile and the 32 x 64 tiles of Wg and Wu in shared memory, the
// weight tiles transposed (n-major) so that every fragment is one 32-bit
// shared load. Ragged M, D and F are zero-filled on load and masked on store.
// No cp.async, TMA or wgmma yet: a simple kernel that is right, for later PRs
// to make fast. f32 (swiglu_f32): the same tiling on CUDA cores, 64 x 64
// outputs a block of 256 threads, 4 x 4 outputs a thread, FMA in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64;

__device__ __forceinline__ float gate(float g, float u) {
  return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))), u);
}

// ---------------------------------------------------------------- bf16 path
constexpr int kBK = 32;
constexpr int kPitch = kBK + 8;  // bf16 a shared row: 80 bytes, rows stay 16-byte aligned

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Eight bf16 of row `row`, columns col..col+7, of a (rows, cols) row-major
// matrix; zero outside it. `vec`: cols % 8 == 0 and a 16-byte aligned base.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ a, int row, int col,
                                       int rows, int cols, int vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return r;
  const __nv_bfloat16* p = a + (size_t)row * cols + col;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
  for (int i = 0; i < 8 && col + i < cols; ++i) e[i] = p[i];
  return r;
}

__global__ void __launch_bounds__(128)
swiglu_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                   const __nv_bfloat16* __restrict__ wu, __nv_bfloat16* __restrict__ out, int M,
                   int D, int F, int vec_x, int vec_w) {
  __shared__ __align__(16) __nv_bfloat16 sx[kBM * kPitch];
  __shared__ __align__(16) __nv_bfloat16 sg[kBN * kPitch];  // [n][k]
  __shared__ __align__(16) __nv_bfloat16 su[kBN * kPitch];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float accg[2][4][4], accu[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[i][j][e] = accu[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    // x tile: 64 rows x 32 columns, two 8-wide chunks a thread
#pragma unroll
    for (int c = tid; c < kBM * kBK / 8; c += 128) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(sx + r * kPitch + kc) = load8(x, m0 + r, k0 + kc, M, D, vec_x);
    }
    // weight tiles: 32 rows (k) x 64 columns (n), stored transposed
#pragma unroll
    for (int c = tid; c < kBK * kBN / 8; c += 128) {
      const int kr = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
      const uint4 g8 = load8(wg, k0 + kr, n0 + nc, D, F, vec_w);
      const uint4 u8 = load8(wu, k0 + kr, n0 + nc, D, F, vec_w);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&g8);
      const __nv_bfloat16* ue = reinterpret_cast<const __nv_bfloat16*>(&u8);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sg[(nc + e) * kPitch + kr] = ge[e];
        su[(nc + e) * kPitch + kr] = ue[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p = sx + (wm + i * 16 + gid) * kPitch + kk + tig * 2;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * kPitch);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * kPitch + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = (wn + j * 8 + gid) * kPitch + kk + tig * 2;
        const uint32_t g0 = ld32(sg + off), g1 = ld32(sg + off + 8);
        const uint32_t u0 = ld32(su + off), u1 = ld32(su + off + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(accg[i][j], a[i], g0, g1);
          mma_bf16(accu[i][j], a[i], u0, u1);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + gid + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + tig * 2 + (e & 1);
        if (row < M && col < F)
          out[(size_t)row * F + col] = __float2bfloat16_rn(gate(accg[i][j][e], accu[i][j][e]));
      }
}

// ----------------------------------------------------------------- f32 path
constexpr int kFK = 16;

__global__ void __launch_bounds__(256)
swiglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                  const float* __restrict__ wu, float* __restrict__ out, int M, int D, int F) {
  __shared__ float sx[kFK][kBM];  // transposed: sx[k][m]
  __shared__ float sg[kFK][kBN];
  __shared__ float su[kFK][kBN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float accg[4][4], accu[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accg[i][j] = accu[i][j] = 0.0f;
  for (int k0 = 0; k0 < D; k0 += kFK) {
#pragma unroll
    for (int s = 0; s < kBM * kFK / 256; ++s) {
      const int idx = tid + 256 * s;
      const int r = idx / kFK, kk = idx % kFK;
      const int row = m0 + r, k = k0 + kk;
      sx[kk][r] = (row < M && k < D) ? x[(size_t)row * D + k] : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kFK * kBN / 256; ++s) {
      const int idx = tid + 256 * s;
      const int kk = idx / kBN, n = idx % kBN;
      const int k = k0 + kk, col = n0 + n;
      const bool ok = k < D && col < F;
      sg[kk][n] = ok ? wg[(size_t)k * F + col] : 0.0f;
      su[kk][n] = ok ? wu[(size_t)k * F + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sx[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sg[kk][tx + 16 * j];
        c[j] = su[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accg[i][j] = __fmaf_rn(a[i], b[j], accg[i][j]);
          accu[i][j] = __fmaf_rn(a[i], c[j], accu[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < M && col < F) out[(size_t)row * F + col] = gate(accg[i][j], accu[i][j]);
    }
}

bool bad_shape(int M, int D, int F) {
  return M < 1 || D < 1 || F < 1 || (F + kBN - 1) / kBN > 65535;
}

}  // namespace

// C interface, bound with ctypes. x (M, D), wg and wu (D, F), out (M, F), all
// row-major and of one type. vec_x / vec_w != 0 ask for 16-byte loads of x /
// the weights: the caller sets them only when D / F is a multiple of 8 and
// the pointers are 16-byte aligned. Returns 0 or the CUDA error code of a
// failed launch.
extern "C" int swiglu_bf16(const void* x, const void* wg, const void* wu, void* out, int M, int D,
                           int F, int vec_x, int vec_w, void* stream) {
  if (bad_shape(M, D, F)) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM, (F + kBN - 1) / kBN);
  swiglu_bf16_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu), static_cast<__nv_bfloat16*>(out), M, D, F, vec_x,
      vec_w);
  return (int)cudaGetLastError();
}

extern "C" int swiglu_f32(const void* x, const void* wg, const void* wu, void* out, int M, int D,
                          int F, void* stream) {
  if (bad_shape(M, D, F)) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM, (F + kBN - 1) / kBN);
  swiglu_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg), static_cast<const float*>(wu),
      static_cast<float*>(out), M, D, F);
  return (int)cudaGetLastError();
}
