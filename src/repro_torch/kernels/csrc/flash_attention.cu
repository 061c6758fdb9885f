// Flash attention (forward) for Hopper (sm_90a), FA2-style. Replaces the TPU
// kernel kernels/flash_attention.py::flash_attention of the JAX package:
// online-softmax attention of q (B, H, Sq, hd) against k, v (B, G, Sk, hd),
// GQA (head h reads kv head h / (H / G)), causal and / or a sliding window,
// right-aligned when Sq < Sk (query row i sits at position i + Sk - Sq), with
// the running max, the running sum and the output accumulator in f32. The
// mask follows the Pallas kernel: a key is kept when key <= qpos (causal) and
// key > qpos - window (window > 0); the running max starts at -2^30; masked
// probabilities are exactly 0 (masked scores are -inf, so exp gives 0 and the
// max is the Pallas kernel's, whose masked scores are -2^30 <= its start);
// the output is acc / max(l, 1e-30). Any stride is taken for the batch, head
// and sequence axes (hd must be contiguous), so the model's (B, S, H, hd)
// tensors are read in place, without a transposing copy.
//
// Bound: operations. The serve path's causal prefill, q (8, 15, 1,024, 64)
// against k, v (8, 5, 1,024, 64) bf16, needs 2 * 2 * B*H*hd * (Sq*(Sq+1)/2)
// = 16.1 GFLOP (QK^T and PV over the unmasked half), about 16 us at 989
// TFLOP/s; its bytes (q, k, v, o: 18.4 MB) take 5.5 us.
//
// Design, bf16 with hd in {16, 32, 64, 128} (fa_mma_kernel): one block of four
// warps per (64-row q tile, head, batch), 16 q rows a warp. The Q tile's
// mma.sync.m16n8k16 A fragments stay in registers for the whole block. The
// loop over 64-key tiles stages K (key-major) and V (transposed, hd-major) in
// shared memory, so every B fragment is one 32-bit shared load; S = Q K^T
// comes out in the accumulator layout, which after the softmax is packed to
// bf16 as the A fragments of P V (the FA2 register reuse). Key tiles that
// the causal mask or the window masks out for every row of the q tile are
// skipped. Other bf16 head sizes and f32 (fa_simple_kernel): a warp per four
// q rows, 16-key tiles in shared memory as f32, a lane per 1/32 of hd, dot
// products reduced with shuffles, FMA in f32. Neither kernel uses cp.async,
// TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the Pallas kernel's mask value

struct Shape {
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int H, G, Sq, Sk, hd;
  float scale;
  int causal, window;
};

__device__ __forceinline__ bool keep(const Shape& s, int key, int qpos) {
  return key < s.Sk && (!s.causal || key <= qpos) && (s.window <= 0 || key > qpos - s.window);
}

// Keys [lo, hi) that some query row in [q_lo, q_hi) may attend to.
__device__ __forceinline__ void key_range(const Shape& s, int q_lo, int q_hi, int& lo, int& hi) {
  const int off = s.Sk - s.Sq;
  lo = 0;
  hi = s.Sk;
  if (s.causal) hi = min(s.Sk, q_hi + off);
  if (s.window > 0) lo = max(0, q_lo + off - s.window + 1);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ------------------------------------------------------------ bf16 + mma.sync
constexpr int kBM = 64, kBN = 64;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(128)
fa_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Shape s) {
  constexpr int LD = HD + 8;     // shared row pitch of Q and K tiles (bf16)
  constexpr int LDV = kBN + 8;   // shared row pitch of the transposed V tile
  constexpr int NT = kBN / 8;    // n8 tiles of S
  constexpr int DT = HD / 8;     // n8 tiles of the output
  __shared__ __align__(16) __nv_bfloat16 sk[kBN * LD];  // the Q tile first, then K tiles
  __shared__ __align__(16) __nv_bfloat16 svt[HD * LDV];
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, g = h / (s.H / s.G);
  const int q0 = blockIdx.x * kBM;
  const __nv_bfloat16* qb = q + b * s.qsb + h * s.qsh;
  const __nv_bfloat16* kb = k + b * s.ksb + g * s.ksh;
  const __nv_bfloat16* vb = v + b * s.vsb + g * s.vsh;
  __nv_bfloat16* ob = o + b * s.osb + h * s.osh;

  for (int c = tid; c < kBM * HD / 8; c += 128) {
    const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < s.Sq) val = __ldg(reinterpret_cast<const uint4*>(qb + (q0 + r) * s.qss + d));
    *reinterpret_cast<uint4*>(sk + r * LD + d) = val;
  }
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* p = sk + (wr + gid) * LD + kk * 16 + tig * 2;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }
  __syncthreads();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const int off = s.Sk - s.Sq;
  const int qpos[2] = {q0 + wr + gid + off, q0 + wr + gid + 8 + off};
  int k_lo, k_hi;
  key_range(s, q0, min(q0 + kBM, s.Sq), k_lo, k_hi);

  for (int k0 = (k_lo / kBN) * kBN; k0 < k_hi; k0 += kBN) {
    for (int c = tid; c < kBN * HD / 8; c += 128) {
      const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < s.Sk) {
        kv = __ldg(reinterpret_cast<const uint4*>(kb + (k0 + r) * s.kss + d));
        vv = __ldg(reinterpret_cast<const uint4*>(vb + (k0 + r) * s.vss + d));
      }
      *reinterpret_cast<uint4*>(sk + r * LD + d) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) svt[(d + e) * LDV + r] = ve[e];
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* p = sk + (j * 8 + gid) * LD + kk * 16 + tig * 2;
        mma_bf16(sc[j], qf[kk], ld32(p), ld32(p + 8));
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tig * 2 + (e & 1);
        sc[j][e] = keep(s, key, qpos[e >> 1]) ? __fmul_rn(sc[j][e], s.scale) : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - m[e >> 1]);
        sc[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int t = 0; t < kBN / 16; ++t) {
      const uint32_t a[4] = {pack_bf16(sc[2 * t][0], sc[2 * t][1]),
                             pack_bf16(sc[2 * t][2], sc[2 * t][3]),
                             pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]),
                             pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3])};
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const __nv_bfloat16* p = svt + (n * 8 + gid) * LDV + t * 16 + tig * 2;
        mma_bf16(acc[n], a, ld32(p), ld32(p + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xFFFFFFFFu, l[r], 1);
    l[r] += __shfl_xor_sync(0xFFFFFFFFu, l[r], 2);
    const float den = fmaxf(l[r], 1e-30f);
    const int row = q0 + wr + gid + 8 * r;
    if (row >= s.Sq) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(__fdiv_rn(acc[n][2 * r], den),
                                                       __fdiv_rn(acc[n][2 * r + 1], den));
      *reinterpret_cast<__nv_bfloat162*>(ob + row * s.oss + n * 8 + tig * 2) = val;
    }
  }
}

// ------------------------------------------------------- any hd, f32 or bf16
constexpr int kRows = 16;  // q rows a block: four warps, four rows each
constexpr int kKeys = 16;  // keys a shared tile

template <typename T, int DPL>  // DPL: head dims a lane, hd <= 32 * DPL
__global__ void __launch_bounds__(128)
fa_simple_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Shape s) {
  constexpr int W = 32 * DPL;
  __shared__ float sk[kKeys][W];
  __shared__ float sv[kKeys][W];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y, g = h / (s.H / s.G);
  const int q0 = blockIdx.x * kRows;
  const T* qb = q + b * s.qsb + h * s.qsh;
  const T* kb = k + b * s.ksb + g * s.ksh;
  const T* vb = v + b * s.vsb + g * s.vsh;
  T* ob = o + b * s.osb + h * s.osh;
  const int off = s.Sk - s.Sq;
  float qr[4][DPL], acc[4][DPL], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 4 + i;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj) {
      const int d = lane + 32 * jj;
      qr[i][jj] = (row < s.Sq && d < s.hd) ? __fmul_rn(to_f32(qb[row * s.qss + d]), s.scale)
                                           : 0.0f;
      acc[i][jj] = 0.0f;
    }
  }
  int k_lo, k_hi;
  key_range(s, q0, min(q0 + kRows, s.Sq), k_lo, k_hi);
  for (int k0 = (k_lo / kKeys) * kKeys; k0 < k_hi; k0 += kKeys) {
    for (int idx = tid; idx < kKeys * W; idx += 128) {
      const int j = idx / W, d = idx % W, key = k0 + j;
      const bool ok = key < s.Sk && d < s.hd;
      sk[j][d] = ok ? to_f32(kb[key * s.kss + d]) : 0.0f;
      sv[j][d] = ok ? to_f32(vb[key * s.vss + d]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + warp * 4 + i + off;
      float sc[kKeys];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float part = 0.0f;
#pragma unroll
        for (int jj = 0; jj < DPL; ++jj) part = __fmaf_rn(qr[i][jj], sk[j][lane + 32 * jj], part);
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) part += __shfl_xor_sync(0xFFFFFFFFu, part, w);
        sc[j] = keep(s, k0 + j, qpos) ? part : -INFINITY;
        mx = fmaxf(mx, sc[j]);
      }
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        sc[j] = expf(sc[j] - mx);
        rs += sc[j];
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int jj = 0; jj < DPL; ++jj) {
        float a = acc[i][jj] * alpha;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) a = __fmaf_rn(sc[j], sv[j][lane + 32 * jj], a);
        acc[i][jj] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 4 + i;
    if (row >= s.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj) {
      const int d = lane + 32 * jj;
      if (d < s.hd) ob[row * s.oss + d] = from_f32<T>(__fdiv_rn(acc[i][jj], den));
    }
  }
}

template <typename T>
int launch_simple(const void* q, const void* k, const void* v, void* o, const Shape& s, int B,
                  cudaStream_t st) {
  const dim3 grid((s.Sq + kRows - 1) / kRows, s.H, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  if (s.hd <= 32) fa_simple_kernel<T, 1><<<grid, 128, 0, st>>>(qq, kk, vv, oo, s);
  else if (s.hd <= 64) fa_simple_kernel<T, 2><<<grid, 128, 0, st>>>(qq, kk, vv, oo, s);
  else if (s.hd <= 128) fa_simple_kernel<T, 4><<<grid, 128, 0, st>>>(qq, kk, vv, oo, s);
  else fa_simple_kernel<T, 8><<<grid, 128, 0, st>>>(qq, kk, vv, oo, s);
  return (int)cudaGetLastError();
}

int launch_mma(const void* q, const void* k, const void* v, void* o, const Shape& s, int B,
               cudaStream_t st) {
  const dim3 grid((s.Sq + kBM - 1) / kBM, s.H, B);
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kk = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vv = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* oo = static_cast<__nv_bfloat16*>(o);
  switch (s.hd) {
    case 16: fa_mma_kernel<16><<<grid, 128, 0, st>>>(qq, kk, vv, oo, s); break;
    case 32: fa_mma_kernel<32><<<grid, 128, 0, st>>>(qq, kk, vv, oo, s); break;
    case 64: fa_mma_kernel<64><<<grid, 128, 0, st>>>(qq, kk, vv, oo, s); break;
    case 128: fa_mma_kernel<128><<<grid, 128, 0, st>>>(qq, kk, vv, oo, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. q, o (B, H, Sq, hd) and k, v (B, G, Sk, hd)
// given by their strides in elements (the hd axis contiguous), all f32
// (dtype 0) or all bf16 (dtype 1). use_mma != 0 takes the tensor-core kernel:
// bf16 only, hd in {16, 32, 64, 128}, every stride a multiple of 8 and every
// pointer 16-byte aligned. Otherwise hd <= 256. Returns 0 or the CUDA error
// code of a failed launch (cudaErrorInvalidValue for an input it does not
// take).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   long long qsb, long long qsh, long long qss, long long ksb,
                                   long long ksh, long long kss, long long vsb, long long vsh,
                                   long long vss, long long osb, long long osh, long long oss,
                                   int B, int H, int G, int Sq, int Sk, int hd, float scale,
                                   int causal, int window, int dtype, int use_mma, void* stream) {
  if (B < 1 || H < 1 || G < 1 || H % G || Sq < 1 || Sk < 1 || hd < 1 || hd > 256 || H > 65535 ||
      B > 65535 || (use_mma && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Shape s{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                H,   G,   Sq,  Sk,  hd,  scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_mma) return launch_mma(q, k, v, o, s, B, st);
  if (dtype == 0) return launch_simple<float>(q, k, v, o, s, B, st);
  return launch_simple<__nv_bfloat16>(q, k, v, o, s, B, st);
}
