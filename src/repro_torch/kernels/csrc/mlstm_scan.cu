// Chunkwise gated linear attention (mLSTM / SSD) for Hopper (sm_90a). Replaces
// the TPU kernel kernels/mlstm_scan.py::mlstm_scan of the JAX package, with the
// semantics of its oracle models/ssm.py::gated_linear_attention: q, k (B, H, S,
// dk), v (B, H, S, dv), log_f and log_i (B, H, S) f32 (no log_i: the SSD form,
// input gate 1). Chunk by chunk, in f32: g = cumsum(log_f), the stabilizer
// M_c = max(g_c + m, max_{c'<=c} (g_c - g_c') + i_c') (0 where not finite, and 0
// without normalization), scores_cc' = (q_c . k_c') exp((g_c - g_c') + i_c' - M_c)
// for c' <= c, y = scores v + exp(g_c + m - M_c) q_c S, and with normalization
// out = y / max(|rowsum(scores) + exp(g_c + m - M_c) q_c . n|, exp(-M_c)). The
// state (S dk x dv, n dk, m) is carried in f32 in the oracle's stabilized form
// (S_true = e^m S): m' = max(G + m, max_c (G - g_c) + i_c), S' = e^(G+m-m') S +
// sum_c e^((G - g_c) + i_c - m') k_c v_c^T, likewise n. The padded tail of the
// last chunk has f = 1, i = 0 (log 0, -inf) and zero q, k, v, so it changes
// nothing. Unlike the TPU kernel, this one also writes the final S, n and m,
// which prefill needs for the decode cache, and reads an initial state if one is
// given. Any stride is taken for the batch, head and sequence axes (the head
// axis of q, k, v and out must be contiguous), so the models' (B, S, H, d)
// tensors are read and written in place.
//
// Bound: operations. xLSTM-125M's prefill, (4, 4, 2,048, 384 / 384) bf16 in
// chunks of 256, needs QK^T and PV over the C(C+1)/2 causal pairs of each
// chunk, q.S, q.n and the state update: 25.8 GFLOP, of which QK^T's 3.2 are
// exact on the bf16 tensor cores (989 TFLOP/s) and the other 22.6 in f32 (the
// oracle's arithmetic, 67 TFLOP/s): 0.34 ms, against 0.03 ms for its 110 MB.
// Hymba-1.5B's, (4, 25, 2,048, 16 / 64): 0.8 + 4.2 GFLOP, 0.064 ms.
//
// Design (simple first): one block of 256 threads per (batch x head, 64-wide
// tile of dv); a loop over the chunks takes the place of the TPU's sequential
// grid axis. The block's dk x 64 slice of S and all of n live in shared memory
// (576 KB of f32 state per xLSTM head would not fit one block). Each block
// recomputes the chunk's gate weights, QK^T and n for its own tile. Within a
// chunk the output is made in 64-row query tiles against 64-key slabs (the
// C x C weight matrix is never held whole), each product a 64 x 64 tile with a
// 4 x 4 f32 FMA micro-tile per thread over 32-wide dk slabs staged in shared
// memory; then the state takes the chunk's keys in 32-key slabs. The
// stabilizer is kept per chunk, as in the oracle. All products are f32 FMA (no
// tensor cores, no cp.async or TMA yet).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // query rows a tile, keys a slab, dv columns a block
constexpr int kDS = 32;         // dk a slab of the Q.K^T and Q.S products
constexpr int kKS = 32;         // keys a slab of the state update
constexpr int kPitch = kT + 4;  // row pitch of the staged tiles (floats, 16-byte rows)
constexpr int kMaxChunk = 256;
constexpr int kMaxDk = 512;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* f;
  const float* i;   // null: the SSD form
  void* o;
  const float* S0;  // null: a zero initial state
  const float* n0;
  const float* m0;
  float* S1;
  float* n1;
  float* m1;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  long long fsb, fsh, fss, isb, ish, iss;
  int B, H, S, dk, dv, chunk, normalize;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

size_t smem_bytes(int dk) {
  const int dkp = round_up(dk, kT);
  return sizeof(float) *
         (size_t(dkp) * kT + dkp + 4 * kMaxChunk + 2 * kDS * kPitch + 2 * kT * kPitch);
}

// Max over the block; every thread gets the result.
__device__ float block_max(float x, float* red) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, w));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}

// Stage rows [r0, r0 + kT) x dims [d0, d0 + kDS) of x (the chunk's rows from t0,
// Cv of them valid) transposed into dst[d][row]; zero outside.
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* x, long long ss, int t0, int r0,
                                        int Cv, int d0, int dk) {
  for (int idx = threadIdx.x; idx < kT * kDS; idx += kThreads) {
    const int row = idx / kDS, d = idx % kDS;
    const int r = r0 + row, dd = d0 + d;
    dst[d * kPitch + row] = (r < Cv && dd < dk) ? to_f32(x[(t0 + r) * ss + dd]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_scan_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kThreads / 32];
  const int dk = a.dk, dv = a.dv, C = a.chunk;
  const int dkp = round_up(dk, kT);
  float* Ss = sm;                  // [dkp][kT]: this block's columns of S
  float* ns = Ss + dkp * kT;       // [dkp]
  float* gs = ns + dkp;            // [kMaxChunk]: cumulative log f
  float* is = gs + kMaxChunk;      // [kMaxChunk]: log i (-inf on the tail)
  float* Ms = is + kMaxChunk;      // [kMaxChunk]: the stabilizer of each row
  float* ws = Ms + kMaxChunk;      // [kMaxChunk]: the state update's key weights
  float* As = ws + kMaxChunk;      // [kDS][kPitch]: Q slab (d, row) / weighted K (key, d)
  float* Bs = As + kDS * kPitch;   // [kDS][kPitch]: K slab (d, key) / V (key, col)
  float* Ps = Bs + kDS * kPitch;   // [kT][kPitch]: scores (key, row)
  float* Vs = Ps + kT * kPitch;    // [kT][kPitch]: V slab (key, col)

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int col0 = blockIdx.y * kT;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh + col0;
  T* ob = static_cast<T*>(a.o) + b * a.osb + h * a.osh + col0;
  const float* fb = a.f + b * a.fsb + h * a.fsh;
  const float* ib = a.i ? a.i + b * a.isb + h * a.ish : nullptr;
  const int ncol = min(kT, dv - col0);

  for (int idx = tid; idx < dkp * kT; idx += kThreads) {
    const int d = idx / kT, c = idx % kT;
    Ss[idx] = (a.S0 && d < dk && c < ncol) ? a.S0[(size_t(bh) * dk + d) * dv + col0 + c] : 0.0f;
  }
  for (int d = tid; d < dkp; d += kThreads) ns[d] = (a.n0 && d < dk) ? a.n0[size_t(bh) * dk + d] : 0.0f;
  float m_prev = a.m0 ? a.m0[bh] : 0.0f;

  for (int t0 = 0; t0 < a.S; t0 += C) {
    const int Cv = min(C, a.S - t0);
    __syncthreads();  // the previous chunk is done with gs, is, Ss, ns
    for (int c = tid; c < C; c += kThreads) {  // log f staged in Ms for the cumsum
      const bool ok = c < Cv;
      Ms[c] = ok ? fb[(t0 + c) * a.fss] : 0.0f;
      is[c] = ok ? (ib ? ib[(t0 + c) * a.iss] : 0.0f) : -INFINITY;
    }
    __syncthreads();
    // Inclusive cumsum of log f, each entry summed in order from the chunk's
    // start: the sequential sum, so non-increasing for log f <= 0, and G - g_c
    // <= 0 keeps the SSD form's m at exactly 0, as in the oracle.
    for (int c = tid; c < C; c += kThreads) {
      float run = 0.0f;
      for (int j = 0; j <= c; ++j) run += Ms[j];
      gs[c] = run;
    }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float mx = gs[c] + m_prev;
      for (int j = 0; j <= c; ++j) mx = fmaxf(mx, (gs[c] - gs[j]) + is[j]);
      if (!isfinite(mx) || !a.normalize) mx = 0.0f;
      Ms[c] = mx;
    }
    __syncthreads();

    // ---- outputs: 64-row query tiles
    const int nqt = (Cv + kT - 1) / kT;
    for (int qt = 0; qt < nqt; ++qt) {
      const int r0 = qt * kT;
      float yi[4][4] = {}, qn[4] = {};
      for (int d0 = 0; d0 < dk; d0 += kDS) {  // q . S and q . n
        stage_t(As, qb, a.qss, t0, r0, Cv, d0, dk);
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < kDS; ++d) {
          const float4 qa = *reinterpret_cast<const float4*>(As + d * kPitch + tr * 4);
          const float4 sv = *reinterpret_cast<const float4*>(Ss + (d0 + d) * kT + tc * 4);
          const float nv = ns[d0 + d];
          const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qn[i] = fmaf(qv[i], nv, qn[i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) yi[i][j] = fmaf(qv[i], s4[j], yi[i][j]);
          }
        }
        __syncthreads();
      }
      float y[4][4] = {}, nr[4] = {};
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kT;
        float qk[4][4] = {};
        for (int d0 = 0; d0 < dk; d0 += kDS) {
          stage_t(As, qb, a.qss, t0, r0, Cv, d0, dk);
          stage_t(Bs, kb, a.kss, t0, k0, Cv, d0, dk);
          __syncthreads();
#pragma unroll 4
          for (int d = 0; d < kDS; ++d) {
            const float4 qa = *reinterpret_cast<const float4*>(As + d * kPitch + tr * 4);
            const float4 ka = *reinterpret_cast<const float4*>(Bs + d * kPitch + tc * 4);
            const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) qk[i][j] = fmaf(qv[i], kv[j], qk[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + tr * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = k0 + tc * 4 + j;
            float p = 0.0f;
            if (c <= r && c < Cv) p = qk[i][j] * expf(((gs[r] - gs[c]) + is[c]) - Ms[r]);
            nr[i] += p;
            Ps[(tc * 4 + j) * kPitch + tr * 4 + i] = p;
          }
        }
        for (int idx = tid; idx < kT * kT; idx += kThreads) {
          const int key = idx / kT, col = idx % kT, c = k0 + key;
          Vs[key * kPitch + col] = (c < Cv && col < ncol) ? to_f32(vb[(t0 + c) * a.vss + col]) : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int key = 0; key < kT; ++key) {
          const float4 pa = *reinterpret_cast<const float4*>(Ps + key * kPitch + tr * 4);
          const float4 va = *reinterpret_cast<const float4*>(Vs + key * kPitch + tc * 4);
          const float pv[4] = {pa.x, pa.y, pa.z, pa.w}, v4[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) y[i][j] = fmaf(pv[i], v4[j], y[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // row sums over the 16 threads of a row group
#pragma unroll
        for (int w = 1; w < 16; w <<= 1) nr[i] += __shfl_xor_sync(0xFFFFFFFFu, nr[i], w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + tr * 4 + i;
        if (r >= Cv) continue;
        const float M = Ms[r];
        const float wi = expf((gs[r] + m_prev) - M);
        float den = 1.0f;
        if (a.normalize) den = fmaxf(fabsf(nr[i] + wi * qn[i]), expf(-M));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tc * 4 + j;
          if (col >= ncol) continue;
          float val = y[i][j] + wi * yi[i][j];
          if (a.normalize) val = val / den;
          ob[(t0 + r) * a.oss + col] = from_f32<T>(val);
        }
      }
    }

    // ---- state update
    const float G = gs[C - 1];
    float mx = -INFINITY;
    for (int c = tid; c < C; c += kThreads) mx = fmaxf(mx, (G - gs[c]) + is[c]);
    float m_new = fmaxf(G + m_prev, block_max(mx, red));
    if (!isfinite(m_new)) m_new = 0.0f;
    const float decay = expf((G + m_prev) - m_new);
    for (int c = tid; c < C; c += kThreads) ws[c] = expf(((G - gs[c]) + is[c]) - m_new);
    __syncthreads();
    for (int db = 0; db < dkp; db += kT) {
      float acc[4][4] = {}, na[4] = {};
      for (int ks = 0; ks < Cv; ks += kKS) {
        for (int idx = tid; idx < kKS * kT; idx += kThreads) {
          const int key = idx / kT, e = idx % kT, c = ks + key;
          As[key * kPitch + e] =
              (c < Cv && db + e < dk) ? ws[c] * to_f32(kb[(t0 + c) * a.kss + db + e]) : 0.0f;
          Bs[key * kPitch + e] = (c < Cv && e < ncol) ? to_f32(vb[(t0 + c) * a.vss + e]) : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int key = 0; key < kKS; ++key) {
          const float4 ka = *reinterpret_cast<const float4*>(As + key * kPitch + tr * 4);
          const float4 va = *reinterpret_cast<const float4*>(Bs + key * kPitch + tc * 4);
          const float kv[4] = {ka.x, ka.y, ka.z, ka.w}, v4[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            na[i] += kv[i];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kv[i], v4[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = db + tr * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* s = Ss + d * kT + tc * 4 + j;
          *s = decay * *s + acc[i][j];
        }
        if (tc == 0) ns[d] = decay * ns[d] + na[i];
      }
    }
    m_prev = m_new;
  }

  __syncthreads();
  for (int idx = tid; idx < dk * kT; idx += kThreads) {
    const int d = idx / kT, c = idx % kT;
    if (c < ncol) a.S1[(size_t(bh) * dk + d) * dv + col0 + c] = Ss[d * kT + c];
  }
  if (blockIdx.y == 0) {
    for (int d = tid; d < dk; d += kThreads) a.n1[size_t(bh) * dk + d] = ns[d];
    if (tid == 0) a.m1[bh] = m_prev;
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t st) {
  // Raised once, to the largest size (dk = 512), on the first launch: a
  // caller's first launch comes before any CUDA graph capture of it.
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(kMaxDk));
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = smem_bytes(a.dk);
  const dim3 grid(a.B * a.H, (a.dv + kT - 1) / kT);
  mlstm_scan_kernel<T><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. q, k (B, H, S, dk), v and o (B, H, S, dv)
// given by their strides in elements (the last axis contiguous), all f32 (dtype
// 0) or all bf16 (dtype 1); log_f and log_i (B, H, S) f32 by strides, log_i
// null for the SSD form. S0, n0, m0: a contiguous f32 initial state (B, H, dk,
// dv), (B, H, dk), (B, H), or null for zeros; S1, n1, m1 receive the final
// state in the same layout. 1 <= dk <= 512, 1 <= chunk <= 256. Returns 0 or the
// CUDA error code of a failed launch (cudaErrorInvalidValue for an input it
// does not take).
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v, const float* f,
                              const float* i, void* o, const float* S0, const float* n0,
                              const float* m0, float* S1, float* n1, float* m1, long long qsb,
                              long long qsh, long long qss, long long ksb, long long ksh,
                              long long kss, long long vsb, long long vsh, long long vss,
                              long long osb, long long osh, long long oss, long long fsb,
                              long long fsh, long long fss, long long isb, long long ish,
                              long long iss, int B, int H, int S, int dk, int dv, int chunk,
                              int normalize, int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk < 1 || dk > kMaxDk || dv < 1 || chunk < 1 ||
      chunk > kMaxChunk || (dtype != 0 && dtype != 1) || (S0 && (!n0 || !m0)) ||
      (long long)B * H > 2147483647LL || (dv + kT - 1) / kT > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   f,   i,   o,   S0,  n0,  m0,  S1,  n1,  m1,  qsb,
               qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, fsb, fsh,
               fss, isb, ish, iss, B,   H,   S,   dk,  dv,  chunk, normalize};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, st);
  return launch<__nv_bfloat16>(a, st);
}
