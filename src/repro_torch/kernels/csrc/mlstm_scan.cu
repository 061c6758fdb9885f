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
// chunk, q.S, q.n and the state update: 25.8 GFLOP. QK^T's 3.2 are exact on the
// bf16 tensor cores (989 TFLOP/s). The other 22.6 take f32 operands (P, S,
// w o V); the bf16 route computes each as three bf16 products (an f32 operand
// split into hi + mid + lo, exact, times the exact bf16 one), 67.8 GFLOP at
// 989 TFLOP/s: 0.072 ms in all, against 0.03 ms for its 110 MB. The f32 route
// does the oracle's arithmetic at the f32 rate (67 TFLOP/s): 0.34 ms.
// Hymba-1.5B's, (4, 25, 2,048, 16 / 64) SSD, is bound by its 66.8 MB: 0.020 ms.
//
// f32, and bf16 shapes the chunked route does not take (mlstm_scan_kernel,
// simple first): one block of 256 threads per (batch x head, 64-wide tile of
// dv); a loop over the chunks takes the place of the TPU's sequential grid
// axis. The block's dk x 64 slice of S and all of n live in shared memory (576
// KB of f32 state per xLSTM head would not fit one block). Each block
// recomputes the chunk's gate weights, QK^T and n for its own tile. Within a
// chunk the output is made in 64-row query tiles against 64-key slabs (the
// C x C weight matrix is never held whole), each product a 64 x 64 tile with a
// 4 x 4 f32 FMA micro-tile per thread over 32-wide dk slabs staged in shared
// memory; then the state takes the chunk's keys in 32-key slabs. All products
// are f32 FMA.
//
// bf16 with dk and dv multiples of 8, chunks a multiple of 64 and operands a
// TMA map can describe (the chunked route, after FLA's chunk_gla forward, the
// GPU form of the TPU kernel's chunkwise scan): four kernels on the caller's
// stream. (1) mlstm_scan_gates_kernel computes every per-chunk scalar once, so
// the others cannot disagree on them; (2) mlstm_scan_delta_kernel, grid (dk
// tile, dv tile, chunk, batch x head), computes each chunk's own state update
// K^T (w o V) at once; (3) mlstm_scan_chain_kernel adds them up, S' = decay S
// + dS, and writes the state entering each chunk in f32 over that chunk's
// update, so the workspace holds one f32 state a chunk (4 (dk dv + dk) /
// chunk + 16 bytes a token and head: 76 MB at xLSTM-125M's prefill); (4)
// mlstm_scan_out_kernel, grid (row tile, dv tile, chunk, batch x head), makes
// every chunk's output at once from that state and the chunk's own keys, so
// the intra-chunk work no longer waits on the chain of chunks. Every product
// runs on the tensor cores (wgmma m64nNk16, operands by TMA, 128-byte
// swizzle, dk and dv padded to 64 by TMA's zero fill). QK^T is one bf16
// product; P V, q . S_prev and the state update take their f32 operand as
// three exact bf16 terms, three products each, so they reach the oracle's f32
// accuracy. Hymba's dk of 16 takes the same wgmma tiles (not mma.sync): TMA's
// zero fill pads it to 64 without reading a byte, and the products over dk
// stop at its last 16. Each kernel's design is at its definition.
#include <math.h>

#include "hopper.cuh"

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

// ------------------------------------------------------------------------
// bf16: the chunk-parallel route (four kernels; TMA tiles and wgmma)

constexpr int kW = 64;                     // a tile's rows: query rows, keys, dk or dv
constexpr uint32_t kTileBytes = kW * 128;  // a 64 x 64 bf16 tile, 128-byte swizzled rows
constexpr int kWg = 128;                   // the route's product kernels: one warpgroup
constexpr int kSlabs = kMaxChunk / kW;     // a chunk's (K, V) slabs of 64 keys, at most
constexpr int kGateThreads = 256;

struct Chunked {
  const float* f;
  const float* i;  // null: the SSD form
  const float* S0; // null: a zero initial state
  const float* n0;
  const float* m0;
  float* S1;
  float* n1;
  float* m1;
  __nv_bfloat16* o;
  // workspace, f32: each chunk's own state update (BH x NC x dk x dv, then
  // BH x NC x dk for n), which the chain pass overwrites with the state
  // entering the chunk; four planes of BH x NC x C (g, the cumulative log f
  // from the chunk's start; i, log i with -inf past S; M, the row
  // stabilizer; w, the state update's key weight); the stabilizer entering
  // each chunk (BH x (NC + 1), the final m last); each chunk's state decay
  // (BH x NC)
  float* dS;
  float* dn;
  float* gw;
  float* mch;
  float* dch;
  long long fsb, fsh, fss, isb, ish, iss, osb, osh, oss;
  int H, BH, S, dk, dv, C, NC, normalize;
};

// D (64 x N f32, the accumulator layout) (+)= A B over 16 of K. mma_ss:
// both operands in shared memory, TA / TB: the operand is MN-major (read
// through wgmma's transpose bit), else K-major; the first product of a chain
// overwrites D (accumulate 0). mma_rs: A (bf16 fragments) from registers, B
// MN-major in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}
__device__ __forceinline__ void mma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 64) mma_ss_n64<TA, TB>(d, da, db, accumulate);
  else mma_ss_n128<TA, TB>(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) mma_rs_n64(d, a, db);
  else mma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// Two f32 values as three bf16 pairs with x = hi + mid + lo exactly: each
// term rounds what the terms before it left, 8 bits of the significand a
// term, so the three hold all 24 (finite x).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y)));
}

// The byte offset of element (row, col) of a 64-column tile of 128-byte
// rows under the 128-byte swizzle (16-byte groups XORed with row % 8).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
}
__device__ __forceinline__ float ld_bf16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ uint4 ld_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Gate pass, a block per (batch x head): every per-position and per-chunk
// scalar, once, so the later passes cannot disagree on them.
// A warp takes a chunk: g summed in order from the chunk's start (as the
// oracle's sequential sum: non-increasing for log f <= 0, so the SSD form's m
// stays exactly 0), the running max of i - g, the chunk's G and
// max_c (G - g_c) + i_c; then one thread walks the chain of chunk
// stabilizers m (and decays); then M_c = max(g_c + m, g_c + max_{c'<=c}
// (i_c' - g_c')) (0 where not finite or without normalization) and the key
// weights w_c = exp((G - g_c) + i_c - m'), position by position.
__global__ void __launch_bounds__(kGateThreads) mlstm_scan_gates_kernel(Chunked a) {
  __shared__ float fs[kGateThreads / 32][kMaxChunk];
  __shared__ float is[kGateThreads / 32][kMaxChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, C = a.C, NC = a.NC;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const size_t P = (size_t)a.BH * NC * C;
  float* g_ = a.gw + (size_t)bh * NC * C;
  float* i_ = g_ + P;
  float* M_ = i_ + P;
  float* w_ = M_ + P;
  float* mch = a.mch + (size_t)bh * (NC + 1);
  float* dch = a.dch + (size_t)bh * NC;
  const float* fb = a.f + b * a.fsb + h * a.fsh;
  const float* ib = a.i ? a.i + b * a.isb + h * a.ish : nullptr;
  for (int j = warp; j < NC; j += kGateThreads / 32) {
    const int t0 = j * C, Cv = min(C, a.S - t0);
    for (int c = lane; c < C; c += 32) {
      const bool ok = c < Cv;
      fs[warp][c] = ok ? fb[(long long)(t0 + c) * a.fss] : 0.0f;
      is[warp][c] = ok ? (ib ? ib[(long long)(t0 + c) * a.iss] : 0.0f) : -INFINITY;
    }
    __syncwarp();
    if (lane == 0) {
      float run = 0.0f, pm = -INFINITY;
      for (int c = 0; c < C; ++c) {
        run += fs[warp][c];
        pm = fmaxf(pm, is[warp][c] - run);
        fs[warp][c] = run;
        M_[t0 + c] = pm;
      }
    }
    __syncwarp();
    const float G = fs[warp][C - 1];
    float L = -INFINITY;
    for (int c = lane; c < C; c += 32) {
      L = fmaxf(L, (G - fs[warp][c]) + is[warp][c]);
      g_[t0 + c] = fs[warp][c];
      i_[t0 + c] = is[warp][c];
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) L = fmaxf(L, __shfl_xor_sync(0xFFFFFFFFu, L, w));
    if (lane == 0) {  // G and L wait in the decay and m slots for the chain
      dch[j] = G;
      mch[j] = L;
    }
    __syncwarp();
  }
  __syncthreads();
  if (tid == 0) {
    float m = a.m0 ? a.m0[bh] : 0.0f;
    for (int j = 0; j < NC; ++j) {
      const float G = dch[j], L = mch[j];
      float m_new = fmaxf(G + m, L);
      if (!isfinite(m_new)) m_new = 0.0f;
      mch[j] = m;
      dch[j] = expf((G + m) - m_new);
      m = m_new;
    }
    mch[NC] = m;
    a.m1[bh] = m;
  }
  __syncthreads();
  for (int t = tid; t < NC * C; t += kGateThreads) {
    const int j = t / C;
    const float g = g_[t], G = g_[j * C + C - 1];
    float M = 0.0f;
    if (a.normalize) {
      M = fmaxf(g + mch[j], g + M_[t]);
      if (!isfinite(M)) M = 0.0f;
    }
    M_[t] = M;
    w_[t] = expf(((G - g) + i_[t]) - mch[j + 1]);
  }
}

// Chunk pass, a block (one warpgroup) per (64 of dk, 64 of dv, chunk, batch
// x head): the chunk's own state update dS = K^T (w o V) and, in the blocks
// of the first dv tile, dn = K^T w (f32 FMA), written in f32. The chunk's K
// and V slabs (64 keys each, at most four) are all requested by TMA at the
// start, one barrier each; w o V is formed in f32 and split into three bf16
// tiles at V's own swizzled offsets (hi over V in place, mid and lo in one
// of two buffers), so K^T (exact in bf16, read MN-major) times each is one
// wgmma chain, twelve m64n64k16 products a slab; a slab's split runs while
// the tensor cores take the previous slab's products. No block waits on
// another chunk: the chain pass adds the updates up.
constexpr int kDeltaSmem =
    2048 + (2 * kSlabs + 4) * (int)kTileBytes + (kMaxChunk + kWg) * (int)sizeof(float);

__global__ void __launch_bounds__(kWg) mlstm_scan_delta_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap, Chunked a) {
  extern __shared__ __align__(1024) unsigned char smem_d[];
  const uint32_t raw = smem_u32(smem_d), base = (raw + 1023u) & ~1023u;
  // slab s: the K slab, then the V slab (then w o V's hi term); then two
  // (mid, lo) buffers, slab s using buffer s % 2
  const uint32_t bar = base, stages = base + 1024, mlb = stages + 2 * kSlabs * kTileBytes;
  float* ws = reinterpret_cast<float*>(smem_d + (base - raw) + 1024 + (2 * kSlabs + 4) * kTileBytes);
  float* nred = ws + kMaxChunk;  // [kWg]: the two halves of a slab's dn sums
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0), gid = lane >> 2, tig = lane & 3;
  const int dk = a.dk, dv = a.dv, C = a.C, NC = a.NC;
  const int ndk = (dk + kW - 1) / kW, ndv = (dv + kW - 1) / kW;
  const int dvt = blockIdx.x % ndv, dkt = (blockIdx.x / ndv) % ndk;
  const int cj = blockIdx.x / (ndv * ndk), j = cj % NC, bh = cj / NC;
  const int b = bh / a.H, h = bh % a.H, d0 = dkt * kW, e0 = dvt * kW, t0 = j * C;
  const bool carry_n = dvt == 0;
  const int nslab = (min(C, a.S - t0) + kW - 1) / kW;
  if (tid == 0) {
    for (int s = 0; s < kSlabs; ++s) mbar_init(bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < nslab; ++s) {
      const uint32_t kt = stages + s * 2 * kTileBytes;
      mbar_expect_tx(bar + 8 * s, 2 * kTileBytes);
      tma_load(kt, &kmap, bar + 8 * s, d0, t0 + s * kW, h, b);
      tma_load(kt + kTileBytes, &vmap, bar + 8 * s, e0, t0 + s * kW, h, b);
    }
  const size_t P = (size_t)a.BH * NC * C;
  for (int c = tid; c < nslab * kW; c += kWg) ws[c] = a.gw[3 * P + (size_t)cj * C + c];
  // the tile in the accumulator layout: element i at row 16 warp + gid +
  // 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 tig + (i & 1)
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  fence_regs<32>(acc);
  float nsum = 0.0f;
  __syncthreads();
  for (int s = 0; s < nslab; ++s) {
    const uint32_t kt = stages + s * 2 * kTileBytes, vt = kt + kTileBytes;
    const uint32_t ml = mlb + (s & 1) * 2 * kTileBytes;
    mbar_wait(bar + 8 * s, 0);
    // w o V as hi (over V), mid and lo; a row of the swizzled tile is one key
    for (int q = tid; q < kW * 8; q += kWg) {
      const uint32_t off = q * 16;
      const float w = ws[s * kW + (q >> 3)];
      const uint4 vv = ld_v4(vt + off);
      const uint32_t in[4] = {vv.x, vv.y, vv.z, vv.w};
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[e]));
        split3(w * x.x, w * x.y, hi[e], mid[e], lo[e]);
      }
      st_v4(vt + off, make_uint4(hi[0], hi[1], hi[2], hi[3]));
      st_v4(ml + off, make_uint4(mid[0], mid[1], mid[2], mid[3]));
      st_v4(ml + kTileBytes + off, make_uint4(lo[0], lo[1], lo[2], lo[3]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wg_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint32_t part = p == 0 ? vt : ml + (p - 1) * kTileBytes;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        mma_ss<64, 1, 1>(acc, gmma_desc(kt + t * 2048, kTileBytes, 1024),
                         gmma_desc(part + t * 2048, kTileBytes, 1024), 1);
    }
    wg_commit();
    if (carry_n) {  // dn's partial sums over the slab's two halves of keys
      const int d = tid & (kW - 1), k0 = (tid >> 6) * 32;
      float sum = 0.0f;
#pragma unroll 8
      for (int c = k0; c < k0 + 32; ++c) sum = fmaf(ws[s * kW + c], ld_bf16(kt + swz(c, d)), sum);
      nred[tid] = sum;
    }
    // the previous slab's products (and with them its buffer) are done
    wg_wait<1>();
    __syncthreads();
    if (carry_n && tid < kW) nsum += nred[tid] + nred[tid + kW];
  }
  wg_wait<0>();
  fence_regs<32>(acc);
  const int row0 = d0 + 16 * warp + gid, col0 = e0 + 2 * tig;
  float* dS = a.dS + (size_t)cj * dk * dv;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1), col = col0 + 8 * (i >> 2);
    if (row < dk && col < dv)
      *reinterpret_cast<float2*>(dS + (size_t)row * dv + col) = make_float2(acc[i], acc[i + 1]);
  }
  if (carry_n && tid < kW && d0 + tid < dk) a.dn[(size_t)cj * dk + d0 + tid] = nsum;
}

// Chain pass: S' = decay S + dS chunk by chunk, in f32, eight elements of one
// (batch x head)'s S a thread (and n in the first block of each), from S0 or
// zeros; the state entering each chunk takes the place of the chunk's own
// update once that is read (16-byte loads and stores), so the output pass
// reads it in f32 and the workspace holds one f32 state a chunk; the final S
// and n in f32.
constexpr int kChainThreads = 256;

__global__ void __launch_bounds__(kChainThreads) mlstm_scan_chain_kernel(Chunked a, int per) {
  const int bh = blockIdx.x / per, x0 = blockIdx.x % per, NC = a.NC, dk = a.dk;
  const size_t DD = (size_t)dk * a.dv;
  const float* dch = a.dch + (size_t)bh * NC;
  const size_t e = ((size_t)x0 * kChainThreads + threadIdx.x) * 8;
  if (e < DD) {
    float S[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) S[x] = a.S0 ? a.S0[bh * DD + e + x] : 0.0f;
    // the next chunk's update is requested before this chunk's slot is
    // overwritten, so its load is in flight under the store and the sums
    const size_t step = DD / 4;
    float4* at = reinterpret_cast<float4*>(a.dS + (size_t)bh * NC * DD + e);
    float4 u = at[0], w = at[1];
    for (int j = 0; j < NC; ++j, at += step) {
      float4 un = u, wn = w;
      if (j + 1 < NC) {
        un = at[step];
        wn = at[step + 1];
      }
      const float decay = dch[j];
      const float d[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
      at[0] = make_float4(S[0], S[1], S[2], S[3]);
      at[1] = make_float4(S[4], S[5], S[6], S[7]);
#pragma unroll
      for (int x = 0; x < 8; ++x) S[x] = __fadd_rn(__fmul_rn(decay, S[x]), d[x]);
      u = un;
      w = wn;
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) a.S1[bh * DD + e + x] = S[x];
  }
  if (x0 == 0)
    for (int d = threadIdx.x; d < dk; d += kChainThreads) {
      float n = a.n0 ? a.n0[(size_t)bh * dk + d] : 0.0f;
      for (int j = 0; j < NC; ++j) {
        const size_t at = ((size_t)bh * NC + j) * dk + d;
        const float dn = a.dn[at];
        a.dn[at] = n;
        n = __fadd_rn(__fmul_rn(dch[j], n), dn);
      }
      a.n1[(size_t)bh * dk + d] = n;
    }
}

// Output pass, a block (one warpgroup) per (64 query rows, NV of dv, chunk,
// batch x head), after FLA's chunk_fwd_o. The Q tile (all of dk) arrives by
// TMA once. y starts as q . S_prev, 64 of dk at a time: the threads read the
// f32 state entering the chunk (from L2: the chunk's row tiles read it
// alike), split it into three bf16 planes (hi + mid + lo, exact) in the
// last stages of the ring, swizzled as TMA would lay them, and Q (exact
// bf16) times each plane is one wgmma chain; the next tile's loads run
// under its products. Then a stream of items, each NV / 64 tiles of 64 x
// 64, runs through a ring of up to eight stages: for each key tile at or
// below the diagonal, K (NV of dk an item) and V; the items that fit
// before the planes are requested at the start. A stage is handed back to
// TMA once the products of the item after it have been issued and its own
// are done, so the loads run ahead while the tensor cores work. y is
// scaled by each row's exp(g + m - M); then per key tile S = Q K^T (bf16
// wgmma, exact products),
// P = S o exp((g_r - g_c) + i_c - M_r) on the causal pairs in f32
// registers, P split into three bf16 A fragments and y += P V as three
// chains from registers, which run while the next tile's Q K^T is issued.
// Products over dk stop at its last 16 (TMA's zero padding is not
// multiplied). Row sums of P, q . n (f32 FMA over the Q tile) and the
// normalizer finish in registers; the output is written in the caller's
// strides. NV is 128 where dv is wider than 64 (Q K^T, the weights and the
// K and Q loads of a key tile then serve twice the columns), else 64.
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block can have
constexpr int kSmemPerSm = 233472;  // an SM's shared memory, 1 KB of it reserved a block
constexpr int kMaxRing = 8;       // the most stages the output pass's ring holds
constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU.EX2 (results below 2^-126 flush to 0; 2^-inf is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A stage of the output pass's ring: NV / 64 tiles, or three times that
// where the items are packed; the three planes of a 64-row slab of the
// state take three stages, or one where packed.
template <int NV, bool PACKED>
__host__ __device__ constexpr uint32_t out_stage(void) {
  return (PACKED ? 3 : 1) * (NV / kW) * kTileBytes;
}
template <int NV, bool PACKED>
__host__ __device__ constexpr int out_smem(int ndk, int ring) {
  return 2048 + ndk * (int)kTileBytes + ring * (int)out_stage<NV, PACKED>() +
         (3 * kMaxChunk + ndk * kW + kW) * (int)sizeof(float);
}

template <int NV, bool PACKED>
__global__ void __launch_bounds__(kWg) mlstm_scan_out_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, Chunked a, int ring) {
  constexpr int NT = NV / kW, NA = NV / 2;  // dv's column tiles, accumulator registers
  constexpr uint32_t SB = out_stage<NV, PACKED>();
  extern __shared__ __align__(1024) unsigned char smem_out[];
  const int dk = a.dk, dv = a.dv, C = a.C, NC = a.NC;
  const int ndk = (dk + kW - 1) / kW, ndv = (dv + NV - 1) / NV, nqt = C / kW;
  // the row tiles of one (dv tile, chunk, head) side by side: they read the
  // same entering state and keys, so those stay in L2
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt), rest = blockIdx.x / nqt;
  const int dvt = rest % ndv, jb = rest / ndv;
  const int j = jb % NC, bh = jb / NC, b = bh / a.H, h = bh % a.H;
  const int t0 = j * C, Cv = min(C, a.S - t0), r0 = qt * kW, e0 = dvt * NV;
  if (r0 >= Cv) return;
  const uint32_t raw = smem_u32(smem_out), base = (raw + 1023u) & ~1023u;
  const uint32_t bar_q = base, bar_f = base + 8;  // Q, then the ring's stages
  const uint32_t sq = base + 1024, stages = sq + ndk * kTileBytes;
  float* gs = reinterpret_cast<float*>(smem_out + (base - raw) + 1024 + ndk * kTileBytes + ring * SB);
  float* is = gs + kMaxChunk;
  float* Ms = is + kMaxChunk;
  float* nps = Ms + kMaxChunk;  // [ndk * kW]: n entering the chunk
  float* qns = nps + ndk * kW;  // [kW]: q . n of the tile's rows
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0), gid = lane >> 2, tig = lane & 3;
  const size_t P = (size_t)a.BH * NC * C, cj = (size_t)bh * NC + j;
  const int nkg = (ndk + NT - 1) / NT;         // K items of a key tile
  const int total = PACKED ? qt + 1 : (qt + 1) * (nkg + 1);
  const int nks = (dk + 15) / 16;              // products over dk: 16 a step
  constexpr int SP = PACKED ? 1 : 3;           // stages the state's planes take
  const int early = max(0, min(total, ring - SP));  // items requested at the start

  // item it: per key tile its nkg K items (column tiles g NT .. g NT + NT -
  // 1 of dk) and its V item. PACKED (dk of one tile, where the products are
  // too small to pay for an item each): a key tile's K (one tile) and V are
  // one item.
  const CUtensorMap *km = &kmap, *vm = &vmap;
  auto issue = [&](int it) {
    const int st = it % ring;
    const uint32_t sb = stages + st * SB, fb = bar_f + 8 * st;
    if constexpr (PACKED) {
      const int k0 = t0 + it * kW;
      mbar_expect_tx(fb, (1 + NT) * kTileBytes);
      tma_load(sb, km, fb, 0, k0, h, b);
      for (int c = 0; c < NT; ++c)
        tma_load(sb + (1 + c) * kTileBytes, vm, fb, e0 + c * kW, k0, h, b);
      return;
    }
    const int g = it % (nkg + 1), k0 = t0 + (it / (nkg + 1)) * kW;
    if (g < nkg) {
      const int c1 = min(ndk, g * NT + NT);
      mbar_expect_tx(fb, (c1 - g * NT) * kTileBytes);
      for (int c = g * NT; c < c1; ++c)
        tma_load(sb + (c - g * NT) * kTileBytes, km, fb, c * kW, k0, h, b);
    } else {
      mbar_expect_tx(fb, SB);
      for (int c = 0; c < NT; ++c) tma_load(sb + c * kTileBytes, vm, fb, e0 + c * kW, k0, h, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= ring; ++i) mbar_init(base + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, ndk * kTileBytes);
    for (int ct = 0; ct < ndk; ++ct) tma_load(sq + ct * kTileBytes, &qmap, bar_q, ct * kW, t0 + r0, h, b);
    for (int it = 0; it < early; ++it) issue(it);
  }
  for (int c = tid; c < C; c += kWg) {
    gs[c] = a.gw[cj * C + c];
    is[c] = a.gw[P + cj * C + c];
    Ms[c] = a.gw[2 * P + cj * C + c];
  }
  if (a.normalize)
    for (int d = tid; d < ndk * kW; d += kWg) nps[d] = d < dk ? a.dn[cj * dk + d] : 0.0f;
  const float m_prev = a.mch[(size_t)bh * (NC + 1) + j];
  __syncthreads();
  mbar_wait(bar_q, 0);
  if (a.normalize) {  // q . n, two threads a row, each half of every 64 dims
    const int r = tid >> 1, half = tid & 1;
    float sum = 0.0f;
    for (int ct = 0; ct < ndk; ++ct)
      for (int pc = 4 * half; pc < 4 * half + 4; ++pc) {
        const uint4 qq = ld_v4(sq + ct * kTileBytes + r * 128 + pc * 16);
        const uint32_t in[4] = {qq.x, qq.y, qq.z, qq.w};
        const float* nn = nps + ct * kW + ((pc ^ (r & 7)) << 3);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[e]));
          sum = fmaf(x.x, nn[2 * e], sum);
          sum = fmaf(x.y, nn[2 * e + 1], sum);
        }
      }
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
    if (half == 0) qns[r] = sum;
    __syncthreads();
  }

  // Every item's products are one commit group. Once an item's group is
  // issued, next() waits until only it is in flight and drain() until none
  // is (where the results are read next); either way the earlier items'
  // stages are free, and thread 0 hands them back to TMA. Every wait sits
  // at a fixed point, so ptxas sees which registers a product may still
  // write, and registers that wgmma reads are fenced after every other
  // write, so the compiler keeps those writes out of a product's pipeline
  // stage.
  int it = 0, released = 0;  // items consumed; items whose stage went back
  auto release = [&](int done) {
    __syncthreads();
    if (tid == 0)
      for (; released < done; ++released)
        if (released + ring < total) issue(released + ring);
  };
  auto next = [&]() {
    wg_wait<1>();
    release(it);
    ++it;
  };
  auto drain = [&]() {
    wg_wait<0>();
    release(it);
  };
  auto stage_of = [&](int i) {
    mbar_wait(bar_f + 8 * (i % ring), (i / ring) & 1);
    return stages + (i % ring) * SB;
  };
  // accumulator element i: tile row 16 warp + gid + 8 ((i >> 1) & 1), column
  // 8 (i >> 2) + 2 tig + (i & 1)
  const int rl[2] = {16 * warp + gid, 16 * warp + gid + 8};
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  fence_regs<NA>(acc);
  // y = q . S_prev, 64 of dk at a time: each thread loads NV / 16 runs of 8
  // f32 values of the state (zeros past dk and dv) before the previous
  // slab's products are waited for, then writes their three bf16 terms
  constexpr int U = NV / 16;
  const uint32_t planes = stages + (ring - SP) * SB;
  const float* Sp = a.dS + cj * dk * dv;
  for (int ct = 0; ct < ndk; ++ct) {
    const int nk = (min(kW, dk - ct * kW) + 15) / 16;
    float4 x[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int run = tid + u * kWg, d = ct * kW + run / (NV / 8), e = e0 + (run % (NV / 8)) * 8;
      const bool in = d < dk && e < dv;
      const float4* src = reinterpret_cast<const float4*>(Sp + (in ? (size_t)d * dv + e : 0));
      x[u][0] = in ? src[0] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[u][1] = in ? src[1] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    wg_wait<0>();  // the previous slab's products have read the planes
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int run = tid + u * kWg, r = run / (NV / 8), col = (run % (NV / 8)) * 8;
      const float y[8] = {x[u][0].x, x[u][0].y, x[u][0].z, x[u][0].w,
                          x[u][1].x, x[u][1].y, x[u][1].z, x[u][1].w};
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(y[2 * e], y[2 * e + 1], hi[e], mid[e], lo[e]);
      const uint32_t at = planes + (col >> 6) * kTileBytes + swz(r, col & (kW - 1));
      st_v4(at, make_uint4(hi[0], hi[1], hi[2], hi[3]));
      st_v4(at + NT * kTileBytes, make_uint4(mid[0], mid[1], mid[2], mid[3]));
      st_v4(at + 2 * NT * kTileBytes, make_uint4(lo[0], lo[1], lo[2], lo[3]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wg_fence();
#pragma unroll 1
    for (int pp = 0; pp < 3; ++pp)
      for (int t = 0; t < nk; ++t)
        mma_ss<NV, 0, 1>(acc, gmma_desc(sq + ct * kTileBytes + t * 32, 16, 1024),
                         gmma_desc(planes + pp * NT * kTileBytes + t * 2048, kTileBytes, 1024), 1);
    wg_commit();
  }
  wg_wait<0>();
  __syncthreads();  // the planes' stages are free: the rest of the first items
  if (tid == 0)
    for (int i = early; i < min(total, ring); ++i) issue(i);
  fence_regs<NA>(acc);
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  fence_regs<32>(sc);
  // P's weights as 2^(a_r + b_c): a_r = (g_r - M_r) log2 e a row, b_c = (i_c
  // - g_c) log2 e a key; a_r + b_c <= 0 on the causal pairs, and -inf past S
  float Mr[2], ar[2], wi[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float g = gs[r0 + rl[hr]];
    Mr[hr] = Ms[r0 + rl[hr]];
    ar[hr] = (g - Mr[hr]) * kLog2e;
    wi[hr] = expf((g + m_prev) - Mr[hr]);
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] *= wi[(i >> 1) & 1];
  fence_regs<NA>(acc);
  float rs[2] = {0.0f, 0.0f};
  uint32_t pa[3][4][4];  // P's three bf16 terms as A fragments, 16 keys a step
  for (int kt = 0; kt <= qt; ++kt) {  // y += P V, one key tile at a time
    const int k0 = kt * kW;
    uint32_t sb = 0;
    for (int g = 0; g < nkg; ++g) {  // S = Q K^T over the K items
      sb = stage_of(it);
      wg_fence();
      for (int ks = 4 * NT * g; ks < min(nks, 4 * NT * (g + 1)); ++ks) {
        const uint32_t at = (ks >> 2) * kTileBytes + (ks & 3) * 32;
        mma_ss<64, 0, 0>(sc, gmma_desc(sq + at, 16, 1024),
                         gmma_desc(sb + at - g * NT * kTileBytes, 16, 1024), ks != 0);
      }
      wg_commit();
      if constexpr (!PACKED) next();
    }
    if constexpr (PACKED) wg_wait<0>();  // S, and the previous tile's P V
    else drain();
    fence_regs<32>(sc);
    fence_regs<NA>(acc);
    fence_regs<48>(&pa[0][0][0]);
    float bc[16];  // b_c of this thread's 16 keys
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = k0 + 8 * (i >> 1) + 2 * tig + (i & 1);
      bc[i] = (is[c] - gs[c]) * kLog2e;
    }
    float pv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1, r = r0 + rl[hr], c = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
      pv[i] = c <= r ? sc[i] * ex2(ar[hr] + bc[2 * (i >> 2) + (i & 1)]) : 0.0f;
      rs[hr] += pv[i];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split3(pv[8 * t + 2 * e], pv[8 * t + 2 * e + 1], pa[0][t][e], pa[1][t][e], pa[2][t][e]);
    fence_regs<48>(&pa[0][0][0]);
    const uint32_t vb = PACKED ? sb + kTileBytes : stage_of(it);
    wg_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        mma_rs<NV>(acc, pa[p][t], gmma_desc(vb + t * 2048, kTileBytes, 1024));
    wg_commit();
    next();  // P V runs on under the next tile's Q K^T
  }
  drain();
  fence_regs<NA>(acc);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] += __shfl_xor_sync(0xFFFFFFFFu, rs[hr], 1);
    rs[hr] += __shfl_xor_sync(0xFFFFFFFFu, rs[hr], 2);
  }
  __nv_bfloat16* ob = a.o + b * a.osb + h * a.osh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + rl[hr];
    if (r >= Cv) continue;
    float den = 1.0f;
    if (a.normalize) den = fmaxf(fabsf(rs[hr] + wi[hr] * qns[rl[hr]]), expf(-Mr[hr]));
#pragma unroll
    for (int n8 = 0; n8 < NV / 8; ++n8) {
      const int col = e0 + 8 * n8 + 2 * tig;
      if (col >= dv) continue;
      float y0 = acc[4 * n8 + 2 * hr], y1 = acc[4 * n8 + 2 * hr + 1];
      if (a.normalize) {
        y0 = y0 / den;
        y1 = y1 / den;
      }
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(t0 + r) * a.oss + col) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
}

// The output pass's dv tile: 128 where dv is wider than 64, no 64-column
// tile would lie wholly past dv and the block's shared memory allows it,
// else 64.
int out_cols(int dk, int dv) {
  return dv > kW && (dv % 128 == 0 || dv % 128 > kW) &&
                 out_smem<128, false>((dk + kW - 1) / kW, 3) <= kMaxSmem
             ? 128
             : 64;
}

// The output pass's ring: as many stages as fit (up to kMaxRing) while as
// many blocks share an SM as with the fewest stages (those the state's
// planes take, and one more where packed), up to three (three blocks of
// 128 threads about fill an SM's registers at this kernel's count).
template <int NV, bool PACKED>
int out_ring(int ndk) {
  const auto blocks = [ndk](int ring) {
    return kSmemPerSm / (out_smem<NV, PACKED>(ndk, ring) + 1024);
  };
  int ring = PACKED ? 2 : 3;
  const int want = min(3, blocks(ring));
  while (ring < kMaxRing && out_smem<NV, PACKED>(ndk, ring + 1) <= kMaxSmem &&
         blocks(ring + 1) >= want)
    ++ring;
  return ring;
}

template <int NV>
void launch_out(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                const Chunked& c, int ndk, int tiles, cudaStream_t st) {
  if (ndk == 1) {
    const int ring = out_ring<NV, true>(ndk);
    mlstm_scan_out_kernel<NV, true>
        <<<tiles, kWg, out_smem<NV, true>(ndk, ring), st>>>(qm, km, vm, c, ring);
  } else {
    const int ring = out_ring<NV, false>(ndk);
    mlstm_scan_out_kernel<NV, false>
        <<<tiles, kWg, out_smem<NV, false>(ndk, ring), st>>>(qm, km, vm, c, ring);
  }
}

int launch_chunked(const void* q, const void* k, const void* v, const Args& s, const Chunked& c,
                   cudaStream_t st) {
  // Raised once, on the first launch: a caller's first launch comes before
  // any CUDA graph capture of it.
  static const cudaError_t attr = [] {
    const void* fns[5] = {(const void*)mlstm_scan_out_kernel<64, false>,
                          (const void*)mlstm_scan_out_kernel<64, true>,
                          (const void*)mlstm_scan_out_kernel<128, false>,
                          (const void*)mlstm_scan_out_kernel<128, true>,
                          (const void*)mlstm_scan_delta_kernel};
    const int sizes[5] = {kMaxSmem, kMaxSmem, kMaxSmem, kMaxSmem, kDeltaSmem};
    for (int f = 0; f < 5; ++f) {
      const cudaError_t e =
          cudaFuncSetAttribute(fns[f], cudaFuncAttributeMaxDynamicSharedMemorySize, sizes[f]);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int ndk = (s.dk + kW - 1) / kW, ndv = (s.dv + kW - 1) / kW, nv = out_cols(s.dk, s.dv);
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, s.dk, s.S, s.H, s.B, s.qss, s.qsh, s.qsb, kW) ||
      !make_map(&km, k, s.dk, s.S, s.H, s.B, s.kss, s.ksh, s.ksb, kW) ||
      !make_map(&vm, v, s.dv, s.S, s.H, s.B, s.vss, s.vsh, s.vsb, kW))
    return (int)cudaErrorInvalidValue;
  mlstm_scan_gates_kernel<<<c.BH, kGateThreads, 0, st>>>(c);
  mlstm_scan_delta_kernel<<<ndk * ndv * c.NC * c.BH, kWg, kDeltaSmem, st>>>(km, vm, c);
  const int per = (s.dk * s.dv / 8 + kChainThreads - 1) / kChainThreads;
  mlstm_scan_chain_kernel<<<per * c.BH, kChainThreads, 0, st>>>(c, per);
  const int tiles = (s.chunk / kW) * ((s.dv + nv - 1) / nv) * c.NC * c.BH;
  if (nv == 128)
    launch_out<128>(qm, km, vm, c, ndk, tiles, st);
  else
    launch_out<64>(qm, km, vm, c, ndk, tiles, st);
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

// The chunked route (bf16): the operands as for mlstm_scan_fwd, with dk <= 512
// and dv multiples of 8, chunk a multiple of 64 up to 256, q, k, v on 16-byte
// boundaries with strides that are multiples of 8; ws an f32 workspace of
// BH NC dk dv + BH NC dk + 4 BH NC chunk + BH (NC + 1) + BH NC floats on a
// 16-byte boundary (BH = B H, NC = ceil(S / chunk)), not read before it is
// written. Returns 0 or the CUDA error code of a failed launch
// (cudaErrorInvalidValue for an input it does not take).
extern "C" int mlstm_scan_chunked(const void* q, const void* k, const void* v, const float* f,
                                  const float* i, void* o, const float* S0, const float* n0,
                                  const float* m0, float* S1, float* n1, float* m1, float* ws,
                                  long long qsb, long long qsh, long long qss,
                                  long long ksb, long long ksh, long long kss, long long vsb,
                                  long long vsh, long long vss, long long osb, long long osh,
                                  long long oss, long long fsb, long long fsh, long long fss,
                                  long long isb, long long ish, long long iss, int B, int H, int S,
                                  int dk, int dv, int chunk, int normalize, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk < 8 || dk > kMaxDk || dk % 8 || dv < 8 || dv % 8 ||
      chunk < kW || chunk > kMaxChunk || chunk % kW || (S0 && (!n0 || !m0)) || !ws ||
      (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long BH = (long long)B * H, NC = (S + chunk - 1) / chunk;
  const long long ndk = (dk + kW - 1) / kW, ndv = (dv + kW - 1) / kW;
  const long long chain = ((long long)dk * dv / 8 + 255) / 256 * BH;
  if (ndk * ndv * NC * BH > 2147483647LL || (chunk / kW) * ndv * NC * BH > 2147483647LL ||
      chain > 2147483647LL || reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   f,   i,   o,   S0,  n0,  m0,  S1,  n1,  m1,  qsb,
               qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, fsb, fsh,
               fss, isb, ish, iss, B,   H,   S,   dk,  dv,  chunk, normalize};
  Chunked c{};
  c.f = f;
  c.i = i;
  c.S0 = S0;
  c.n0 = n0;
  c.m0 = m0;
  c.S1 = S1;
  c.n1 = n1;
  c.m1 = m1;
  c.o = static_cast<__nv_bfloat16*>(o);
  c.dS = ws;
  c.dn = c.dS + BH * NC * dk * dv;
  c.gw = c.dn + BH * NC * dk;
  c.mch = c.gw + 4 * BH * NC * chunk;
  c.dch = c.mch + BH * (NC + 1);
  c.fsb = fsb;
  c.fsh = fsh;
  c.fss = fss;
  c.isb = isb;
  c.ish = ish;
  c.iss = iss;
  c.osb = osb;
  c.osh = osh;
  c.oss = oss;
  c.H = H;
  c.BH = (int)BH;
  c.S = S;
  c.dk = dk;
  c.dv = dv;
  c.C = chunk;
  c.NC = (int)NC;
  c.normalize = normalize;
  return launch_chunked(q, k, v, a, c, static_cast<cudaStream_t>(stream));
}
