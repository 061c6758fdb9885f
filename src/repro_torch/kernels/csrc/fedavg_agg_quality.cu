// Fused FedAvg aggregation + quality pass for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
// - kernels/fedavg_agg.py::fedavg_agg_quality: from the stacked client
//   updates U (K, P), f32 or bf16, and the FedAvg weights w (K,), f32, it
//   computes
//     agg[p]  = sum_k w_k U[k, p]          (P,)  in U's dtype
//     dots[k] = <U[k], agg_f32>            (K,)  f32
//     sq[k]   = ||U[k]||^2                 (K,)  f32
//     asq     = ||agg_f32||^2              ()    f32
//   with every sum in f32 and U read from device memory once;
// - kernels/compression.py::fedavg_agg_quality_i8: the same four outputs
//   (agg in f32) from int8 payloads, U[k, p] = float(V[k, p]) * S[k, p /
//   chunk], dequantized in registers, so the f32 (K, P) matrix is never
//   built.
//
// Bound: bandwidth. At the main path's shape (K = 13, P = 1,070,794, f32)
// the pass reads 55.7 MB and writes 4.3 MB, about 18 us at 3.35 TB/s; it
// does about 6KP flops, 1.5 per byte read, far below the card's ridge.
// From int8 payloads it reads 13.9 MB of values and 0.22 MB of scales and
// writes 4.3 MB: 5.5 us.
//
// Design of the f32 and bf16 entries. The TPU kernel walked the P-blocks
// in order and carried the sums in its outputs. Here the blocks run in
// parallel: each thread owns one column at a time, holds that column's K
// values in registers (so its agg entry is complete and U is not read
// again), and keeps per-client partial dots and squares in registers
// across a grid-stride loop. Each block then reduces its threads' partials
// (warp shuffles, then warps in a fixed order) into partial_dots/partial_sq
// (nblocks, K) and partial_asq (nblocks,). A second kernel sums the
// partials in a fixed order. No float atomics, so results repeat bit for
// bit from run to run. The grid depends on P only. The ragged tail is
// masked by the column bound.
//
// Design of the int8 entry (agg_quality_i8_kernel): one launch, bound by
// bytes rather than by instructions. Each thread owns 16 consecutive
// columns, one 16-byte word of each client row. Rows k >= 1 start off
// 16-byte alignment (P = 1,070,794 is 10 mod 16), so no 2-D TMA map of V
// exists (its row stride is not a multiple of 16); a thread reads the two
// aligned 16-byte words that cover its 16 bytes and funnel-shifts them by
// the row's offset, which is the same for every thread of the row. The
// neighbour's second word is the thread's first, so the extra load hits
// L1 and device memory is read once; this keeps no shared memory and no
// barrier, where a bulk-copy ring would add both for the same bytes. With
// K <= 16 the first 12 rows' words stay in registers between the pass
// that completes agg and the pass that sums dots and squares (rows past
// them are read again, from L1 or L2): 12 keeps a thread at 128
// registers without spills, two blocks an SM (16 rows spilled at 128,
// 13 took more registers and one block an SM). A byte becomes a float
// by a byte permute into 2^23 + (b + 128) and one exact subtraction, then
// one __fmul_rn by its chunk's scale, as float(V) * S rounds; where the
// chunk is a multiple of 16 a thread needs one scale a row, else each
// column finds its chunk with 32-bit arithmetic. agg[p] is fmaf over k
// in order, as the f32 entry sums it. The block's partials go to device
// memory, output-major. The launch is cooperative (its grid no larger
// than the card holds at once), so after one grid barrier block 0 sums
// them in a fixed order, every load of a warp in flight at once (the grid
// is capped at 288 blocks, nine a lane; the kernel strides past it): the
// outputs repeat bit for bit and no float atomics are used. The barrier
// is the launch's own, so calls on concurrent streams or CUDA graphs
// share no state and nothing is zeroed before a launch (a ticket word
// taken by the last block to finish needs a memset node beside each
// launch in a graph). A tail whose outputs each waited on the last's
// loads cost the first version of this kernel most of its fixed time.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Loaders: the value of client k at column c, as f32.
template <typename T>
struct DenseLoad {
  const T* u;
  long long P;
  __device__ __forceinline__ float operator()(int k, long long c) const {
    return load_f32(u + (long long)k * P + c);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename Load, typename TOut, int KB>
__global__ void __launch_bounds__(kThreads)
agg_quality_partials(Load load, const float* __restrict__ w,
                     TOut* __restrict__ agg, float* __restrict__ part_dots,
                     float* __restrict__ part_sq, float* __restrict__ part_asq,
                     int K, long long P) {
  __shared__ float s_w[KB];
  __shared__ float s_red[kWarps][2 * KB + 1];
  for (int k = threadIdx.x; k < KB; k += kThreads) s_w[k] = k < K ? w[k] : 0.f;
  __syncthreads();

  float dacc[KB], qacc[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    dacc[k] = 0.f;
    qacc[k] = 0.f;
  }
  float aacc = 0.f;

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x; c < P;
       c += stride) {
    float x[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) x[k] = k < K ? load(k, c) : 0.f;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < KB; ++k) a = fmaf(s_w[k], x[k], a);
    store_from_f32(agg + c, a);
    aacc = fmaf(a, a, aacc);
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      dacc[k] = fmaf(x[k], a, dacc[k]);
      qacc[k] = fmaf(x[k], x[k], qacc[k]);
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float d = warp_sum(dacc[k]);
    const float q = warp_sum(qacc[k]);
    if (lane == 0) {
      s_red[warp][k] = d;
      s_red[warp][KB + k] = q;
    }
  }
  const float a = warp_sum(aacc);
  if (lane == 0) s_red[warp][2 * KB] = a;
  __syncthreads();

  const int t = threadIdx.x;
  if (t <= 2 * KB) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += s_red[i][t];
    const long long b = blockIdx.x;
    if (t < K) {
      part_dots[b * K + t] = s;
    } else if (t >= KB && t < KB + K) {
      part_sq[b * K + (t - KB)] = s;
    } else if (t == 2 * KB) {
      part_asq[b] = s;
    }
  }
}

// One block per output (K dots, K squares, 1 agg square); each sums its
// nblocks partials in a fixed order.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ part_dots,
                const float* __restrict__ part_sq,
                const float* __restrict__ part_asq, float* __restrict__ out,
                int K, int nblocks) {
  const int o = blockIdx.x;
  const float* src;
  int step;
  if (o < K) {
    src = part_dots + o;
    step = K;
  } else if (o < 2 * K) {
    src = part_sq + (o - K);
    step = K;
  } else {
    src = part_asq;
    step = 1;
  }
  float s = 0.f;
  for (int i = threadIdx.x; i < nblocks; i += kThreads) s += src[(long long)i * step];
  __shared__ float red[kThreads];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = red[0];
}

template <typename Load, typename TOut>
int launch(Load load, const void* w, void* agg, void* part_dots, void* part_sq,
           void* part_asq, void* out, int K, long long P, int nblocks,
           cudaStream_t stream) {
  if (K < 1 || K > kMaxK || P < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const float* ww = static_cast<const float*>(w);
  TOut* aa = static_cast<TOut*>(agg);
  float* pd = static_cast<float*>(part_dots);
  float* pq = static_cast<float*>(part_sq);
  float* pa = static_cast<float*>(part_asq);
  if (K <= 16) {
    agg_quality_partials<Load, TOut, 16><<<nblocks, kThreads, 0, stream>>>(load, ww, aa, pd, pq,
                                                                          pa, K, P);
  } else if (K <= 32) {
    agg_quality_partials<Load, TOut, 32><<<nblocks, kThreads, 0, stream>>>(load, ww, aa, pd, pq,
                                                                          pa, K, P);
  } else {
    agg_quality_partials<Load, TOut, 64><<<nblocks, kThreads, 0, stream>>>(load, ww, aa, pd, pq,
                                                                          pa, K, P);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<2 * K + 1, kThreads, 0, stream>>>(pd, pq, pa, static_cast<float*>(out), K,
                                                      nblocks);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ the int8 entry

constexpr int kI8Cols = 16;       // columns a thread: one 16-byte word of each client row
constexpr int kI8Hold = 12;       // rows whose words stay in registers between the passes
constexpr int kI8TailLoads = 9;   // blocks a lane of the last block sums, per output
constexpr int kI8MaxBlocks = 32 * kI8TailLoads;  // 288: every SM twice over

// The 16 bytes of V at byte `at`: the two aligned 16-byte words that cover
// them, shifted down by at's offset (the same for every thread of a row).
// `last` is the aligned word that holds V's last byte; no word past it is
// read (bytes past a row's P columns are masked by the caller).
__device__ __forceinline__ uint4 load_cols(const unsigned char* v, long long at, uintptr_t last) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(v + at);
  const uintptr_t lo = a & ~(uintptr_t)15;
  const uintptr_t hi = lo + 16 <= last ? lo + 16 : last;
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(lo));
  const uint4 y = __ldg(reinterpret_cast<const uint4*>(hi));
  const uint32_t wd[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  const unsigned off = (unsigned)(a & 15), q = off >> 2, sh = (off & 3) * 8;
  uint32_t o[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    o[i] = q == 0 ? wd[i] : q == 1 ? wd[i + 1] : q == 2 ? wd[i + 2] : wd[i + 3];
  return make_uint4(__funnelshift_r(o[0], o[1], sh), __funnelshift_r(o[1], o[2], sh),
                    __funnelshift_r(o[2], o[3], sh), __funnelshift_r(o[3], o[4], sh));
}

// Byte b of a word whose bytes were XORed with 0x80 (b + 128, unsigned), as
// the float of the signed byte: 2^23 + (b + 128) by a byte permute, less
// 2^23 + 128, exactly.
__device__ __forceinline__ float i8_value(uint32_t flipped, int b) {
  return __fsub_rn(__int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u + b)), 8388736.0f);
}

// The 16 dequantized values of one row's word: float(V) * S, one rounding.
template <bool ALIGNED>
__device__ __forceinline__ void dequant16(const uint4 word, const float* sk, int q0,
                                          const int* qi, float* x) {
  const uint32_t fw[4] = {word.x ^ 0x80808080u, word.y ^ 0x80808080u, word.z ^ 0x80808080u,
                          word.w ^ 0x80808080u};
  float sc = 0.f;
  if constexpr (ALIGNED) sc = __ldg(sk + q0);
#pragma unroll
  for (int i = 0; i < kI8Cols; ++i)
    x[i] = __fmul_rn(i8_value(fw[i >> 2], i & 3), ALIGNED ? sc : __ldg(sk + qi[i]));
}

// Pass 2 of one thread's 16 columns, of which the first `lim` are real:
// each client's dot with the finished agg columns and its square, and agg's
// square. Inlined, so the arrays stay in registers and lim = 16 folds away.
template <int KB, int HOLD, bool ALIGNED>
__device__ __forceinline__ void quality_pass(const unsigned char* v, const float* s, int P, int c0,
                                             uintptr_t last, int K, int nc, int q0, const int* qi,
                                             const uint4 (&held)[HOLD > 0 ? HOLD : 1],
                                             const float (&a)[kI8Cols], const int lim,
                                             float (&dacc)[KB], float (&qacc)[KB], float& aacc) {
  float x[kI8Cols];
#pragma unroll
  for (int i = 0; i < kI8Cols; ++i)
    if (i < lim) aacc = fmaf(a[i], a[i], aacc);
#pragma unroll (KB <= 16 ? KB : 1)
  for (int k = 0; k < KB; ++k) {
    if (k < K) {
      const uint4 word = k < HOLD ? held[k < HOLD ? k : 0]
                                  : load_cols(v, (long long)k * P + c0, last);
      dequant16<ALIGNED>(word, s + (long long)k * nc, q0, qi, x);
#pragma unroll
      for (int i = 0; i < kI8Cols; ++i) {
        if (i < lim) {
          dacc[k] = fmaf(x[i], a[i], dacc[k]);
          qacc[k] = fmaf(x[i], x[i], qacc[k]);
        }
      }
    }
  }
}

// KB: the accumulators' size (K <= KB); ALIGNED: chunk % 16 == 0, so one
// scale a row serves a thread's 16 columns. Past 16 clients (no path has
// them) the client loops are not unrolled: the accumulators live in local
// memory, and the build stays short.
template <int KB, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
agg_quality_i8_kernel(const unsigned char* __restrict__ v, const float* __restrict__ s,
                      const float* __restrict__ w, float* __restrict__ agg,
                      float* __restrict__ part, float* __restrict__ out, int K, int P,
                      int chunk, int nc) {
  constexpr int kHold = KB <= 16 ? kI8Hold : 0;
  __shared__ float s_w[KB];
  __shared__ float s_red[kWarps][2 * KB + 1];
  for (int k = threadIdx.x; k < KB; k += kThreads) s_w[k] = k < K ? w[k] : 0.f;
  __syncthreads();
  const uintptr_t last = reinterpret_cast<uintptr_t>(v + (long long)K * P - 1) & ~(uintptr_t)15;

  float dacc[KB], qacc[KB];
#pragma unroll (KB <= 16 ? KB : 1)
  for (int k = 0; k < KB; ++k) {
    dacc[k] = 0.f;
    qacc[k] = 0.f;
  }
  float aacc = 0.f;

  const int groups = (P + kI8Cols - 1) / kI8Cols;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < groups; g += gridDim.x * kThreads) {
    const int c0 = g * kI8Cols;
    const int nv = min(kI8Cols, P - c0);
    const int q0 = c0 / chunk;  // 32-bit: column indices fit
    int qi[ALIGNED ? 1 : kI8Cols];
    if constexpr (!ALIGNED) {
      int q = q0;
      long long next = (long long)(q0 + 1) * chunk;
#pragma unroll
      for (int i = 0; i < kI8Cols; ++i) {
        if (c0 + i >= next) {
          ++q;
          next += chunk;
        }
        qi[i] = min(q, nc - 1);  // columns past P read a valid scale, then are masked
      }
    }
    // every held row's word in flight before any is used
    uint4 held[kHold > 0 ? kHold : 1];
#pragma unroll
    for (int k = 0; k < kHold; ++k)
      if (k < K) held[k] = load_cols(v, (long long)k * P + c0, last);

    // pass 1: agg[p] = fmaf over k in order, as the f32 entry sums it
    float a[kI8Cols], x[kI8Cols];
#pragma unroll
    for (int i = 0; i < kI8Cols; ++i) a[i] = 0.f;
#pragma unroll (KB <= 16 ? KB : 1)
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        const uint4 word = k < kHold ? held[k < kHold ? k : 0]
                                     : load_cols(v, (long long)k * P + c0, last);
        dequant16<ALIGNED>(word, s + (long long)k * nc, q0, qi, x);
#pragma unroll
        for (int i = 0; i < kI8Cols; ++i) a[i] = fmaf(s_w[k], x[i], a[i]);
      }
    }
    if (nv == kI8Cols) {
      float4* dst = reinterpret_cast<float4*>(agg + c0);
#pragma unroll
      for (int i = 0; i < kI8Cols / 4; ++i)
        dst[i] = make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
    } else {
      for (int i = 0; i < nv; ++i) agg[c0 + i] = a[i];
    }

    // pass 2: dots and squares against the finished agg columns
    if (nv == kI8Cols)
      quality_pass<KB, kHold, ALIGNED>(v, s, P, c0, last, K, nc, q0, qi, held, a, kI8Cols, dacc,
                                       qacc, aacc);
    else
      quality_pass<KB, kHold, ALIGNED>(v, s, P, c0, last, K, nc, q0, qi, held, a, nv, dacc, qacc,
                                       aacc);
  }

  // the block's partials: warp shuffles, then warps in a fixed order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll (KB <= 16 ? KB : 1)
  for (int k = 0; k < KB; ++k) {
    if (k < K) {
      const float d = warp_sum(dacc[k]);
      const float q = warp_sum(qacc[k]);
      if (lane == 0) {
        s_red[warp][k] = d;
        s_red[warp][KB + k] = q;
      }
    }
  }
  const float as = warp_sum(aacc);
  if (lane == 0) s_red[warp][2 * KB] = as;
  __syncthreads();
  // partials output-major: part[o * nblocks + block]
  const int t = threadIdx.x, no = 2 * K + 1, nb = gridDim.x;
  if (t <= 2 * KB) {
    float sum = 0.f;
    for (int i = 0; i < kWarps; ++i) sum += s_red[i][t];
    const int o = t < K ? t : t >= KB && t < KB + K ? K + t - KB : t == 2 * KB ? 2 * K : -1;
    if (o >= 0) part[(long long)o * nb + blockIdx.x] = sum;
    __threadfence();  // the partial is visible before the grid barrier
  }

  // block 0 sums every block's partials in a fixed order once all are
  // written: a warp takes four outputs at a time, each lane nine blocks of
  // each, so all of a warp's loads are in flight at once (grid <= 32 *
  // kI8TailLoads)
  cooperative_groups::this_grid().sync();
  if (blockIdx.x != 0) return;
  __threadfence();
  for (int j0 = 0; warp + kWarps * j0 < no; j0 += 4) {
    float x[4][kI8TailLoads];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int o = warp + kWarps * (j0 + jj);
#pragma unroll
      for (int u = 0; u < kI8TailLoads; ++u) {
        const int bb = lane + 32 * u;
        x[jj][u] = o < no && bb < nb ? __ldcg(part + (long long)o * nb + bb) : 0.f;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kI8TailLoads; ++u) sum += x[jj][u];
      sum = warp_sum(sum);
      const int o = warp + kWarps * (j0 + jj);
      if (lane == 0 && o < no) out[o] = sum;
    }
  }
}

// The most blocks of agg_quality_i8_kernel<KB, ALIGNED> that the current
// device holds at once (a cooperative launch takes no more), by device.
template <int KB, bool ALIGNED>
int i8_resident() {
  static int cache[64] = {};
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] > 0) return cache[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, agg_quality_i8_kernel<KB, ALIGNED>,
                                                    kThreads, 0) != cudaSuccess)
    return 0;
  return cache[dev] = per_sm * sms;
}

// One cooperative launch of at most `nblocks` blocks, no more than are
// resident at once.
template <int KB, bool ALIGNED>
int launch_i8(int nblocks, cudaStream_t st, const unsigned char* v, const float* s,
              const float* w, float* agg, float* part, float* out, int K, int P, int chunk,
              int nc) {
  const int resident = i8_resident<KB, ALIGNED>();
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks < resident ? nblocks : resident, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, agg_quality_i8_kernel<KB, ALIGNED>, v, s, w, agg, part,
                                 out, K, P, chunk, nc);
}

}  // namespace

// C interface, bound with ctypes. `out` holds dots (K), sq (K) and asq (1)
// back to back. Returns 0 or the CUDA error code of the failed launch.
extern "C" int fedavg_agg_quality_f32(const void* u, const void* w, void* agg,
                                      void* part_dots, void* part_sq, void* part_asq,
                                      void* out, int K, long long P, int nblocks,
                                      void* stream) {
  return launch<DenseLoad<float>, float>({static_cast<const float*>(u), P}, w, agg, part_dots,
                                         part_sq, part_asq, out, K, P, nblocks,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int fedavg_agg_quality_bf16(const void* u, const void* w, void* agg,
                                       void* part_dots, void* part_sq, void* part_asq,
                                       void* out, int K, long long P, int nblocks,
                                       void* stream) {
  return launch<DenseLoad<__nv_bfloat16>, __nv_bfloat16>(
      {static_cast<const __nv_bfloat16*>(u), P}, w, agg, part_dots, part_sq, part_asq, out, K, P,
      nblocks, static_cast<cudaStream_t>(stream));
}

// From int8 payloads: values (K, P) int8, scales (K, nc) f32 with nc =
// ceil(P / chunk); agg (P,) f32; part: nblocks * (2K + 1) f32 of scratch.
// One cooperative launch of at most nblocks blocks. Returns 0 or the CUDA
// error code.
extern "C" int fedavg_agg_quality_i8(const void* values, const void* scales, const void* w,
                                     void* agg, void* part, void* out, int K, long long P,
                                     int chunk, long long nc, int nblocks, void* stream) {
  if (K < 1 || K > kMaxK || P < 1 || P > 2147483647LL - kI8Cols || chunk < 1 ||
      nc != (P + chunk - 1) / chunk || nblocks < 1 || nblocks > kI8MaxBlocks)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const unsigned char*>(values);
  const auto* s = static_cast<const float*>(scales);
  const auto* ww = static_cast<const float*>(w);
  auto* aa = static_cast<float*>(agg);
  auto* pp = static_cast<float*>(part);
  auto* oo = static_cast<float*>(out);
  const int p = (int)P, q = (int)nc;
  const bool aligned = chunk % kI8Cols == 0;
  int rc;
  if (K <= 16)
    rc = aligned ? launch_i8<16, true>(nblocks, st, v, s, ww, aa, pp, oo, K, p, chunk, q)
                 : launch_i8<16, false>(nblocks, st, v, s, ww, aa, pp, oo, K, p, chunk, q);
  else if (K <= 32)
    rc = aligned ? launch_i8<32, true>(nblocks, st, v, s, ww, aa, pp, oo, K, p, chunk, q)
                 : launch_i8<32, false>(nblocks, st, v, s, ww, aa, pp, oo, K, p, chunk, q);
  else
    rc = aligned ? launch_i8<64, true>(nblocks, st, v, s, ww, aa, pp, oo, K, p, chunk, q)
                 : launch_i8<64, false>(nblocks, st, v, s, ww, aa, pp, oo, K, p, chunk, q);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

extern "C" int fedavg_agg_quality_i8_max_blocks() { return kI8MaxBlocks; }

extern "C" int fedavg_agg_quality_max_k() { return kMaxK; }
