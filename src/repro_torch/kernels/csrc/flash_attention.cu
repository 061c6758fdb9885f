// Flash attention (forward) for Hopper (sm_90a). Replaces the TPU kernel
// kernels/flash_attention.py::flash_attention of the JAX package:
// online-softmax attention of q (B, H, Sq, hd) against k, v (B, G, Sk, hd),
// GQA (head h reads kv head h / (H / G)), causal and / or a sliding window,
// right-aligned when Sq < Sk (query row i sits at position i + Sk - Sq), with
// the running max, the running sum and the output accumulator in f32. The
// mask follows the Pallas kernel: a key is kept when key <= qpos (causal) and
// key > qpos - window (window > 0); the running max starts at -2^30; masked
// probabilities are exactly 0 (masked scores are -inf, so exp gives 0 and the
// max is the Pallas kernel's, whose masked scores are -2^30 <= its start);
// the output is acc / max(l, 1e-30) (times its reciprocal in the wgmma
// kernel). Any stride is taken for the batch, head
// and sequence axes (hd must be contiguous), so the model's (B, S, H, hd)
// tensors are read in place, without a transposing copy. A call is
// deterministic: every output row is one block's, summed in a fixed order.
//
// Bound: operations. The serve path's causal prefill, q (8, 15, 1,024, 64)
// against k, v (8, 5, 1,024, 64) bf16, needs 2 * 2 * B*H*hd * (Sq*(Sq+1)/2)
// = 16.1 GFLOP (QK^T and PV over the unmasked half), about 16 us at 989
// TFLOP/s; its bytes (q, k, v, o: 18.4 MB) take 5.5 us. Hymba's windowed
// prefill, q (4, 25, 2,048, 64), G 5, window 1,024, needs 40.3 GFLOP, 41 us.
//
// Design, bf16 with hd in {64, 128} (fa_wgmma_kernel, after FlashAttention-3):
// a persistent kernel, one block an SM, that walks 128-row q tiles of one
// (b, h) each: two consumer warpgroups of 64 rows and one producer warp. The
// producer (its warpgroup gives up registers with setmaxnreg) loads each
// tile's Q once, ahead, into one of two buffers, and keeps K and V tiles (128
// keys at hd 64, 64 at hd 128, so a consumer thread's S, P and O registers
// fit) in flight with TMA into a ring of three shared-memory stages, with a
// full barrier for K, one for V and an empty barrier the consumers' eight
// warps arrive on; so one tile's epilogue overlaps the next one's loads. The
// tensor maps describe the strided 4-D view (hd, S, heads, B) with the
// caller's strides, built on
// the host for each call and passed as __grid_constant__ parameters; the
// 128-byte swizzle (an hd-64 bf16 row is 128 bytes; hd 128 is two 64-wide
// column tiles) feeds wgmma without bank conflicts, and TMA's zero fill
// covers the ragged Sq and Sk tails. S = QK^T is wgmma m64nBNk16 with Q and K
// both K-major in shared memory. Each consumer issues tile j's S beside tile
// j-1's O += P V and runs the softmax of tile j while the tensor cores do
// P V; the two consumers take turns to issue (named barriers), so one's
// softmax overlaps the other's products. No product sits in a branch: the
// compiler serialises wgmma it cannot prove warp-uniform. The online
// softmax runs on the accumulator fragments in registers: the max of the
// raw scores, then one FFMA (score * scale * log2(e) - max) and one
// ex2.approx a score; only the tiles that straddle the diagonal, the
// window's edge or the Sk tail are masked. P, packed to bf16, is wgmma's A
// operand from registers, and V is its B operand read as TMA wrote it,
// key-major, through wgmma's transpose bit. Key tiles outside every row's
// mask are not loaded. Tiles are taken longest first, in snake order over
// the blocks (the causal tail balances), and the H / G q heads of one kv
// head are neighbours in that order, so their K and V tiles are still in
// L2. The output is normalised in registers, rounded to bf16 into shared
// memory and written by a TMA store (rows >= Sq fall outside the map).
//
// bf16 with hd in {16, 32} (fa_mma_kernel): one block of four warps per
// (64-row q tile, head, batch), 16 q rows a warp, mma.sync.m16n8k16 with the
// Q tile's A fragments in registers; K (key-major) and V (transposed) staged
// in shared memory, so every B fragment is one 32-bit shared load; S comes
// out in the accumulator layout, which after the softmax is packed to bf16 as
// the A fragments of P V. f32 and other bf16 head sizes (fa_simple_kernel): a
// warp per four q rows, 16-key tiles in shared memory as f32, a lane per 1/32
// of hd, dot products reduced with shuffles, FMA in f32.
#include <math.h>

#include "hopper.cuh"

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

// Whether rows [q_lo, q_hi] (row indices) need the mask on keys [k0, k1):
// the tile crosses the Sk tail, the causal diagonal or the window's edge.
__device__ __forceinline__ bool tile_masked(const Shape& s, int q_lo, int q_hi, int k0, int k1) {
  const int off = s.Sk - s.Sq;
  return k1 > s.Sk || (s.causal && k1 - 1 > q_lo + off) ||
         (s.window > 0 && k0 <= q_hi + off - s.window);
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
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
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


// 2^x in one MUFU.EX2 (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over one key tile of one thread's two rows, in the
// wgmma accumulator layout (mma.sync's, a warp at a time): s[4j + e] holds
// row qpos[e >> 1], key k0 + 8j + 2 * tig + (e & 1). m is the running max of the scaled scores
// (scale * log2(e) = c), l the running sum, alpha the factor that rescales
// the accumulator; p = 2^(score * c - m), one FFMA and one ex2.approx a
// score. MASK tests every score (edge tiles only): a row keeps the tile's
// columns [lo, hi]; masked scores become -inf, so p is 0. Each row's max and
// sum run as four partial chains of NT / 2 (one chain of 2 * NT dependent
// operations would stall the warp).
template <int NT, bool MASK>
__device__ __forceinline__ void softmax_tile(float* s, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Shape& sh, int k0, int tig,
                                             const int (&qpos)[2], float c) {
  int lo[2], hi[2];
  if (MASK) {
    const int base = k0 + 2 * tig;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hi[r] = (sh.causal ? min(sh.Sk - 1, qpos[r]) : sh.Sk - 1) - base;
      lo[r] = sh.window > 0 ? qpos[r] - sh.window + 1 - base : -(1 << 30);
    }
  }
  if (!(c > 0.0f)) {  // the max of raw scores is the max of scaled ones only for c > 0
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[i] *= c;
    c = 1.0f;
  }
  float pm[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pm[0][i] = pm[1][i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = 8 * j + (e & 1);
      if (MASK && (col < lo[r] || col > hi[r])) s[4 * j + e] = -INFINITY;
      pm[r][j & 3] = fmaxf(pm[r][j & 3], s[4 * j + e]);
    }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(m[r], fmaxf(fmaxf(pm[r][0], pm[r][1]), fmaxf(pm[r][2], pm[r][3])) * c);
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
    alpha[r] = ex2(m[r] - mx);
    m[r] = mx;
    mc[r] = -mx;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) pm[0][i] = pm[1][i] = 0.0f;  // now the partial sums
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], c, mc[e >> 1]));
      s[4 * j + e] = p;
      pm[e >> 1][j & 3] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((pm[r][0] + pm[r][1]) + (pm[r][2] + pm[r][3]));
}

// Tile t's q rows and (b, h), tiles in the order they are taken: the
// longest q tiles first, and within a q tile (b, h) with h fastest, so the
// H / G heads of one kv head sit side by side.
__device__ __forceinline__ void tile_coords(const Shape& s, int B, int BM, int t, int& q0, int& b,
                                            int& h) {
  const int nq = (s.Sq + BM - 1) / BM, bh = t % (B * s.H);
  q0 = (nq - 1 - t / (B * s.H)) * BM;
  b = bh / s.H;
  h = bh % s.H;
}

// ------------------------------- bf16, hd 64 / 128: wgmma over a TMA ring
constexpr int kWgBM = 128, kWgThreads = 384;

// Key tiles of 128 at hd 64 and of 64 at hd 128: S (BN / 2), P (BN / 4) and
// O (HD / 2) registers a thread then fit the 168 the compiler gives a
// thread of the 384.
template <int HD>
struct WgCfg {
  static constexpr int kBN = HD == 64 ? 128 : 64, kStages = 3;
  static constexpr uint32_t kQBytes = kWgBM * HD * 2, kKVBytes = kBN * HD * 2;
  // barriers in the first 1 KB, then two Q buffers, the stages (K, V) and
  // the output tile, all 1 KB aligned
  static constexpr int kSmem = 1024 + 3 * kQBytes + 2 * kStages * kKVBytes + 1024;
};

// The consumers' turn to issue products (FlashAttention-3's ping-pong):
// warpgroup wg waits on barrier 3 + wg until the other has arrived there,
// issues, then arrives on the other's barrier.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_s(float* sc, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 128) wgmma_ss_n128(sc, da, db, accumulate);
  else wgmma_ss_n64(sc, da, db, accumulate);
}
template <int HD>
__device__ __forceinline__ void wgmma_pv(float* acc, const uint32_t* a, uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(acc, a, db);
  else wgmma_rs_n128(acc, a, db);
}

// O += P V, P (bf16, 16 keys a step) from registers, V the tile at vt in
// shared memory, key-major (its 64-wide column tiles BN * 128 bytes apart).
template <int HD, int BN>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t (*pa)[4], uint32_t vt) {
#pragma unroll
  for (int t = 0; t < BN / 16; ++t)
    wgmma_pv<HD>(acc, pa[t], gmma_desc(vt + t * 16 * 128, BN * 128, 1024));
  wg_commit();
}

// S = Q K^T for one warpgroup: Q its 64 rows at qa (64-wide column tiles
// kWgBM * 128 bytes apart), K the BN-key tile at kt (BN * 128 apart), both
// K-major, 16 dims a step.
template <int HD, int BN>
__device__ __forceinline__ void issue_s(float* sc, uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t in = (kk & 3) * 32, ct = kk >> 2;
    wgmma_s<BN>(sc, gmma_desc(qa + ct * kWgBM * 128 + in, 16, 1024),
                gmma_desc(kt + ct * BN * 128 + in, 16, 1024), kk > 0);
  }
  wg_commit();
}

// The softmax of one warpgroup's 64 rows from r_lo over keys [k0, k0 +
// 8 * NT), masked only where the tile needs it.
template <int NT>
__device__ __forceinline__ void softmax(float* sc, float (&m)[2], float (&l)[2], float (&alpha)[2],
                                        const Shape& s, int r_lo, int k0, int tig,
                                        const int (&qpos)[2], float c) {
  if (tile_masked(s, r_lo, r_lo + 63, k0, k0 + 8 * NT))
    softmax_tile<NT, true>(sc, m, l, alpha, s, k0, tig, qpos, c);
  else
    softmax_tile<NT, false>(sc, m, l, alpha, s, k0, tig, qpos, c);
}

// P (probabilities in the accumulator layout) packed to bf16 A fragments,
// 16 keys a step.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* sc) {
#pragma unroll
  for (int t = 0; t < BN / 16; ++t) {
    pa[t][0] = pack_bf16(sc[8 * t], sc[8 * t + 1]);
    pa[t][1] = pack_bf16(sc[8 * t + 2], sc[8 * t + 3]);
    pa[t][2] = pack_bf16(sc[8 * t + 4], sc[8 * t + 5]);
    pa[t][3] = pack_bf16(sc[8 * t + 6], sc[8 * t + 7]);
  }
}

// The block's it-th tile: rounds of gridDim.x tiles, taken in alternate
// directions (block k takes k, 2P - 1 - k, 2P + k, ...), so that over the
// tiles, longest first, every block gets about the same work.
__device__ __forceinline__ int snake_tile(int it) {
  const int k = (it & 1) ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  return it * (int)gridDim.x + k;
}

// Persistent: gridDim.x blocks (one an SM) take the `tiles` (q tile, b, h)
// tiles in snake order, so the producer loads the next tile's Q, K and V
// while the consumers finish the last one; the stage ring runs on across
// tiles.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                Shape s, int B, int tiles) {
  using C = WgCfg<HD>;
  constexpr int ST = C::kStages, BN = C::kBN, CH = HD / 64, NT = BN / 8, DT = HD / 8;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023u) & ~1023u;
  // Q buffer i's full and empty barriers at bar_q + 8i and bar_qe + 8i
  const uint32_t bar_q = base, bar_qe = base + 16, bar_k = base + 32, bar_v = bar_k + 8 * ST,
                 bar_e = bar_v + 8 * ST;
  // two Q buffers (tile it uses it % 2), then stage st's K and V, then the
  // output tile; each a column tile (64 dims, 128 bytes a row) after another
  const uint32_t sq = base + 1024, skv = sq + 2 * C::kQBytes, so = skv + 2 * ST * C::kKVBytes;
  // warp and warpgroup broadcast from lane 0, so the compiler knows them
  // uniform across the warp (a branch it cannot prove uniform around wgmma
  // makes it serialise the products)
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0), wg = warp >> 2;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar_q + 8 * i, 1);
      mbar_init(bar_qe + 8 * i, 8);  // one arrival a consumer warp
    }
    for (int i = 0; i < ST; ++i) {
      mbar_init(bar_k + 8 * i, 1);
      mbar_init(bar_v + 8 * i, 1);
      mbar_init(bar_e + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int j_all = 0;
      for (int it = 0, t; (t = snake_tile(it)) < tiles; ++it) {
        int q0, b, h, k_lo, k_hi;
        tile_coords(s, B, kWgBM, t, q0, b, h);
        const int g = h / (s.H / s.G);
        key_range(s, q0, min(q0 + kWgBM, s.Sq), k_lo, k_hi);
        const int k_begin = (k_lo / BN) * BN;
        const int n = k_hi > k_begin ? (k_hi - k_begin + BN - 1) / BN : 0;
        const int qb = it & 1;  // tile it - 2's products are done with this buffer
        mbar_wait(bar_qe + 8 * qb, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(bar_q + 8 * qb, C::kQBytes);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load(sq + qb * C::kQBytes + c * kWgBM * 128, &qmap, bar_q + 8 * qb, 64 * c, q0, h,
                   b);
        for (int j = 0; j < n; ++j, ++j_all) {
          const int st = j_all % ST, k0 = k_begin + j * BN;
          const uint32_t kt = skv + st * 2 * C::kKVBytes, vt = kt + C::kKVBytes;
          mbar_wait(bar_e + 8 * st, ((j_all / ST) & 1) ^ 1);
          mbar_expect_tx(bar_k + 8 * st, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < CH; ++c)
            tma_load(kt + c * BN * 128, &kmap, bar_k + 8 * st, 64 * c, k0, g, b);
          mbar_expect_tx(bar_v + 8 * st, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < CH; ++c)
            tma_load(vt + c * BN * 128, &vmap, bar_v + 8 * st, 64 * c, k0, g, b);
        }
      }
    }
  } else {  // consumer warpgroups 0 and 1: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int gid = lane >> 2, tig = lane & 3, wrow = 16 * (warp & 3) + gid;
    const float c = s.scale * kLog2e;
    const uint32_t ot = so + wg * 64 * 128;  // this warpgroup's rows in the output tile
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    int j_all = 0;
    for (int it = 0, t; (t = snake_tile(it)) < tiles; ++it) {
      int q0, b, h, k_lo, k_hi;
      tile_coords(s, B, kWgBM, t, q0, b, h);
      key_range(s, q0, min(q0 + kWgBM, s.Sq), k_lo, k_hi);
      const int k_begin = (k_lo / BN) * BN;
      const int n = k_hi > k_begin ? (k_hi - k_begin + BN - 1) / BN : 0;
      const int r_lo = q0 + 64 * wg, row = r_lo + wrow;
      const int qpos[2] = {row + s.Sk - s.Sq, row + 8 + s.Sk - s.Sq};
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
      float acc[DT * 4], sc[NT * 4];
      uint32_t pa[BN / 16][4];  // P of the tile whose P V is pending, bf16
#pragma unroll
      for (int i = 0; i < DT * 4; ++i) acc[i] = 0.0f;
      const int qb = it & 1;
      const uint32_t qa = sq + qb * C::kQBytes + wg * 64 * 128;  // this warpgroup's Q rows
      mbar_wait(bar_q + 8 * qb, (it >> 1) & 1);
      // Tile j's S = QK^T is issued beside tile j-1's P V, so the softmax of
      // tile j runs while the tensor cores do P V. No product sits in a
      // branch (the compiler would serialise them): the first tile and the
      // last P V are peeled off the loop.
      int pst = j_all % ST, pph = (j_all / ST) & 1;  // the stage of the pending P V
      if (n > 0) {
        const int k0 = k_begin;
        mbar_wait(bar_k + 8 * pst, pph);
        turn_wait(wg);
        wg_fence();
        issue_s<HD, BN>(sc, qa, skv + pst * 2 * C::kKVBytes);
        turn_pass(wg);
        wg_wait<0>();
        fence_regs<NT * 4>(sc);
        softmax<NT>(sc, m, l, alpha, s, r_lo, k0, tig, qpos, c);
        pack_p<BN>(pa, sc);
        ++j_all;
      }
      for (int j = 1; j < n; ++j, ++j_all) {
        const int st = j_all % ST, ph = (j_all / ST) & 1, k0 = k_begin + j * BN;
        mbar_wait(bar_k + 8 * st, ph);
        mbar_wait(bar_v + 8 * pst, pph);
        turn_wait(wg);
        wg_fence();
        issue_s<HD, BN>(sc, qa, skv + st * 2 * C::kKVBytes);
        issue_pv<HD, BN>(acc, pa, skv + pst * 2 * C::kKVBytes + C::kKVBytes);
        turn_pass(wg);
        wg_wait<1>();
        fence_regs<NT * 4>(sc);
        softmax<NT>(sc, m, l, alpha, s, r_lo, k0, tig, qpos, c);
        wg_wait<0>();
        fence_regs<DT * 4>(acc);
        fence_regs<BN / 4>(&pa[0][0]);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * pst);
#pragma unroll
        for (int i = 0; i < DT * 4; ++i) acc[i] *= alpha[(i >> 1) & 1];
        pack_p<BN>(pa, sc);
        pst = st;
        pph = ph;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_qe + 8 * qb);  // every S = QK^T of this tile is done
      if (n > 0) {
        mbar_wait(bar_v + 8 * pst, pph);
        turn_wait(wg);
        wg_fence();
        issue_pv<HD, BN>(acc, pa, skv + pst * 2 * C::kKVBytes + C::kKVBytes);
        turn_pass(wg);
        wg_wait<0>();
        fence_regs<DT * 4>(acc);
        fence_regs<BN / 4>(&pa[0][0]);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * pst);
      }
      // Epilogue: normalise, round to bf16 into this warpgroup's half of the
      // output tile (128-byte swizzled, as the map's boxes are), and store
      // it with TMA; rows >= Sq fall outside the map and are not written.
      if ((tid & 127) == 0) tma_store_drain();  // the last tile's store has read it
      wg_barrier(wg);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xFFFFFFFFu, l[r], 1);
        l[r] += __shfl_xor_sync(0xFFFFFFFFu, l[r], 2);
        const float inv = 1.0f / fmaxf(l[r], 1e-30f);
        const int rr = wrow + 8 * r;
#pragma unroll
        for (int n8 = 0; n8 < DT; ++n8) {
          const uint32_t at = ot + (n8 >> 3) * kWgBM * 128 + rr * 128 +
                              ((((n8 & 7) ^ (rr & 7))) << 4) + tig * 4;
          const uint32_t val = pack_bf16(acc[4 * n8 + 2 * r] * inv, acc[4 * n8 + 2 * r + 1] * inv);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(val) : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_barrier(wg);
      if ((tid & 127) == 0) {
#pragma unroll
        for (int cc = 0; cc < CH; ++cc)
          tma_store(&omap, ot + cc * kWgBM * 128, 64 * cc, r_lo, h, b);
      }
    }
    if (wg == 0) turn_wait(wg);  // takes warpgroup 1's last pass
    if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The wgmma kernel's 128-row (q tile, b, h) tiles, or 0 if they do not fit
// an int.
unsigned tile_grid(const Shape& s, int B) {
  const long long blocks = (long long)((s.Sq + 127) / 128) * B * s.H;
  return blocks <= 2147483647LL ? (unsigned)blocks : 0u;
}

template <int HD>
int launch_wgmma_hd(const void* q, const void* k, const void* v, void* o, const Shape& s, int B,
                    cudaStream_t st) {
  constexpr int smem = WgCfg<HD>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  const unsigned tiles = tile_grid(s, B);
  CUtensorMap qm, km, vm, om;
  if (!tiles || !make_map(&qm, q, HD, s.Sq, s.H, B, s.qss, s.qsh, s.qsb, kWgBM) ||
      !make_map(&km, k, HD, s.Sk, s.G, B, s.kss, s.ksh, s.ksb, WgCfg<HD>::kBN) ||
      !make_map(&vm, v, HD, s.Sk, s.G, B, s.vss, s.vsh, s.vsb, WgCfg<HD>::kBN) ||
      !make_map(&om, o, HD, s.Sq, s.H, B, s.oss, s.osh, s.osb, 64))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = tiles < (unsigned)sms ? tiles : (unsigned)sms;
  fa_wgmma_kernel<HD><<<grid, kWgThreads, smem, st>>>(qm, km, vm, om, s, B, (int)tiles);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, const Shape& s, int B,
                 cudaStream_t st) {
  if (s.hd == 64) return launch_wgmma_hd<64>(q, k, v, o, s, B, st);
  if (s.hd == 128) return launch_wgmma_hd<128>(q, k, v, o, s, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, bound with ctypes. q, o (B, H, Sq, hd) and k, v (B, G, Sk, hd)
// given by their strides in elements (the hd axis contiguous), all f32
// (dtype 0) or all bf16 (dtype 1). route 0 takes the CUDA-core kernel (hd <=
// 256); the others are bf16 only, with every pointer 16-byte aligned and
// every stride a multiple of 8: route 1 the mma.sync kernel (hd 16 or 32),
// route 2 the wgmma kernel (hd 64 or 128; q, k, v and o must each be a
// valid TMA map: strides below 2^40 bytes). Returns 0 or the CUDA error code
// of a failed launch (cudaErrorInvalidValue for an input it does not take).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   long long qsb, long long qsh, long long qss, long long ksb,
                                   long long ksh, long long kss, long long vsb, long long vsh,
                                   long long vss, long long osb, long long osh, long long oss,
                                   int B, int H, int G, int Sq, int Sk, int hd, float scale,
                                   int causal, int window, int dtype, int route, void* stream) {
  if (B < 1 || H < 1 || G < 1 || H % G || Sq < 1 || Sk < 1 || hd < 1 || hd > 256 || H > 65535 ||
      B > 65535 || route < 0 || route > 2 || (route && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Shape s{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                H,   G,   Sq,  Sk,  hd,  scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2) return launch_wgmma(q, k, v, o, s, B, st);
  if (route == 1) return launch_mma(q, k, v, o, s, B, st);
  if (dtype == 0) return launch_simple<float>(q, k, v, o, s, B, st);
  return launch_simple<__nv_bfloat16>(q, k, v, o, s, B, st);
}
