// Toyoda pseudo-utility and stage 2's whole MKP greedy for Hopper (sm_90a)
// (paper §VI-B).
//
// Replaces the TPU kernel kernels/mkp_utility.py::mkp_utility of the JAX
// package, which the reference's _mkp_greedy_jax calls once a pick inside
// one compiled lax.while_loop. Two entries share its device code:
//
// - mkp_utility_f32: one rescoring. For values v (n,), weights w (n, m),
//   residual capacities r (m,) and a selectable mask (n,) it computes, all
//   in f32,
//     s_k    = 1 / max(r_k, 1e-12)
//     util_j = v_j / max(sum_k w_jk s_k, 1e-12)
//   and -inf where item j is not selectable or some w_jk > r_k + 1e-12.
// - mkp_greedy_f32: the whole greedy of one MKP solve in one launch. Each
//   pick rescores every item as above against r = cap - used, takes the
//   first maximum (torch.argmax's order: a NaN above everything, the first
//   NaN winning), and, if that utility is finite, marks the item and adds
//   its weights to used; the first pick whose best utility is not finite
//   ends the loop (every later one would change nothing), as does max_picks.
//
// Bound. One rescoring reads n*(m+2)*4 + n bytes plus r and writes n*4;
// for stage 2's MKP over a 3,846-client pool with m = 10 that is about
// 0.2 MB, under 0.1 us at 3.35 TB/s. The greedy reads v and w once and
// writes the mask and used: about 0.17 MB, 0.05 us. What bounds the greedy
// in practice is the chain of picks: each depends on the last, so a pick's
// cost is one pass over the pool and one block-wide reduction, and with one
// launch a pick (the per-pick loop) it was the launches.
//
// Design of one rescoring: one thread per item; the block stages r + 1e-12
// and s in shared memory, a tile of columns at a time, so any m works.
//
// Design of the greedy: one cluster of up to 8 blocks of 1,024 threads,
// each block a contiguous slice of the items. A block copies its slice's v
// and w rows into shared memory once, with 1-D bulk asynchronous copies
// (cp.async.bulk) completing on an mbarrier; the copies need 16-byte
// aligned addresses and sizes, so each window is widened to 16-byte
// boundaries (the extra bytes lie in the same 16-byte granules as the
// slice's own, so no page is touched that the slice does not touch) and
// the rows are read from the slice's offset in it. The picked flags live
// there too, one byte an item. Rows past what a block's 227 KB hold are
// read from device memory (L2) on each pick, their flags in the output.
// A pick: each thread scores its items and keeps its best as an unsigned
// key that orders utilities as torch.argmax does, and its index; a warp's
// best is two redux instructions (the largest key, then the lowest index
// holding it), a block's one more pair over the warps' bests; with more
// than one block, each block leaves its best in its shared memory, one
// cluster barrier, and every block reduces the blocks' bests over
// distributed shared memory. The order is total (key, then index), so
// every block gets the same winner. Warp 0 then adds the winner's weights
// to used and rescores the knapsacks (residual, fit limit and scarcity, in
// shared memory; in device memory past kSmemCols knapsacks). The host
// takes a block per 512 items (a pick's pass is shorter on more SMs, and
// one cluster barrier a pick costs less than the items it spreads), and
// at least the blocks whose shared memory holds the pool.
//
// Both entries sum the penalty in column order with separately rounded
// products and sums (__fmul_rn, __fadd_rn: no contracted FMA), compute
// r = cap - used and used += w with __fsub_rn / __fadd_rn, use IEEE
// divisions, and clamp with a NaN kept NaN, as torch.clamp_min does, so
// they are bit-equal to the plain PyTorch versions (kernels/ref.py), which
// sum the columns left to right. No atomics.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-12f;

// ------------------------------------------------ shared device code

// max(x, eps) as torch.clamp_min and jnp.maximum take it: NaN stays NaN.
__device__ __forceinline__ float clamp_eps(float x) { return x != x ? x : fmaxf(x, kEps); }

// The fit limit r_k + eps and the scarcity 1 / max(r_k, eps) of knapsack k.
__device__ __forceinline__ void knapsack_terms(float rk, float* lim, float* inv) {
  *lim = __fadd_rn(rk, kEps);
  *inv = __fdiv_rn(1.0f, clamp_eps(rk));
}

// One item's penalty over `cnt` columns, summed left to right, and whether
// each of them fits.
__device__ __forceinline__ void add_columns(float& acc, bool& fits, const float* wj,
                                            const float* lim, const float* inv, int cnt) {
  for (int t = 0; t < cnt; ++t) {
    const float wk = wj[t];
    acc = __fadd_rn(acc, __fmul_rn(wk, inv[t]));
    fits = fits && (wk <= lim[t]);
  }
}

__device__ __forceinline__ float utility(float vj, float acc, bool fits) {
  return fits ? __fdiv_rn(vj, clamp_eps(acc)) : -INFINITY;
}

// ------------------------------------------------ one rescoring

constexpr int kThreads = 256;
constexpr int kColTile = 256;

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
    for (int t = threadIdx.x; t < cnt; t += kThreads)
      knapsack_terms(r[k0 + t], s_lim + t, s_inv + t);
    __syncthreads();
    if (j < n) add_columns(acc, fits, w + j * m + k0, s_lim, s_inv, cnt);
    __syncthreads();
  }
  if (j < n) out[j] = utility(v[j], acc, fits && sel[j] != 0);
}

// ------------------------------------------------ the greedy

constexpr int kGreedyThreads = 1024;
constexpr int kGreedyWarps = kGreedyThreads / 32;
constexpr int kMaxBlocks = 8;          // a portable cluster
constexpr int kItemsPerBlock = 512;    // the host's cluster: a block per 512 items
constexpr int kSmemCols = 2048;        // knapsack terms in shared memory up to this m
constexpr int kSmemBytes = 232448;     // what one block may hold (227 KB)

__host__ __device__ constexpr long long align16(long long x) { return (x + 15) & ~15LL; }

// Shared memory of one block, in bytes from the dynamic base: knapsack
// terms (lim, inv, used, cap; unless m > kSmemCols), the warps' bests, the
// blocks' bests (two, by pick parity), the stop word, the mbarrier, then
// the windows of v and w and the flags of `staged` rows. A window spans the
// rows' bytes widened to 16-byte boundaries: at most 4 * rows + 30 bytes
// for v.
struct Layout {
  long long terms, red, cand, stop, bar, v, w, flags, total;
};

__host__ __device__ inline Layout layout(int m, long long staged) {
  Layout L;
  L.terms = 0;
  L.red = L.terms + (m <= kSmemCols ? align16(16LL * m) : 0);
  L.cand = L.red + 8 * kGreedyWarps;
  L.stop = L.cand + 16;
  L.bar = L.stop + 16;
  L.v = L.bar + 16;
  L.w = L.v + (staged ? align16(4 * staged + 32) : 0);
  L.flags = L.w + (staged ? align16(4LL * m * staged + 32) : 0);
  L.total = L.flags + align16(staged);
  return L;
}

// Rows of a slice that one block holds in shared memory.
long long staged_rows(int m, long long slice) {
  const long long fixed = layout(m, 0).total + 96;
  long long rows = (kSmemBytes - fixed) / (4LL * m + 5);
  if (rows > slice) rows = slice;
  while (rows > 0 && layout(m, rows).total > kSmemBytes) --rows;
  return rows < 0 ? 0 : rows;
}

// torch.argmax's order as one unsigned key: a NaN above +inf above the
// finite values above -inf, -0 equal to +0; 0 is below every item (a
// thread with no item left). The lower index wins among equal keys.
__device__ __forceinline__ uint32_t order_key(float f) {
  if (f != f) return 0xffffffffu;
  const uint32_t u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A key's value is finite: above -inf (0x007fffff) and below +inf.
__device__ __forceinline__ bool key_finite(uint32_t key) {
  return key > 0x007fffffu && key < 0xff800000u;
}

// One bulk copy of `bytes` (a multiple of 16) from 16-byte aligned `src`
// into shared memory, counted on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

struct GreedyArgs {
  const float* v;       // (n,)
  const float* w;       // (n, m) row-major
  const float* cap;     // (m,)
  unsigned char* sel;   // (n,) out: the picked mask
  float* used;          // (m,) out
  float* terms;         // (blocks, 4, m) scratch when m > kSmemCols, else null
  long long max_picks;
  int n, m, slice;      // items a block (the last may have fewer)
  long long staged;     // rows of a slice in shared memory
};

// MR: fit limits and scarcities held in registers for m <= MR (MR > 0),
// else read from shared (or device) memory in the column loop.
template <int MR>
__global__ void __launch_bounds__(kGreedyThreads, 1) mkp_greedy_kernel(const GreedyArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.m, a.staged);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, b = blockIdx.x;  // the grid is one cluster
  const int m = a.m;
  const int r0 = (int)min((long long)a.n, (long long)b * a.slice);
  const int r1 = (int)min((long long)a.n, (long long)r0 + a.slice);
  const int ns = (int)min(a.staged, (long long)(r1 - r0));

  float* lim = a.terms ? a.terms + 4LL * m * b : reinterpret_cast<float*>(smem + L.terms);
  float* inv = lim + m;
  float* used = inv + m;
  float* cap = used + m;
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + L.red);  // [key, idx] a warp
  uint32_t* cand = reinterpret_cast<uint32_t*>(smem + L.cand);  // [key, idx] x 2 parities
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  unsigned char* flag = smem + L.flags;
  int& stop = *reinterpret_cast<int*>(smem + L.stop);

  const uintptr_t v0 = reinterpret_cast<uintptr_t>(a.v + r0);
  const uintptr_t w0 = reinterpret_cast<uintptr_t>(a.w + (long long)r0 * m);
  const float* vs = reinterpret_cast<const float*>(smem + L.v + (v0 & 15));
  const float* ws = reinterpret_cast<const float*>(smem + L.w + (w0 & 15));

  if (tid == 0) {
    mbar_init(smem_u32(bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && ns > 0) {
    const uintptr_t v1 = reinterpret_cast<uintptr_t>(a.v + r0 + ns);
    const uintptr_t w1 = reinterpret_cast<uintptr_t>(a.w + (long long)(r0 + ns) * m);
    const uint32_t vbytes = (uint32_t)(((v1 + 15) & ~(uintptr_t)15) - (v0 & ~(uintptr_t)15));
    const uint32_t wbytes = (uint32_t)(((w1 + 15) & ~(uintptr_t)15) - (w0 & ~(uintptr_t)15));
    mbar_expect_tx(smem_u32(bar), vbytes + wbytes);
    bulk_load(smem_u32(smem + L.v), reinterpret_cast<const void*>(v0 & ~(uintptr_t)15), vbytes,
              smem_u32(bar));
    bulk_load(smem_u32(smem + L.w), reinterpret_cast<const void*>(w0 & ~(uintptr_t)15), wbytes,
              smem_u32(bar));
  }
  // while the rows arrive: flags, used = 0 and the first knapsack terms
  for (int i = tid; i < ns; i += kGreedyThreads) flag[i] = 0;
  for (int j = r0 + ns + tid; j < r1; j += kGreedyThreads) a.sel[j] = 0;
  for (int k = tid; k < m; k += kGreedyThreads) {
    cap[k] = a.cap[k];
    used[k] = 0.f;
    knapsack_terms(__fsub_rn(cap[k], 0.f), lim + k, inv + k);
  }
  if (ns > 0) mbar_wait(smem_u32(bar), 0);
  __syncthreads();

  cg::cluster_group cluster = cg::this_cluster();
  for (long long p = 0; p < a.max_picks; ++p) {
    float rl[MR > 0 ? MR : 1], ri[MR > 0 ? MR : 1];
    if constexpr (MR > 0) {
#pragma unroll
      for (int t = 0; t < MR; ++t) {
        rl[t] = t < m ? lim[t] : 0.f;
        ri[t] = t < m ? inv[t] : 0.f;
      }
    }
    uint32_t bk = 0u, bi = 0x7fffffffu;  // this thread's best so far
    for (int i = tid; i < r1 - r0; i += kGreedyThreads) {
      const int j = r0 + i;
      const bool here = i < ns;
      if (here ? flag[i] != 0 : a.sel[j] != 0) continue;  // picked: -inf, below bk
      const float* wj = here ? ws + (long long)i * m : a.w + (long long)j * m;
      float acc = 0.f;
      bool fits = true;
      if constexpr (MR > 0) {
#pragma unroll
        for (int t = 0; t < MR; ++t) {
          if (t < m) {
            const float wk = wj[t];
            acc = __fadd_rn(acc, __fmul_rn(wk, ri[t]));
            fits = fits && (wk <= rl[t]);
          }
        }
      } else {
        add_columns(acc, fits, wj, lim, inv, m);
      }
      const uint32_t key = order_key(utility(here ? vs[i] : a.v[j], acc, fits));
      if (key > bk) {  // items in rising order: an equal key keeps the lower index
        bk = key;
        bi = (uint32_t)j;
      }
    }
    uint32_t wk = __reduce_max_sync(0xffffffffu, bk);
    uint32_t wi = __reduce_min_sync(0xffffffffu, bk == wk ? bi : 0x7fffffffu);
    if (lane == 0) {
      red[2 * warp] = wk;
      red[2 * warp + 1] = wi;
    }
    __syncthreads();
    if (warp == 0) {
      bk = red[2 * lane];
      bi = red[2 * lane + 1];
      wk = __reduce_max_sync(0xffffffffu, bk);
      wi = __reduce_min_sync(0xffffffffu, bk == wk ? bi : 0x7fffffffu);
      if (nb > 1 && lane == 0) {
        cand[2 * (p & 1)] = wk;
        cand[2 * (p & 1) + 1] = wi;
      }
    }
    if (nb > 1) {
      cluster.sync();  // every block's best is in its shared memory
      if (warp == 0) {
        bk = 0u;
        bi = 0x7fffffffu;
        if (lane < nb) {
          const uint32_t* c = cluster.map_shared_rank(cand + 2 * (p & 1), lane);
          bk = c[0];
          bi = c[1];
        }
        wk = __reduce_max_sync(0xffffffffu, bk);
        wi = __reduce_min_sync(0xffffffffu, bk == wk ? bi : 0x7fffffffu);
      }
    }
    if (warp == 0) {
      const bool ok = key_finite(wk);
      if (ok) {
        const int j = (int)wi;
        const bool mine = j >= r0 && j < r0 + ns;
        const float* wrow = mine ? ws + (long long)(j - r0) * m : a.w + (long long)j * m;
        for (int k = lane; k < m; k += 32) {
          used[k] = __fadd_rn(used[k], wrow[k]);
          knapsack_terms(__fsub_rn(cap[k], used[k]), lim + k, inv + k);
        }
        if (lane == 0 && j >= r0 && j < r1) {
          if (mine)
            flag[j - r0] = 1;
          else
            a.sel[j] = 1;
        }
      }
      if (lane == 0) stop = !ok;
    }
    __syncthreads();
    if (stop) break;
  }

  for (int i = tid; i < ns; i += kGreedyThreads) a.sel[r0 + i] = flag[i];
  if (b == 0)
    for (int k = tid; k < m; k += kGreedyThreads) a.used[k] = used[k];
  if (nb > 1) cluster.sync();  // no block leaves while another may read its bests
}

template <int MR>
int launch_greedy(const GreedyArgs& a, int blocks, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      mkp_greedy_kernel<MR>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kGreedyThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)layout(a.m, a.staged).total;
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = blocks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, mkp_greedy_kernel<MR>, a);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
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

// The cluster for n rows of m knapsacks: a block for every kItemsPerBlock
// items (a pick's pass is shorter on more SMs, and one cluster barrier a
// pick costs less than the items it spreads), and at least the blocks
// whose shared memory holds all the rows; at most 8 (rows past them are
// read from device memory) and at most n.
extern "C" int mkp_greedy_blocks(int n, int m) {
  if (n < 1 || m < 1) return 0;
  int b = (int)min((long long)kMaxBlocks, ((long long)n + kItemsPerBlock - 1) / kItemsPerBlock);
  for (; b < kMaxBlocks; ++b) {
    const long long slice = ((long long)n + b - 1) / b;
    if (staged_rows(m, slice) >= slice) break;
  }
  return b < n ? b : n;
}

extern "C" int mkp_greedy_max_blocks() { return kMaxBlocks; }
extern "C" int mkp_greedy_smem_cols() { return kSmemCols; }

// The whole greedy of one MKP solve. v (n,), w (n, m) row-major, cap (m,):
// f32, any alignment; sel (n,) bool as bytes and used (m,) f32 written;
// terms: blocks * 4 * m f32 of scratch when m > mkp_greedy_smem_cols(),
// else null. blocks: 1 to 8, one cluster. Returns 0 or the CUDA error code
// of the launch.
extern "C" int mkp_greedy_f32(const void* v, const void* w, const void* cap, void* sel,
                              void* used, void* terms, int n, int m, long long max_picks,
                              int blocks, void* stream) {
  if (n < 1 || m < 1 || blocks < 1 || blocks > kMaxBlocks || blocks > n || max_picks < 0 ||
      ((m > kSmemCols) != (terms != nullptr)))
    return (int)cudaErrorInvalidValue;
  GreedyArgs a;
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.cap = static_cast<const float*>(cap);
  a.sel = static_cast<unsigned char*>(sel);
  a.used = static_cast<float*>(used);
  a.terms = static_cast<float*>(terms);
  a.max_picks = max_picks;
  a.n = n;
  a.m = m;
  a.slice = (int)(((long long)n + blocks - 1) / blocks);
  a.staged = staged_rows(m, a.slice);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // fit limits and scarcities in registers up to 16 knapsacks
  if (m <= 4) return launch_greedy<4>(a, blocks, st);
  if (m <= 8) return launch_greedy<8>(a, blocks, st);
  if (m <= 12) return launch_greedy<12>(a, blocks, st);
  if (m <= 16) return launch_greedy<16>(a, blocks, st);
  return launch_greedy<0>(a, blocks, st);
}
