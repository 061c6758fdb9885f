// Per-row top-k for Hopper (sm_90a), in two keyings:
//
// - segmented_topk_f32: the per-shard frontier of the fleet-scale stage 1
//   (the hierarchical greedy knapsack), keyed on x. Replaces the TPU
//   kernel kernels/segmented_topk.py::segmented_topk of the JAX package.
//   For x (S, C) f32 it gives, per row, the k largest values (S, k) f32
//   and their lanes (S, k) int32, in descending order, ties to the lowest
//   lane; -0.0 ties with +0.0 (the reference compares with ==) and NaN
//   orders above +inf (as torch.sort does). Rows padded with -inf yield
//   -inf slots once their finite entries run out.
// - topk_sparsify_f32: the magnitude top-k codec of the compressed update
//   plane, keyed on |x| (fabsf, so -0.0 ties with +0.0 as jnp.abs has
//   it). Replaces kernels/compression.py::topk_sparsify. For the client
//   deltas x (K, P) it gives the k indices of largest |x| per row,
//   descending, ties to the lowest index, and the signed x at each: the
//   emit gathers x at the kept lane, so it serves both keyings as it is.
//
// Bound: bytes and launches. segmented_topk must read S*C*4 bytes and
// write S*k*8; at the fleet shape (S = 8, C = 131,072, k = 4,096) that is
// 4.46 MB, 1.3 us at 3.35 TB/s, so the passes over the row and the
// launches, not the bytes, set its time. topk_sparsify at the compressed
// plane's shape (K = 13, P = 1,070,794, k = 53,540 at F = 0.05) reads
// 55.7 MB and writes 5.6 MB, 18.3 us; its sort is 65,536 pairs a row,
// mostly global passes, and select and compact keep 13 of 132 SMs busy.
//
// Design. The TPU kernel did k max-extract passes over a row held in
// VMEM; at k = 4,096 (and up to k = C when the frontier escalates) that
// does not carry over. Here, per row:
//   1. select (one block per row): map each f32 (or its magnitude) to an
//      order-preserving uint32 key and find the key T of the k-th largest
//      element with four 8-bit histogram passes (shared-memory integer
//      counts, one add per distinct digit in a warp);
//   2. compact (one block per row): walk the row in lane order and keep
//      every key above T plus the lowest-lane keys equal to T, up to k,
//      by block-wide ballot scans. Each survivor becomes the 64-bit pair
//      (~key << 32 | lane), so ascending pairs are keys descending, lanes
//      ascending: a total order, so any correct sort gives one answer;
//   3. sort the k survivors (padded to a power of two kp) with a bitonic
//      network: tiles of up to 4,096 pairs (32 KB) in shared memory, and
//      for kp > 4,096 the strides of a tile or more as global passes;
//   4. emit values (gathered from x) and lanes.
// No float atomics; the output is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 1024;           // select and compact
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kTile = 4096;                 // pairs sorted in shared memory
constexpr int kPairThreads = 256;           // global bitonic passes, emit
constexpr unsigned long long kPad = ~0ull;  // sorts after every survivor

__device__ __forceinline__ uint32_t order_key(float f) {
  if (f != f) return 0xFFFFFFFFu;           // NaN: above +inf
  uint32_t b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;             // -0.0 ties with +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The two keyings the select and compact kernels are templated on.
struct ValueKey {
  __device__ __forceinline__ static uint32_t of(float f) { return order_key(f); }
};
struct MagnitudeKey {
  __device__ __forceinline__ static uint32_t of(float f) { return order_key(fabsf(f)); }
};

// Per row: the key T of the k-th largest element, and how many elements
// equal to T the top k takes (the rest of the k lie above T).
template <typename Key>
__global__ void __launch_bounds__(kRowThreads)
topk_select(const float* __restrict__ x, int C, int k, uint32_t* __restrict__ thresh,
            int* __restrict__ need_eq) {
  __shared__ unsigned hist[256];
  __shared__ uint32_t s_prefix;
  __shared__ int s_need;
  const float* row = x + (size_t)blockIdx.x * C;
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0, mask = 0;
  int need = k;  // elements to take among those whose key matches `prefix`
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += kRowThreads) hist[b] = 0u;
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += kRowThreads) {  // uniform trip count
      const int c = c0 + threadIdx.x;
      int digit = -1;
      if (c < C) {
        const uint32_t key = Key::of(row[c]);
        if ((key & mask) == prefix) digit = (int)((key >> shift) & 0xFFu);
      }
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // The digit of the k-th largest: walk down from 255 until the counts
      // above and at it reach `need` (bin 0 must then hold the rest).
      int above = 0, b = 255;
      for (; b > 0; --b) {
        if (above + (int)hist[b] >= need) break;
        above += (int)hist[b];
      }
      s_prefix = prefix | ((uint32_t)b << shift);
      s_need = need - above;
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    mask |= 0xFFu << shift;
    // Thread 0 rewrites s_prefix/s_need only after the next pass's first
    // barrier, which every thread reaches after these reads.
  }
  if (threadIdx.x == 0) {
    thresh[blockIdx.x] = prefix;
    need_eq[blockIdx.x] = need;
  }
}

// Per row: the k survivors as (~key << 32 | lane) pairs in lane order,
// then kPad up to kp.
template <typename Key>
__global__ void __launch_bounds__(kRowThreads)
topk_compact(const float* __restrict__ x, int C, int k, int kp,
             const uint32_t* __restrict__ thresh, const int* __restrict__ need_eq,
             unsigned long long* __restrict__ buf) {
  __shared__ int s_eq[kRowWarps];
  __shared__ int s_take[kRowWarps];
  const float* row = x + (size_t)blockIdx.x * C;
  unsigned long long* out = buf + (size_t)blockIdx.x * kp;
  const uint32_t T = thresh[blockIdx.x];
  const int need = need_eq[blockIdx.x];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int eq_seen = 0, taken = 0;  // the same in every thread of the block
  for (int c0 = 0; c0 < C && taken < k; c0 += kRowThreads) {
    const int c = c0 + threadIdx.x;
    uint32_t key = 0u;
    bool gt = false, eq = false;
    if (c < C) {
      key = Key::of(row[c]);
      gt = key > T;
      eq = key == T;
    }
    const unsigned eq_bits = __ballot_sync(0xFFFFFFFFu, eq);
    if (lane == 0) s_eq[warp] = __popc(eq_bits);
    __syncthreads();
    int eq_rank = eq_seen + __popc(eq_bits & below), eq_chunk = 0;
    for (int w = 0; w < kRowWarps; ++w) {
      const int n = s_eq[w];
      if (w < warp) eq_rank += n;
      eq_chunk += n;
    }
    const bool take = gt || (eq && eq_rank < need);
    const unsigned take_bits = __ballot_sync(0xFFFFFFFFu, take);
    if (lane == 0) s_take[warp] = __popc(take_bits);
    __syncthreads();
    int pos = taken + __popc(take_bits & below), take_chunk = 0;
    for (int w = 0; w < kRowWarps; ++w) {
      const int n = s_take[w];
      if (w < warp) pos += n;
      take_chunk += n;
    }
    if (take) out[pos] = ((unsigned long long)(~key) << 32) | (uint32_t)c;
    eq_seen += eq_chunk;
    taken += take_chunk;
    __syncthreads();  // s_eq and s_take are rewritten by the next chunk
  }
  for (int i = k + threadIdx.x; i < kp; i += kRowThreads) out[i] = kPad;
}

// Bitonic stages on tiles of `tile` pairs (a power of two <= kTile) in
// shared memory: for each size in [size_lo, size_hi] (powers of two), the
// strides min(size, tile)/2 down to 1. A pair's direction follows its
// index within the row, so tiles combine into row-wide sequences.
__global__ void __launch_bounds__(kRowThreads)
bitonic_tile(unsigned long long* __restrict__ buf, int kp, int tile, int size_lo, int size_hi) {
  __shared__ unsigned long long s[kTile];
  const int tiles_per_row = kp / tile;
  const size_t row = blockIdx.x / tiles_per_row;
  const int base = (blockIdx.x % tiles_per_row) * tile;
  unsigned long long* g = buf + row * kp + base;
  for (int i = threadIdx.x; i < tile; i += kRowThreads) s[i] = g[i];
  __syncthreads();
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    for (int stride = (size < tile ? size : tile) >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += kRowThreads) {
        const int i = 2 * stride * (p / stride) + (p % stride);
        const bool asc = ((base + i) & size) == 0;
        const unsigned long long a = s[i], b = s[i + stride];
        if ((a > b) == asc) {
          s[i] = b;
          s[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += kRowThreads) g[i] = s[i];
}

// One bitonic stage (size, stride >= tile) over every row, a pair a thread.
__global__ void __launch_bounds__(kPairThreads)
bitonic_global(unsigned long long* __restrict__ buf, int kp, int size, int stride,
               long long pairs) {
  const long long p = (long long)blockIdx.x * kPairThreads + threadIdx.x;
  if (p >= pairs) return;
  const int half = kp >> 1;
  const size_t row = (size_t)(p / half);
  const int q = (int)(p % half);
  const int i = 2 * stride * (q / stride) + (q % stride);
  const bool asc = (i & size) == 0;
  unsigned long long* g = buf + row * kp;
  const unsigned long long a = g[i], b = g[i + stride];
  if ((a > b) == asc) {
    g[i] = b;
    g[i + stride] = a;
  }
}

__global__ void __launch_bounds__(kPairThreads)
topk_emit(const float* __restrict__ x, int C, int k, int kp,
          const unsigned long long* __restrict__ buf, float* __restrict__ vals,
          int* __restrict__ lanes, long long total) {
  const long long p = (long long)blockIdx.x * kPairThreads + threadIdx.x;
  if (p >= total) return;
  const size_t row = (size_t)(p / k);
  const int i = (int)(p % k);
  const uint32_t lane = (uint32_t)(buf[row * kp + i] & 0xFFFFFFFFull);
  vals[p] = x[row * C + lane];
  lanes[p] = (int)lane;
}

unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

// Every launch of one top-k over x (S, C) keyed by Key; returns 0 or the
// CUDA error code of the first failed launch.
template <typename Key>
int run_topk(const void* x, void* vals, void* lanes, void* buf, void* thresh, void* need_eq,
             int S, int C, int k, int kp, void* stream) {
  if (S < 1 || C < 1 || C > (1 << 30) || k < 1 || k > C || kp < k || (kp & (kp - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xx = static_cast<const float*>(x);
  unsigned long long* b = static_cast<unsigned long long*>(buf);
  uint32_t* th = static_cast<uint32_t*>(thresh);
  int* ne = static_cast<int*>(need_eq);
  cudaError_t err;
  topk_select<Key><<<S, kRowThreads, 0, st>>>(xx, C, k, th, ne);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  topk_compact<Key><<<S, kRowThreads, 0, st>>>(xx, C, k, kp, th, ne, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int tile = kp < kTile ? kp : kTile;
  const unsigned tile_blocks = (unsigned)S * (unsigned)(kp / tile);
  bitonic_tile<<<tile_blocks, kRowThreads, 0, st>>>(b, kp, tile, 2, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long pairs = (long long)S * (kp / 2);
  for (int size = 2 * tile; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride >= tile; stride >>= 1) {
      bitonic_global<<<blocks_for(pairs, kPairThreads), kPairThreads, 0, st>>>(b, kp, size,
                                                                              stride, pairs);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    bitonic_tile<<<tile_blocks, kRowThreads, 0, st>>>(b, kp, tile, size, size);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const long long total = (long long)S * k;
  topk_emit<<<blocks_for(total, kPairThreads), kPairThreads, 0, st>>>(
      xx, C, k, kp, b, static_cast<float*>(vals), static_cast<int*>(lanes), total);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. x (S, C) f32; vals (S, k) f32; lanes
// (S, k) int32; scratch: buf (S, kp) uint64 with kp the least power of two
// >= k, thresh (S,) uint32, need_eq (S,) int32. Returns 0 or the CUDA
// error code of the first failed launch.
extern "C" int segmented_topk_f32(const void* x, void* vals, void* lanes, void* buf,
                                  void* thresh, void* need_eq, int S, int C, int k, int kp,
                                  void* stream) {
  return run_topk<ValueKey>(x, vals, lanes, buf, thresh, need_eq, S, C, k, kp, stream);
}

// The same, keyed on |x|: rows are the K client deltas, lanes the kept
// indices, vals the signed values at them.
extern "C" int topk_sparsify_f32(const void* x, void* vals, void* lanes, void* buf,
                                 void* thresh, void* need_eq, int S, int C, int k, int kp,
                                 void* stream) {
  return run_topk<MagnitudeKey>(x, vals, lanes, buf, thresh, need_eq, S, C, k, kp, stream);
}
