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
// Bound: bytes. segmented_topk must read S*C*4 bytes and write S*k*8; at
// the fleet shape (S = 8, C = 131,072, k = 4,096) that is 4.46 MB, 1.3 us
// at 3.35 TB/s, so launches and the passes over the row set its time.
// topk_sparsify at the compressed plane's shape (K = 13, P = 1,070,794,
// k = 53,540 at F = 0.05) reads 55.7 MB (more than the 50 MB L2) and
// writes 5.6 MB, 18.3 us; each pass over the input costs device-memory
// bytes, and the sort moves 65,536 pairs a row.
//
// Design. The TPU kernel did k max-extract passes over a row held in
// VMEM; at k = 4,096 (and up to k = C when the frontier escalates) that
// does not carry over. An earlier version gave each row one block, so
// 13 (or 8) of 132 SMs did the work; here each row is cut into G chunks
// (the wrapper picks G from C, S and the SM count so rows x chunks fill
// the card; G <= 256) and every pass runs a block a chunk. Each f32 (or
// its magnitude) maps to an order-preserving uint32 key.
//   1. select: three radix passes over the row with digits of 11, 11 and
//      10 bits (the first digit is the sign, the 8 exponent bits and 2
//      mantissa bits). A block counts its chunk's digits, among the keys
//      that match the prefix chosen so far, in shared memory, and adds
//      the nonzero bins to the row's histogram with integer atomics (the
//      counts, and so the choice, are the same on every run). The last
//      block of the row to finish (a counter after __threadfence) picks
//      the digit of the k-th largest key and the count still needed. The
//      last pass also stores each chunk's bins, so that block can scan
//      the chunks' counts of keys equal to the threshold T.
//   2. compact: one more pass. Each survivor is the 64-bit pair
//      (~key << 32 | lane); ascending pairs are keys descending, lanes
//      ascending, a total order, so survivors may land in any slot and
//      any correct sort gives one answer. Keys above T, and the keys
//      equal to T of a chunk whose equals are all taken, go to slots from
//      a per-row counter (one atomic a warp a step). Only the one chunk
//      whose equals straddle the count still needed ranks them by lane,
//      with block scans, from the base the scan of step 1 gave it.
//   3. sort the k survivors (padded to a power of two kp) with a bitonic
//      network on tiles in shared memory, a block a tile. A thread holds
//      8 pairs in registers and applies three strides to them between
//      two trips to memory (a third of the barriers and of the
//      shared-memory traffic of one stride a trip); the shared slots are
//      swizzled against bank conflicts. For kp > 4,096 the tiles hold
//      4,096 pairs (32 KB) and the strides of a tile or more run as
//      global passes. A shorter row would be one block: its tiles are
//      halved (down to 256 pairs) until rows x tiles fill the SMs, and
//      one more launch merges them, a block a tile with the whole row in
//      shared memory, each pair's slot its index in its tile plus a
//      binary search in each other tile;
//   4. the last sort launch emits values (gathered from x) and lanes.
// Loads are 16, 8 or 4 bytes a thread: the widest that divides C and the
// base address (the wrapper picks it). Scratch comes from the wrapper
// and is zeroed here on the stream; nothing is read back to the host, so
// the launches can be captured in a CUDA graph. No float atomics; the
// output is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // select and compact
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                  // vectors a thread loads a step
constexpr int kStep = kThreads * kUnroll;   // vectors a block loads a step
constexpr int kMaxChunks = kThreads;        // one scan over a row's chunks
constexpr int kPasses = 3;
constexpr int kBins = 2048;                 // bins of the widest digit
constexpr int kLastBins = 1024;             // bins of the last digit
// Per row: the three passes' histograms, a counter a pass, the survivor
// count, then (prefix, need) after each pass. After the S rows: each
// chunk's last-pass bins (G x kLastBins a row), then each chunk's
// (equals before it, equals in it) (G x 2 a row).
constexpr int kHistWords = 2 * kBins + kLastBins;
constexpr int kRowWords = kHistWords + kPasses + 1 + 2 * kPasses;
constexpr int kChunkWords = kLastBins + 2;
constexpr int kSortThreads = 512;           // a tile of 8 pairs a thread
constexpr int kTile = 4096;                 // pairs sorted in shared memory
constexpr int kMinTile = 256;               // the least tile of a short row
constexpr int kMaxTiles = kTile / kMinTile;  // tiles of a short row
constexpr int kRankThreads = 256;           // the short rows' merge
constexpr int kPairThreads = 256;           // global bitonic passes
constexpr unsigned kFull = 0xFFFFFFFFu;
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

template <int V>
struct alignas(4 * V) Vec {
  float f[V];
};

struct RowScratch {
  int* hist;        // kHistWords: pass p's bins at p * kBins
  int* done;        // blocks finished, a pass
  int* count;       // survivors placed
  int* state;       // (prefix, need) after each pass
  int* chunk_bins;  // G x kLastBins
  int* equals;      // G x 2
};

__device__ __forceinline__ RowScratch row_scratch(int* s, int S, int G, int row) {
  int* r = s + (size_t)row * kRowWords;
  int* chunks = s + (size_t)S * kRowWords;
  return {r, r + kHistWords, r + kHistWords + kPasses, r + kHistWords + kPasses + 1,
          chunks + (size_t)row * G * kLastBins,
          chunks + (size_t)S * G * kLastBins + (size_t)row * G * 2};
}

// Exclusive sum of v over the block's threads in thread order; *total
// gets the block's sum. Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is rewritten by the next call
  return before + incl - v;
}

// One step of a block over its chunk: vectors base + u * kThreads + tid,
// u < kUnroll, those below `end` loaded (the rest left zero).
template <int V>
__device__ __forceinline__ void load_step(const Vec<V>* __restrict__ src, int base, int end,
                                          Vec<V> (&r)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = base + u * kThreads + (int)threadIdx.x;
    r[u] = i < end ? src[i] : Vec<V>{};
  }
}

// Add one to hist[digit] for every lane with digit >= 0; a warp whose
// lanes all hold one digit (a run of -inf padding, an all-equal row)
// adds 32 at once instead of 32 serialized atomics.
__device__ __forceinline__ void count_digit(int* hist, int digit) {
  const int first = __shfl_sync(kFull, digit, 0);
  if (__all_sync(kFull, digit == first)) {
    if (first >= 0 && (threadIdx.x & 31) == 0) atomicAdd(&hist[first], 32);
  } else if (digit >= 0) {
    atomicAdd(&hist[digit], 1);
  }
}

// Radix pass P (digits of 11, 11, 10 bits from the top) over the blocks'
// chunks; the row's last block picks the digit (see the header).
template <typename Key, int V, int P>
__global__ void __launch_bounds__(kThreads)
topk_radix_pass(const float* __restrict__ x, int S, int C, int k, int chunk, int G,
                int* __restrict__ scratch) {
  constexpr int kNumBins = P == 2 ? kLastBins : kBins;
  constexpr int kShift = P == 0 ? 21 : (P == 1 ? 10 : 0);
  constexpr uint32_t kMask = P == 0 ? 0u : (P == 1 ? 0xFFE00000u : 0xFFFFFC00u);  // digits above
  constexpr int kPer = kNumBins / kThreads;
  __shared__ int hist[kNumBins];
  __shared__ int warp_sums[kWarps];
  __shared__ int s_last, s_digit;
  const int row = blockIdx.y, ch = blockIdx.x;
  const RowScratch rs = row_scratch(scratch, S, G, row);
  const uint32_t prefix = P == 0 ? 0u : (uint32_t)rs.state[2 * (P - 1)];
  for (int b = threadIdx.x; b < kNumBins; b += kThreads) hist[b] = 0;
  __syncthreads();

  const int c0 = ch * chunk, end = min(c0 + chunk, C) / V;
  const Vec<V>* src = reinterpret_cast<const Vec<V>*>(x + (size_t)row * C);
  for (int base = c0 / V; base < end; base += kStep) {  // uniform trip count
    Vec<V> r[kUnroll];
    load_step<V>(src, base, end, r);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = base + u * kThreads + (int)threadIdx.x < end;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const uint32_t key = Key::of(r[u].f[e]);
        count_digit(hist, ok && (key & kMask) == prefix
                              ? (int)((key >> kShift) & (kNumBins - 1)) : -1);
      }
    }
  }
  __syncthreads();

  int* row_hist = rs.hist + P * kBins;
  for (int b = threadIdx.x; b < kNumBins; b += kThreads) {
    const int h = hist[b];
    if (h) atomicAdd(&row_hist[b], h);
    if (P == 2) rs.chunk_bins[(size_t)ch * kLastBins + b] = h;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&rs.done[P], 1) == G - 1;
  __syncthreads();
  if (!s_last) return;

  // The row's last block: every other block's counts are in row_hist.
  __threadfence();
  for (int b = threadIdx.x; b < kNumBins; b += kThreads) hist[b] = __ldcg(&row_hist[b]);
  __syncthreads();
  const int need = P == 0 ? k : rs.state[2 * (P - 1) + 1];
  // Thread t holds kPer bins, thread 0 the top ones, so an exclusive scan
  // in thread order counts the keys above each thread's bins.
  const int lo = (kThreads - 1 - (int)threadIdx.x) * kPer;
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) sum += hist[lo + i];
  int total;
  const int above = block_exclusive_scan(sum, warp_sums, &total);
  if (above < need && above + sum >= need) {  // exactly one thread
    int a = above, b = lo + kPer - 1;
    for (; b > lo && a + hist[b] < need; --b) a += hist[b];
    rs.state[2 * P] = (int)(prefix | ((uint32_t)b << kShift));
    rs.state[2 * P + 1] = need - a;
    s_digit = b;
  }
  if (P != 2) return;
  __syncthreads();
  // Each chunk's count of keys equal to T, and the count before it.
  const int t = threadIdx.x;
  const int n_eq = t < G ? __ldcg(&rs.chunk_bins[(size_t)t * kLastBins + s_digit]) : 0;
  const int before = block_exclusive_scan(n_eq, warp_sums, &total);
  if (t < G) {
    rs.equals[2 * t] = before;
    rs.equals[2 * t + 1] = n_eq;
  }
}

// Per row: the k survivors as (~key << 32 | lane) pairs, in slots [0, k)
// of the row's kp, in no particular order.
template <typename Key, int V>
__global__ void __launch_bounds__(kThreads)
topk_compact(const float* __restrict__ x, int S, int C, int k, int kp, int chunk, int G,
             int* __restrict__ scratch, unsigned long long* __restrict__ buf) {
  __shared__ int warp_sums[kWarps];
  const int row = blockIdx.y, ch = blockIdx.x;
  const RowScratch rs = row_scratch(scratch, S, G, row);
  const uint32_t T = (uint32_t)rs.state[4];
  const int need_eq = rs.state[5];  // keys equal to T that the top k takes
  const int eq_before = rs.equals[2 * ch], eq_here = rs.equals[2 * ch + 1];
  const bool all_eq = eq_before + eq_here <= need_eq;        // block-uniform
  const bool straddle = !all_eq && eq_before < need_eq;
  int eq_seen = eq_before;
  unsigned long long* out = buf + (size_t)row * kp;

  const int c0 = ch * chunk, end = min(c0 + chunk, C) / V;
  const Vec<V>* src = reinterpret_cast<const Vec<V>*>(x + (size_t)row * C);
  for (int base = c0 / V; base < end; base += kStep) {  // uniform trip count
    Vec<V> r[kUnroll];
    load_step<V>(src, base, end, r);
    unsigned take = 0;  // bit u * V + e
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = base + u * kThreads + (int)threadIdx.x < end;
      unsigned eq = 0;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const uint32_t key = Key::of(r[u].f[e]);
        if (ok && key > T) take |= 1u << (u * V + e);
        if (ok && key == T) eq |= 1u << e;
      }
      if (straddle) {  // rank the equals by lane: (u, thread, e) is lane order
        int n;
        int rank = eq_seen + block_exclusive_scan(__popc(eq), warp_sums, &n);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((eq >> e) & 1u) {
            if (rank < need_eq) take |= 1u << (u * V + e);
            ++rank;
          }
        }
        eq_seen += n;
      } else if (all_eq) {
        take |= eq << (u * V);
      }
    }
    // Slots for this step's survivors: a warp scan of the counts and one
    // atomic a warp.
    const int lane_id = threadIdx.x & 31, n_take = __popc(take);
    int incl = n_take;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, incl, o);
      if (lane_id >= o) incl += n;
    }
    int first = 0;
    if (lane_id == 31 && incl) first = atomicAdd(rs.count, incl);
    int slot = __shfl_sync(kFull, first, 31) + incl - n_take;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (((take >> (u * V + e)) & 1u) && slot < k) {
          const uint32_t lane = (uint32_t)((base + u * kThreads + (int)threadIdx.x) * V + e);
          out[slot++] = ((unsigned long long)(~Key::of(r[u].f[e])) << 32) | lane;
        }
      }
    }
  }
}

// Shared-memory slot of pair i of a tile: XOR-swizzled so that the
// rounds below, which read pairs i0 + m * 2^b for consecutive groups,
// hit distinct bank pairs (two wavefronts a warp, as for contiguous
// reads), whatever b.
__device__ __forceinline__ int swizzle(int i) { return i ^ ((i >> 3) & 15); }

// Group g's first pair for the butterfly over the strides 2^b .. 2^(b+L-1):
// g with L zero bits inserted at bit b.
__device__ __forceinline__ int group_base(int g, int b, int L) {
  return ((g >> b) << (b + L)) | (g & ((1 << b) - 1));
}

// The compare-exchanges of L consecutive bitonic strides over 2^L pairs
// held in registers, the largest stride first.
template <int L>
__device__ __forceinline__ void butterfly(unsigned long long (&v)[1 << L], bool asc) {
#pragma unroll
  for (int l = L - 1; l >= 0; --l) {
#pragma unroll
    for (int m = 0; m < (1 << L); ++m) {
      if (m & (1 << l)) continue;
      const unsigned long long a = v[m], c = v[m | (1 << l)];
      const bool swap = (a > c) == asc;
      v[m] = swap ? c : a;
      v[m | (1 << l)] = swap ? a : c;
    }
  }
}

// One round in shared memory: the strides 2^b .. 2^(b+L-1) of the merge
// of `size` over a tile, 2^L pairs a group. A pair's direction follows
// its index within the row (base + i), so tiles combine into row-wide
// sequences.
template <int L>
__device__ __forceinline__ void tile_round(unsigned long long* s, int tile, int base, int size,
                                           int b) {
  for (int g = threadIdx.x; g < (tile >> L); g += kSortThreads) {
    const int i0 = group_base(g, b, L);
    unsigned long long v[1 << L];
#pragma unroll
    for (int m = 0; m < (1 << L); ++m) v[m] = s[swizzle(i0 + (m << b))];
    butterfly<L>(v, ((base + i0) & size) == 0);
#pragma unroll
    for (int m = 0; m < (1 << L); ++m) s[swizzle(i0 + (m << b))] = v[m];
  }
  __syncthreads();
}

// What the last sort launch writes: the first k sorted pairs of each row
// as values (gathered from x) and lanes.
struct Emit {
  const float* x;
  float* vals;
  int* lanes;
  int C, k;
};

// Bitonic stages on tiles of `tile` pairs (a power of two <= kTile) in
// shared memory: for each size in [size_lo, size_hi] (powers of two), the
// strides min(size, tile)/2 down to 1, three a round (the remainder
// first). Slots at or past `valid` load as kPad. The row's sort is done
// when size_hi == kp: then the tile is emitted instead of stored back.
__global__ void __launch_bounds__(kSortThreads)
bitonic_tile(unsigned long long* __restrict__ buf, int kp, int tile, int size_lo, int size_hi,
             int valid, Emit out) {
  __shared__ unsigned long long s[kTile];
  const int tiles_per_row = kp / tile;
  const size_t row = blockIdx.x / tiles_per_row;
  const int base = (blockIdx.x % tiles_per_row) * tile;
  unsigned long long* g = buf + row * kp + base;
  if (base >= valid) {  // all padding (first launch only): sorted either way
    for (int i = threadIdx.x; i < tile; i += kSortThreads) g[i] = kPad;
    return;
  }
  for (int i = threadIdx.x; i < tile; i += kSortThreads)
    s[swizzle(i)] = base + i < valid ? g[i] : kPad;
  __syncthreads();
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    int l = 30 - __clz(size < tile ? size : tile);  // the largest stride's bit
    const int first = (l + 1) % 3;
    if (first == 1) tile_round<1>(s, tile, base, size, l);
    if (first == 2) tile_round<2>(s, tile, base, size, l - 1);
    for (l -= first; l >= 0; l -= 3) tile_round<3>(s, tile, base, size, l - 2);
  }
  if (size_hi < kp) {
    for (int i = threadIdx.x; i < tile; i += kSortThreads) g[i] = s[swizzle(i)];
    return;
  }
  const int end = min(tile, out.k - base);
  for (int i = threadIdx.x; i < end; i += kSortThreads) {
    const uint32_t lane = (uint32_t)(s[swizzle(i)] & 0xFFFFFFFFull);
    out.vals[row * out.k + base + i] = out.x[row * out.C + lane];
    out.lanes[row * out.k + base + i] = (int)lane;
  }
}

// The merge of a short row (kp <= kTile) from its Tiles sorted tiles, a
// block a tile, the whole row in shared memory. A pair's slot in the row
// is the count of pairs below it, summed over the tiles by binary
// searches run in step (independent reads); pairs are distinct but for
// the padding, which counts k below it, so only survivors take the first
// k slots and are emitted. The tile stage sorts odd tiles descending
// (their bitonic direction), so they load reversed. kp is at least
// 2 * kMinTile here, so rows start on 16 bytes.
template <int Tiles>
__global__ void __launch_bounds__(kRankThreads)
rank_emit(const unsigned long long* __restrict__ buf, int kp, Emit out) {
  __shared__ unsigned long long s[kTile];
  const int tile = kp / Tiles;
  const size_t row = blockIdx.x / Tiles;
  const int mine = blockIdx.x % Tiles;
  // The row, 16 bytes a thread a step, every load in flight at once.
  const ulonglong2* g = reinterpret_cast<const ulonglong2*>(buf + row * kp);
#pragma unroll
  for (int u = 0; u < kTile / (2 * kRankThreads); ++u) {
    const int i = 2 * (u * kRankThreads + (int)threadIdx.x);
    if (i < kp) {
      const ulonglong2 p = g[i / 2];
      s[(i & tile) ? i ^ (tile - 1) : i] = p.x;
      s[(i & tile) ? (i + 1) ^ (tile - 1) : i + 1] = p.y;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < tile; o += kRankThreads) {
    const unsigned long long v = s[mine * tile + o];
    int below[Tiles];  // pairs of tile j below v, so far
#pragma unroll
    for (int j = 0; j < Tiles; ++j) below[j] = 0;
    for (int step = tile >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int j = 0; j < Tiles; ++j)
        below[j] += s[j * tile + below[j] + step - 1] < v ? step : 0;
    }
    int rank = 0;
#pragma unroll
    for (int j = 0; j < Tiles; ++j) rank += below[j] + (s[j * tile + below[j]] < v);
    if (rank < out.k) {
      const uint32_t lane = (uint32_t)(v & 0xFFFFFFFFull);
      out.vals[row * out.k + rank] = out.x[row * out.C + lane];
      out.lanes[row * out.k + rank] = (int)lane;
    }
  }
}

// The strides 2^b .. 2^(b+L-1) (>= tile) of the merge of `size` over every
// row, a group of 2^L pairs a thread.
template <int L>
__global__ void __launch_bounds__(kPairThreads)
bitonic_global(unsigned long long* __restrict__ buf, int kp, int size, int b, long long groups) {
  const long long p = (long long)blockIdx.x * kPairThreads + threadIdx.x;
  if (p >= groups) return;
  const int shift = __ffs(kp) - 1 - L;  // groups a row: kp >> L
  const size_t row = (size_t)(p >> shift);
  const int i0 = group_base((int)(p & ((1ll << shift) - 1)), b, L);
  unsigned long long* r = buf + row * kp;
  unsigned long long v[1 << L];
#pragma unroll
  for (int m = 0; m < (1 << L); ++m) v[m] = r[i0 + (m << b)];
  butterfly<L>(v, (i0 & size) == 0);
#pragma unroll
  for (int m = 0; m < (1 << L); ++m) r[i0 + (m << b)] = v[m];
}

// The int32 scratch words of one call over S rows of G chunks.
long long scratch_words_for(int S, int G) {
  return (long long)S * (kRowWords + (long long)G * kChunkWords);
}

unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <int L>
cudaError_t launch_global(unsigned long long* b, int S, int kp, int size, int bit,
                          cudaStream_t st) {
  const long long groups = (long long)S * (kp >> L);
  bitonic_global<L><<<blocks_for(groups, kPairThreads), kPairThreads, 0, st>>>(b, kp, size, bit,
                                                                             groups);
  return cudaGetLastError();
}

template <typename Key, int V>
cudaError_t select_and_compact(const float* x, int S, int C, int k, int kp, int chunk, int G,
                               int* sc, unsigned long long* b, cudaStream_t st) {
  const dim3 grid(G, S);
  cudaError_t err;
  topk_radix_pass<Key, V, 0><<<grid, kThreads, 0, st>>>(x, S, C, k, chunk, G, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  topk_radix_pass<Key, V, 1><<<grid, kThreads, 0, st>>>(x, S, C, k, chunk, G, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  topk_radix_pass<Key, V, 2><<<grid, kThreads, 0, st>>>(x, S, C, k, chunk, G, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  topk_compact<Key, V><<<grid, kThreads, 0, st>>>(x, S, C, k, kp, chunk, G, sc, b);
  return cudaGetLastError();
}

// Every launch of one top-k over x (S, C) keyed by Key; returns 0 or the
// CUDA error code of the first failed launch.
template <typename Key>
int run_topk(const void* x, void* vals, void* lanes, void* buf, void* scratch,
             long long scratch_words, int S, int C, int k, int kp, int chunk, int G, int vec,
             void* stream) {
  if (S < 1 || S > 65535 || C < 1 || C > (1 << 30) || k < 1 || k > C || kp < k ||
      (kp & (kp - 1)) != 0 || chunk < 1 || chunk % 4 != 0 || G < 1 || G > kMaxChunks ||
      (long long)(G - 1) * chunk >= C || (long long)G * chunk < C ||
      (vec != 1 && vec != 2 && vec != 4) || C % vec != 0 ||
      reinterpret_cast<uintptr_t>(x) % (4 * vec) != 0 ||
      scratch_words < scratch_words_for(S, G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xx = static_cast<const float*>(x);
  unsigned long long* b = static_cast<unsigned long long*>(buf);
  int* sc = static_cast<int*>(scratch);
  cudaError_t err = cudaMemsetAsync(sc, 0, sizeof(int) * (size_t)S * kRowWords, st);
  if (err != cudaSuccess) return (int)err;
  switch (vec) {
    case 4: err = select_and_compact<Key, 4>(xx, S, C, k, kp, chunk, G, sc, b, st); break;
    case 2: err = select_and_compact<Key, 2>(xx, S, C, k, kp, chunk, G, sc, b, st); break;
    default: err = select_and_compact<Key, 1>(xx, S, C, k, kp, chunk, G, sc, b, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const Emit out{xx, static_cast<float*>(vals), static_cast<int*>(lanes), C, k};
  // Tiles of up to kTile pairs, sorted a block each. A short row would be
  // one block: its tiles are halved (to kMinTile) until rows x tiles fill
  // the SMs, then merged by rank. A row of one tile is emitted by its sort.
  int tile = kp < kTile ? kp : kTile;
  if (kp <= kTile) {
    int dev, sms;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    while (tile > kMinTile && (long long)S * (kp / tile) < sms) tile >>= 1;
  }
  const unsigned tile_blocks = (unsigned)S * (unsigned)(kp / tile);
  bitonic_tile<<<tile_blocks, kSortThreads, 0, st>>>(b, kp, tile, 2, tile, k, out);
  if ((err = cudaGetLastError()) != cudaSuccess || tile == kp) return (int)err;
  if (kp <= kTile) {
    switch (kp / tile) {
      case 2: rank_emit<2><<<tile_blocks, kRankThreads, 0, st>>>(b, kp, out); break;
      case 4: rank_emit<4><<<tile_blocks, kRankThreads, 0, st>>>(b, kp, out); break;
      case 8: rank_emit<8><<<tile_blocks, kRankThreads, 0, st>>>(b, kp, out); break;
      default: rank_emit<kMaxTiles><<<tile_blocks, kRankThreads, 0, st>>>(b, kp, out); break;
    }
    return (int)cudaGetLastError();
  }
  const int tile_bit = __builtin_ctz((unsigned)tile);
  for (int size = 2 * tile; size <= kp; size <<= 1) {
    // The strides size/2 .. tile in global passes, three a pass (the
    // remainder first), then the rest of the merge in each tile.
    int l = __builtin_ctz((unsigned)size) - 1;
    const int first = (l - tile_bit + 1) % 3;
    if (first == 1) err = launch_global<1>(b, S, kp, size, l, st);
    if (first == 2) err = launch_global<2>(b, S, kp, size, l - 1, st);
    if (err != cudaSuccess) return (int)err;
    for (l -= first; l >= tile_bit; l -= 3)
      if ((err = launch_global<3>(b, S, kp, size, l - 2, st)) != cudaSuccess) return (int)err;
    bitonic_tile<<<tile_blocks, kSortThreads, 0, st>>>(b, kp, tile, size, size, kp, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// C interface, bound with ctypes. x (S, C) f32, aligned to 4 * vec bytes
// with vec (1, 2 or 4) dividing C; vals (S, k) f32; lanes (S, k) int32;
// buf (S, kp) uint64 with kp the least power of two >= k; scratch: at
// least topk_scratch_words(S, G) int32 words. Each row is cut
// into G chunks of `chunk` lanes (a multiple of 4, the last chunk
// non-empty), a block each. Returns 0 or the CUDA error code of the
// first failed launch.
extern "C" long long topk_scratch_words(int S, int G) { return scratch_words_for(S, G); }

extern "C" int segmented_topk_f32(const void* x, void* vals, void* lanes, void* buf,
                                  void* scratch, long long scratch_words, int S, int C, int k,
                                  int kp, int chunk, int G, int vec, void* stream) {
  return run_topk<ValueKey>(x, vals, lanes, buf, scratch, scratch_words, S, C, k, kp, chunk, G,
                            vec, stream);
}

// The same, keyed on |x|: rows are the K client deltas, lanes the kept
// indices, vals the signed values at them.
extern "C" int topk_sparsify_f32(const void* x, void* vals, void* lanes, void* buf,
                                 void* scratch, long long scratch_words, int S, int C, int k,
                                 int kp, int chunk, int G, int vec, void* stream) {
  return run_topk<MagnitudeKey>(x, vals, lanes, buf, scratch, scratch_words, S, C, k, kp, chunk,
                                G, vec, stream);
}
