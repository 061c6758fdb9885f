// Fused SwiGLU for Hopper (sm_90a): out = silu(x @ Wg) * (x @ Wu) for x (M, D)
// and Wg, Wu (D, F), all f32 or all bf16, out (M, F) in the same type.
// Replaces the TPU kernel kernels/swiglu.py::swiglu of the JAX package: both
// products are taken from the same x tile into two f32 accumulators per
// output element, and the gate g / (1 + exp(-g)) * u is applied in the
// epilogue, so neither product goes to device memory. Every output element
// is summed by one block (or, at decode, by one cluster) in a fixed order,
// so a call repeats bit for bit.
//
// Bound. Prefill (M = 8,192 tokens, bf16): 2 * 2*M*D*F operations on the
// tensor cores, 80.5 GFLOP at SmolLM-360M's D = 960, F = 2,560 (81 us at 989
// TFLOP/s; its 36 MB of bytes take 11 us) and 288.5 GFLOP at Hymba-1.5B's
// D = 1,600, F = 5,504 (292 us). A decode step (M = 8 or 4) is a weight
// stream: 2*D*F*2 bytes, 9.8 MB (2.9 us at 3.35 TB/s) and 35.2 MB (10.5 us).
//
// Routes (the binding picks one: repro_torch.kernels.swiglu.route).
// - bf16 prefill, D and F multiples of 8, 16-byte aligned bases
//   (swiglu_wgmma_kernel, after CUTLASS's warp-specialised GEMM): a
//   persistent kernel, one block an SM, walking 128 x 128 output tiles in
//   groups of 16 m tiles (m fastest), so the tiles in flight share x rows
//   and weight columns in L2. One producer warp (its warpgroup gives up
//   registers with setmaxnreg) keeps TMA loads of the x tile (128 rows x 64
//   of D, K-major) and of the Wg and Wu tiles (64 rows of D x 128 columns,
//   MN-major, as they lie in memory: no transposing copy) in flight into a
//   ring of stages with full and empty mbarriers, 128-byte swizzled. Two
//   consumer warpgroups own 64 rows each and issue, per 16 of D, one
//   wgmma.m64n256k16 over [Wg | Wu] (the weights read through wgmma's
//   transpose bit), so x is read from shared memory once for both
//   products. The gate runs on the accumulators in registers; the result
//   is rounded to bf16 into shared memory and written with a TMA store.
//   TMA zero-fills D's tail and M's and F's tails fall outside the store's
//   map. No product sits in a branch (ptxas serialises a wgmma it cannot
//   prove warp-uniform).
// - bf16 decode, M <= 16, the same alignment, D <= 2,048
//   (swiglu_splitk_kernel): the weights are read once, by F tiles of 64
//   columns x `splits` ranges of D (the grid covers the card's SMs a few
//   times); each block brings its whole Wg and Wu slices into shared memory
//   with TMA loads of 32 rows (all of its bytes in flight at once) while it
//   stages x's rows as f32, and the products run as FMA in f32, a chunk of
//   rows as soon as it lands. Each F tile's splits form one thread-block
//   cluster: every block leaves its partial sums in its shared memory, then
//   each block adds its share of the tile's outputs over all splits, in
//   split order, through distributed shared memory, and applies the gate.
//   No workspace, no counter and no float atomics.
// - bf16 otherwise (swiglu_bf16_kernel): 64 x 64 output tiles, four warps in
//   a 2 x 2 grid, each warp 32 x 32 outputs as 2 x 4 tiles of
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate) for each of the two
//   products; the K loop stages a 64 x 32 x tile and the 32 x 64 tiles of Wg
//   and Wu in shared memory, the weight tiles transposed (n-major) so that
//   every fragment is one 32-bit shared load. Ragged M, D and F are
//   zero-filled on load and masked on store.
// - f32 (swiglu_f32_kernel): the same tiling on CUDA cores, 64 x 64 outputs
//   a block of 256 threads, 4 x 4 outputs a thread, FMA in f32.
#include <cooperative_groups.h>
#include <math.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

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


// ------------------------------------- bf16 prefill: wgmma over a TMA ring
constexpr int kPreBM = 128;       // rows of an output tile: two consumer warpgroups of 64
constexpr int kPreBK = 64;        // D columns a stage: one 128-byte swizzled row of bf16
constexpr int kPreThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kGroupM = 16;       // m tiles a group of the tile order

// 128 output columns of each product a tile: both products' accumulators
// (128 f32 registers a consumer thread) fit the 168 registers ptxas gives a
// thread of the 384.
constexpr int kPreBN = 128;
constexpr int kPreStages = 4;
constexpr uint32_t kPreABytes = kPreBM * kPreBK * 2;       // the x tile, K-major
constexpr uint32_t kPreBBytes = 2 * kPreBN * kPreBK * 2;   // Wg's then Wu's, MN-major
constexpr uint32_t kPreStageBytes = kPreABytes + kPreBBytes;
// 1 KB of alignment slack and 1 KB of barriers, the stages, the output tile
constexpr int kPreSmem = 2048 + kPreStages * kPreStageBytes + kPreBM * kPreBN * 2;

// D (64 x 256, f32) (+)= A (64 x 16) B (16 x 256), both from shared memory: A
// K-major, B MN-major (the weights' row-major (D, F) tiles as TMA wrote them,
// read through the transpose bit).
__device__ __forceinline__ void wgmma_tb_n256(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One stage's products for one warpgroup: its 64 rows of the x tile at sa
// against the [Wg | Wu] tile (256 columns in 64-wide column tiles 8 KB
// apart), 16 of D a step. accumulate = 0 starts the sums.
__device__ __forceinline__ void issue_stage(float* acc, uint32_t sa, int wg, int accumulate) {
  const uint32_t a = sa + wg * 64 * 128, b = sa + kPreABytes;
#pragma unroll
  for (int kk = 0; kk < kPreBK / 16; ++kk)
    wgmma_tb_n256(acc, gmma_desc(a + kk * 32, 16, 1024),
                  gmma_desc(b + kk * 16 * 128, kPreBK * 128, 1024), accumulate | (kk > 0));
  wg_commit();
}

// Output tile t as its first row and column: groups of kGroupM m tiles, m
// fastest within a group, so the tiles in flight together share x rows and
// weight columns in L2.
__device__ __forceinline__ void pre_tile(int t, int nm, int nn, int bn, int& m0, int& n0) {
  const int per = kGroupM * nn, grp = t / per, first = grp * kGroupM;
  const int gm = min(nm - first, kGroupM), r = t - grp * per;
  m0 = (first + r % gm) * kPreBM;
  n0 = (r / gm) * bn;
}

// Persistent: gridDim.x blocks (at most one an SM) take the 128 x 128 output
// tiles t = blockIdx.x, + gridDim.x, ...; the stage ring runs on across
// tiles, so the producer loads the next tile while the consumers finish the
// last one.
__global__ void __launch_bounds__(kPreThreads, 1)
swiglu_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap umap,
                    const __grid_constant__ CUtensorMap omap, int M, int D, int F) {
  constexpr int ST = kPreStages, BN = kPreBN, CT = BN / 64;  // CT: 64-wide column tiles
  extern __shared__ __align__(1024) unsigned char smem_sw[];
  const uint32_t base = (smem_u32(smem_sw) + 1023u) & ~1023u;
  const uint32_t bar_full = base, bar_empty = base + 8 * ST;
  const uint32_t stages = base + 1024, so = stages + ST * kPreStageBytes;
  // warp and warpgroup broadcast from lane 0, so the compiler knows them
  // uniform across the warp (it serialises a wgmma in a branch it cannot
  // prove uniform)
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0), wg = warp >> 2;
  const int nm = (M + kPreBM - 1) / kPreBM, nn = (F + BN - 1) / BN, tiles = nm * nn;
  const int nk = (D + kPreBK - 1) / kPreBK;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int s_all = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        pre_tile(t, nm, nn, BN, m0, n0);
        for (int kb = 0; kb < nk; ++kb, ++s_all) {
          const int st = s_all % ST;
          const uint32_t sa = stages + st * kPreStageBytes, sb = sa + kPreABytes;
          const uint32_t full = bar_full + 8 * st;
          mbar_wait(bar_empty + 8 * st, ((s_all / ST) & 1) ^ 1);
          mbar_expect_tx(full, kPreStageBytes);
          tma_load_2d(sa, &xmap, full, kb * kPreBK, m0);
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            tma_load_2d(sb + c * kPreBK * 128, &gmap, full, n0 + 64 * c, kb * kPreBK);
            tma_load_2d(sb + (CT + c) * kPreBK * 128, &umap, full, n0 + 64 * c, kb * kPreBK);
          }
        }
      }
    }
  } else {  // consumer warpgroups 0 and 1: 64 rows each, both products
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int gid = lane >> 2, tig = lane & 3, wrow = 16 * (warp & 3) + gid;
    const uint32_t ot = so + wg * 64 * 128;  // this warpgroup's rows of the output tile
    float acc[BN];                           // gate columns in [0, BN/2), up in [BN/2, BN)
#pragma unroll
    for (int i = 0; i < BN; ++i) acc[i] = 0.0f;
    int s_all = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      pre_tile(t, nm, nn, BN, m0, n0);
      // Stage kb's products are issued before stage kb-1's are waited on,
      // and stage kb-1 is then handed back to the producer. No product
      // sits in a branch: the first stage is peeled off the loop.
      int st = s_all % ST;
      mbar_wait(bar_full + 8 * st, (s_all / ST) & 1);
      wg_fence();
      issue_stage(acc, stages + st * kPreStageBytes, wg, 0);
      int prev = st;
      ++s_all;
      for (int kb = 1; kb < nk; ++kb, ++s_all) {
        st = s_all % ST;
        mbar_wait(bar_full + 8 * st, (s_all / ST) & 1);
        wg_fence();
        issue_stage(acc, stages + st * kPreStageBytes, wg, 1);
        wg_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
        prev = st;
      }
      wg_wait<0>();
      fence_regs<BN>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
      // Epilogue: the gate in registers, rounded to bf16 into this
      // warpgroup's half of the output tile (128-byte swizzled, as the
      // map's boxes are), stored with TMA; rows >= M and columns >= F fall
      // outside the map and are not written.
      if ((tid & 127) == 0) tma_store_drain();  // the last tile's store has read it
      wg_barrier(wg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = wrow + 8 * r;
          const float* g = acc + 4 * j + 2 * r;
          const float* u = g + BN / 2;
          const uint32_t at =
              ot + (j >> 3) * kPreBM * 128 + rr * 128 + (((j & 7) ^ (rr & 7)) << 4) + tig * 4;
          const uint32_t val = pack_bf16(gate(g[0], u[0]), gate(g[1], u[1]));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(val) : "memory");
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_barrier(wg);
      if ((tid & 127) == 0) {
#pragma unroll
        for (int c = 0; c < CT; ++c)
          tma_store_2d(&omap, ot + c * kPreBM * 128, n0 + 64 * c, m0 + 64 * wg);
      }
    }
    if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ------------------------ bf16 decode: split-K weight stream, cluster sum
constexpr int kDecThreads = 256;
constexpr int kDecCols = 64;      // F columns of each product a block
constexpr int kDecChunk = 32;     // D rows a TMA box: kc is a multiple
constexpr int kDecMaxKC = 256;    // D rows a block at most
constexpr int kDecMaxSplits = 8;  // blocks of a cluster: the splits of D

// Shared memory of a decode block with MT rows a pass and kc rows of D: 1 KB
// of alignment slack, the Wg and Wu tiles (kc x 128 bytes each), x's rows in
// f32, the eight warps' partial sums, the block's sums and an mbarrier a
// chunk of rows.
__host__ __device__ constexpr int dec_smem(int MT, int kc) {
  return 1024 + 2 * kc * 128 + 4 * MT * kc + 4 * (kDecThreads / 32) * MT * 2 * kDecCols +
         4 * MT * 2 * kDecCols + 8 * (kDecMaxKC / kDecChunk);
}

// Block (F tile of 64 columns, split of kc rows of D): TMA loads bring
// Wg[k0:k0+kc, n0:n0+64] and Wu's into shared memory in chunks of 32 rows,
// all in flight at once (rows past D and columns past F read as zeros),
// while the threads stage MT of x's rows as f32. A thread takes 8 columns of
// one product on every 16th row, FMA in f32 over MT rows, a chunk at a time
// as its barrier completes, so the products overlap the loads still in
// flight. The split's sums stay in shared memory; the F tile's splits are
// one cluster, and each of its blocks adds a share of the tile's outputs
// over every split, in split order, from the splits' shared memory, and
// applies the gate. Passes of MT rows cover M.
template <int MT>
__global__ void __launch_bounds__(kDecThreads)
swiglu_splitk_kernel(const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap umap, const __nv_bfloat16* __restrict__ x,
                     __nv_bfloat16* __restrict__ out, int M, int D, int F, int kc) {
  constexpr int W = kDecThreads / 32, NC = 2 * kDecCols;
  extern __shared__ __align__(1024) unsigned char smem_dec[];
  unsigned char* sm = smem_dec + ((1024u - (smem_u32(smem_dec) & 1023u)) & 1023u);
  const uint32_t slab = smem_u32(sm);                     // Wg's tile, then Wu's: 128-byte rows
  float* xs = reinterpret_cast<float*>(sm + 2 * kc * 128);  // [MT][kc]
  float* red = xs + MT * kc;                                // [W][MT][NC]
  float* part = red + W * MT * NC;                          // [MT][NC], read across the cluster
  const uint32_t bar = smem_u32(part + MT * NC);            // chunk j's at bar + 8j
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.y, splits = gridDim.y;  // cluster (1, splits): its rank is split
  const int n0 = blockIdx.x * kDecCols, k0 = split * kc, kn = min(kc, D - k0);
  const int chunks = (kn + kDecChunk - 1) / kDecChunk;
  const int prod = (tid >> 3) & 1, ch = tid & 7, kr = tid >> 4;  // kr: 0..15
  if (tid == 0) {
    for (int j = 0; j < chunks; ++j) mbar_init(bar + 8 * j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < chunks; ++j) {
      const uint32_t at = slab + j * kDecChunk * 128;
      mbar_expect_tx(bar + 8 * j, 2 * kDecChunk * 128);
      tma_load_2d(at, &gmap, bar + 8 * j, n0, k0 + j * kDecChunk);
      tma_load_2d(at + kc * 128, &umap, bar + 8 * j, n0, k0 + j * kDecChunk);
    }
  }
  const unsigned char* wt = sm + prod * kc * 128;
  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mr = min(MT, M - m0);
    __syncthreads();  // the last pass is done with xs and red (the first: the barriers' init)
    for (int i = tid; i < MT * kn; i += kDecThreads) {
      const int m = i / kn, kk = i - m * kn;
      xs[m * kc + kk] = m < mr ? __bfloat162float(x[(size_t)(m0 + m) * D + k0 + kk]) : 0.0f;
    }
    __syncthreads();
    float acc[MT][8];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] = 0.0f;
    for (int j = 0; j < chunks; ++j) {
      mbar_wait(bar + 8 * j, 0);  // chunk j has landed (complete from the first pass on)
#pragma unroll
      for (int h = 0; h < kDecChunk; h += 16) {
        const int r = j * kDecChunk + h + kr;
        if (r >= kn) break;
        // row r's 16-byte chunk ch, where the 128-byte swizzle put it
        const uint4 v = *reinterpret_cast<const uint4*>(wt + r * 128 + (((r & 7) ^ ch) << 4));
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
        float wf[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) wf[c] = __bfloat162float(e[c]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m * kc + r];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
        }
      }
    }
    // rows kr and kr + 1 of a warp (lanes l and l ^ 16), then the W warps
    // in order: a fixed summing order, so a call repeats bit for bit
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] += __shfl_xor_sync(0xFFFFFFFFu, acc[m][c], 16);
    if (lane < 16) {
      float* rw = red + warp * MT * NC + prod * kDecCols + ch * 8;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        *reinterpret_cast<float4*>(rw + m * NC) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        *reinterpret_cast<float4*>(rw + m * NC + 4) =
            make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
      }
    }
    __syncthreads();
    for (int i = tid; i < MT * NC; i += kDecThreads) {
      float s = 0.0f;
#pragma unroll
      for (int ww = 0; ww < W; ++ww) s += red[ww * MT * NC + i];
      part[i] = s;
    }
    cluster.sync();  // every split's sums are in its shared memory
    // the tile's outputs dealt over the cluster's blocks; each reads its
    // output's sums from every split (all loads in flight together), then
    // adds them in split order
    for (int i = split * kDecThreads + tid; i < mr * kDecCols; i += splits * kDecThreads) {
      const int m = i / kDecCols, c = i % kDecCols;
      if (n0 + c >= F) continue;
      float pg[kDecMaxSplits], pu[kDecMaxSplits];
#pragma unroll
      for (int r = 0; r < kDecMaxSplits; ++r) {
        if (r < splits) {
          const float* p = cluster.map_shared_rank(part, r);
          pg[r] = p[m * NC + c];
          pu[r] = p[m * NC + kDecCols + c];
        }
      }
      float g = 0.0f, u = 0.0f;
#pragma unroll
      for (int r = 0; r < kDecMaxSplits; ++r) {
        if (r < splits) {
          g += pg[r];
          u += pu[r];
        }
      }
      out[(size_t)(m0 + m) * F + n0 + c] = __float2bfloat16_rn(gate(g, u));
    }
    cluster.sync();  // every block has read the splits' sums before they change or it exits
  }
}

bool bad_shape(int M, int D, int F) {
  return M < 1 || D < 1 || F < 1 || (F + kBN - 1) / kBN > 65535;
}

int sm_count(int& sms) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int launch_wgmma(const void* x, const void* wg, const void* wu, void* out, int M, int D, int F,
                 cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      swiglu_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPreSmem);
  if (attr != cudaSuccess) return (int)attr;
  int sms = 0;
  if (const int rc = sm_count(sms)) return rc;
  const long long tiles = (long long)((M + kPreBM - 1) / kPreBM) * ((F + kPreBN - 1) / kPreBN);
  CUtensorMap xm, gm, um, om;
  if (tiles > 2147483647LL || !make_map_2d(&xm, x, D, M, D, kPreBM) ||
      !make_map_2d(&gm, wg, F, D, F, kPreBK) || !make_map_2d(&um, wu, F, D, F, kPreBK) ||
      !make_map_2d(&om, out, F, M, F, 64))
    return (int)cudaErrorInvalidValue;
  const int grid = tiles < sms ? (int)tiles : sms;
  swiglu_wgmma_kernel<<<grid, kPreThreads, kPreSmem, st>>>(xm, gm, um, om, M, D, F);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_splitk(const void* x, const void* wg, const void* wu, void* out, int M, int D, int F,
                  int splits, int kc, cudaStream_t st) {
  constexpr int max_smem = dec_smem(MT, kDecMaxKC);
  static const cudaError_t attr = cudaFuncSetAttribute(
      swiglu_splitk_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap gm, um;
  if (!make_map_2d(&gm, wg, F, D, F, kDecChunk) || !make_map_2d(&um, wu, F, D, F, kDecChunk))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((F + kDecCols - 1) / kDecCols, splits, 1);
  cfg.blockDim = dim3(kDecThreads, 1, 1);
  cfg.dynamicSmemBytes = dec_smem(MT, kc);
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = splits;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, swiglu_splitk_kernel<MT>, gm, um,
                         static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
                         M, D, F, kc);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
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

// The Hopper prefill route: x (M, D), wg and wu (D, F), out (M, F), bf16,
// row-major, D and F multiples of 8 and every pointer 16-byte aligned (TMA).
extern "C" int swiglu_wgmma(const void* x, const void* wg, const void* wu, void* out, int M,
                            int D, int F, void* stream) {
  if (bad_shape(M, D, F) || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  return launch_wgmma(x, wg, wu, out, M, D, F, static_cast<cudaStream_t>(stream));
}

// The decode route: the same operands, F a multiple of 8 and the weights
// 16-byte aligned (TMA); D cut into `splits` (<= 8) ranges of kc rows (a
// multiple of 32, <= 256), one cluster of `splits` blocks an F tile of 64
// columns; x's rows four at a time for M <= 4, else eight.
extern "C" int swiglu_splitk(const void* x, const void* wg, const void* wu, void* out, int M,
                             int D, int F, int splits, int kc, void* stream) {
  if (bad_shape(M, D, F) || F % 8 || splits < 1 || splits > kDecMaxSplits || kc < kDecChunk ||
      kc > kDecMaxKC || kc % kDecChunk || (long long)kc * splits < D ||
      (long long)kc * (splits - 1) >= D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4) return launch_splitk<4>(x, wg, wu, out, M, D, F, splits, kc, st);
  return launch_splitk<8>(x, wg, wu, out, M, D, F, splits, kc, st);
}
