// Block-sparse matmul for Hopper (sm_90a): y = x W over the kept
// (block x block) blocks of W, and the two products of its backward.
//
// Replaces the Pallas kernel `_mm_kernel` (`_call`) of
// torchpruner_tpu/ops/blocksparse.py, which that file runs in three grid
// layouts:
//   tp_bs_fwd <- `_bs_fwd`: y (R, F) = x (R, D) W (D, F), contracting the
//                kept input blocks; dropped output columns exactly 0
//   tp_bs_dx  <- `_bs_dx`:  dx (R, D) = g (R, F) W^T, contracting the kept
//                output blocks; dropped input columns exactly 0
//   tp_bs_dw  <- `_bs_dw`:  dW (D, F) = x^T g on the kept (in x out)
//                blocks; every other block exactly 0
// All tensors are row-major and contiguous, f32 or bf16 (one type per
// call, f32 accumulation).  `in_keep` / `out_keep` are int32 device
// arrays of kept block indices (any order, no duplicates); `block` is a
// multiple of 32 that divides D and F.
//
// Bound on the H100: operations at the path's shapes (R 4096: ~2 R
// operations per weight byte, far above the card's ~295 bf16 / ~20 f32
// operations per byte), so what counts is that dropped blocks are
// neither read nor multiplied, and that the kept ones run at the tensor
// cores' rate.  Three bodies, chosen by `plan` from the shapes alone:
//
// bf16, block a multiple of 64: `bs_wgmma`, a gathered GEMM on Hopper's
// warpgroup products.  The kept set is in_keep x out_keep, so each mode
// is a dense product over the kept rows and columns of W: a CTA maps its
// tile through the keep lists in 64-wide chunks (a tile may span kept
// blocks that lie apart), as a grouped GEMM does:
//   - one producer thread starts 2-d TMA boxes (64 columns in the 128-byte
//     swizzle, the layout TMA writes and wgmma reads) into a ring of 2-8
//     stages of 64 contracted elements with full / empty mbarriers; the
//     coordinate of a chunk is keep[v / block] * block + v % block, from
//     the keep lists the CTA copies into shared memory once;
//   - two consumer warpgroups of 64 output rows each run
//     wgmma.mma_async m64nNk16 (N = the tile's 64, 128 or 192 columns),
//     f32 sums in registers, a stage's products started while the previous
//     stage's retire; operand major-ness per mode, W (D, F):
//       fwd: A = x K-major,          B = W MN-major
//       dx:  A = g K-major,          B = W read as (N = D, K = F), K-major
//       dW:  A = x^T MN-major,       B = g MN-major
//     so no transpose is ever made;
//   - the kernel is bound by what its CTAs read from L2, so tiles are as
//     wide as the registers allow (128 x 192: 96 sums a thread);
//   - fwd and dx are persistent: min(132, tiles) CTAs walk the kept
//     tiles, the ring filling for the next tile while the consumers round
//     this one into a swizzled bf16 staging tile that one thread stores
//     by TMA (clipped at R); dW has few kept tiles (48 at BERT-base) and
//     R to contract, so R is split over a thread-block cluster of `split`
//     CTAs that own one tile, and their f32 partials are summed through
//     distributed shared memory in rank order (no atomics, no global
//     scratch: dW is bit-equal from run to run), staged and stored alike;
//   - the dropped output tiles are written as exact zeros by the same
//     launch: the producer warpgroup's three idle warps walk them with
//     16-byte stores while the products run;
//   - TMA zero-fills rows past R and never stores them, so every R >= 1
//     launches; each output is rounded to bf16 once.
// bf16, block an odd multiple of 32 (32, 96, ...): `bs_kernel` with
// `MmaTile`, the earlier wmma body (16x16x16 fragments, register-staged
// single-buffered copies), since a wgmma tile is 64 rows.
// f32: `bs_kernel` with `FmaTile` on the FMA units at full f32 (no TF32),
// each thread a strided micro-tile of the output, tiles staged through
// registers into shared memory.  In both `bs_kernel` bodies one CTA owns
// one output tile of the whole output and loops over the contraction
// (the TPU carried the accumulator across a sequential grid axis), a CTA
// whose tile lies in a dropped block writes zeros and leaves, and dW is
// not split over R.
//
// `tp_bs_plan` returns the plan a call takes (body, tile, stages, split,
// CTAs, dynamic shared memory), a function of (mode, R, D, F, block,
// n_in, n_out, dtype) alone; ops/blocksparse.py `plan` mirrors it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

using namespace nvcuda;
namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

enum Mode { FWD = 0, DX = 1, DW = 2 };

// per element type: contraction step (DW_BK for dW), elements per 16-byte
// chunk, and the padding of a shared-memory row (f32: odd row length, so the 16
// lanes of a column group hit distinct banks; bf16: 16 bytes, which
// keeps rows 16-byte aligned and fragments 32-byte aligned)
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int BK = 16, DW_BK = 64, VEC = 4, PAD = 1;
};
template <>
struct Elem<bf16> {
  static constexpr int BK = 32, DW_BK = 32, VEC = 8, PAD = 8;
};

// Operand tiles as stored in shared memory.  With C (TM, TN) = A B:
//   FWD: A = x tile (TM, BK),        B = W tile (BK, TN)
//   DX:  A = g tile (TM, BK),        B^T = W tile (TN, BK)
//   DW:  A^T = x tile (BK, TM),      B = g tile (BK, TN)
// dW contracts the rows, thousands of short steps for one small tile.
// In f32 a 4x longer step (a quarter as many waits on global memory)
// measured 1.7x faster at BERT-base's shapes on the H100; in bf16 it
// measured no faster at fc1 and 16 % slower at R 1024, so bf16 keeps BK.
template <typename T, int MODE, int TM, int TN>
struct Shape {
  static constexpr int BK = MODE == DW ? Elem<T>::DW_BK : Elem<T>::BK;
  static constexpr int AR = MODE == DW ? BK : TM;
  static constexpr int AC = MODE == DW ? TM : BK;
  static constexpr int BR = MODE == DX ? TN : BK;
  static constexpr int BC = MODE == DX ? BK : TN;
  static constexpr int LDA = AC + Elem<T>::PAD;
  static constexpr int LDB = BC + Elem<T>::PAD;
};

__device__ __forceinline__ void put_chunk(float* p, uint4 v) {
  p[0] = __uint_as_float(v.x);
  p[1] = __uint_as_float(v.y);
  p[2] = __uint_as_float(v.z);
  p[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void put_chunk(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// One (NR, NC) tile on its way from global to shared memory, held in
// registers as 16-byte chunks (rows at or past `row_limit` are zeros).
template <typename T, int NR, int NC, int THREADS>
struct Stage {
  static constexpr int VEC = Elem<T>::VEC;
  static constexpr int CPR = NC / VEC;  // chunks per row
  static constexpr int CH = NR * CPR;
  static constexpr int N = (CH + THREADS - 1) / THREADS;
  uint4 v[N];

  __device__ __forceinline__ void fetch(const T* __restrict__ src, int ld,
                                        int row0, int col0, int row_limit) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int r = c / CPR;
      const int col = (c - r * CPR) * VEC;
      if (c < CH && row0 + r < row_limit)
        v[i] = *reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * ld + col0 + col);
      else
        v[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(T* dst, int ldd) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * THREADS;
      if (c < CH) {
        const int r = c / CPR;
        const int col = (c - r * CPR) * VEC;
        put_chunk(dst + r * ldd + col, v[i]);
      }
    }
  }
};

// f32 on the FMA units: 256 threads as 16 x 16, thread (ty, tx) owns the
// output entries (ty + 16 i, tx + 16 j)
template <int MODE, int TM, int TN, int THREADS>
struct FmaTile {
  static_assert(THREADS == 256, "the f32 tile is 16 x 16 threads");
  using S = Shape<float, MODE, TM, TN>;
  static constexpr int MI = TM / 16, NJ = TN / 16;
  float acc[MI][NJ];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void step(const float* As, const float* Bs) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int k = 0; k < S::BK; ++k) {
      float av[MI], bv[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        av[i] = MODE == DW ? As[k * S::LDA + ty + 16 * i]
                           : As[(ty + 16 * i) * S::LDA + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        bv[j] = MODE == DX ? Bs[(tx + 16 * j) * S::LDB + k]
                           : Bs[k * S::LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void write(float* __restrict__ out, int ld,
                                        int m0, int n0, int row_limit,
                                        float* /*patch*/) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= row_limit) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        out[(long long)row * ld + n0 + tx + 16 * j] = acc[i][j];
    }
  }
};

// bf16 on the tensor cores: the warps as 2 x (WARPS / 2), each warp a
// (TM / 2, TN / (WARPS / 2)) part of the tile in 16 x 16 fragments
template <int MODE, int TM, int TN, int THREADS>
struct MmaTile {
  using S = Shape<bf16, MODE, TM, TN>;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int WR = 2, WC = WARPS / 2;
  static constexpr int WTM = TM / WR, WTN = TN / WC;
  static constexpr int FM = WTM / 16, FN = WTN / 16;
  static_assert(FM >= 1 && FN >= 1 && WTM % 16 == 0 && WTN % 16 == 0,
                "a warp's part is whole 16 x 16 fragments");
  using ALayout = typename std::conditional<MODE == DW, wmma::col_major,
                                            wmma::row_major>::type;
  using BLayout = typename std::conditional<MODE == DX, wmma::col_major,
                                            wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ __forceinline__ void step(const bf16* As, const bf16* Bs) {
    const int warp = threadIdx.x >> 5;
    const int wm = warp / WC, wn = warp % WC;
#pragma unroll
    for (int kk = 0; kk < S::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = wm * WTM + i * 16;
        wmma::load_matrix_sync(
            fa[i], MODE == DW ? As + kk * S::LDA + m : As + m * S::LDA + kk,
            S::LDA);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = wn * WTN + j * 16;
        wmma::load_matrix_sync(
            fb[j], MODE == DX ? Bs + n * S::LDB + kk : Bs + kk * S::LDB + n,
            S::LDB);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // each fragment goes through the warp's own (16, 16) f32 patch of
  // shared memory; a lane then rounds and writes 8 neighbouring entries
  __device__ __forceinline__ void write(bf16* __restrict__ out, int ld,
                                        int m0, int n0, int row_limit,
                                        float* patch_all) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp / WC, wn = warp % WC;
    float* patch = patch_all + warp * 256;
    const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(patch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = m0 + wm * WTM + i * 16 + r;
        if (row < row_limit) {
          const float* p = patch + r * 16 + c;
          __nv_bfloat162 h0 = __floats2bfloat162_rn(p[0], p[1]);
          __nv_bfloat162 h1 = __floats2bfloat162_rn(p[2], p[3]);
          __nv_bfloat162 h2 = __floats2bfloat162_rn(p[4], p[5]);
          __nv_bfloat162 h3 = __floats2bfloat162_rn(p[6], p[7]);
          uint4 v;
          v.x = *reinterpret_cast<uint32_t*>(&h0);
          v.y = *reinterpret_cast<uint32_t*>(&h1);
          v.z = *reinterpret_cast<uint32_t*>(&h2);
          v.w = *reinterpret_cast<uint32_t*>(&h3);
          *reinterpret_cast<uint4*>(out + (long long)row * ld + n0 +
                                    wn * WTN + j * 16 + c) = v;
        }
        __syncwarp();
      }
  }
};

template <typename T, int MODE, int TM, int TN, int THREADS>
struct Pick {
  typedef typename std::conditional<
      std::is_same<T, float>::value, FmaTile<MODE, TM, TN, THREADS>,
      MmaTile<MODE, TM, TN, THREADS> >::type type;
};

__device__ __forceinline__ bool listed(const int* __restrict__ keep, int n,
                                       int blk) {
  bool hit = false;
  for (int i = 0; i < n; ++i) hit = hit || keep[i] == blk;
  return hit;
}

// a, b, out per mode:
//   FWD: x (R, D), W (D, F) -> y (R, F)
//   DX:  g (R, F), W (D, F) -> dx (R, D)
//   DW:  x (R, D), g (R, F) -> dW (D, F)
// 1-D grid: row tile x column tile of the whole output, columns fastest.
template <typename T, int MODE, int TM, int TN, int THREADS>
__global__ void __launch_bounds__(THREADS)
bs_kernel(const T* __restrict__ a, const T* __restrict__ b,
          T* __restrict__ out, const int* __restrict__ ii,
          const int* __restrict__ oo, int n_in, int n_out, int R, int D,
          int F, int block) {
  using S = Shape<T, MODE, TM, TN>;
  using Tile = typename Pick<T, MODE, TM, TN, THREADS>::type;
  constexpr int BK = S::BK;
  constexpr int VEC = Elem<T>::VEC;
  constexpr bool TC = !std::is_same<T, float>::value;
  __shared__ __align__(32) unsigned char a_raw[S::AR * S::LDA * sizeof(T)];
  __shared__ __align__(32) unsigned char b_raw[S::BR * S::LDB * sizeof(T)];
  __shared__ __align__(32) float patch[TC ? (THREADS / 32) * 256 : 8];
  T* As = reinterpret_cast<T*>(a_raw);
  T* Bs = reinterpret_cast<T*>(b_raw);

  const int out_ld = MODE == DX ? D : F;
  const int n_ct = out_ld / TN;
  const int ct = blockIdx.x % n_ct, rt = blockIdx.x / n_ct;
  const int m0 = rt * TM, n0 = ct * TN;
  const int row_limit = MODE == DW ? D : R;

  bool kept = MODE == DX ? listed(ii, n_in, n0 / block)
                         : listed(oo, n_out, n0 / block);
  if (MODE == DW) kept = kept && listed(ii, n_in, m0 / block);
  if (!kept) {  // the whole CTA: a tile of a dropped block is zeros
    constexpr int CPR = TN / VEC;
    for (int c = threadIdx.x; c < TM * CPR; c += THREADS) {
      const int r = c / CPR;
      const int col = (c - r * CPR) * VEC;
      if (m0 + r < row_limit)
        *reinterpret_cast<uint4*>(out + (long long)(m0 + r) * out_ld + n0 +
                                  col) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int spb = block / BK;  // contraction steps per kept block
  const int steps = MODE == FWD  ? n_in * spb
                    : MODE == DX ? n_out * spb
                                 : (R + BK - 1) / BK;
  Stage<T, S::AR, S::AC, THREADS> ra;
  Stage<T, S::BR, S::BC, THREADS> rb;
  auto fetch = [&](int s) {
    if (MODE == DW) {
      const int r0 = s * BK;
      ra.fetch(a, D, r0, m0, R);
      rb.fetch(b, F, r0, n0, R);
    } else {
      const int t = s / spb;
      const int kc =
          (MODE == FWD ? ii[t] : oo[t]) * block + (s - t * spb) * BK;
      if (MODE == FWD) {
        ra.fetch(a, D, m0, kc, R);
        rb.fetch(b, F, kc, n0, D);
      } else {
        ra.fetch(a, F, m0, kc, R);
        rb.fetch(b, F, n0, kc, D);
      }
    }
  };

  Tile tile;
  tile.init();
  fetch(0);
  ra.store(As, S::LDA);
  rb.store(Bs, S::LDB);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) fetch(s + 1);  // in flight while this step's products run
    tile.step(As, Bs);
    __syncthreads();
    if (more) {
      ra.store(As, S::LDA);
      rb.store(Bs, S::LDB);
      __syncthreads();
    }
  }
  tile.write(out, out_ld, m0, n0, row_limit, patch);
}

template <typename T, int MODE, int TM, int TN, int THREADS>
cudaError_t launch(const void* a, const void* b, void* out, const int* ii,
                   const int* oo, int n_in, int n_out, int R, int D, int F,
                   int block, cudaStream_t s) {
  const long long n_rt = MODE == DW ? D / TM : (R + TM - 1) / TM;
  const long long grid = n_rt * ((MODE == DX ? D : F) / TN);
  if (grid <= 0 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  bs_kernel<T, MODE, TM, TN, THREADS><<<(unsigned)grid, THREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), ii, oo, n_in, n_out, R, D, F, block);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16: wgmma body

constexpr int WG = 128;          // threads of a warpgroup
constexpr int BK = 64;           // contracted elements of a ring stage
constexpr int CH = 64;           // rows or columns of a swizzled chunk
constexpr int CHUNK = CH * 128;  // bytes of a (64, 64) bf16 chunk
constexpr int BM = 128;          // output rows of a tile: two consumers
constexpr int NT = 2 * WG;       // consumer threads
constexpr int THREADS = 3 * WG;  // two consumer warpgroups, a producer
constexpr int SMS = 132;         // the H100 SXM's SMs: the persistent grid
constexpr int SMEM_LIMIT = 232448;  // shared memory a CTA can have
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLIT = 8;     // the portable cluster size
constexpr int MIN_SPLIT_STEPS = 4;  // ring stages a dW rank contracts, at least
// the cost model of the plan, in chunk rows moved from L2: a ring stage
// of a (BM, BN) tile moves BM + BN; a tile's or a CTA's fixed cost (its
// first fill, its epilogue, a dW reduction) is about 6 stages of (128, 128)
constexpr int FIXED_COST = 6 * 256;

enum Body { BODY_FMA = 0, BODY_WMMA = 1, BODY_WGMMA = 2 };

struct Plan {
  int body, bm, bn, stages, split, ctas, tiles;
  long long smem;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// dynamic shared memory of the wgmma body: the 1024-aligned ring, the
// output tile's bf16 staging, the ring's barriers, the keep lists and one
// kept flag per block of D and of F
long long wgmma_smem(int bn, int stages, int n_in, int n_out, int D, int F,
                     int block) {
  return 1024 + (long long)stages * (BM + bn) * BK * 2 + BM * bn * 2 +
         16LL * stages +
         cdiv(4LL * (n_in + n_out), 16) * 16 +
         cdiv((long long)D / block + F / block, 16) * 16;
}

// The launch plan, from the shapes alone.  The wgmma body's tiles are
// 128 rows by 64, 128 or 192 columns, both axes gathered in 64-wide
// chunks through the keep lists (so a tile may span kept blocks); the
// tile width, and dW's split of R over a cluster of 1, 2, 4 or 8 CTAs
// (each at least MIN_SPLIT_STEPS stages), minimize rounds of 132 CTAs x
// (stages x (128 + width) + FIXED_COST): the kernel is bound by what its
// CTAs read from L2, and wider tiles read less per product.  fwd / dx run
// min(132, units) persistent CTAs; dW one cluster per tile.  The ring
// takes as many stages (at most 8) as 227 KB holds.  The `bs_kernel`
// bodies (f32; bf16 on odd multiples of 32) take fixed tiles by block:
// f32 fwd / dx (128, 128) on 128-blocks, (64, 64) on 64-blocks, (64, 32)
// else, f32 dW (64, 64) or (32, 32); bf16 (64, 32), dW (32, 32); one CTA
// per output tile, no ring (stages 1), static shared memory (0).
int make_plan(int mode, int R, int D, int F, int block, int n_in, int n_out,
              int dtype, Plan* p) {
  if (R < 1 || block < 32 || block % 32 || D < 1 || F < 1 || D % block ||
      F % block || n_in < 1 || n_out < 1 || n_in > D / block ||
      n_out > F / block || mode < FWD || mode > DW || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  *p = Plan{};
  p->split = 1;
  p->stages = 1;
  if (dtype == 0 || block % 64) {
    const bool f32 = dtype == 0;
    p->body = f32 ? BODY_FMA : BODY_WMMA;
    if (mode == DW) {
      p->bm = p->bn = (f32 && block % 64 == 0) ? 64 : 32;
    } else if (f32 && block % 64 == 0) {
      p->bm = p->bn = block % 128 == 0 ? 128 : 64;
    } else {
      p->bm = 64, p->bn = 32;
    }
    const long long rows = mode == DW ? D / p->bm : cdiv(R, p->bm);
    p->ctas = (int)(rows * ((mode == DX ? D : F) / p->bn));
    p->tiles = p->ctas;
    return 0;
  }
  p->body = BODY_WGMMA;
  p->bm = BM;
  const long long rows = mode == DW ? (long long)n_in * block : R;
  const long long cols = (long long)(mode == DX ? n_in : n_out) * block;
  const long long steps = mode == FWD  ? (long long)n_in * block / BK
                          : mode == DX ? (long long)n_out * block / BK
                                       : cdiv(R, BK);
  long long best = -1;
  for (int bn = CH; bn <= 3 * CH; bn += CH) {
    const long long tiles = cdiv(rows, BM) * cdiv(cols, bn);
    for (int s = 1; s <= (mode == DW ? MAX_SPLIT : 1); s *= 2) {
      if (s > 1 && steps < (long long)s * MIN_SPLIT_STEPS) break;
      const long long c = cdiv(tiles * s, SMS) *
                          (cdiv(steps, s) * (BM + bn) + FIXED_COST);
      if (best < 0 || c < best) {
        best = c;
        p->bn = bn;
        p->split = s;
        p->tiles = (int)(tiles < 0x7fffffff ? tiles : 0x7fffffff);
      }
    }
  }
  if (best < 0 || (long long)p->tiles * p->split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (mode == DW) {
    p->ctas = p->tiles * p->split;
  } else {  // the CTAs also write the dropped (64-row, block) units
    const long long units =
        cdiv(R, CH) * ((mode == FWD ? F : D) / block) + p->tiles;
    p->ctas = (int)(units < SMS ? units : SMS);
  }
  const long long stage = (long long)(BM + p->bn) * BK * 2;
  const long long fixed =
      wgmma_smem(p->bn, 0, n_in, n_out, D, F, block) + 16LL * MAX_STAGES;
  const long long fit = (SMEM_LIMIT - fixed) / stage;
  p->stages = (int)(fit < MAX_STAGES ? fit : MAX_STAGES);
  // dW's partial sums (BM x BN f32) reuse the drained ring
  if (p->stages < 2 || p->stages * stage < (long long)BM * p->bn * 4)
    return (int)cudaErrorInvalidValue;
  p->smem = wgmma_smem(p->bn, p->stages, n_in, n_out, D, F, block);
  return 0;
}

// One kept output tile in real coordinates: the rows of its two 64-row
// chunks (fwd / dx: m[0] is the first row, rows are contiguous), the
// columns of its BN / 64 column chunks, how many of those chunks are
// real (a chunk past the kept width loads the last real one again and is
// never stored), and its ring stages [kb, ke).
template <int BN>
struct TileAt {
  int m[2], n[BN / CH];
  int mv, nv, kb, ke;
};

// element v of the gathered axis whose kept blocks are keep[0 .. n)
__device__ __forceinline__ int gathered(const int* keep, int v, int block) {
  return keep[v / block] * block + v % block;
}

// a: fwd x, dx g, dW x; b: fwd W, dx W, dW g (their tensor maps ta, tb:
// boxes of 64 columns by 128 rows for the fwd / dx activations, by 64
// rows otherwise); out: fwd y (R, F), dx dx (R, D), dW dW (D, F).  Grid:
// `split` CTAs per cluster; cluster c walks kept tiles c, c + clusters, ...
template <int MODE, int BN>
__global__ void __launch_bounds__(THREADS, 1)
bs_wgmma(const __grid_constant__ CUtensorMap ta,
         const __grid_constant__ CUtensorMap tb,
         const __grid_constant__ CUtensorMap to, bf16* __restrict__ out,
         const int* __restrict__ ii, const int* __restrict__ oo, int n_in,
         int n_out, int R, int D, int F, int block, int stages, int split,
         int tiles) {
  constexpr int NC = BN / CH;  // column chunks of a tile
  constexpr int A_BYTES = BM * BK * 2;
  constexpr int STAGE = A_BYTES + BN * BK * 2;
  constexpr int ACC = BN / 2;  // f32 sums a consumer thread holds
  extern __shared__ unsigned char raw[];
  unsigned char* ring = align1024(raw);
  unsigned char* staging = ring + stages * STAGE;  // (BM, BN) bf16, swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + BM * BN * 2);
  uint64_t* empty = full + stages;
  int* ik = reinterpret_cast<int*>(empty + stages);
  int* ok = ik + n_in;
  unsigned char* fin =
      reinterpret_cast<unsigned char*>(ik + (n_in + n_out + 3) / 4 * 4);
  const int nbd = D / block, nbf = F / block;
  unsigned char* fout = fin + nbd;

  const int tid = threadIdx.x, wg = tid / WG, lane = tid & 31;
  for (int i = tid; i < n_in; i += THREADS) ik[i] = ii[i];
  for (int i = tid; i < n_out; i += THREADS) ok[i] = oo[i];
  for (int i = tid; i < nbd + nbf; i += THREADS) fin[i] = 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = tid; i < n_in; i += THREADS) fin[ik[i]] = 1;
  for (int i = tid; i < n_out; i += THREADS) fout[ok[i]] = 1;
  __syncthreads();

  const int rank = blockIdx.x % split;
  const int cluster0 = blockIdx.x / split, clusters = gridDim.x / split;
  const int out_ld = MODE == DX ? D : F;
  const int row_limit = MODE == DW ? D : R;
  // the gathered axes: columns of the output, rows of dW, the
  // contraction of fwd / dx
  const int* col_keep = MODE == DX ? ik : ok;
  const int cols = (MODE == DX ? n_in : n_out) * block;
  const int col_tiles = (cols + BN - 1) / BN;
  const int* k_keep = MODE == FWD ? ik : ok;
  auto tile_at = [&](int t) {
    TileAt<BN> a;
    const int rt = t / col_tiles, ct = t - rt * col_tiles;
    a.nv = min(NC, (cols - ct * BN) / CH);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      a.n[c] = gathered(col_keep, ct * BN + min(c, a.nv - 1) * CH, block);
    if (MODE == DW) {
      a.mv = min(2, (n_in * block - rt * BM) / CH);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        a.m[c] = gathered(ik, rt * BM + min(c, a.mv - 1) * CH, block);
      const int steps = (R + BK - 1) / BK;
      const int per = (steps + split - 1) / split;
      a.kb = rank * per;
      a.ke = min(steps, a.kb + per);
    } else {
      a.mv = 2;
      a.m[0] = rt * BM;
      a.m[1] = rt * BM + CH;
      a.kb = 0;
      a.ke = (MODE == FWD ? n_in : n_out) * (block / BK);
    }
    return a;
  };

  if (wg == 2) {  // the producer warpgroup
    const int warp = (tid - NT) / 32;
    if (warp == 0) {
      if (lane == 0) {  // TMA: the kept tiles' stages into the ring
        int it = 0;
        for (int t = cluster0; t < tiles; t += clusters) {
          const TileAt<BN> a = tile_at(t);
          for (int k = a.kb; k < a.ke; ++k, ++it) {
            const int s = it % stages;
            mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
            unsigned char* as = ring + s * STAGE;
            unsigned char* bs = as + A_BYTES;
            mbar_arrive_tx(&full[s], STAGE);
            if (MODE == DW) {  // x and g chunks: 64 rows of R each
#pragma unroll
              for (int c = 0; c < 2; ++c)
                tma_load_2d(as + c * CHUNK, &ta, a.m[c], k * BK, &full[s]);
#pragma unroll
              for (int c = 0; c < NC; ++c)
                tma_load_2d(bs + c * CHUNK, &tb, a.n[c], k * BK, &full[s]);
            } else {
              const int kc = gathered(k_keep, k * BK, block);
              tma_load_2d(as, &ta, kc, a.m[0], &full[s]);  // 128 rows
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                if (MODE == FWD)  // W rows kc.., columns of chunk c
                  tma_load_2d(bs + c * CHUNK, &tb, a.n[c], kc, &full[s]);
                else  // W rows of chunk c, columns kc..
                  tma_load_2d(bs + c * CHUNK, &tb, kc, a.n[c], &full[s]);
              }
            }
          }
        }
      }
    } else {  // warps 1-3: exact zeros into the dropped (64-row, block) units
      const int zt = tid - NT - 32;
      const long long units_c = out_ld / block;
      const long long units = (long long)((row_limit + CH - 1) / CH) * units_c;
      const int per_row = block / 8;  // 16-byte stores
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const int r0 = (int)(u / units_c) * CH, uc = (int)(u % units_c);
        const bool kept = MODE == FWD  ? fout[uc]
                          : MODE == DX ? fin[uc]
                                       : fin[r0 / block] && fout[uc];
        if (kept) continue;
        for (int c = zt; c < CH * per_row; c += 3 * 32) {
          const int r = r0 + c / per_row, col = uc * block + c % per_row * 8;
          if (r < row_limit)
            *reinterpret_cast<uint4*>(out + (long long)r * out_ld + col) =
                make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  } else {  // consumers: rows 64 wg .. 64 wg + 63 of each tile
    const int r0 = (tid % WG) / 32 * 16 + (lane >> 2), c2 = (lane & 3) * 2;
    float acc[ACC];
    int it = 0;
    for (int t = cluster0; t < tiles; t += clusters) {
      const TileAt<BN> a = tile_at(t);
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
      for (int k = a.kb; k < a.ke; ++k, ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const uint32_t as = smem_u32(ring + s * STAGE);
        const uint32_t bs = as + A_BYTES;
        // A: fwd / dx rows 64 wg.. of the K-major activation tile; dW
        // chunk wg of x, MN-major.  B: fwd and dW MN-major chunks; dx
        // K-major rows (the column chunks stacked)
        const uint64_t da = MODE == DW ? sdesc(as + wg * CHUNK, CHUNK, 1024)
                                       : sdesc(as + wg * CHUNK, 16, 1024);
        const uint64_t db =
            MODE == DX ? sdesc(bs, 16, 1024) : sdesc(bs, CHUNK, 1024);
        fence_regs(acc);
        wg_fence();
        unrolled<BK / 16>([&](auto kk) {
          constexpr int J = decltype(kk)::value;
          // k16 step J: +32 bytes along a K-major row, +16 rows of an
          // MN-major chunk (in 16-byte units)
          constexpr int OA = MODE == DW ? 128 * J : 2 * J;
          constexpr int OB = MODE == DX ? 2 * J : 128 * J;
          wgmma_ss<OA, OB, MODE == DW ? 1 : 0, MODE == DX ? 0 : 1>(acc, da,
                                                                 db);
        });
        wg_commit();
        wg_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (k > a.kb) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
        }
      }
      wg_wait<0>();
      fence_regs(acc);
      if (a.ke > a.kb) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
      }
      if (split == 1 && wg < a.mv) {
        // round once into this warpgroup's (64, BN) staging, in the
        // 128-byte swizzle (conflict-free: a warp's 8 rows hit 8 distinct
        // 16-byte units), then one thread stores it by TMA, clipped at R,
        // while the warpgroup goes on to the next tile's products
        unsigned char* stg = staging + wg * NC * CHUNK;
        if (tid % WG == 0) bulk_wait_read<0>();  // the last tile's store
        asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG) : "memory");
#pragma unroll
        for (int i = 0; i < ACC; i += 2) {
          const int r = r0 + 8 * ((i >> 1) & 1), u = (i >> 2) & 7;
          *reinterpret_cast<uint32_t*>(stg + i / 32 * CHUNK + r * 128 +
                                       ((u ^ (r & 7)) << 4) + c2 * 2) =
              pack_bf16(acc[i], acc[i + 1]);
        }
        fence_async_smem();
        asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG) : "memory");
        if (tid % WG == 0) {
          const int row0 = MODE == DW ? a.m[wg] : a.m[0] + 64 * wg;
          for (int c = 0; c < a.nv; ++c)
            tma_store_2d(&to, stg + c * CHUNK, a.n[c], row0);
          bulk_commit();
        }
      } else if (split > 1) {  // the partial into the drained ring, by pairs
        asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
        float2* part = reinterpret_cast<float2*>(ring);
#pragma unroll
        for (int i = 0; i < ACC; i += 2)
          part[(i / 2) * NT + tid] = make_float2(acc[i], acc[i + 1]);
      }
    }
    if (tid % WG == 0) bulk_wait<0>();  // the stores are done
  }
  if (split == 1) return;
  // dW over a cluster (one kept tile per cluster): rank q takes the
  // tile's (64, 64) chunks q, q + split, ...; the CTA sums each chunk over
  // the ranks' partials in rank order 0, 1, ..., rounds it once into the
  // chunk's own staging and stores it by TMA
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster0 < tiles) {
    const TileAt<BN> a = tile_at(cluster0);
    const float2* part = reinterpret_cast<const float2*>(ring);
    for (int q = rank; q < 2 * NC; q += split) {
      const int w = q / NC, c = q % NC;  // rows 64 w.., column chunk c
      if (w >= a.mv || c >= a.nv) continue;
      unsigned char* stg = staging + q * CHUNK;
      for (int e = tid; e < CH * CH / 2; e += THREADS) {
        const int j = e / WG, t = e % WG;  // pair 16 c + j of thread t
        const int p = (16 * c + j) * NT + w * WG + t, i = 2 * (16 * c + j);
        float2 sum = cluster.map_shared_rank(part, 0)[p];
        for (int k = 1; k < split; ++k) {
          const float2 v = cluster.map_shared_rank(part, k)[p];
          sum.x += v.x;
          sum.y += v.y;
        }
        const int r = t / 32 * 16 + (t & 31) / 4 + 8 * ((i >> 1) & 1);
        const int u = (i >> 2) & 7;
        *reinterpret_cast<uint32_t*>(stg + r * 128 + ((u ^ (r & 7)) << 4) +
                                     (t & 3) * 4) = pack_bf16(sum.x, sum.y);
      }
      fence_async_smem();
      __syncthreads();
      if (tid == 0) {
        tma_store_2d(&to, stg, a.n[c], a.m[w]);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

// The (rows, cols) tensor map of a row-major bf16 matrix, boxes of 64
// columns by `box_rows` rows in the 128-byte swizzle, zeros outside it.
// 0, or 1000 + the CUresult of a refused map.
int make_map_2d(CUtensorMap* m, const void* ptr, int rows, int cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {CH, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <int MODE, int BN>
int launch_wgmma(const Plan& p, const void* a, const void* b, void* out,
                 const int* ii, const int* oo, int n_in, int n_out, int R,
                 int D, int F, int block, cudaStream_t s) {
  CUtensorMap ta, tb, to;
  int err;
  if (MODE == FWD) {  // x (R, D), W (D, F) -> y (R, F)
    err = make_map_2d(&ta, a, R, D, BM);
    if (!err) err = make_map_2d(&tb, b, D, F, CH);
    if (!err) err = make_map_2d(&to, out, R, F, CH);
  } else if (MODE == DX) {  // g (R, F), W (D, F) -> dx (R, D)
    err = make_map_2d(&ta, a, R, F, BM);
    if (!err) err = make_map_2d(&tb, b, D, F, CH);
    if (!err) err = make_map_2d(&to, out, R, D, CH);
  } else {  // x (R, D), g (R, F) -> dW (D, F)
    err = make_map_2d(&ta, a, R, D, CH);
    if (!err) err = make_map_2d(&tb, b, R, F, CH);
    if (!err) err = make_map_2d(&to, out, D, F, CH);
  }
  if (err) return err;
  auto kernel = bs_wgmma<MODE, BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  bf16* o = static_cast<bf16*>(out);
  int stages = p.stages, split = p.split, tiles = p.tiles;
  void* args[] = {&ta, &tb,    &to,     &o,     &ii,    &oo,   &n_in, &n_out,
                  &R,  &D,     &F,      &block, &stages, &split, &tiles};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch of a plan: the body and tile make_plan chose, one template
// instance each (f32 tiles 256 threads, bf16 wmma tiles 128)
template <int MODE>
int dispatch(const Plan& p, const void* a, const void* b, void* out,
             const int* ii, const int* oo, int n_in, int n_out, int R, int D,
             int F, int block, cudaStream_t s) {
  if (p.body == BODY_WGMMA) {
    if (p.bn == 64)
      return launch_wgmma<MODE, 64>(p, a, b, out, ii, oo, n_in, n_out, R, D,
                                    F, block, s);
    if (p.bn == 128)
      return launch_wgmma<MODE, 128>(p, a, b, out, ii, oo, n_in, n_out, R, D,
                                     F, block, s);
    return launch_wgmma<MODE, 192>(p, a, b, out, ii, oo, n_in, n_out, R, D,
                                   F, block, s);
  }
  if (p.body == BODY_WMMA) {
    if constexpr (MODE == DW)
      return (int)launch<bf16, MODE, 32, 32, 128>(a, b, out, ii, oo, n_in,
                                                  n_out, R, D, F, block, s);
    else
      return (int)launch<bf16, MODE, 64, 32, 128>(a, b, out, ii, oo, n_in,
                                                  n_out, R, D, F, block, s);
  }
  if constexpr (MODE == DW) {
    if (p.bm == 64)
      return (int)launch<float, MODE, 64, 64, 256>(a, b, out, ii, oo, n_in,
                                                   n_out, R, D, F, block, s);
    return (int)launch<float, MODE, 32, 32, 256>(a, b, out, ii, oo, n_in,
                                                 n_out, R, D, F, block, s);
  } else {
    if (p.bm == 128)
      return (int)launch<float, MODE, 128, 128, 256>(
          a, b, out, ii, oo, n_in, n_out, R, D, F, block, s);
    if (p.bn == 64)
      return (int)launch<float, MODE, 64, 64, 256>(a, b, out, ii, oo, n_in,
                                                   n_out, R, D, F, block, s);
    return (int)launch<float, MODE, 64, 32, 256>(a, b, out, ii, oo, n_in,
                                                 n_out, R, D, F, block, s);
  }
}

bool args_ok(const void* a, const void* b, const void* out, const void* ii,
             const void* oo) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out);
  return (bits % 16) == 0 && ii != nullptr && oo != nullptr;
}

template <int MODE>
int entry(const void* a, const void* b, void* out, const void* in_keep,
          const void* out_keep, int n_in, int n_out, int R, int D, int F,
          int block, int dtype, void* stream) {
  Plan p;  // make_plan refuses the shapes no body takes
  if (!args_ok(a, b, out, in_keep, out_keep) ||
      make_plan(MODE, R, D, F, block, n_in, n_out, dtype, &p) != 0)
    return (int)cudaErrorInvalidValue;
  return dispatch<MODE>(p, a, b, out, static_cast<const int*>(in_keep),
                        static_cast<const int*>(out_keep), n_in, n_out, R, D,
                        F, block, static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (both operands and the output).
// Data pointers must be 16-byte aligned; the keep lists must be non-empty.
// Each returns the cudaError_t of its launch, or 1000 + the CUresult of a
// refused tensor map.

extern "C" int tp_bs_fwd(const void* x, const void* w, void* y,
                         const void* in_keep, const void* out_keep, int n_in,
                         int n_out, int R, int D, int F, int block, int dtype,
                         void* stream) {
  return entry<FWD>(x, w, y, in_keep, out_keep, n_in, n_out, R, D, F, block,
                    dtype, stream);
}

extern "C" int tp_bs_dx(const void* g, const void* w, void* dx,
                        const void* in_keep, const void* out_keep, int n_in,
                        int n_out, int R, int D, int F, int block, int dtype,
                        void* stream) {
  return entry<DX>(g, w, dx, in_keep, out_keep, n_in, n_out, R, D, F, block,
                   dtype, stream);
}

extern "C" int tp_bs_dw(const void* x, const void* g, void* dw,
                        const void* in_keep, const void* out_keep, int n_in,
                        int n_out, int R, int D, int F, int block, int dtype,
                        void* stream) {
  return entry<DW>(x, g, dw, in_keep, out_keep, n_in, n_out, R, D, F, block,
                   dtype, stream);
}

// The plan of a call (mode 0 fwd, 1 dx, 2 dW): out[] = body (0 f32 FMA,
// 1 bf16 wmma, 2 bf16 wgmma), tile rows, tile columns, ring stages, dW
// split, CTAs, kept tiles, dynamic shared memory bytes.  Returns 0, or
// cudaErrorInvalidValue for shapes no body takes.
extern "C" int tp_bs_plan(int mode, int R, int D, int F, int block, int n_in,
                          int n_out, int dtype, long long* out) {
  Plan p;
  const int err = make_plan(mode, R, D, F, block, n_in, n_out, dtype, &p);
  if (err) return err;
  const long long v[8] = {p.body,  p.bm,    p.bn,    p.stages,
                          p.split, p.ctas,  p.tiles, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
