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
// f32, every block: `bs_tf32x3`, on the tensor cores in 3xTF32
// (tf32x3.cuh: three TF32 mma.sync.m16n8k8 products a product, which
// keeps f32's accuracy) with the same operand major-ness, fed by a
// 3-stage cp.async ring of 32 contracted elements (see "f32: 3xTF32
// body" below); wgmma is not used, as it takes TF32 operands K-major
// only, and W (fwd), x (dW) and g (dW) enter MN-major.
// In `bs_kernel` and `bs_tf32x3` one CTA owns one output tile of the
// whole output grid and loops over the contraction (the TPU carried the
// accumulator across a sequential grid axis), and a CTA whose tile lies
// in a dropped block writes zeros and leaves; `bs_tf32x3` splits dW's R
// over a cluster like `bs_wgmma`, `bs_kernel` does not.
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
#include "tf32x3.cuh"

using namespace nvcuda;
namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

enum Mode { FWD = 0, DX = 1, DW = 2 };

__device__ __forceinline__ bool listed(const int* __restrict__ keep, int n,
                                       int blk) {
  bool hit = false;
  for (int i = 0; i < n; ++i) hit = hit || keep[i] == blk;
  return hit;
}

// element v of the gathered axis whose kept blocks are keep[0 .. n)
__device__ __forceinline__ int gathered(const int* keep, int v, int block) {
  return keep[v / block] * block + v % block;
}

// ------------------------------------------- bf16, odd blocks: wmma body

// the contraction step, bf16 elements a 16-byte chunk, and the padding of
// a shared-memory row (16 bytes: rows stay 16-byte aligned, fragments
// 32-byte aligned)
constexpr int W_BK = 32, W_VEC = 8, W_PAD = 8;
constexpr int W_THREADS = 128;

// Operand tiles as stored in shared memory.  With C (TM, TN) = A B:
//   FWD: A = x tile (TM, BK),        B = W tile (BK, TN)
//   DX:  A = g tile (TM, BK),        B^T = W tile (TN, BK)
//   DW:  A^T = x tile (BK, TM),      B = g tile (BK, TN)
template <int MODE, int TM, int TN>
struct Shape {
  static constexpr int BK = W_BK;
  static constexpr int AR = MODE == DW ? BK : TM;
  static constexpr int AC = MODE == DW ? TM : BK;
  static constexpr int BR = MODE == DX ? TN : BK;
  static constexpr int BC = MODE == DX ? BK : TN;
  static constexpr int LDA = AC + W_PAD;
  static constexpr int LDB = BC + W_PAD;
};

// One (NR, NC) bf16 tile on its way from global to shared memory, held
// in registers as 16-byte chunks (rows at or past `row_limit` are zeros).
template <int NR, int NC>
struct Stage {
  static constexpr int CPR = NC / W_VEC;  // chunks per row
  static constexpr int CH = NR * CPR;
  static constexpr int N = (CH + W_THREADS - 1) / W_THREADS;
  uint4 v[N];

  __device__ __forceinline__ void fetch(const bf16* __restrict__ src, int ld,
                                        int row0, int col0, int row_limit) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * W_THREADS;
      const int r = c / CPR;
      const int col = (c - r * CPR) * W_VEC;
      if (c < CH && row0 + r < row_limit)
        v[i] = *reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * ld + col0 + col);
      else
        v[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(bf16* dst, int ldd) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * W_THREADS;
      if (c < CH) {
        const int r = c / CPR;
        const int col = (c - r * CPR) * W_VEC;
        *reinterpret_cast<uint4*>(dst + r * ldd + col) = v[i];
      }
    }
  }
};

// the warps as 2 x (WARPS / 2), each warp a (TM / 2, TN / (WARPS / 2))
// part of the tile in 16 x 16 fragments
template <int MODE, int TM, int TN>
struct MmaTile {
  using S = Shape<MODE, TM, TN>;
  static constexpr int WARPS = W_THREADS / 32;
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

// a, b, out per mode:
//   FWD: x (R, D), W (D, F) -> y (R, F)
//   DX:  g (R, F), W (D, F) -> dx (R, D)
//   DW:  x (R, D), g (R, F) -> dW (D, F)
// 1-D grid: row tile x column tile of the whole output, columns fastest.
template <int MODE, int TM, int TN>
__global__ void __launch_bounds__(W_THREADS)
bs_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
          bf16* __restrict__ out, const int* __restrict__ ii,
          const int* __restrict__ oo, int n_in, int n_out, int R, int D,
          int F, int block) {
  using S = Shape<MODE, TM, TN>;
  constexpr int BK = S::BK;
  __shared__ __align__(32) bf16 As[S::AR * S::LDA];
  __shared__ __align__(32) bf16 Bs[S::BR * S::LDB];
  __shared__ __align__(32) float patch[(W_THREADS / 32) * 256];

  const int out_ld = MODE == DX ? D : F;
  const int n_ct = out_ld / TN;
  const int ct = blockIdx.x % n_ct, rt = blockIdx.x / n_ct;
  const int m0 = rt * TM, n0 = ct * TN;
  const int row_limit = MODE == DW ? D : R;

  bool kept = MODE == DX ? listed(ii, n_in, n0 / block)
                         : listed(oo, n_out, n0 / block);
  if (MODE == DW) kept = kept && listed(ii, n_in, m0 / block);
  if (!kept) {  // the whole CTA: a tile of a dropped block is zeros
    constexpr int CPR = TN / W_VEC;
    for (int c = threadIdx.x; c < TM * CPR; c += W_THREADS) {
      const int r = c / CPR;
      const int col = (c - r * CPR) * W_VEC;
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
  Stage<S::AR, S::AC> ra;
  Stage<S::BR, S::BC> rb;
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

  MmaTile<MODE, TM, TN> tile;
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

template <int MODE, int TM, int TN>
cudaError_t launch_wmma(const void* a, const void* b, void* out,
                        const int* ii, const int* oo, int n_in, int n_out,
                        int R, int D, int F, int block, cudaStream_t s) {
  const long long n_rt = MODE == DW ? D / TM : (R + TM - 1) / TM;
  const long long grid = n_rt * ((MODE == DX ? D : F) / TN);
  if (grid <= 0 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  bs_kernel<MODE, TM, TN><<<(unsigned)grid, W_THREADS, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), ii, oo, n_in, n_out, R, D, F, block);
  return cudaGetLastError();
}

// ------------------------------------------------- f32: 3xTF32 body
//
// `bs_tf32x3<MODE, BM, BN>`: one CTA per (BM, BN) output tile of the
// whole output (fwd / dx: BM 128 rows of R by BN 32-128 columns; dW: BM
// rows of D by BN of F), a tile of a dropped block written as zeros;
// warps of WTM x 32 outputs (WTM 64, or 32 in a tile 32 wide or 32
// tall), MT = WTM / 16 m16 tiles by 4 n8 tiles, 16 MT sums a thread in
// registers (at 128 x 128: 8 warps, 64 sums).  Per stage of 32
// contracted elements (a 32-wide piece of one kept block, or 32 rows of
// R), a 3-stage cp.async ring of whole 16-byte copies (D and F are
// multiples of 32 floats, so rows stay aligned; rows past R are
// zero-filled) holds
//   fwd: A = x (BM, 32) K-contiguous,  B = W (32, BN) N-contiguous
//   dx:  A = g (BM, 32) K-contiguous,  B = W as (BN, 32) K-contiguous
//   dW:  A = x (32, BM) M-contiguous,  B = g (32, BN) N-contiguous
// so no transpose is made.  Each block of 8 contracted elements is summed
// in the order 2t -> k-index t, 2t + 1 -> t + 4, so a K-contiguous
// operand gives a thread's two elements in one 8-byte load (pitch
// 32 + 8 = 8 mod 32: rows g hit 32 distinct banks) and the others are
// read at rows 2t and 2t + 1 (pitch width + 4 = 4 mod 16: 32 distinct
// banks).  Each warp splits the operands it reads (the A elements of
// its rows, the B elements of its columns) into TF32 halves in registers
// and runs 3 mma.sync per m16n8k8 product.  The tensor core truncates the
// f32 sums it accumulates, and along a long contraction that drifts one
// way: dx at fc1 (576 mma.sync into each accumulator) missed the f32
// tolerance by 1.2x.  So each stage's 12 products a fragment start from
// 0, and join the running sums by an f32 add, rounded to nearest.  dW
// contracts all of R for few tiles (72 of 128 x 128 at BERT-base), so
// `plan` splits R over a thread-block cluster of `ranks` CTAs of one
// tile; each rank writes its f32 partial into its drained ring, and rank
// q sums pairs q, q + ranks, ... over the ranks' partials in rank order
// 0, 1, ... through distributed shared memory and stores them (no
// atomics: bit-equal from run to run).

constexpr int TK = 32;        // contracted elements of a ring stage
constexpr int TF_STAGES = 3;  // the cp.async ring

// floats of one ring stage of mode `mode` at tile (bm, bn): A then B,
// K-contiguous tiles at pitch TK + 8, the others at their width + 4
__host__ __device__ constexpr int tf_stage_floats(int mode, int bm, int bn) {
  return (mode == DW ? TK * (bm + 4) : bm * (TK + 8)) +
         (mode == DX ? bn * (TK + 8) : TK * (bn + 4));
}

template <int MODE, int BM, int BN>
struct Tf {
  // 64 rows a warp where the tile has 64 rows and 64 columns, else 32
  // (a 32-wide tile keeps 4 warps: 1.4-1.6x faster at block 32)
  static constexpr int WTM = BM < 64 || BN < 64 ? 32 : 64, MT = WTM / 16;
  static constexpr int WARPS_N = BN / 32;
  static constexpr int THREADS = 32 * (BM / WTM) * WARPS_N;
  static constexpr int PA = MODE == DW ? BM + 4 : TK + 8;
  static constexpr int PB = MODE == DX ? TK + 8 : BN + 4;
  static constexpr int A_FLOATS = (MODE == DW ? TK : BM) * PA;
  static constexpr int STAGE = tf_stage_floats(MODE, BM, BN);
  static_assert(TF_STAGES * STAGE >= BM * BN, "dW's partial fits the ring");
};

// rows row0 .. row0 + NR - 1, columns col0 .. col0 + NC - 1 of a
// row-major f32 matrix (ld floats a row) into dst (pitch P) by 16-byte
// cp.async, zeros for rows at or past `limit`
template <int NR, int NC, int P, int THREADS>
__device__ __forceinline__ void tf_copy(float* dst,
                                        const float* __restrict__ src, int ld,
                                        int row0, int col0, int limit) {
  constexpr int CPR = NC / 4, N = NR * CPR;
  static_assert(N % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < N / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / CPR, c = (i - r * CPR) * 4, row = row0 + r;
    cp_async<16>(dst + r * P + c,
                 src + (long long)min(row, limit - 1) * ld + col0 + c,
                 row < limit);
  }
}

// a, b, out as for bs_kernel.  Grid: every (BM, BN) output tile, columns
// fastest, `ranks` CTAs (a cluster) a tile.
template <int MODE, int BM, int BN>
__global__ void __launch_bounds__(Tf<MODE, BM, BN>::THREADS)
bs_tf32x3(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ out, const int* __restrict__ ii,
          const int* __restrict__ oo, int n_in, int n_out, int R, int D,
          int F, int block, int ranks) {
  using T = Tf<MODE, BM, BN>;
  constexpr int THREADS = T::THREADS, MT = T::MT, PA = T::PA, PB = T::PB;
  extern __shared__ float4 smem_tf[];
  float* ring = reinterpret_cast<float*>(smem_tf);
  const int tid = threadIdx.x;
  const int out_ld = MODE == DX ? D : F;
  const int row_limit = MODE == DW ? D : R;
  const int n_ct = out_ld / BN;
  const int tile = blockIdx.x / ranks, rank = blockIdx.x % ranks;
  const int m0 = tile / n_ct * BM, n0 = tile % n_ct * BN;

  bool kept = MODE == DX ? listed(ii, n_in, n0 / block)
                         : listed(oo, n_out, n0 / block);
  if (MODE == DW) kept = kept && listed(ii, n_in, m0 / block);
  if (!kept) {  // exact zeros; the ranks of a cluster share the rows
    constexpr int CPR = BN / 4;
    const int rows = (BM - rank + ranks - 1) / ranks;
    for (int i = tid; i < rows * CPR; i += THREADS) {
      const int row = m0 + rank + i / CPR * ranks, c = i % CPR * 4;
      if (row < row_limit)
        *reinterpret_cast<float4*>(out + (long long)row * out_ld + n0 + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  // this CTA's stages [kb, ke): fwd / dx every kept block's 32-wide
  // pieces, dW its rank's share of R
  int kb = 0, ke;
  if (MODE == DW) {
    const int steps = (R + TK - 1) / TK, per = (steps + ranks - 1) / ranks;
    kb = min(steps, rank * per);
    ke = min(steps, kb + per);
  } else {
    ke = (MODE == FWD ? n_in : n_out) * (block / TK);
  }
  const int* k_keep = MODE == FWD ? ii : oo;
  auto load = [&](int k) {
    float* As = ring + (k - kb) % TF_STAGES * T::STAGE;
    float* Bs = As + T::A_FLOATS;
    if constexpr (MODE == DW) {  // x and g rows k TK ..
      tf_copy<TK, BM, PA, THREADS>(As, a, D, k * TK, m0, R);
      tf_copy<TK, BN, PB, THREADS>(Bs, b, F, k * TK, n0, R);
    } else {
      const int kc = gathered(k_keep, k * TK, block);
      if constexpr (MODE == FWD) {  // x columns kc .., W rows kc ..
        tf_copy<BM, TK, PA, THREADS>(As, a, D, m0, kc, R);
        tf_copy<TK, BN, PB, THREADS>(Bs, b, F, kc, n0, D);
      } else {  // g columns kc .., W rows n0 .., columns kc ..
        tf_copy<BM, TK, PA, THREADS>(As, a, F, m0, kc, R);
        tf_copy<BN, TK, PB, THREADS>(Bs, b, F, n0, kc, D);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  // rows 16 mi + g (+ 8) of the warp's WTM, columns 8 ni + 2t (+ 1) of
  // its 32
  float acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll
  for (int i = 0; i < TF_STAGES - 1; ++i) {
    if (kb + i < ke) load(kb + i);
    cp_commit();
  }
  for (int k = kb; k < ke; ++k) {
    cp_wait<TF_STAGES - 2>();  // stage k has landed
    __syncthreads();           // and stage k - 1 is read by every warp
    if (k + TF_STAGES - 1 < ke) load(k + TF_STAGES - 1);
    cp_commit();
    const float* As = ring + (k - kb) % TF_STAGES * T::STAGE;
    const float* Bs = As + T::A_FLOATS;
    // this stage's sums start from 0 and join acc by a rounded f32 add
    float part[MT][4][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk) {
      const int k2 = 8 * kk + 2 * t;  // k-index t; k2 + 1: t + 4
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {  // B: columns 8 ni + g
        const int n = wn * 32 + 8 * ni + g;
        if constexpr (MODE == DX) {
          const float2 x = *reinterpret_cast<const float2*>(Bs + n * PB + k2);
          split(x.x, bb[ni][0], bs[ni][0]);
          split(x.y, bb[ni][1], bs[ni][1]);
        } else {
          split(Bs[k2 * PB + n], bb[ni][0], bs[ni][0]);
          split(Bs[(k2 + 1) * PB + n], bb[ni][1], bs[ni][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {  // A: rows 16 mi + g (+ 8)
        const int m = wm * T::WTM + 16 * mi + g;
        uint32_t ab[4], as[4];
        if constexpr (MODE == DW) {
          const float* p = As + k2 * PA + m;
          split(p[0], ab[0], as[0]);
          split(p[8], ab[1], as[1]);
          split(p[PA], ab[2], as[2]);
          split(p[PA + 8], ab[3], as[3]);
        } else {
          a_frag_pair<PA>(As, m, k2, ab, as);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma3(part[mi][ni], ab, as, bb[ni], bs[ni]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_wait<0>();
  const int row0 = m0 + wm * T::WTM + g, col0 = n0 + wn * 32 + 2 * t;
  if (ranks == 1) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * mi + 8 * h;
        if (row >= row_limit) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          *reinterpret_cast<float2*>(out + (long long)row * out_ld + col0 +
                                     8 * ni) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    return;
  }
  // dW over a cluster: pair j = (mi, ni, h) of thread tid at
  // part[j * THREADS + tid] of each rank's drained ring
  __syncthreads();  // every warp is done with the ring
  float2* part = reinterpret_cast<float2*>(ring);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        part[((mi * 4 + ni) * 2 + h) * THREADS + tid] =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int j = rank; j < MT * 8; j += ranks) {
    const int p = j * THREADS + tid;
    float2 sum = cluster.map_shared_rank(part, 0)[p];
    for (int q = 1; q < ranks; ++q) {
      const float2 v = cluster.map_shared_rank(part, q)[p];
      sum.x += v.x;
      sum.y += v.y;
    }
    const int row = row0 + 16 * (j / 8) + 8 * (j % 2);
    *reinterpret_cast<float2*>(out + (long long)row * out_ld + col0 +
                               8 * (j / 2 % 4)) = sum;
  }
  cluster.sync();  // no CTA leaves while another reads its partial
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


enum Body { BODY_WMMA = 1, BODY_WGMMA = 2, BODY_TF32X3 = 3 };

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

// The launch plan, from the shapes alone.  The tiles of the wgmma body
// (bf16, block a multiple of 64) are 128 rows by 64, 128 or 192 columns,
// both axes gathered in 64-wide chunks through the keep lists (so a tile
// may span kept blocks); those of the 3xTF32 body (f32) are 128 rows by
// 128, 64 or 32 columns (fwd / dx), or 128 x 128, 128 x 64, 64 x 64 or
// 32 x 32 (dW), inside one block of each gathered axis.  The tile, and
// dW's split of R over a cluster of 1, 2, 4 or 8 CTAs (each at least
// MIN_SPLIT_STEPS stages), minimize rounds of 132 CTAs x (stages x (tile
// rows + width) + FIXED_COST): both bodies are bound by what their CTAs
// read from L2, and wider tiles read less per product.  wgmma: fwd / dx
// run min(132, units) persistent CTAs, dW one cluster per kept tile, and
// the ring takes as many stages (at most 8) as 227 KB holds.  3xTF32: one
// CTA (dW: one cluster) per output tile, kept or not, a 3-stage ring.
// The wmma body (bf16 on odd multiples of 32) takes (64, 32) tiles, dW
// (32, 32); one CTA per output tile, no ring (stages 1), static shared
// memory (0).
int make_plan(int mode, int R, int D, int F, int block, int n_in, int n_out,
              int dtype, Plan* p) {
  if (R < 1 || block < 32 || block % 32 || D < 1 || F < 1 || D % block ||
      F % block || n_in < 1 || n_out < 1 || n_in > D / block ||
      n_out > F / block || mode < FWD || mode > DW || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  *p = Plan{};
  p->split = 1;
  p->stages = 1;
  const long long out_cols = mode == DX ? D : F;
  if (dtype == 1 && block % 64) {
    p->body = BODY_WMMA;
    p->bm = mode == DW ? 32 : 64;
    p->bn = 32;
    const long long rows = mode == DW ? D / p->bm : cdiv(R, p->bm);
    p->ctas = (int)(rows * (out_cols / p->bn));
    p->tiles = p->ctas;
    return 0;
  }
  const bool f32 = dtype == 0;
  // the gathered rows and columns of the kept output, the stages of the
  // contraction
  const long long rows = mode == DW ? (long long)n_in * block : R;
  const long long cols = (long long)(mode == DX ? n_in : n_out) * block;
  const int kd = f32 ? TK : BK;
  const long long steps = mode == FWD  ? (long long)n_in * block / kd
                          : mode == DX ? (long long)n_out * block / kd
                                       : cdiv(R, kd);
  // candidate tiles (rows, columns)
  static const int wg_tiles[3][2] = {{BM, CH}, {BM, 2 * CH}, {BM, 3 * CH}};
  static const int tf_tiles[3][2] = {{128, 128}, {128, 64}, {128, 32}};
  static const int tf_dw_tiles[4][2] = {
      {128, 128}, {128, 64}, {64, 64}, {32, 32}};
  const int(*cand)[2] = !f32 ? wg_tiles : mode == DW ? tf_dw_tiles : tf_tiles;
  const int n_cand = !f32 ? 3 : mode == DW ? 4 : 3;
  long long best = -1;
  for (int i = 0; i < n_cand; ++i) {
    const int bm = cand[i][0], bn = cand[i][1];
    if (f32 && (block % bn || (mode == DW && block % bm))) continue;
    const long long tiles = cdiv(rows, bm) * cdiv(cols, bn);
    for (int s = 1; s <= (mode == DW ? MAX_SPLIT : 1); s *= 2) {
      if (s > 1 && steps < (long long)s * MIN_SPLIT_STEPS) break;
      const long long c = cdiv(tiles * s, SMS) *
                          (cdiv(steps, s) * (bm + bn) + FIXED_COST);
      if (best < 0 || c < best) {
        best = c;
        p->bm = bm;
        p->bn = bn;
        p->split = s;
        p->tiles = (int)(tiles < 0x7fffffff ? tiles : 0x7fffffff);
      }
    }
  }
  if (best < 0 || (long long)p->tiles * p->split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (f32) {  // every output tile, kept or not
    p->body = BODY_TF32X3;
    p->stages = TF_STAGES;
    const long long ctas = (mode == DW ? D / p->bm : cdiv(R, p->bm)) *
                           (out_cols / p->bn) * p->split;
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p->ctas = (int)ctas;
    p->smem = 4LL * TF_STAGES * tf_stage_floats(mode, p->bm, p->bn);
    return 0;
  }
  p->body = BODY_WGMMA;
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

// One launch of `kernel` (its arguments `args`) on `ctas` CTAs of
// `threads`, in clusters of `split` CTAs when split > 1
int launch_ex(const void* kernel, void** args, int ctas, int threads,
              long long smem, int split, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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
  bf16* o = static_cast<bf16*>(out);
  int stages = p.stages, split = p.split, tiles = p.tiles;
  void* args[] = {&ta, &tb,    &to,     &o,     &ii,    &oo,   &n_in, &n_out,
                  &R,  &D,     &F,      &block, &stages, &split, &tiles};
  return launch_ex(reinterpret_cast<const void*>(bs_wgmma<MODE, BN>), args,
                   p.ctas, THREADS, p.smem, p.split, s);
}

template <int MODE, int BM_, int BN_>
int launch_tf32x3(const Plan& p, const void* a, const void* b, void* out,
                  const int* ii, const int* oo, int n_in, int n_out, int R,
                  int D, int F, int block, cudaStream_t s) {
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fo = static_cast<float*>(out);
  int split = p.split;
  void* args[] = {&fa, &fb, &fo, &ii, &oo,    &n_in,
                  &n_out, &R, &D,  &F,  &block, &split};
  return launch_ex(reinterpret_cast<const void*>(bs_tf32x3<MODE, BM_, BN_>),
                   args, p.ctas, Tf<MODE, BM_, BN_>::THREADS, p.smem,
                   p.split, s);
}

// The launch of a plan: the body and tile make_plan chose, one template
// instance each
template <int MODE>
int dispatch(const Plan& p, const void* a, const void* b, void* out,
             const int* ii, const int* oo, int n_in, int n_out, int R, int D,
             int F, int block, cudaStream_t s) {
#define TP_BS_ARGS p, a, b, out, ii, oo, n_in, n_out, R, D, F, block, s
  if (p.body == BODY_WGMMA) {
    if (p.bn == 64) return launch_wgmma<MODE, 64>(TP_BS_ARGS);
    if (p.bn == 128) return launch_wgmma<MODE, 128>(TP_BS_ARGS);
    return launch_wgmma<MODE, 192>(TP_BS_ARGS);
  }
  if (p.body == BODY_TF32X3) {
    if constexpr (MODE == DW) {
      if (p.bm == 128)
        return p.bn == 128 ? launch_tf32x3<MODE, 128, 128>(TP_BS_ARGS)
                           : launch_tf32x3<MODE, 128, 64>(TP_BS_ARGS);
      return p.bm == 64 ? launch_tf32x3<MODE, 64, 64>(TP_BS_ARGS)
                        : launch_tf32x3<MODE, 32, 32>(TP_BS_ARGS);
    } else {
      if (p.bn == 128) return launch_tf32x3<MODE, 128, 128>(TP_BS_ARGS);
      if (p.bn == 64) return launch_tf32x3<MODE, 128, 64>(TP_BS_ARGS);
      return launch_tf32x3<MODE, 128, 32>(TP_BS_ARGS);
    }
  }
#undef TP_BS_ARGS
  if constexpr (MODE == DW)
    return (int)launch_wmma<MODE, 32, 32>(a, b, out, ii, oo, n_in, n_out, R,
                                          D, F, block, s);
  else
    return (int)launch_wmma<MODE, 64, 32>(a, b, out, ii, oo, n_in, n_out, R,
                                          D, F, block, s);
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

// The plan of a call (mode 0 fwd, 1 dx, 2 dW): out[] = body (1 bf16
// wmma, 2 bf16 wgmma, 3 f32 3xTF32; 0 was the f32 FMA body of earlier
// sources), tile rows, tile columns, ring stages, dW
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
