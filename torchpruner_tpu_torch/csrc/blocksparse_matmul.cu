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
// neither read nor multiplied.  Design, simple first:
//   - one CTA owns one output tile and loops over the contraction inside
//     the block (the TPU carried the accumulator across a sequential grid
//     axis): kept input blocks for fwd, kept output blocks for dx, rows
//     for dW; the CTA reads the kept-block indices itself (the TPU
//     prefetched them as scalars);
//   - the grid covers the WHOLE output: a CTA whose tile lies in a
//     dropped block writes zeros and leaves, so the output needs no
//     separate clearing pass and dropped entries are exactly 0.0;
//   - tiles go global -> registers -> shared memory in 16-byte loads,
//     the next step's loads in flight while this step's products run;
//   - bf16 runs on the tensor cores (wmma 16x16x16, f32 accumulate), the
//     operand tiles kept in shared memory in the layout they have in
//     global memory and read as row- or column-major fragments, so no
//     transpose is ever made; f32 runs on the FMA units at full f32 (no
//     TF32), each thread a strided micro-tile of the output;
//   - the ragged row edge (R not a multiple of the tile) is masked in the
//     kernel, so every R launches; rows past R load as zeros.
// dW is not split over R: one CTA contracts all rows of its tile, in a
// fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

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

// Tile by block size: fwd and dx take (128, 128) tiles on 128-blocks,
// (64, 64) on 64-blocks and (64, 32) on 32-blocks; dW, whose grid has
// only kept-in x kept-out tiles to fill the card with, takes (64, 64)
// or (32, 32).  bf16 tiles below 128 run 4 warps, everything else 8.
template <typename T, int MODE>
cudaError_t dispatch(const void* a, const void* b, void* out, const int* ii,
                     const int* oo, int n_in, int n_out, int R, int D, int F,
                     int block, cudaStream_t s) {
  constexpr int SMALL = std::is_same<T, float>::value ? 256 : 128;
  if constexpr (MODE == DW) {
    if (block % 64 == 0)
      return launch<T, MODE, 64, 64, SMALL>(a, b, out, ii, oo, n_in, n_out, R,
                                            D, F, block, s);
    return launch<T, MODE, 32, 32, SMALL>(a, b, out, ii, oo, n_in, n_out, R,
                                          D, F, block, s);
  } else {
    if (block % 128 == 0)
      return launch<T, MODE, 128, 128, 256>(a, b, out, ii, oo, n_in, n_out, R,
                                            D, F, block, s);
    if (block % 64 == 0)
      return launch<T, MODE, 64, 64, SMALL>(a, b, out, ii, oo, n_in, n_out, R,
                                            D, F, block, s);
    return launch<T, MODE, 64, 32, SMALL>(a, b, out, ii, oo, n_in, n_out, R,
                                          D, F, block, s);
  }
}

bool args_ok(const void* a, const void* b, const void* out, const void* ii,
             const void* oo, int n_in, int n_out, int R, int D, int F,
             int block) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out);
  return (bits % 16) == 0 && ii != nullptr && oo != nullptr && R > 0 &&
         block > 0 && block % 32 == 0 && D > 0 && F > 0 && D % block == 0 &&
         F % block == 0 && n_in > 0 && n_out > 0 && n_in <= D / block &&
         n_out <= F / block;
}

template <int MODE>
int entry(const void* a, const void* b, void* out, const void* in_keep,
          const void* out_keep, int n_in, int n_out, int R, int D, int F,
          int block, int dtype, void* stream) {
  if (!args_ok(a, b, out, in_keep, out_keep, n_in, n_out, R, D, F, block))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ii = static_cast<const int*>(in_keep);
  const int* oo = static_cast<const int*>(out_keep);
  if (dtype == 0)
    return (int)dispatch<float, MODE>(a, b, out, ii, oo, n_in, n_out, R, D, F,
                                      block, s);
  if (dtype == 1)
    return (int)dispatch<bf16, MODE>(a, b, out, ii, oo, n_in, n_out, R, D, F,
                                     block, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (both operands and the output).
// Data pointers must be 16-byte aligned; the keep lists must be non-empty.
// Each returns the cudaError_t of its launch.

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
