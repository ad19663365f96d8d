// Fused dequant matmul for Hopper (sm_90a):
//     y (M, F) f32 = bf16(x) (M, D) . widen(q) (D, F)  [* scale (F,)]
//
// Replaces the Pallas kernel `dequant_matmul` / `_kernel` in
// torchpruner_tpu/ops/fused_matmul.py.  q is int8 (D, F), or int4 packed
// (D/2, F) where byte k of column f holds w[2k, f] in its sign-extended
// low nibble and w[2k+1, f] in the high nibble.
//
// Bound on the H100: bytes.  At decode (M <= 8) every weight byte is
// read once per step and used for at most 2 * M operations, far below the
// card's ~295 operations per byte; the floor is the integer payload over
// the 3.35 TB/s memory rate.  Design against that bound:
//   - the weight stays packed in device memory and is widened in
//     registers; each thread reads 4 neighbouring columns with one 32-bit
//     load, so a warp reads 128 contiguous bytes of a weight row, and
//     keeps 4 rows' loads in flight before using any of them;
//   - threads lie along F (contiguous), each block covers 128 columns, and
//     the contracted axis D is cut into segments that depend on D and F
//     only (8 warps per block x `ks` blocks along grid.z) so that enough
//     blocks are in flight to stream the weight at full rate;
//   - BATCH INVARIANCE: every output element is reduced in one fixed
//     order - sequentially over k inside a segment, then segments in
//     ascending order - that depends on (D, F) and never on M or on the
//     row's place in its tile.  Slot decode (M = n_slots) and a solo
//     replay (M = 1) therefore produce the same bits.
// Ragged edges (M not a multiple of 8, F not a multiple of 128) are
// masked inside the kernel.  Plain C interface for ctypes; launches go on
// the caller's stream and the launch error is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 8;       // rows of x per block
constexpr int WARPS = 8;    // contraction segments per block (one a warp)
constexpr int VEC = 4;      // columns per thread
constexpr int COLS = 32 * VEC;  // columns per block
constexpr int RG = 4;       // weight rows whose loads are in flight at once

template <int BITS>
__global__ void __launch_bounds__(WARPS * 32)
dq_partial(const __nv_bfloat16* __restrict__ x,
           const int8_t* __restrict__ q,
           const float* __restrict__ scale,
           float* __restrict__ dst,
           int M, int D, int F, int rows, int seg, int vec_ok) {
  __shared__ float red[WARPS][MT][COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.x * COLS + lane * VEC;
  const int m0 = blockIdx.y * MT;
  const int s = blockIdx.z * WARPS + warp;
  const int r_begin = min(rows, s * seg);
  const int r_end = min(rows, r_begin + seg);
  const bool vec = vec_ok && (f0 + VEC - 1 < F);

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

  // rows go in groups of RG whose weight loads are all issued before any
  // is used (memory-level parallelism); the accumulation order stays
  // row by row, ascending
  for (int r0 = r_begin; r0 < r_end; r0 += RG) {
    int packed[RG];
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const int r = r0 + g;
      packed[g] = 0;
      if (r < r_end) {
        const int8_t* row = q + (size_t)r * F;
        if (vec) {
          packed[g] = __ldg(reinterpret_cast<const int*>(row + f0));
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            if (f0 + c < F)
              packed[g] |= ((int)(uint8_t)__ldg(row + f0 + c)) << (8 * c);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const int r = r0 + g;
      if (r >= r_end) break;
      int w[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        w[c] = (int)(int8_t)((packed[g] >> (8 * c)) & 0xFF);
      if (BITS == 4) {
        float lo[VEC], hi[VEC];
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          lo[c] = (float)((w[c] << 28) >> 28);  // sign-extended low nibble
          hi[c] = (float)(w[c] >> 4);           // arithmetic shift
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m0 + m < M) {
            // x[m, 2r] and x[m, 2r + 1] in one 32-bit load (D is even)
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    x + (size_t)(m0 + m) * D + 2 * r));
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              acc[m][c] = fmaf(xv.x, lo[c], acc[m][c]);
              acc[m][c] = fmaf(xv.y, hi[c], acc[m][c]);
            }
          }
        }
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m0 + m < M) {
            const float x0 = __bfloat162float(x[(size_t)(m0 + m) * D + r]);
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[m][c] = fmaf(x0, (float)w[c], acc[m][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) red[warp][m][lane * VEC + c] = acc[m][c];
  __syncthreads();

  // segments of this block summed in ascending order
  for (int i = threadIdx.x; i < MT * COLS; i += WARPS * 32) {
    const int m = i / COLS;
    const int col = i % COLS;
    const int f = blockIdx.x * COLS + col;
    if (m0 + m >= M || f >= F) continue;
    float sum = red[0][m][col];
#pragma unroll
    for (int w2 = 1; w2 < WARPS; ++w2) sum += red[w2][m][col];
    if (scale != nullptr) sum *= scale[f];
    dst[((size_t)blockIdx.z * M + (m0 + m)) * F + f] = sum;
  }
}

// y[m, f] = (sum over z in ascending order of part[z, m, f]) [* scale[f]]
__global__ void dq_reduce(const float* __restrict__ part,
                          const float* __restrict__ scale,
                          float* __restrict__ y, int M, int F, int ks) {
  const size_t n = (size_t)M * F;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = part[i];
    for (int z = 1; z < ks; ++z) sum += part[(size_t)z * n + i];
    if (scale != nullptr) sum *= scale[i % F];
    y[i] = sum;
  }
}

}  // namespace

// x: (M, D) bf16; q: (rows, F) int8 with rows = D/2 (bits 4) or D (bits 8);
// scale: (F,) f32 or null; y: (M, F) f32; part: (ks, M, F) f32 scratch
// (unused when ks == 1).  Returns the cudaError_t of the launches.
extern "C" int tp_dequant_matmul(const void* x, const void* q,
                                 const void* scale, void* y, void* part,
                                 int M, int D, int F, int bits, int ks,
                                 void* stream) {
  const int rows = bits == 4 ? D / 2 : D;
  const int seg = (rows + ks * WARPS - 1) / (ks * WARPS);
  const int vec_ok = (F % VEC == 0) &&
                     (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  const dim3 grid((F + COLS - 1) / COLS, (M + MT - 1) / MT, ks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(ks == 1 ? y : part);
  const float* sc = ks == 1 ? static_cast<const float*>(scale) : nullptr;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  if (bits == 4) {
    dq_partial<4><<<grid, WARPS * 32, 0, s>>>(xb, qb, sc, dst, M, D, F,
                                               rows, seg, vec_ok);
  } else {
    dq_partial<8><<<grid, WARPS * 32, 0, s>>>(xb, qb, sc, dst, M, D, F,
                                               rows, seg, vec_ok);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ks == 1) return (int)err;
  const size_t n = (size_t)M * F;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 65535
                               ? (n + threads - 1) / threads
                               : 65535);
  dq_reduce<<<blocks, threads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<float*>(y), M, F, ks);
  return (int)cudaGetLastError();
}
