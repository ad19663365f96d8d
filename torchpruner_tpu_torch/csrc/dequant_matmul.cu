// Fused dequant matmul for Hopper (sm_90a), on the tensor cores:
//     y (M, F) f32 = bf16(x) (M, D) . widen(q) (D, F)  [* scale (F,)]
//
// Replaces the Pallas kernel `_kernel` of torchpruner_tpu/ops/fused_matmul.py
// (line 60, launched by `dequant_matmul` at line 150).  q is int8 (D, F), or
// int4 packed (D/2, F) where byte k of column f holds w[2k, f] in its
// sign-extended low nibble and w[2k+1, f] in the high nibble.
//
// What bounds it on the H100: at decode (M = slots <= 8) bytes - every
// weight byte is read once and used for at most 4 * M operations, far below
// the card's ~295 operations per byte.  At the prefill bucket M = 104 the
// weight bytes over 3.35 TB/s and the 2 * M * D * F operations over the
// 989 TFLOP/s bf16 rate are about equal.
//
// Design.  The product runs as mma.sync.m16n8k16 (bf16 in, f32 sums) with
// the weight on the instruction's M side ("swap AB"): 16 output columns f
// by a k16 slab of D, times x on the N side in groups of 8 rows.  One
// packed int4 byte (w[2k, f], w[2k+1, f]) widens to exactly one bf16x2
// register of the A fragment; an int8 pair comes from the same column of
// two neighbouring weight rows.  Widening is exact (|v| <= 128) and every
// bf16 product is exact in f32, so only the sums round.
//
// A CTA (4 warps, 32 columns each) owns a strip of 128 output columns and a
// tile of up to 128 rows of x (16 groups of 8).  Per k16 step each warp
// widens its weight fragments ONCE and multiplies them into every active
// row group, so each weight tile crosses the memory bus once per CTA for
// all rows of its tile; only M above 128 launches a second row tile, which
// reads the weight again.  Weight and x slabs of 64 contracted rows stream
// through a 3-stage ring in shared memory with cp.async (16-byte chunks
// where the shapes and pointers allow, narrower ones where they do not),
// so two stages are in flight while the tensor cores work on the third.
// Three CTAs fit on an SM (66 KB of shared memory, at most 170 registers a
// thread), so about 24 KB of int4 weight per SM is in flight at decode.
// The kernel is bound by latency more than by either roof, so CTAs per SM
// count: a 4-stage ring (two CTAs per SM) was slower wherever the grid
// holds more than one CTA per SM.
//
// What this does about the five faults of the kernel it replaced:
//   1. the weight was read once per 8 rows of x: now once per 128 rows;
//   2. the products ran as FMAs with the tensor cores idle: every output is
//      produced by mma.sync;
//   3. x was reloaded from global memory in the inner loop: each x slab is
//      copied to shared memory once per stage and read from there with
//      ldmatrix (rows swizzled by 16-byte chunk, so without bank
//      conflicts);
//   4. few bytes were in flight (4-byte loads, 4 rows): 16-byte cp.async
//      into a 3-stage ring, three CTAs per SM;
//   5. the K-split partials went through global memory and a second pass:
//      the CTAs of one strip's K segments form a thread-block cluster and
//      sum their partials through distributed shared memory, in rank
//      order, with no global scratch and no atomics.
//
// BATCH INVARIANCE.  One kernel body serves every M.  The instruction
// sequence that produces a row does not depend on M or on the row's place
// in its tile: mma columns are independent, a row group that holds no row
// of x is skipped as a whole, and every output element sums - inside one
// instruction over its k16, then over k16 steps in ascending order in the
// accumulator, then over K segments in ascending rank order - in an order
// fixed by (D, F, bits) alone.  The segment count is computed by the
// wrapper's launch plan from (D, F, bits) and never from M.  So slot decode
// (M = slots) and bucketed prefill (M = bucket) equal a solo replay bit for
// bit.  Ragged F, D and M are zero-filled or masked inside the kernel.
//
// Plain C interface for ctypes; launches go on the caller's stream and the
// launch error is returned.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WCOLS = 32;              // output columns per warp
constexpr int STRIP = WARPS * WCOLS;   // output columns per CTA
constexpr int ROWS = 128;              // rows of x per CTA (row tile)
constexpr int GROUPS = ROWS / 8;       // n8 row groups per row tile
constexpr int KSTEP = 64;              // contracted rows per ring stage
constexpr int STAGES = 3;
constexpr int MAX_SEGMENTS = 16;       // Hopper's largest cluster
constexpr int PSTRIDE = STRIP + 4;     // floats per row of the partial tile

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }
constexpr int WROW_SH = ilog2(STRIP);      // log2 bytes of a weight row slab
constexpr int XROW_SH = ilog2(KSTEP * 2);  // log2 bytes of an x row slab
static_assert((1 << WROW_SH) == STRIP && (1 << XROW_SH) == KSTEP * 2,
              "row slabs are powers of two");

__host__ __device__ constexpr int x_stage_bytes() { return ROWS * KSTEP * 2; }
template <int BITS>
__host__ __device__ constexpr int w_rows() { return BITS == 4 ? KSTEP / 2 : KSTEP; }
template <int BITS>
__host__ __device__ constexpr int stage_bytes() { return x_stage_bytes() + w_rows<BITS>() * STRIP; }
template <int BITS>
__host__ __device__ constexpr int smem_bytes() {
  // the ring, or the segments' partial tile, which reuses it
  return STAGES * stage_bytes<BITS>() > ROWS * PSTRIDE * 4
             ? STAGES * stage_bytes<BITS>()
             : ROWS * PSTRIDE * 4;
}

// copy `w` bytes (a power of two <= 16) from global to shared memory, or
// zeros when !ok; widths 4..16 go asynchronously through cp.async
__device__ __forceinline__ void copy_chunk(void* dst, const void* src, int w,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? w : 0;
  switch (w) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(n));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                   "l"(src), "r"(n));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(src), "r"(n));
      break;
    case 2:
      *static_cast<uint16_t*>(dst) =
          ok ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
      break;
    default:
      *static_cast<uint8_t*>(dst) =
          ok ? *static_cast<const uint8_t*>(src) : (uint8_t)0;
      break;
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one stage: weight rows [pr0, pr0 + w_rows) of this strip, stored per warp
// as [warp][row][32 bytes]; x rows [m0, m0 + 8 * groups) by contracted
// columns [k0, k0 + 64) as [row][64 bf16] with 16-byte chunks swizzled by
// the row's low 3 bits.  Chunks are 1 << xsh bytes of x, 1 << wsh of q.
template <int BITS>
__device__ __forceinline__ void load_stage(
    uint8_t* st, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ q, int M, int D, int F, int rows, int m0,
    int f0, int stage, int groups, int xsh, int wsh) {
  constexpr int WR = w_rows<BITS>();
  const int pr0 = stage * WR;
  uint8_t* ws = st + x_stage_bytes();
  const int ww = 1 << wsh;
  const int w_sh = WROW_SH - wsh;  // log2 chunks per weight row slab
  for (int i = threadIdx.x; i < (WR << w_sh); i += THREADS) {
    const int r = i >> w_sh;
    const int c = (i & ((1 << w_sh) - 1)) << wsh;
    const int gr = pr0 + r;
    const int gf = f0 + c;
    const bool ok = gr < rows && gf < F;
    const int8_t* src = ok ? q + (size_t)gr * F + gf : q;
    copy_chunk(ws + (c / WCOLS) * (WR * WCOLS) + r * WCOLS + (c % WCOLS), src,
               ww, ok);
  }
  const int k0 = stage * KSTEP;
  const int xw = 1 << xsh;
  const int x_sh = XROW_SH - xsh;  // log2 chunks per x row slab
  for (int i = threadIdx.x; i < ((groups * 8) << x_sh); i += THREADS) {
    const int r = i >> x_sh;
    const int cb = (i & ((1 << x_sh) - 1)) << xsh;  // byte offset in the row
    const int gm = m0 + r;
    const int gk = k0 + cb / 2;
    const bool ok = gm < M && gk < D;
    const __nv_bfloat16* src = ok ? x + (size_t)gm * D + gk : x;
    copy_chunk(st + r * (KSTEP * 2) + (((cb >> 4) ^ (r & 7)) << 4) + (cb & 15),
               src, xw, ok);
  }
}

// byte c of the int4 word w (4 columns of one packed row) as the bf16x2
// register (w[2k, f] low, w[2k+1, f] high): the nibble, biased by 8, is put
// in the mantissa of 128.0 and 136.0 is subtracted - exact
__device__ __forceinline__ uint32_t widen4(uint32_t lo, uint32_t hi, int c) {
  const uint32_t sel = (uint32_t)c | ((uint32_t)c << 4) |
                       ((uint32_t)(c + 4) << 8) | ((uint32_t)(c + 4) << 12);
  uint32_t r = (__byte_perm(lo, hi, sel) & 0x00FF00FFu) | 0x43004300u;
  const uint32_t k = 0x43084308u;  // (136, 136)
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&k));
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte c of two int8 words (the same 4 columns of weight rows k and k+1)
// as the bf16x2 register (w[k, f] low, w[k+1, f] high) - exact
__device__ __forceinline__ uint32_t widen8(uint32_t a, uint32_t b, int c) {
  const float lo = (float)(int8_t)((a >> (8 * c)) & 0xFFu);
  const float hi = (float)(int8_t)((b >> (8 * c)) & 0xFFu);
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// store the 4 neighbouring columns [f, f + 4) of row m of y
__device__ __forceinline__ void store4(float* __restrict__ y,
                                       const float* __restrict__ scale,
                                       int m, int f, int F, float4 v,
                                       bool vec) {
  if (f >= F) return;  // a vector store never straddles F (F % 4 == 0)
  if (scale != nullptr) {
    if (vec) {
      const float4 s = *reinterpret_cast<const float4*>(scale + f);
      v.x *= s.x; v.y *= s.y; v.z *= s.z; v.w *= s.w;
    } else {
      if (f < F) v.x *= scale[f];
      if (f + 1 < F) v.y *= scale[f + 1];
      if (f + 2 < F) v.z *= scale[f + 2];
      if (f + 3 < F) v.w *= scale[f + 3];
    }
  }
  float* dst = y + (size_t)m * F + f;
  if (vec) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    if (f < F) dst[0] = v.x;
    if (f + 1 < F) dst[1] = v.y;
    if (f + 2 < F) dst[2] = v.z;
    if (f + 3 < F) dst[3] = v.w;
  }
}

// grid (strips, row tiles, segments); a cluster spans the segments of one
// (strip, row tile), and its rank is the segment
template <int BITS>
__global__ void __launch_bounds__(THREADS, 3)
dq_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
       const float* __restrict__ scale, float* __restrict__ y, int M, int D,
       int F, int seg_stages, int xsh, int wsh, int vec_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int WR = w_rows<BITS>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // groupID: fragment row / x row in the group
  const int tig = lane & 3;  // thread in group: fragment k pair
  const int f0 = blockIdx.x * STRIP;
  const int m0 = blockIdx.y * ROWS;
  const int segments = gridDim.z;
  const int seg = blockIdx.z;
  const int rows = BITS == 4 ? D / 2 : D;
  const int n_stages = (D + KSTEP - 1) / KSTEP;
  const int s_begin = seg * seg_stages;
  const int s_end = min(n_stages, s_begin + seg_stages);
  const int n_iter = s_end - s_begin;
  // row groups of this tile that hold a row of x
  const int groups = min(GROUPS, (M - m0 + 7) / 8);

  float acc[GROUPS][2][4];
#pragma unroll
  for (int n = 0; n < GROUPS; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][j][e] = 0.f;

  // the prologue and the k16 loop stay rolled, so the hot loop's code
  // stays small
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iter)
      load_stage<BITS>(smem + s * stage_bytes<BITS>(), x, q, M, D, F, rows,
                       m0, f0, s_begin + s, groups, xsh, wsh);
    cp_commit();
  }

  for (int it = 0; it < n_iter; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nxt = it + STAGES - 1;
      if (nxt < n_iter)
        load_stage<BITS>(smem + (nxt % STAGES) * stage_bytes<BITS>(), x, q,
                         M, D, F, rows, m0, f0, s_begin + nxt, groups, xsh,
                         wsh);
      cp_commit();
    }
    const uint8_t* st = smem + (it % STAGES) * stage_bytes<BITS>();
    const uint8_t* ws = st + x_stage_bytes() + warp * (WR * WCOLS);
#pragma unroll 1
    for (int kk = 0; kk < KSTEP / 16; ++kk) {
      // A fragments of the warp's two 16-column tiles.  Tile j, fragment
      // row g is column 4g + j, row g + 8 is column 4g + 2 + j, so one
      // 32-bit word of a weight row feeds both tiles
      uint32_t a[2][4];
      if (BITS == 4) {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
            ws + (kk * 8 + tig) * WCOLS + 4 * g);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
            ws + (kk * 8 + tig + 4) * WCOLS + 4 * g);
        const uint32_t t0 = w0 ^ 0x88888888u, t1 = w1 ^ 0x88888888u;
        const uint32_t lo0 = t0 & 0x0F0F0F0Fu, hi0 = (t0 >> 4) & 0x0F0F0F0Fu;
        const uint32_t lo1 = t1 & 0x0F0F0F0Fu, hi1 = (t1 >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[j][0] = widen4(lo0, hi0, j);
          a[j][1] = widen4(lo0, hi0, j + 2);
          a[j][2] = widen4(lo1, hi1, j);
          a[j][3] = widen4(lo1, hi1, j + 2);
        }
      } else {
        const uint8_t* base = ws + (kk * 16 + 2 * tig) * WCOLS + 4 * g;
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t r1 = *reinterpret_cast<const uint32_t*>(base + WCOLS);
        const uint32_t r8 =
            *reinterpret_cast<const uint32_t*>(base + 8 * WCOLS);
        const uint32_t r9 =
            *reinterpret_cast<const uint32_t*>(base + 9 * WCOLS);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[j][0] = widen8(r0, r1, j);
          a[j][1] = widen8(r0, r1, j + 2);
          a[j][2] = widen8(r8, r9, j);
          a[j][3] = widen8(r8, r9, j + 2);
        }
      }
      // B fragments of two row groups per ldmatrix.x4: matrices (group
      // 2p, k 0-7), (2p, k 8-15), (2p + 1, k 0-7), (2p + 1, k 8-15)
      // (lane >> 3 picks the matrix, lane & 7 its row, which is also the
      // row's swizzle since groups start at multiples of 8)
      const uint8_t* xs =
          st + (((lane >> 4) * 8 + (lane & 7)) << XROW_SH) +
          (((2 * kk + ((lane >> 3) & 1)) ^ (lane & 7)) << 4);
#pragma unroll
      for (int p = 0; p < GROUPS / 2; ++p) {
        if (2 * p < groups) {
          uint32_t b[4];
          ldmatrix_x4(b, xs + ((16 * p) << XROW_SH));
          mma16816(acc[2 * p][0], a[0], b[0], b[1]);
          mma16816(acc[2 * p][1], a[1], b[0], b[1]);
          if (2 * p + 1 < groups) {
            mma16816(acc[2 * p + 1][0], a[0], b[2], b[3]);
            mma16816(acc[2 * p + 1][1], a[1], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_wait<0>();

  // lane holds, for row 8n + 2 tig (+1), the columns 4g .. 4g + 3 of its
  // warp's 32: (tile 0 c0, tile 1 c0, tile 0 c2, tile 1 c2) and (c1, c3)
  const int fc = warp * WCOLS + 4 * g;  // column in the strip
  if (segments == 1) {
#pragma unroll
    for (int n = 0; n < GROUPS; ++n) {
      if (n < groups) {
        const int m = m0 + n * 8 + 2 * tig;
        if (m < M)
          store4(y, scale, m, f0 + fc, F,
                 make_float4(acc[n][0][0], acc[n][1][0], acc[n][0][2],
                             acc[n][1][2]),
                 vec_out);
        if (m + 1 < M)
          store4(y, scale, m + 1, f0 + fc, F,
                 make_float4(acc[n][0][1], acc[n][1][1], acc[n][0][3],
                             acc[n][1][3]),
                 vec_out);
      }
    }
    return;
  }

  // segments > 1: each CTA writes its partial tile into its own shared
  // memory (the ring is drained), the cluster syncs, and rank r sums the
  // chunks i = r, r + segments, ... over ranks 0, 1, ... in that order
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < GROUPS; ++n) {
    if (n < groups) {
      const int r = n * 8 + 2 * tig;
      *reinterpret_cast<float4*>(part + r * PSTRIDE + fc) = make_float4(
          acc[n][0][0], acc[n][1][0], acc[n][0][2], acc[n][1][2]);
      *reinterpret_cast<float4*>(part + (r + 1) * PSTRIDE + fc) =
          make_float4(acc[n][0][1], acc[n][1][1], acc[n][0][3],
                      acc[n][1][3]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int live = min(ROWS, M - m0);
  const int chunks = live * (STRIP / 4);
  for (int i = rank * THREADS + threadIdx.x; i < chunks;
       i += segments * THREADS) {
    const int r = i / (STRIP / 4);
    const int c = (i - r * (STRIP / 4)) * 4;
    if (f0 + c >= F) continue;
    float4 sum = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + r * PSTRIDE + c);
    for (int s = 1; s < segments; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, s) + r * PSTRIDE + c);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    store4(y, scale, m0 + r, f0 + c, F, sum, vec_out);
  }
  cluster.sync();  // no CTA leaves while another reads its partials
}

// the widest power of two <= 16 that divides both n and the address
int chunk_width(const void* p, long long n) {
  int w = 16;
  while (w > 1 && ((reinterpret_cast<uintptr_t>(p) % w) != 0 || n % w != 0))
    w >>= 1;
  return w;
}

template <int BITS>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* q,
                   const float* scale, float* y, int M, int D, int F,
                   int segments, int seg_stages, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dq_mma<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<BITS>());
    if (e != cudaSuccess) return e;
    // clusters above 8 CTAs (the portable size) need the opt-in
    e = cudaFuncSetAttribute(
        dq_mma<BITS>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // x rows are D bf16 (2D bytes); chunks never cross a row or D
  const int xsh = ilog2(chunk_width(x, 2LL * D));
  const int wsh = ilog2(chunk_width(q, F));
  const int vec_out = (F % 4 == 0) && (scale == nullptr ||
                      reinterpret_cast<uintptr_t>(scale) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((F + STRIP - 1) / STRIP, (M + ROWS - 1) / ROWS,
                     segments);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<BITS>();
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = segments;
  cfg.attrs = attr;
  cfg.numAttrs = segments > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, dq_mma<BITS>, x, q, scale, y, M, D, F,
                            seg_stages, xsh, wsh, vec_out);
}

}  // namespace

// x: (M, D) bf16; q: (rows, F) int8 with rows = D/2 (bits 4) or D (bits 8);
// scale: (F,) f32 or null; y: (M, F) f32.  The launch plan (ops/
// fused_matmul.py `plan`): `segments` K segments of `seg_stages` stages of
// `k_step` contracted rows each, CTA strips of `strip` columns, row tiles
// of `row_tile` rows, a ring of `stages`; the fixed fields must match this
// build.  Returns the cudaError_t of the launch.
extern "C" int tp_dequant_matmul(const void* x, const void* q,
                                 const void* scale, void* y, int M, int D,
                                 int F, int bits, int segments,
                                 int seg_stages, int strip, int row_tile,
                                 int k_step, int stages, void* stream) {
  const int n_stages = (D + KSTEP - 1) / KSTEP;
  if ((bits != 4 && bits != 8) || (bits == 4 && D % 2) || strip != STRIP ||
      row_tile != ROWS || k_step != KSTEP || stages != STAGES ||
      segments < 1 || segments > MAX_SEGMENTS || seg_stages < 1 ||
      (long long)segments * seg_stages < n_stages ||
      (segments - 1) * seg_stages >= n_stages || M < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* yb = static_cast<float*>(y);
  cudaError_t err =
      bits == 4 ? launch<4>(xb, qb, sc, yb, M, D, F, segments, seg_stages, s)
                : launch<8>(xb, qb, sc, yb, M, D, F, segments, seg_stages, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
