// Flash attention for Hopper (sm_90a): the forward pass and the two
// backward passes (dQ, dK/dV) of softmax(Q K^T / sqrt(Dh)) V.
//
// Replaces the Pallas kernels of torchpruner_tpu/ops/flash_attention.py:
//   tp_flash_fwd  <- `_flash_fwd` / `_fwd_kernel`
//   tp_flash_dq   <- `_flash_bwd` / `_dq_kernel`
//   tp_flash_dkv  <- `_flash_bwd` / `_dkv_kernel`
// q, k, v, o, do: (B, S, H, Dh) f32|bf16 read through their (b, s, h)
// element strides (the head-dim stride is 1), so the JAX layout needs no
// transpose; lse, delta: (B, H, S) f32; outputs in the input dtype.
//
// Bound on the H100: operations.  At the path's shapes (S 128-1024,
// Dh 64-128) attention does ~4 S Dh operations per element of Q/K/V it
// reads, far above the card's ~20 f32 (~295 bf16) operations per byte,
// and the (S, S) score matrix, the one large intermediate, never leaves
// the chip.  Design against that bound, simple first:
//   - f32 and bf16 dQ: one CTA per (b, h, 64-row tile) (the bf16
//     forward and dK/dV: 128 rows); the forward and dQ tile queries
//     and loop over key tiles, dK/dV tiles keys and loops over query
//     tiles; blocks run in parallel, so each loop carries its own f32
//     accumulators (the TPU carried them across sequential grid steps);
//   - f32 (the scoring path) runs on the FMA units, which is all the
//     card has for f32 without TF32 rounding: 256 threads, tiles staged
//     through shared memory padded to an odd row length so the 16
//     threads of a row group hit 16 distinct banks, each thread a 4 x 4
//     block of the 64 x 64 score tile and 4 rows x Dh/16 output columns;
//   - bf16 (training) runs its products on the tensor cores: the
//     forward and dK/dV on Hopper's wgmma with TMA-fed rings and the
//     scores in registers (see "bf16 forward and dK/dV" below), dQ on
//     wmma 16x16x16 with its score tiles in shared memory;
//   - the online softmax keeps (m, l) per row in registers;
//   - causal: key tiles above the query tile's diagonal are never loaded
//     (forward, dQ), query tiles above the key tile's diagonal are never
//     loaded (dK/dV); only ragged or diagonal entries are masked;
//   - delta = rowsum(dO * O) is computed once, by the dQ kernel, which
//     writes it for the dK/dV kernel that runs after it on the stream;
//   - the ragged S edge is masked in the kernel, so every S launches.

#include <cuda.h>  // CUtensorMap and its enums (headers only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <utility>

#include "sm90.cuh"

using namespace nvcuda;

namespace {

constexpr int BT = 64;            // rows of a query or key tile
constexpr int THREADS = 256;      // 16 row groups x 16 column lanes
constexpr int MAX_DH = 128;
constexpr int DC = MAX_DH / 16;   // head-dim columns a thread owns
constexpr int LDP = BT + 1;       // padded row of a (64, 64) tile
constexpr float NEG = -1e30f;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// sum / max over the 16 lanes of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// dst[r * ld + d] = src[b, row0 + r, h, d] as f32 for r < 64 (0 past S);
// `vec`: every row starts 16-byte aligned, so 4 elements load at once
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          Strides st, int b, int h,
                                          int row0, int S, int Dh,
                                          int vec) {
  const T* base = src + b * st.b + h * st.h;
  if (vec && sizeof(T) == 4) {
    const int n4 = Dh / 4;
    for (int i = threadIdx.x; i < BT * n4; i += THREADS) {
      const int r = i / n4;
      const int d = (i - r * n4) * 4;
      const int s = row0 + r;
      const float4 x = s < S ? *reinterpret_cast<const float4*>(
                                   base + (long long)s * st.s + d)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      float* o = dst + r * ld + d;
      o[0] = x.x;
      o[1] = x.y;
      o[2] = x.z;
      o[3] = x.w;
    }
    return;
  }
  for (int i = threadIdx.x; i < BT * Dh; i += THREADS) {
    const int r = i / Dh;
    const int d = i - r * Dh;
    const int s = row0 + r;
    dst[r * ld + d] = s < S ? to_f(base[(long long)s * st.s + d]) : 0.f;
  }
}

// key tiles a query tile starting at q0 visits
__device__ __forceinline__ int key_tiles(int q0, int S, int causal) {
  const int n = (S + BT - 1) / BT;
  return causal ? min(n, (q0 + BT - 1) / BT + 1) : n;
}

// ------------------------------------------- f32: FMA kernels
// (templated on the element type; launched for float)

// ---------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
           Strides so, int H, int S, int Dh, float scale, int causal, int vec) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;
  float* Qs = smem;
  float* Ks = Qs + BT * ld;
  float* Vs = Ks + BT * ld;
  float* Ps = Vs + BT * ld;  // (64, LDP)
  const int n_qt = (S + BT - 1) / BT;
  const int q0 = (blockIdx.x % n_qt) * BT;
  const int b = blockIdx.x / n_qt / H;
  const int h = blockIdx.x / n_qt % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile(Qs, ld, q, sq, b, h, q0, S, Dh, vec);
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = key_tiles(q0, S, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile(Ks, ld, k, sk, b, h, k0, S, Dh, vec);
    load_tile(Vs, ld, v, sv, b, h, k0, S, Dh, vec);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[4];
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < S && (!causal || kp <= qp);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rsum += p;
      }
      l[i] = l[i] * alpha + group_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    const int live = min(BT, S - k0);  // rows of V past S hold zeros
    for (int j = 0; j < live; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < Dh ? Vs[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * LDP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float inv = 1.f / l[i];
    T* orow = o + b * so.b + (long long)qp * so.s + h * so.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) put(orow + col, acc[i][c] * inv);
    }
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * S + qp] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------------- dQ

template <typename T>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, const float* __restrict__ lse,
          T* __restrict__ dq, float* __restrict__ delta, Strides sq,
          Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq,
          int H, int S, int Dh, float scale, int causal, int vec) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;
  float* Qs = smem;
  float* dOs = Qs + BT * ld;
  float* Ks = dOs + BT * ld;
  float* Vs = Ks + BT * ld;
  float* dSs = Vs + BT * ld;  // (64, LDP)
  const int n_qt = (S + BT - 1) / BT;
  const int q0 = (blockIdx.x % n_qt) * BT;
  const int b = blockIdx.x / n_qt / H;
  const int h = blockIdx.x / n_qt % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long row_bh = ((long long)b * H + h) * S;

  load_tile(Qs, ld, q, sq, b, h, q0, S, Dh, vec);
  load_tile(dOs, ld, dout, sdo, b, h, q0, S, Dh, vec);
  load_tile(Ks, ld, o, so, b, h, q0, S, Dh, vec);  // O, for delta only
  __syncthreads();
  float dl[4], lrow[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    float part = 0.f;
    for (int d = tx; d < Dh; d += 16) part += dOs[r * ld + d] * Ks[r * ld + d];
    dl[i] = group_sum(part);
    lrow[i] = qp < S ? lse[row_bh + qp] : 0.f;
    if (tx == 0 && qp < S) delta[row_bh + qp] = dl[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = key_tiles(q0, S, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_tile(Ks, ld, k, sk, b, h, k0, S, Dh, vec);
    load_tile(Vs, ld, v, sv, b, h, k0, S, Dh, vec);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < Dh; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * ld + d];
        gv[i] = dOs[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * ld + d];
        vv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = qp < S && kp < S && (!causal || kp <= qp);
        const float p = ok ? expf(s[i][j] * scale - lrow[i]) : 0.f;
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();
    const int live = min(BT, S - k0);
    for (int j = 0; j < live; ++j) {
      float kk[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        kk[c] = col < Dh ? Ks[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * LDP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, kk[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    T* row = dq + b * sdq.b + (long long)qp * sdq.s + h * sdq.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) put(row + col, acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------- dK/dV

template <typename T>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
           Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int S,
           int Dh, float scale, int causal, int vec) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;
  float* Ks = smem;
  float* Vs = Ks + BT * ld;
  float* Qs = Vs + BT * ld;
  float* dOs = Qs + BT * ld;
  float* Ps = dOs + BT * ld;  // (64, LDP)
  float* dSs = Ps + BT * LDP;  // (64, LDP)
  const int n_t = (S + BT - 1) / BT;
  const int kt = blockIdx.x % n_t;
  const int k0 = kt * BT;
  const int b = blockIdx.x / n_t / H;
  const int h = blockIdx.x / n_t % H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long row_bh = ((long long)b * H + h) * S;

  load_tile(Ks, ld, k, sk, b, h, k0, S, Dh, vec);
  load_tile(Vs, ld, v, sv, b, h, k0, S, Dh, vec);
  float gk[4][DC], gv[4][DC];  // key rows ty + 16 i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[i][c] = gv[i][c] = 0.f;
  // causal: query tiles wholly above this key tile's diagonal see none
  // of its keys
  for (int qt = causal ? kt : 0; qt < n_t; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    load_tile(Qs, ld, q, sq, b, h, q0, S, Dh, vec);
    load_tile(dOs, ld, dout, sdo, b, h, q0, S, Dh, vec);
    __syncthreads();
    float s[4][4], dp[4][4];  // query rows ty + 16 i, keys tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < Dh; ++d) {
      float qv[4], gd[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * ld + d];
        gd[i] = dOs[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * ld + d];
        vv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gd[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      const float lr = qp < S ? lse[row_bh + qp] : 0.f;
      const float dr = qp < S ? delta[row_bh + qp] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = qp < S && kp < S && (!causal || kp <= qp);
        const float p = ok ? expf(s[i][j] * scale - lr) : 0.f;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dp[i][j] - dr) * scale;
      }
    }
    __syncthreads();
    const int live = min(BT, S - q0);
    for (int r = 0; r < live; ++r) {
      float go[DC], qq[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        go[c] = col < Dh ? dOs[r * ld + col] : 0.f;
        qq[c] = col < Dh ? Qs[r * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[r * LDP + ty + 16 * i];
        const float ds = dSs[r * LDP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          gv[i][c] = fmaf(p, go[c], gv[i][c]);
          gk[i][c] = fmaf(ds, qq[c], gk[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= S) continue;
    T* krow = dk + b * sdk.b + (long long)kp * sdk.s + h * sdk.h;
    T* vrow = dv + b * sdv.b + (long long)kp * sdv.s + h * sdv.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) {
        put(krow + col, gk[i][c]);
        put(vrow + col, gv[i][c]);
      }
    }
  }
}

// ------------------------------------------- bf16 dQ: wmma kernel
//
// dQ for bf16 on the tensor cores (wmma 16x16x16, bf16 products into f32
// accumulators, mma.sync on sm_90).  One CTA of 4 warps per 64-row tile,
// each warp owning 16 rows.  Tiles live in shared memory as bf16, the
// head dim zero-padded to a multiple of 16 (Dp); the score tiles a
// product makes are stored to shared memory as f32, where the dS
// arithmetic runs in f32 with two threads per row, and the bf16 result
// feeds the next product.  dS is rounded to bf16 before its product (as
// FlashAttention-2 does); every sum is f32.

constexpr int TC_THREADS = 128;
constexpr int MAX_NT = MAX_DH / 16;  // 16-wide head-dim tiles
constexpr int LDS = BT + 4;          // f32 (64, 64) tile row
constexpr int LDH = BT + 8;          // bf16 (64, 64) tile row
typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ inline int pad16(int Dh) { return (Dh + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// a (64, Dp) bf16 tile: rows row0.. of src, zero past S and past Dh;
// `vec`: every row starts 16-byte aligned, so 8 elements move at once
// (Dh is a multiple of 8, and so is the padded row stride)
__device__ __forceinline__ void load_bf16(bf16* dst, int ld, const bf16* src,
                                          Strides st, int b, int h, int row0,
                                          int S, int Dh, int Dp, int vec) {
  const bf16* base = src + b * st.b + h * st.h;
  if (vec) {
    const int n8 = Dp / 8;
    for (int i = threadIdx.x; i < BT * n8; i += TC_THREADS) {
      const int r = i / n8;
      const int d = (i - r * n8) * 8;
      const int s = row0 + r;
      *reinterpret_cast<uint4*>(dst + r * ld + d) =
          (s < S && d < Dh) ? *reinterpret_cast<const uint4*>(
                                  base + (long long)s * st.s + d)
                            : make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  for (int i = threadIdx.x; i < BT * Dp; i += TC_THREADS) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    const int s = row0 + r;
    dst[r * ld + d] = (s < S && d < Dh) ? base[(long long)s * st.s + d]
                                        : __float2bfloat16(0.f);
  }
}

// out[16 rows of warp w][64] = A[warp rows][Dp] . B^T, B (64, Dp) row-major
// (the "col-major" wmma B operand), stored f32 with row stride LDS
__device__ __forceinline__ void rows_by_rowsT(float* out, const bf16* A,
                                              const bf16* B, int ld, int Dp,
                                              int warp) {
  for (int nt = 0; nt < BT / 16; ++nt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < Dp; kk += 16) {
      FragA a;
      FragBc bm;
      wmma::load_matrix_sync(a, A + warp * 16 * ld + kk, ld);
      wmma::load_matrix_sync(bm, B + nt * 16 * ld + kk, ld);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(out + warp * 16 * LDS + nt * 16, acc, LDS,
                            wmma::mem_row_major);
  }
}

// acc[nt] (+)= P[warp rows][64] . V[64][Dp], P bf16 with row stride LDH
__device__ __forceinline__ void rows_by_tile(FragC (&acc)[MAX_NT],
                                             const bf16* P, const bf16* V,
                                             int ld, int Dp, int warp) {
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt) {
    if (nt * 16 >= Dp) break;
    for (int kk = 0; kk < BT; kk += 16) {
      FragA a;
      FragBr bm;
      wmma::load_matrix_sync(a, P + warp * 16 * LDH + kk, LDH);
      wmma::load_matrix_sync(bm, V + kk * ld + nt * 16, ld);
      wmma::mma_sync(acc[nt], a, bm, acc[nt]);
    }
  }
}

__global__ void __launch_bounds__(TC_THREADS)
dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
      const bf16* __restrict__ v, const bf16* __restrict__ o,
      const bf16* __restrict__ dout, const float* __restrict__ lse,
      bf16* __restrict__ dq, float* __restrict__ delta, Strides sq,
      Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq, int H,
      int S, int Dh, float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char raw[];
  const int Dp = pad16(Dh), ld = Dp + 8, lo = Dp + 4;
  bf16* Qs = reinterpret_cast<bf16*>(raw);
  bf16* dOs = Qs + BT * ld;
  bf16* Ks = dOs + BT * ld;
  bf16* Vs = Ks + BT * ld;
  bf16* dSs = Vs + BT * ld;                                        // (64, LDH)
  float* Ss = reinterpret_cast<float*>(raw + align128((4 * BT * ld + BT * LDH) * sizeof(bf16)));
  float* dPs = Ss + BT * LDS;
  float* Out = Ss;  // (64, lo) staging for dq, after the last tile
  const int n_qt = (S + BT - 1) / BT;
  const int q0 = (blockIdx.x % n_qt) * BT;
  const int b = blockIdx.x / n_qt / H;
  const int h = blockIdx.x / n_qt % H;
  const int warp = threadIdx.x >> 5;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qp = q0 + r;
  const long long row_bh = ((long long)b * H + h) * S;

  load_bf16(Qs, ld, q, sq, b, h, q0, S, Dh, Dp, vec);
  load_bf16(dOs, ld, dout, sdo, b, h, q0, S, Dh, Dp, vec);
  load_bf16(Ks, ld, o, so, b, h, q0, S, Dh, Dp, vec);  // O, for delta only
  __syncthreads();
  float part = 0.f;
  for (int d = half; d < Dh; d += 2)
    part += __bfloat162float(dOs[r * ld + d]) * __bfloat162float(Ks[r * ld + d]);
  const float dl = part + __shfl_xor_sync(0xffffffffu, part, 1);
  const float lr = qp < S ? lse[row_bh + qp] : 0.f;
  if (half == 0 && qp < S) delta[row_bh + qp] = dl;
  FragC acc[MAX_NT];
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt) wmma::fill_fragment(acc[nt], 0.f);
  const int n_kt = key_tiles(q0, S, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_bf16(Ks, ld, k, sk, b, h, k0, S, Dh, Dp, vec);
    load_bf16(Vs, ld, v, sv, b, h, k0, S, Dh, Dp, vec);
    __syncthreads();
    rows_by_rowsT(Ss, Qs, Ks, ld, Dp, warp);
    rows_by_rowsT(dPs, dOs, Vs, ld, Dp, warp);
    __syncwarp();
    for (int j = half; j < BT; j += 2) {
      const int kp = k0 + j;
      const bool ok = qp < S && kp < S && (!causal || kp <= qp);
      const float p = ok ? expf(Ss[r * LDS + j] * scale - lr) : 0.f;
      dSs[r * LDH + j] = __float2bfloat16(p * (dPs[r * LDS + j] - dl) * scale);
    }
    __syncwarp();
    rows_by_tile(acc, dSs, Ks, ld, Dp, warp);
  }
  __syncthreads();  // Ss/dPs are reused as the staging tile
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt)
    if (nt * 16 < Dp)
      wmma::store_matrix_sync(Out + warp * 16 * lo + nt * 16, acc[nt], lo,
                              wmma::mem_row_major);
  __syncwarp();
  if (qp < S) {
    bf16* row = dq + b * sdq.b + (long long)qp * sdq.s + h * sdq.h;
    for (int col = half; col < Dh; col += 2)
      row[col] = __float2bfloat16(Out[r * lo + col]);
  }
}

// dQ stages its (64, Dp + 4) f32 output in the two score tiles
// (2 x 64 x 68 floats >= 64 x 132)
size_t dq_tc_smem(int Dh) {
  const int ld = pad16(Dh) + 8;
  return align128((4 * BT * ld + BT * LDH) * sizeof(bf16)) +
         2 * BT * LDS * sizeof(float);
}

// ------------------------------- bf16 forward and dK/dV: wgmma kernels
//
// `fwd_wgmma` and `dkv_wgmma` run on Hopper's warpgroup products, in the
// shape the hardware is built for:
//   - three warpgroups per CTA: two consumers of 64 rows each and one
//     producer that keeps the next tiles in flight; the consumers get
//     240 registers, the producer 24 (setmaxnreg);
//   - every tile lives in shared memory as 64-column chunks of 128-byte
//     rows in the 128-byte swizzle, the layout both TMA writes and wgmma
//     reads; Dh is zero-padded to DP = 64 or 128 (a template argument);
//   - copies: one TMA box per chunk (`cp.async.bulk.tensor`, a 4-d
//     tensor map over the strided (B, S, H, Dh) view, completion on an
//     mbarrier) when every base is 16-byte aligned and every stride a
//     multiple of 16 bytes; otherwise the producer's 128 threads fill the
//     same ring with their own loads (`copy_tile`), zero past S and Dh;
//   - a ring of tiles (2 stages of K and V in the forward, 3 of Q and dO
//     in dK/dV) with full / empty mbarriers: the producer waits for a
//     free stage, the consumers for a full one;
//   - products on wgmma (m64nNk16, bf16 in, f32 sums in registers).
//     The scores stay in the accumulator fragment; the softmax, dS and
//     masks run on it with quad shuffles; the bf16 weights are repacked
//     in registers as the A operand of the next product (a warp's
//     accumulator rows and columns are exactly an A fragment's), and V,
//     dO and Q enter that product as the transposed (MN-major) B operand;
//   - causal: key tiles above the diagonal are never loaded, tiles
//     below it run unmasked, only the diagonal and the ragged S edge are
//     masked; the forward launches its heaviest query tiles first.
// Forward: one CTA per (128 query rows, b, h); S = Q K^T into registers,
// the online softmax in base 2 with (m, l) per row in registers (l sums
// the f32 weights), O += P V with P in registers, O in registers across
// all key tiles.  dK/dV: one CTA per (128 keys, b, h), K and V resident,
// dK and dV in registers across the query tiles; per 64-row query tile
// S^T = K Q^T and dP^T = V dO^T, then P^T = exp(S^T scale - LSE) and
// dS^T = P^T (dP^T - delta) scale in registers, the A operands of
// dV += P^T dO and dK += dS^T Q.  Rows past S carry LSE = +inf, so their
// weights are 0 with no per-element test.  Deterministic: every sum runs
// in one CTA in a fixed order, no atomics.

constexpr int WG = 128;               // threads of a warpgroup
constexpr int HOP_THREADS = 3 * WG;   // two consumer warpgroups, a producer
constexpr int CH = 64;                // bf16 columns of a 128-byte chunk row
constexpr int CHUNK_ROW = 128;        // bytes of a chunk row
constexpr int FWD_BM = 128;           // query rows of a forward CTA
constexpr int FWD_BN = 128;           // keys of a forward ring stage
constexpr int KV_BN = 128;            // keys of a dK/dV CTA
constexpr int KV_BQ = 64;             // query rows of a dK/dV ring stage
constexpr int FWD_STAGES = 2;         // K/V ring of the forward
constexpr int KV_STAGES = 3;          // Q/dO ring of dK/dV
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows row0.. of one (b, h) slice into nc swizzled chunks of `rows` rows
// with the producer warpgroup's own loads (thread t of 128): 16 bytes
// when aligned, else 8 elements one by one; zero past S and past Dh.
// The route for layouts TMA does not take.
__device__ void copy_tile(unsigned char* dst, const bf16* src, Strides st,
                          int b, int h, int row0, int rows, int S, int Dh,
                          int nc, int t) {
  const bf16* base = src + b * st.b + h * st.h;
  const int units = nc * 8;  // 16-byte units of a padded row
  for (int i = t; i < rows * units; i += WG) {
    const int r = i / units, u = i - r * units;
    const int col = u * 8, s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S && col < Dh) {
      const bf16* p = base + (long long)s * st.s + col;
      if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        bf16 e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = p[j];
        memcpy(&val, e, sizeof(val));
      }
    }
    *reinterpret_cast<uint4*>(dst + (u >> 3) * rows * CHUNK_ROW +
                              r * CHUNK_ROW + (((u & 7) ^ (r & 7)) << 4)) = val;
  }
}

// One stage's tiles: TMA (thread 0 sets the byte count and starts a box
// per chunk) or the warpgroup's copies; each of the producer's 128
// threads then arrives on `bar`.
struct TileLoad {
  unsigned char* dst;
  const CUtensorMap* tm;
  const bf16* src;
  Strides st;
  int row0, rows;
};
template <int N>
__device__ __forceinline__ void load_stage(const TileLoad (&tl)[N], int nc,
                                           int b, int h, int S, int Dh,
                                           int tma, uint64_t* bar, int t) {
  if (tma) {
    if (t == 0) {
      uint32_t bytes = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) bytes += nc * tl[i].rows * CHUNK_ROW;
      mbar_arrive_tx(bar, bytes);
#pragma unroll
      for (int i = 0; i < N; ++i)
        for (int c = 0; c < nc; ++c)
          tma_load(tl[i].dst + c * tl[i].rows * CHUNK_ROW, tl[i].tm, c * CH,
                   tl[i].row0, h, b, bar);
    } else {
      mbar_arrive(bar);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    copy_tile(tl[i].dst, tl[i].src, tl[i].st, b, h, tl[i].row0, tl[i].rows,
              S, Dh, nc, t);
  fence_async_smem();
  mbar_arrive(bar);
}

template <int DP>
constexpr size_t fwd_wgmma_smem() {
  // Q tile, FWD_STAGES K and V tiles, the barriers, 1024-byte alignment
  // slack
  return (size_t)(DP / CH) * FWD_BN * CHUNK_ROW * (1 + 2 * FWD_STAGES) +
         8 * (1 + 2 * FWD_STAGES) + 1024;
}
template <int DP>
constexpr size_t dkv_wgmma_smem() {
  // K and V tiles, KV_STAGES Q and dO tiles with their LSE and delta
  // rows, the barriers, alignment slack
  return (size_t)(DP / CH) * KV_BN * CHUNK_ROW * 2 +
         KV_STAGES *
             ((size_t)(DP / CH) * KV_BQ * CHUNK_ROW * 2 + 2 * KV_BQ * 4) +
         8 * (1 + 2 * KV_STAGES) + 1024;
}

// bars[0]: the resident tile(s), then `stages` full barriers (each
// producer thread arrives) and `stages` empty ones (each consumer warp)
__device__ __forceinline__ void init_ring(uint64_t* bars, int stages) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], WG);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars[1 + s], WG);
      mbar_init(&bars[1 + stages + s], 2 * WG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// a consumer warp is done with a stage
__device__ __forceinline__ void warp_release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

static_assert(FWD_BM == FWD_BN, "the forward's diagonal key tile is j == qt");

template <int DP>
__global__ void __launch_bounds__(HOP_THREADS, 1)
fwd_wgmma(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ q,
          const bf16* __restrict__ k, const bf16* __restrict__ v,
          bf16* __restrict__ o, float* __restrict__ lse, Strides sq,
          Strides sk, Strides sv, Strides so, int B, int H, int S, int Dh,
          float scale, int causal, int tma) {
  constexpr int NC = DP / CH;
  constexpr int TILE = NC * FWD_BN * CHUNK_ROW;  // a 128-row tile (Q, K, V)
  extern __shared__ unsigned char raw[];
  unsigned char* Qs = align1024(raw);
  unsigned char* Ks = Qs + TILE;
  unsigned char* Vs = Ks + FWD_STAGES * TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + FWD_STAGES * TILE);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + FWD_STAGES;

  const int BH = B * H, n_qt = (S + FWD_BM - 1) / FWD_BM;
  const int t = blockIdx.x / BH;
  const int qt = causal ? n_qt - 1 - t : t;  // heaviest query tiles first
  const int b = blockIdx.x % BH / H, h = blockIdx.x % H;
  const int q0 = qt * FWD_BM;
  const int n_kt = causal ? qt + 1 : (S + FWD_BN - 1) / FWD_BN;
  const int wg = threadIdx.x / WG, lane = threadIdx.x & 31;
  init_ring(bars, FWD_STAGES);

  if (wg == 2) {  // producer: Q, then K_j and V_j into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int pt = threadIdx.x - 2 * WG;
    const TileLoad tq_load[1] = {{Qs, &tq, q, sq, q0, FWD_BM}};
    load_stage(tq_load, NC, b, h, S, Dh, tma, &bars[0], pt);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % FWD_STAGES;
      mbar_wait(&empty[s], ((j / FWD_STAGES) & 1) ^ 1);
      const TileLoad kv[2] = {{Ks + s * TILE, &tk, k, sk, j * FWD_BN, FWD_BN},
                              {Vs + s * TILE, &tv, v, sv, j * FWD_BN, FWD_BN}};
      load_stage(kv, NC, b, h, S, Dh, tma, &full[s], pt);
    }
  } else {  // consumers: rows q0 + 64 wg + (r0, r0 + 8)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int quad = lane >> 2, c2 = (lane & 3) * 2;
    const int r0 = (threadIdx.x % WG) / 32 * 16 + quad;
    const int row0 = q0 + wg * 64;
    const float sl2 = scale * LOG2E;
    const uint64_t q_d = sdesc(smem_u32(Qs) + wg * 64 * CHUNK_ROW, 16, 1024);
    float oacc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float m2[2] = {NEG, NEG}, lsum[2] = {0.f, 0.f};  // base-2 max, row sums
    mbar_wait(&bars[0], 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % FWD_STAGES, k0 = j * FWD_BN;
      mbar_wait(&full[s], (j / FWD_STAGES) & 1);
      // S = Q K^T into registers (the scores are written by wgmma only)
      float sacc[FWD_BN / 2];
      const uint64_t k_d = sdesc(smem_u32(Ks + s * TILE), 16, 1024);
      wg_fence();
      unrolled<DP / 16>([&](auto kk) {  // padded columns are zeros
        constexpr int K = decltype(kk)::value;
        constexpr int off = ((K >> 2) * FWD_BN * CHUNK_ROW + (K & 3) * 32) >> 4;
        if constexpr (K == 0)
          wgmma_ss_first<off, off>(sacc, q_d, k_d);
        else
          wgmma_ss<off, off>(sacc, q_d, k_d);
      });
      wg_commit();
      wg_wait<0>();
      fence_regs(sacc);
      // the online softmax in base 2, the diagonal and ragged tiles masked
      const bool masked = (causal && j == qt) || k0 + FWD_BN > S;
      auto score = [&](int i) {
        float x = sacc[i] * sl2;
        if (masked) {
          const int kp = k0 + 8 * (i / 4) + c2 + (i & 1);
          const int qp = row0 + r0 + 8 * ((i >> 1) & 1);
          if (kp >= S || (causal && kp > qp)) x = NEG;
        }
        return x;
      };
      float mx[2] = {m2[0], m2[1]}, alpha[2];
#pragma unroll
      for (int i = 0; i < FWD_BN / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], score(i));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = fast_exp2(m2[r] - mx[r]);
        m2[r] = mx[r];
        lsum[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
      // P: f32 weights summed into l, bf16 pairs as the A operand
      uint32_t pa[FWD_BN / 16][4];
#pragma unroll
      for (int kb = 0; kb < FWD_BN / 16; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kb + 2 * e, r = e & 1;
          const float p0 = fast_exp2(score(i) - m2[r]);
          const float p1 = fast_exp2(score(i + 1) - m2[r]);
          lsum[r] += p0 + p1;
          pa[kb][e] = pack_bf16(p0, p1);
        }
      // O += P V, V the transposed B operand
      const uint64_t v_d = sdesc(smem_u32(Vs + s * TILE), FWD_BN * CHUNK_ROW,
                                 1024);
      fence_regs(oacc);
      wg_fence();
      unrolled<FWD_BN / 16>([&](auto kb) {
        constexpr int K = decltype(kb)::value;
        wgmma_rs<K * 16 * CHUNK_ROW / 16>(oacc, pa[K], v_d);
      });
      wg_commit();
      wg_wait<0>();
      fence_regs(oacc);
      fence_regs(pa);
      warp_release(&empty[s], lane);
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] = quad_sum(lsum[r]);
      inv[r] = 1.f / lsum[r];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int r = (i >> 1) & 1, col = 8 * (i / 4) + c2;
      const int qp = row0 + r0 + 8 * r;
      if (qp < S && col < Dh)
        *reinterpret_cast<uint32_t*>(o + b * so.b + (long long)qp * so.s +
                                     h * so.h + col) =
            pack_bf16(oacc[i] * inv[r], oacc[i + 1] * inv[r]);
    }
    if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = row0 + r0 + 8 * r;
        if (qp < S)
          lse[((long long)b * H + h) * S + qp] = (m2[r] + log2f(lsum[r])) * LN2;
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(HOP_THREADS, 1)
dkv_wgmma(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo, const bf16* __restrict__ q,
          const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dk,
          bf16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
          Strides sdo, Strides sdk, Strides sdv, int B, int H, int S, int Dh,
          float scale, int causal, int tma) {
  constexpr int NC = DP / CH;
  constexpr int KTILE = NC * KV_BN * CHUNK_ROW;  // K or V, 128 keys
  constexpr int QTILE = NC * KV_BQ * CHUNK_ROW;  // Q or dO, 64 rows
  extern __shared__ unsigned char raw[];
  unsigned char* Ks = align1024(raw);
  unsigned char* Vs = Ks + KTILE;
  unsigned char* Qs = Vs + KTILE;              // the Q ring
  unsigned char* Gs = Qs + KV_STAGES * QTILE;  // the dO ring
  float* Ls = reinterpret_cast<float*>(Gs + KV_STAGES * QTILE);  // LSE log2 e
  float* Ds = Ls + KV_STAGES * KV_BQ;                            // delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ds + KV_STAGES * KV_BQ);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + KV_STAGES;

  const int BH = B * H;
  const int kt = blockIdx.x / BH;  // causal: the first key tiles see most
  const int b = blockIdx.x % BH / H, h = blockIdx.x % H;
  const int k0 = kt * KV_BN;
  const int n_qt = (S + KV_BQ - 1) / KV_BQ;
  const int qt0 = causal ? k0 / KV_BQ : 0;  // earlier queries see no key here
  const int n_q = n_qt - qt0;
  const int wg = threadIdx.x / WG, lane = threadIdx.x & 31;
  init_ring(bars, KV_STAGES);

  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int pt = threadIdx.x - 2 * WG;
    const long long row_bh = ((long long)b * H + h) * S;
    const TileLoad kv[2] = {{Ks, &tk, k, sk, k0, KV_BN},
                            {Vs, &tv, v, sv, k0, KV_BN}};
    load_stage(kv, NC, b, h, S, Dh, tma, &bars[0], pt);
    for (int j = 0; j < n_q; ++j) {
      const int s = j % KV_STAGES, q0 = (qt0 + j) * KV_BQ, qp = q0 + pt;
      // this tile's LSE and delta rows are loaded while the stage drains;
      // rows past S: LSE +inf, so their weights are 0
      float lr = __int_as_float(0x7f800000), dr = 0.f;
      if (pt < KV_BQ && qp < S) {
        lr = lse[row_bh + qp] * LOG2E;
        dr = delta[row_bh + qp];
      }
      mbar_wait(&empty[s], ((j / KV_STAGES) & 1) ^ 1);
      if (pt < KV_BQ) {
        Ls[s * KV_BQ + pt] = lr;
        Ds[s * KV_BQ + pt] = dr;
      }
      const TileLoad qg[2] = {{Qs + s * QTILE, &tq, q, sq, q0, KV_BQ},
                              {Gs + s * QTILE, &tdo, dout, sdo, q0, KV_BQ}};
      load_stage(qg, NC, b, h, S, Dh, tma, &full[s], pt);
    }
  } else {  // consumers: keys kw0 + (r0, r0 + 8)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int quad = lane >> 2, c2 = (lane & 3) * 2;
    const int r0 = (threadIdx.x % WG) / 32 * 16 + quad;
    const int kw0 = k0 + wg * 64;
    const float sl2 = scale * LOG2E;
    const uint64_t k_d = sdesc(smem_u32(Ks) + wg * 64 * CHUNK_ROW, 16, 1024);
    const uint64_t v_d = sdesc(smem_u32(Vs) + wg * 64 * CHUNK_ROW, 16, 1024);
    float gk[DP / 2], gv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) gk[i] = gv[i] = 0.f;
    mbar_wait(&bars[0], 0);
    for (int j = 0; j < n_q; ++j) {
      const int s = j % KV_STAGES, q0 = (qt0 + j) * KV_BQ;
      mbar_wait(&full[s], (j / KV_STAGES) & 1);
      if (!causal || q0 >= kw0) {  // else no query of the tile sees a key
        const uint32_t qa = smem_u32(Qs + s * QTILE);
        const uint32_t ga = smem_u32(Gs + s * QTILE);
        float st[KV_BQ / 2], dp[KV_BQ / 2];  // S^T and dP^T of this tile
        const uint64_t q_d = sdesc(qa, 16, 1024), g_d = sdesc(ga, 16, 1024);
        wg_fence();
        unrolled<DP / 16>([&](auto kk) {  // padded columns are zeros
          constexpr int K = decltype(kk)::value;
          constexpr int ko = ((K >> 2) * KV_BN * CHUNK_ROW + (K & 3) * 32) >> 4;
          constexpr int qo = ((K >> 2) * KV_BQ * CHUNK_ROW + (K & 3) * 32) >> 4;
          if constexpr (K == 0) {
            wgmma_ss_first<ko, qo>(st, k_d, q_d);
            wgmma_ss_first<ko, qo>(dp, v_d, g_d);
          } else {
            wgmma_ss<ko, qo>(st, k_d, q_d);
            wgmma_ss<ko, qo>(dp, v_d, g_d);
          }
        });
        wg_commit();
        wg_wait<0>();
        fence_regs(st);
        fence_regs(dp);
        const float* L = Ls + s * KV_BQ;
        const float* D = Ds + s * KV_BQ;
        const bool diag = causal && q0 == kw0;
        // P^T and dS^T in one pass (each score register dies as its pair
        // is packed), bf16 pairs as the A operands of dV and dK
        uint32_t pa[KV_BQ / 16][4], sa[KV_BQ / 16][4];
#pragma unroll
        for (int kb = 0; kb < KV_BQ / 16; ++kb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kb + 2 * e;
            const int kr = r0 + 8 * (e & 1), qc = 16 * kb + 8 * (e >> 1) + c2;
            float p0 = fast_exp2(st[i] * sl2 - L[qc]);
            float p1 = fast_exp2(st[i + 1] * sl2 - L[qc + 1]);
            if (diag) {
              if (kr > qc) p0 = 0.f;
              if (kr > qc + 1) p1 = 0.f;
            }
            pa[kb][e] = pack_bf16(p0, p1);
            sa[kb][e] = pack_bf16(p0 * (dp[i] - D[qc]) * scale,
                                  p1 * (dp[i + 1] - D[qc + 1]) * scale);
          }
        fence_regs(gv);
        fence_regs(gk);
        wg_fence();
        const uint64_t gt_d = sdesc(ga, KV_BQ * CHUNK_ROW, 1024);
        const uint64_t qt_d = sdesc(qa, KV_BQ * CHUNK_ROW, 1024);
        unrolled<KV_BQ / 16>([&](auto kb) {  // dV += P^T dO
          constexpr int K = decltype(kb)::value;
          wgmma_rs<K * 16 * CHUNK_ROW / 16>(gv, pa[K], gt_d);
        });
        unrolled<KV_BQ / 16>([&](auto kb) {  // dK += dS^T Q
          constexpr int K = decltype(kb)::value;
          wgmma_rs<K * 16 * CHUNK_ROW / 16>(gk, sa[K], qt_d);
        });
        wg_commit();
        wg_wait<0>();
        fence_regs(gv);
        fence_regs(gk);
        fence_regs(pa);
        fence_regs(sa);
      }
      warp_release(&empty[s], lane);
    }
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int r = (i >> 1) & 1, col = 8 * (i / 4) + c2;
      const int kp = kw0 + r0 + 8 * r;
      if (kp < S && col < Dh) {
        *reinterpret_cast<uint32_t*>(dk + b * sdk.b + (long long)kp * sdk.s +
                                     h * sdk.h + col) =
            pack_bf16(gk[i], gk[i + 1]);
        *reinterpret_cast<uint32_t*>(dv + b * sdv.b + (long long)kp * sdv.s +
                                     h * sdv.h + col) =
            pack_bf16(gv[i], gv[i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- launch

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

size_t fwd_smem(int Dh) { return (3 * BT * (Dh + 1) + BT * LDP) * sizeof(float); }
size_t dq_smem(int Dh) { return (4 * BT * (Dh + 1) + BT * LDP) * sizeof(float); }
size_t dkv_smem(int Dh) { return (4 * BT * (Dh + 1) + 2 * BT * LDP) * sizeof(float); }

// 16-byte loads: every pointer 16-byte aligned and every stride a
// multiple of 16 bytes
int vec_ok(const void* const* ptrs, int n, const long long* st, int elem) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return 0;
  for (int i = 0; i < 3 * n; ++i)
    if ((st[i] * elem) % 16) return 0;
  return 1;
}

bool shape_ok(int B, int H, int S, int Dh) {
  return B > 0 && H > 0 && S > 0 && Dh > 0 && Dh <= MAX_DH && Dh % 8 == 0;
}

// one CTA per (b, h, 64-row tile), dynamic shared memory above 48 KB
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int B, int H,
                   int S, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)B * H * ((S + BT - 1) / BT);
  kernel<<<(unsigned)grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// TMA's rules, else the copy route: every base 16-byte aligned, and the
// stride of every axis longer than 1 a positive multiple of 16 bytes
// below 2^40 (bf16 elements; st holds (b, s, h) strides per tensor)
int tma_ok(const void* const* ptrs, int n, const long long* st, int B, int H,
           int S) {
  const long long ext[3] = {B, S, H};
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return 0;
    for (int a = 0; a < 3; ++a) {
      const long long bytes = st[3 * i + a] * 2;
      if (ext[a] > 1 && (bytes <= 0 || bytes % 16 || bytes >= (1LL << 40)))
        return 0;
    }
  }
  return 1;
}

// The (Dh, S, H, B) tensor map of one strided bf16 tensor, boxes of 64
// columns by `rows` rows in the 128-byte swizzle, zeros outside the
// tensor.  0, or 1000 + the CUresult of a refused map.
int make_map(CUtensorMap* m, const void* ptr, Strides st, int B, int H, int S,
             int Dh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const long long ext[3] = {S, H, B}, el[3] = {st.s, st.h, st.b};
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  cuuint64_t strides[3];
  for (int a = 0; a < 3; ++a)  // an axis of extent 1 is never stepped
    strides[a] = ext[a] > 1 ? (cuuint64_t)(el[a] * 2) : 16;
  const cuuint32_t box[4] = {(cuuint32_t)CH, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// one CTA of three warpgroups per (tile, b, h)
template <typename Kernel, typename... Args>
cudaError_t launch_hopper(Kernel kernel, size_t smem, int tiles, int B, int H,
                          cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)tiles * B * H;
  kernel<<<(unsigned)grid, HOP_THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename T>
const T* in(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* out(void* p) { return static_cast<T*>(p); }

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (every tensor but lse/delta).
// `st` is a host array of (b, s, h) element strides per tensor, in the
// order of the tensor arguments; the head-dim stride must be 1.  `scale`
// is 1/sqrt(Dh) as the caller rounds it.  Requires Dh <= 128, Dh % 8 == 0
// (checked by the Python wrapper too).  Returns the cudaError_t of the
// launch, or 1000 + the CUresult of a refused tensor map.

// q, k, v, o; lse may be null (no backward will follow)
extern "C" int tp_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, const long long* st, int B,
                            int H, int S, int Dh, float scale, int causal,
                            int dtype, void* stream) {
  if (!shape_ok(B, H, S, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides a = strides_at(st, 0), b = strides_at(st, 1),
                c = strides_at(st, 2), d = strides_at(st, 3);
  float* l = static_cast<float*>(lse);
  const void* ptrs[] = {q, k, v, o};
  if (dtype == 0)
    return (int)launch(fwd_kernel<float>, THREADS, fwd_smem(Dh), B, H, S, s,
                       in<float>(q), in<float>(k), in<float>(v),
                       out<float>(o), l, a, b, c, d, H, S, Dh, scale, causal,
                       vec_ok(ptrs, 4, st, 4));
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int tma = tma_ok(ptrs, 3, st, B, H, S);
  CUtensorMap mq{}, mk{}, mv{};  // unread on the copy route
  if (tma) {
    int e = make_map(&mq, q, a, B, H, S, Dh, FWD_BM);
    if (!e) e = make_map(&mk, k, b, B, H, S, Dh, FWD_BN);
    if (!e) e = make_map(&mv, v, c, B, H, S, Dh, FWD_BN);
    if (e) return e;
  }
  const int tiles = (S + FWD_BM - 1) / FWD_BM;
  if (Dh <= 64)
    return (int)launch_hopper(fwd_wgmma<64>, fwd_wgmma_smem<64>(), tiles, B,
                              H, s, mq, mk, mv, in<bf16>(q), in<bf16>(k),
                              in<bf16>(v), out<bf16>(o), l, a, b, c, d, B, H,
                              S, Dh, scale, causal, tma);
  return (int)launch_hopper(fwd_wgmma<128>, fwd_wgmma_smem<128>(), tiles, B,
                            H, s, mq, mk, mv, in<bf16>(q), in<bf16>(k),
                            in<bf16>(v), out<bf16>(o), l, a, b, c, d, B, H, S,
                            Dh, scale, causal, tma);
}

// strides of q, k, v, o, do, dq; writes dq and delta (B, H, S) f32
extern "C" int tp_flash_dq(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* dq, void* delta, const long long* st, int B,
                           int H, int S, int Dh, float scale, int causal,
                           int dtype, void* stream) {
  if (!shape_ok(B, H, S, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides a = strides_at(st, 0), b = strides_at(st, 1),
                c = strides_at(st, 2), d = strides_at(st, 3),
                e = strides_at(st, 4), f = strides_at(st, 5);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const void* ptrs[] = {q, k, v, o, dout, dq};
  const int vec = vec_ok(ptrs, 6, st, dtype == 0 ? 4 : 2);
  if (dtype == 0)
    return (int)launch(dq_kernel<float>, THREADS, dq_smem(Dh), B, H, S, s,
                       in<float>(q), in<float>(k), in<float>(v),
                       in<float>(o), in<float>(dout), l, out<float>(dq), dl,
                       a, b, c, d, e, f, H, S, Dh, scale, causal, vec);
  if (dtype == 1)
    return (int)launch(dq_tc, TC_THREADS, dq_tc_smem(Dh), B, H, S, s,
                       in<bf16>(q), in<bf16>(k), in<bf16>(v), in<bf16>(o),
                       in<bf16>(dout), l, out<bf16>(dq), dl, a, b, c, d, e,
                       f, H, S, Dh, scale, causal, vec);
  return (int)cudaErrorInvalidValue;
}

// strides of q, k, v, do, dk, dv; reads the delta tp_flash_dq wrote
extern "C" int tp_flash_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            const long long* st, int B, int H, int S, int Dh,
                            float scale, int causal, int dtype,
                            void* stream) {
  if (!shape_ok(B, H, S, Dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides a = strides_at(st, 0), b = strides_at(st, 1),
                c = strides_at(st, 2), d = strides_at(st, 3),
                e = strides_at(st, 4), f = strides_at(st, 5);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  if (dtype == 0)
    return (int)launch(dkv_kernel<float>, THREADS, dkv_smem(Dh), B, H, S, s,
                       in<float>(q), in<float>(k), in<float>(v),
                       in<float>(dout), l, dl, out<float>(dk), out<float>(dv),
                       a, b, c, d, e, f, H, S, Dh, scale, causal,
                       vec_ok(ptrs, 6, st, 4));
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int tma = tma_ok(ptrs, 4, st, B, H, S);
  CUtensorMap mq{}, mk{}, mv{}, mg{};  // unread on the copy route
  if (tma) {
    int err = make_map(&mq, q, a, B, H, S, Dh, KV_BQ);
    if (!err) err = make_map(&mk, k, b, B, H, S, Dh, KV_BN);
    if (!err) err = make_map(&mv, v, c, B, H, S, Dh, KV_BN);
    if (!err) err = make_map(&mg, dout, d, B, H, S, Dh, KV_BQ);
    if (err) return err;
  }
  const int tiles = (S + KV_BN - 1) / KV_BN;
  if (Dh <= 64)
    return (int)launch_hopper(dkv_wgmma<64>, dkv_wgmma_smem<64>(), tiles, B,
                              H, s, mq, mk, mv, mg, in<bf16>(q), in<bf16>(k),
                              in<bf16>(v), in<bf16>(dout), l, dl,
                              out<bf16>(dk), out<bf16>(dv), a, b, c, d, e, f,
                              B, H, S, Dh, scale, causal, tma);
  return (int)launch_hopper(dkv_wgmma<128>, dkv_wgmma_smem<128>(), tiles, B,
                            H, s, mq, mk, mv, mg, in<bf16>(q), in<bf16>(k),
                            in<bf16>(v), in<bf16>(dout), l, dl, out<bf16>(dk),
                            out<bf16>(dv), a, b, c, d, e, f, B, H, S, Dh,
                            scale, causal, tma);
}

// The bf16 forward's and dK/dV's copy route for n tensors (pointers and
// (b, s, h) strides as above): 1 = TMA, 0 = the producer's own copies.
extern "C" int tp_flash_tma_route(const void* const* ptrs,
                                  const long long* st, int n, int B, int H,
                                  int S) {
  return tma_ok(ptrs, n, st, B, H, S);
}

// Dynamic shared memory of the bf16 forward (kernel 0) or dK/dV (1) at Dh.
extern "C" long long tp_flash_smem_bytes(int kernel, int Dh) {
  if (kernel == 0)
    return (long long)(Dh <= 64 ? fwd_wgmma_smem<64>() : fwd_wgmma_smem<128>());
  return (long long)(Dh <= 64 ? dkv_wgmma_smem<64>() : dkv_wgmma_smem<128>());
}
