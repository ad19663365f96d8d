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
//   - one CTA per (b, h, 64-row tile): the forward and dQ tile queries
//     and loop over key tiles, dK/dV tiles keys and loops over query
//     tiles; blocks run in parallel, so each loop carries its own f32
//     accumulators (the TPU carried them across sequential grid steps);
//   - f32 (the scoring path) runs on the FMA units, which is all the
//     card has for f32 without TF32 rounding: 256 threads, tiles staged
//     through shared memory padded to an odd row length so the 16
//     threads of a row group hit 16 distinct banks, each thread a 4 x 4
//     block of the 64 x 64 score tile and 4 rows x Dh/16 output columns;
//   - bf16 (training) runs its products on the tensor cores (wmma
//     16x16x16, bf16 in, f32 accumulate), 4 warps of 16 rows each, with
//     the softmax and dS arithmetic in f32 on score tiles kept in shared
//     memory (see the bf16 section below);
//   - the online softmax keeps (m, l) per row in registers;
//   - causal: key tiles above the query tile's diagonal are never loaded
//     (forward, dQ), query tiles above the key tile's diagonal are never
//     loaded (dK/dV); only ragged or diagonal entries are masked;
//   - delta = rowsum(dO * O) is computed once, by the dQ kernel, which
//     writes it for the dK/dV kernel that runs after it on the stream;
//   - the ragged S edge is masked in the kernel, so every S launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// ------------------------------------------- bf16: tensor-core kernels
//
// The same three passes for bf16 on the tensor cores (wmma 16x16x16,
// bf16 products into f32 accumulators, mma.sync on sm_90).  One CTA of 4
// warps per 64-row tile, each warp owning 16 rows.  Tiles live in shared
// memory as bf16, the head dim zero-padded to a multiple of 16 (Dp); the
// score tiles a product makes are stored to shared memory as f32, where
// the softmax / dS arithmetic runs in f32 with two threads per row, and
// the bf16 result feeds the next product.  P and dS are rounded to bf16
// before their products (as FlashAttention-2 does); every sum is f32.

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
fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, bf16* __restrict__ o,
       float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
       Strides so, int H, int S, int Dh, float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char raw[];
  const int Dp = pad16(Dh), ld = Dp + 8, lo = Dp + 4;
  bf16* Qs = reinterpret_cast<bf16*>(raw);
  bf16* Ks = Qs + BT * ld;
  bf16* Vs = Ks + BT * ld;
  bf16* Ps = Vs + BT * ld;                                         // (64, LDH)
  float* Ss = reinterpret_cast<float*>(raw + align128((3 * BT * ld + BT * LDH) * sizeof(bf16)));
  float* Os = Ss + BT * LDS;                                       // (64, lo)
  const int n_qt = (S + BT - 1) / BT;
  const int q0 = (blockIdx.x % n_qt) * BT;
  const int b = blockIdx.x / n_qt / H;
  const int h = blockIdx.x / n_qt % H;
  const int warp = threadIdx.x >> 5;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;  // row, column parity
  const int qp = q0 + r;

  load_bf16(Qs, ld, q, sq, b, h, q0, S, Dh, Dp, vec);
  float m = NEG, l = 0.f;
  float acc[MAX_DH / 2];
#pragma unroll
  for (int j = 0; j < MAX_DH / 2; ++j) acc[j] = 0.f;
  const int n_kt = key_tiles(q0, S, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_bf16(Ks, ld, k, sk, b, h, k0, S, Dh, Dp, vec);
    load_bf16(Vs, ld, v, sv, b, h, k0, S, Dh, Dp, vec);
    __syncthreads();
    rows_by_rowsT(Ss, Qs, Ks, ld, Dp, warp);
    __syncwarp();
    float rmax = NEG;
    for (int j = half; j < BT; j += 2) {
      const int kp = k0 + j;
      const bool ok = kp < S && (!causal || kp <= qp);
      if (ok) rmax = fmaxf(rmax, Ss[r * LDS + j] * scale);
    }
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
    const float m_new = fmaxf(m, rmax);
    const float alpha = expf(m - m_new);
    float rsum = 0.f;
    for (int j = half; j < BT; j += 2) {
      const int kp = k0 + j;
      const bool ok = kp < S && (!causal || kp <= qp);
      // l (and with it the LSE the backward uses) sums the f32 weights;
      // only the value product sees them rounded to bf16
      const float p = ok ? expf(Ss[r * LDS + j] * scale - m_new) : 0.f;
      Ps[r * LDH + j] = __float2bfloat16(p);
      rsum += p;
    }
    l = l * alpha + rsum + __shfl_xor_sync(0xffffffffu, rsum, 1);
    m = m_new;
    __syncwarp();
    for (int nt = 0; nt * 16 < Dp; ++nt) {  // this tile's P V, stored
      FragC pv;
      wmma::fill_fragment(pv, 0.f);
      for (int kk = 0; kk < BT; kk += 16) {
        FragA a;
        FragBr bm;
        wmma::load_matrix_sync(a, Ps + warp * 16 * LDH + kk, LDH);
        wmma::load_matrix_sync(bm, Vs + kk * ld + nt * 16, ld);
        wmma::mma_sync(pv, a, bm, pv);
      }
      wmma::store_matrix_sync(Os + warp * 16 * lo + nt * 16, pv, lo,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < MAX_DH / 2; ++j) {
      const int col = half + 2 * j;
      if (col < Dp) acc[j] = acc[j] * alpha + Os[r * lo + col];
    }
  }
  if (qp < S) {
    const float inv = 1.f / l;
    bf16* orow = o + b * so.b + (long long)qp * so.s + h * so.h;
#pragma unroll
    for (int j = 0; j < MAX_DH / 2; ++j) {
      const int col = half + 2 * j;
      if (col < Dh) orow[col] = __float2bfloat16(acc[j] * inv);
    }
    if (lse != nullptr && half == 0)
      lse[((long long)b * H + h) * S + qp] = m + logf(l);
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

__global__ void __launch_bounds__(TC_THREADS)
dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const bf16* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq, Strides sk,
       Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int S,
       int Dh, float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char raw[];
  const int Dp = pad16(Dh), ld = Dp + 8, lo = Dp + 4;
  bf16* Ks = reinterpret_cast<bf16*>(raw);
  bf16* Vs = Ks + BT * ld;
  bf16* Qs = Vs + BT * ld;
  bf16* dOs = Qs + BT * ld;
  bf16* Pt = dOs + BT * ld;                                        // (64, LDH)
  bf16* dSt = Pt + BT * LDH;                                       // (64, LDH)
  float* St = reinterpret_cast<float*>(raw + align128((4 * BT * ld + 2 * BT * LDH) * sizeof(bf16)));
  float* dPt = St + BT * LDS;
  float* ls = dPt + BT * LDS;  // the query tile's lse and delta
  float* ds = ls + BT;
  float* Out = St;  // (64, lo) staging for dk / dv, after the last tile
  const int n_t = (S + BT - 1) / BT;
  const int kt = blockIdx.x % n_t;
  const int k0 = kt * BT;
  const int b = blockIdx.x / n_t / H;
  const int h = blockIdx.x / n_t % H;
  const int warp = threadIdx.x >> 5;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;  // key row here
  const int kp = k0 + r;
  const long long row_bh = ((long long)b * H + h) * S;

  load_bf16(Ks, ld, k, sk, b, h, k0, S, Dh, Dp, vec);
  load_bf16(Vs, ld, v, sv, b, h, k0, S, Dh, Dp, vec);
  FragC gk[MAX_NT], gv[MAX_NT];
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt) {
    wmma::fill_fragment(gk[nt], 0.f);
    wmma::fill_fragment(gv[nt], 0.f);
  }
  for (int qt = causal ? kt : 0; qt < n_t; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    load_bf16(Qs, ld, q, sq, b, h, q0, S, Dh, Dp, vec);
    load_bf16(dOs, ld, dout, sdo, b, h, q0, S, Dh, Dp, vec);
    if (threadIdx.x < BT) {
      const int p = q0 + threadIdx.x;
      ls[threadIdx.x] = p < S ? lse[row_bh + p] : 0.f;
      ds[threadIdx.x] = p < S ? delta[row_bh + p] : 0.f;
    }
    __syncthreads();
    rows_by_rowsT(St, Ks, Qs, ld, Dp, warp);    // S^T: keys x queries
    rows_by_rowsT(dPt, Vs, dOs, ld, Dp, warp);  // dP^T
    __syncwarp();
    for (int j = half; j < BT; j += 2) {
      const int qp = q0 + j;
      const bool ok = qp < S && kp < S && (!causal || kp <= qp);
      const float p = ok ? expf(St[r * LDS + j] * scale - ls[j]) : 0.f;
      Pt[r * LDH + j] = __float2bfloat16(p);
      dSt[r * LDH + j] = __float2bfloat16(p * (dPt[r * LDS + j] - ds[j]) * scale);
    }
    __syncwarp();
    rows_by_tile(gv, Pt, dOs, ld, Dp, warp);   // dV += P^T dO
    rows_by_tile(gk, dSt, Qs, ld, Dp, warp);   // dK += dS^T Q
  }
  for (int which = 0; which < 2; ++which) {
    __syncthreads();  // St/dPt are reused as the staging tile
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt * 16 >= Dp) break;
      if (which)
        wmma::store_matrix_sync(Out + warp * 16 * lo + nt * 16, gv[nt], lo,
                                wmma::mem_row_major);
      else
        wmma::store_matrix_sync(Out + warp * 16 * lo + nt * 16, gk[nt], lo,
                                wmma::mem_row_major);
    }
    __syncwarp();
    if (kp < S) {
      const Strides st = which ? sdv : sdk;
      bf16* row = (which ? dv : dk) + b * st.b + (long long)kp * st.s + h * st.h;
      for (int col = half; col < Dh; col += 2)
        row[col] = __float2bfloat16(Out[r * lo + col]);
    }
  }
}

size_t fwd_tc_smem(int Dh) {
  const int ld = pad16(Dh) + 8, lo = pad16(Dh) + 4;
  return align128((3 * BT * ld + BT * LDH) * sizeof(bf16)) +
         (BT * LDS + BT * lo) * sizeof(float);
}
// dQ and dK/dV stage their (64, Dp + 4) f32 output in the two score
// tiles (2 x 64 x 68 floats >= 64 x 132)
size_t dq_tc_smem(int Dh) {
  const int ld = pad16(Dh) + 8;
  return align128((4 * BT * ld + BT * LDH) * sizeof(bf16)) +
         2 * BT * LDS * sizeof(float);
}
size_t dkv_tc_smem(int Dh) {
  const int ld = pad16(Dh) + 8;
  return align128((4 * BT * ld + 2 * BT * LDH) * sizeof(bf16)) +
         (2 * BT * LDS + 2 * BT) * sizeof(float);
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
// launch.

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
  const int vec = vec_ok(ptrs, 4, st, dtype == 0 ? 4 : 2);
  if (dtype == 0)
    return (int)launch(fwd_kernel<float>, THREADS, fwd_smem(Dh), B, H, S, s,
                       in<float>(q), in<float>(k), in<float>(v),
                       out<float>(o), l, a, b, c, d, H, S, Dh, scale, causal,
                       vec);
  if (dtype == 1)
    return (int)launch(fwd_tc, TC_THREADS, fwd_tc_smem(Dh), B, H, S, s,
                       in<bf16>(q), in<bf16>(k), in<bf16>(v), out<bf16>(o),
                       l, a, b, c, d, H, S, Dh, scale, causal, vec);
  return (int)cudaErrorInvalidValue;
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
  const int vec = vec_ok(ptrs, 6, st, dtype == 0 ? 4 : 2);
  if (dtype == 0)
    return (int)launch(dkv_kernel<float>, THREADS, dkv_smem(Dh), B, H, S, s,
                       in<float>(q), in<float>(k), in<float>(v),
                       in<float>(dout), l, dl, out<float>(dk), out<float>(dv),
                       a, b, c, d, e, f, H, S, Dh, scale, causal, vec);
  if (dtype == 1)
    return (int)launch(dkv_tc, TC_THREADS, dkv_tc_smem(Dh), B, H, S, s,
                       in<bf16>(q), in<bf16>(k), in<bf16>(v), in<bf16>(dout),
                       l, dl, out<bf16>(dk), out<bf16>(dv), a, b, c, d, e, f,
                       H, S, Dh, scale, causal, vec);
  return (int)cudaErrorInvalidValue;
}
