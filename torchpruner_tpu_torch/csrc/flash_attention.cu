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
// the chip.  Design against that bound:
//   - f32 (the scoring path): all three kernels run on the tensor cores
//     in 3xTF32, three TF32 mma.sync products a product, which keeps
//     f32's accuracy (see "f32 kernels: 3xTF32" below): one CTA of 4
//     warps per (b, h, 64-row tile), a 2-stage cp.async ring; the forward
//     and dQ tile queries and loop over key tiles, dK/dV tiles keys and
//     loops over query tiles; blocks run in parallel, so each loop
//     carries its own f32 accumulators (the TPU carried them across
//     sequential grid steps);
//   - bf16 (training) runs all three kernels on Hopper's wgmma with
//     TMA-fed rings and the scores in registers (see "bf16 kernels:
//     wgmma" below): the forward and dQ one CTA per 128 query rows, dK/dV
//     one per 128 keys;
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
#include <stdint.h>
#include <string.h>

#include <utility>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int BT = 64;            // rows of a query or key tile
constexpr int MAX_DH = 128;
constexpr float NEG = -1e30f;

struct Strides {
  long long b, s, h;
};

// key tiles a query tile starting at q0 visits
__device__ __forceinline__ int key_tiles(int q0, int S, int causal) {
  const int n = (S + BT - 1) / BT;
  return causal ? min(n, (q0 + BT - 1) / BT + 1) : n;
}

// ------------------------------------------------ bf16 kernels: wgmma
//
// `fwd_wgmma`, `dq_wgmma` and `dkv_wgmma` run on Hopper's warpgroup
// products, in the shape the hardware is built for:
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
//   - a ring of tiles (2 stages of K and V in the forward, 3 of K and V
//     in dQ, 3 of Q and dO in dK/dV) with full / empty mbarriers: the
//     producer waits for a free stage, the consumers for a full one;
//   - products on wgmma (m64nNk16, bf16 in, f32 sums in registers).
//     The scores stay in the accumulator fragment; the softmax, dS and
//     masks run on it with quad shuffles; the bf16 weights are repacked
//     in registers as the A operand of the next product (a warp's
//     accumulator rows and columns are exactly an A fragment's), and V,
//     K, dO and Q enter that product as the transposed (MN-major) B
//     operand;
//   - causal: key tiles above the diagonal are never loaded, tiles
//     below it run unmasked, only the diagonal and the ragged S edge are
//     masked; the forward and dQ launch their heaviest query tiles first.
// Forward: one CTA per (128 query rows, b, h); S = Q K^T into registers,
// the online softmax in base 2 with (m, l) per row in registers (l sums
// the f32 weights), O += P V with P in registers, O in registers across
// all key tiles.  dQ: one CTA per (128 query rows, b, h), Q and dO
// resident, O loaded once beside them only to form delta (written before
// the key loop); per 64-key tile S = Q K^T and dP = dO V^T, then
// P = exp(S scale - LSE) and dS = P (dP - delta) scale in registers, the
// A operand of dQ += dS K; dQ in registers across the key tiles, rounded
// once into the Q tile's shared memory and stored by TMA.  dK/dV: one
// CTA per (128 keys, b, h), K and V resident, dK and dV in registers
// across the query tiles; per 64-row query tile S^T = K Q^T and
// dP^T = V dO^T, then P^T = exp(S^T scale - LSE) and
// dS^T = P^T (dP^T - delta) scale in registers, the A operands of
// dV += P^T dO and dK += dS^T Q.  Rows past S carry LSE = +inf, so their
// weights are 0 with no per-element test.  Deterministic: every sum runs
// in one CTA in a fixed order, no atomics.

typedef __nv_bfloat16 bf16;
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
constexpr int DQ_BM = 128;            // query rows of a dQ CTA
constexpr int DQ_BN = 64;             // keys of a dQ ring stage
constexpr int DQ_STAGES = 3;          // K/V ring of dQ
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

template <int DP>
constexpr size_t dq_wgmma_smem() {
  // Q, dO and O tiles, DQ_STAGES K and V tiles, the barriers, alignment
  // slack
  return (size_t)(DP / CH) * CHUNK_ROW *
             (3 * DQ_BM + 2 * DQ_STAGES * DQ_BN) +
         8 * (1 + 2 * DQ_STAGES) + 1024;
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

template <int DP>
__global__ void __launch_bounds__(HOP_THREADS, 1)
dq_wgmma(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const __grid_constant__ CUtensorMap to,
         const __grid_constant__ CUtensorMap tdo,
         const __grid_constant__ CUtensorMap tdq, const bf16* __restrict__ q,
         const bf16* __restrict__ k, const bf16* __restrict__ v,
         const bf16* __restrict__ o, const bf16* __restrict__ dout,
         const float* __restrict__ lse, float* __restrict__ delta,
         Strides sq, Strides sk, Strides sv, Strides so, Strides sdo, int B,
         int H, int S, int Dh, float scale, int causal, int tma) {
  constexpr int NC = DP / CH;
  constexpr int RTILE = NC * DQ_BM * CHUNK_ROW;  // Q, dO or O, 128 rows
  constexpr int KTILE = NC * DQ_BN * CHUNK_ROW;  // K or V, 64 keys
  extern __shared__ unsigned char raw[];
  unsigned char* Qs = align1024(raw);  // then dQ's staging
  unsigned char* Gs = Qs + RTILE;      // dO
  unsigned char* Os = Gs + RTILE;      // O, for delta only
  unsigned char* Ks = Os + RTILE;      // the K ring
  unsigned char* Vs = Ks + DQ_STAGES * KTILE;  // the V ring
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + DQ_STAGES * KTILE);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int BH = B * H, n_qt = (S + DQ_BM - 1) / DQ_BM;
  const int t = blockIdx.x / BH;
  const int qt = causal ? n_qt - 1 - t : t;  // heaviest query tiles first
  const int b = blockIdx.x % BH / H, h = blockIdx.x % H;
  const int q0 = qt * DQ_BM;
  const int n_all = (S + DQ_BN - 1) / DQ_BN;
  // causal: key tiles past the last query row are never loaded
  const int n_kt = causal ? min(n_all, (q0 + DQ_BM) / DQ_BN) : n_all;
  const int wg = threadIdx.x / WG, lane = threadIdx.x & 31;
  init_ring(bars, DQ_STAGES);

  if (wg == 2) {  // producer: Q, dO and O, then K_j and V_j into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int pt = threadIdx.x - 2 * WG;
    const TileLoad res[3] = {{Qs, &tq, q, sq, q0, DQ_BM},
                             {Gs, &tdo, dout, sdo, q0, DQ_BM},
                             {Os, &to, o, so, q0, DQ_BM}};
    load_stage(res, NC, b, h, S, Dh, tma, &bars[0], pt);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % DQ_STAGES;
      mbar_wait(&empty[s], ((j / DQ_STAGES) & 1) ^ 1);
      const TileLoad kv[2] = {
          {Ks + s * KTILE, &tk, k, sk, j * DQ_BN, DQ_BN},
          {Vs + s * KTILE, &tv, v, sv, j * DQ_BN, DQ_BN}};
      load_stage(kv, NC, b, h, S, Dh, tma, &full[s], pt);
    }
  } else {  // consumers: rows row0 + (r0, r0 + 8)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int quad = lane >> 2, c2 = (lane & 3) * 2;
    const int r0 = (threadIdx.x % WG) / 32 * 16 + quad;
    const int row0 = q0 + wg * 64;
    const long long row_bh = ((long long)b * H + h) * S;
    const float sl2 = scale * LOG2E;
    // key tiles this warpgroup's rows see (causal: up to its diagonal)
    const int n_see = causal ? min(n_kt, (row0 + 64) / DQ_BN) : n_kt;
    // LSE in base 2; rows past S +inf, so their weights are 0
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + r0 + 8 * r;
      l2[r] = qp < S ? lse[row_bh + qp] * LOG2E : __int_as_float(0x7f800000);
    }
    mbar_wait(&bars[0], 0);
    // delta = rowsum(dO * O) from the resident tiles: the four lanes of a
    // quad take every fourth 16-byte unit of the row, then a quad sum
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = wg * 64 + r0 + 8 * r;  // row of the 128-row tiles
      float part = 0.f;
#pragma unroll
      for (int w = 0; w < DP / 32; ++w) {
        const int u = (lane & 3) + 4 * w;
        const int off = (u >> 3) * DQ_BM * CHUNK_ROW + R * CHUNK_ROW +
                        (((u & 7) ^ (R & 7)) << 4);
        const uint4 gu = *reinterpret_cast<const uint4*>(Gs + off);
        const uint4 ou = *reinterpret_cast<const uint4*>(Os + off);
        const uint32_t gw[4] = {gu.x, gu.y, gu.z, gu.w};
        const uint32_t ow[4] = {ou.x, ou.y, ou.z, ou.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat162 gh, oh;
          memcpy(&gh, &gw[e], sizeof(gh));
          memcpy(&oh, &ow[e], sizeof(oh));
          const float2 gf = __bfloat1622float2(gh);
          const float2 of = __bfloat1622float2(oh);
          part = fmaf(gf.x, of.x, part);
          part = fmaf(gf.y, of.y, part);
        }
      }
      dl[r] = quad_sum(part);
      const int qp = row0 + r0 + 8 * r;
      if ((lane & 3) == 0 && qp < S) delta[row_bh + qp] = dl[r];
    }
    const uint64_t q_d = sdesc(smem_u32(Qs) + wg * 64 * CHUNK_ROW, 16, 1024);
    const uint64_t g_d = sdesc(smem_u32(Gs) + wg * 64 * CHUNK_ROW, 16, 1024);
    float acc[DP / 2];  // dQ rows r0, r0 + 8
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % DQ_STAGES, k0 = j * DQ_BN;
      mbar_wait(&full[s], (j / DQ_STAGES) & 1);
      if (j < n_see) {
        // S = Q K^T and dP = dO V^T into registers
        float sacc[DQ_BN / 2], pacc[DQ_BN / 2];
        const uint32_t ka = smem_u32(Ks + s * KTILE);
        const uint64_t k_d = sdesc(ka, 16, 1024);
        const uint64_t v_d = sdesc(smem_u32(Vs + s * KTILE), 16, 1024);
        wg_fence();
        unrolled<DP / 16>([&](auto kk) {  // padded columns are zeros
          constexpr int K = decltype(kk)::value;
          constexpr int ro = ((K >> 2) * DQ_BM * CHUNK_ROW + (K & 3) * 32) >> 4;
          constexpr int ko = ((K >> 2) * DQ_BN * CHUNK_ROW + (K & 3) * 32) >> 4;
          if constexpr (K == 0) {
            wgmma_ss_first<ro, ko>(sacc, q_d, k_d);
            wgmma_ss_first<ro, ko>(pacc, g_d, v_d);
          } else {
            wgmma_ss<ro, ko>(sacc, q_d, k_d);
            wgmma_ss<ro, ko>(pacc, g_d, v_d);
          }
        });
        wg_commit();
        wg_wait<0>();
        fence_regs(sacc);
        fence_regs(pacc);
        // P and dS in one pass (each score register dies as its pair is
        // packed), bf16 pairs as the A operand of dQ += dS K; the
        // diagonal and ragged tiles masked
        const bool masked = (causal && k0 + DQ_BN > row0) || k0 + DQ_BN > S;
        uint32_t sa[DQ_BN / 16][4];
#pragma unroll
        for (int kb = 0; kb < DQ_BN / 16; ++kb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kb + 2 * e, r = e & 1;
            float p0 = fast_exp2(sacc[i] * sl2 - l2[r]);
            float p1 = fast_exp2(sacc[i + 1] * sl2 - l2[r]);
            if (masked) {
              const int kp = k0 + 16 * kb + 8 * (e >> 1) + c2;
              const int qp = row0 + r0 + 8 * r;
              if (kp >= S || (causal && kp > qp)) p0 = 0.f;
              if (kp + 1 >= S || (causal && kp + 1 > qp)) p1 = 0.f;
            }
            sa[kb][e] = pack_bf16(p0 * (pacc[i] - dl[r]) * scale,
                                  p1 * (pacc[i + 1] - dl[r]) * scale);
          }
        // dQ += dS K, K the transposed B operand
        const uint64_t kt_d = sdesc(ka, DQ_BN * CHUNK_ROW, 1024);
        fence_regs(acc);
        wg_fence();
        unrolled<DQ_BN / 16>([&](auto kb) {
          constexpr int K = decltype(kb)::value;
          wgmma_rs<K * 16 * CHUNK_ROW / 16>(acc, sa[K], kt_d);
        });
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
        fence_regs(sa);
      }
      warp_release(&empty[s], lane);
    }
    // dQ rounded once into this warpgroup's 64 rows of the Q tile (its
    // products are done; the other warpgroup reads only its own rows), in
    // the 128-byte swizzle, then stored by TMA, clipped at S and Dh
    unsigned char* stg = Qs + wg * 64 * CHUNK_ROW;
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int r = r0 + 8 * ((i >> 1) & 1), u = (i >> 2) & 7;
      *reinterpret_cast<uint32_t*>(stg + i / 32 * DQ_BM * CHUNK_ROW +
                                   r * CHUNK_ROW + ((u ^ (r & 7)) << 4) +
                                   c2 * 2) = pack_bf16(acc[i], acc[i + 1]);
    }
    fence_async_smem();
    asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(WG) : "memory");
    if (threadIdx.x % WG == 0 && row0 < S) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_store_4d(&tdq, stg + c * DQ_BM * CHUNK_ROW, c * CH, row0, h, b);
      bulk_commit();
      bulk_wait<0>();
    }
  }
}

// ------------------------------------------ f32 kernels: 3xTF32 mma.sync
//
// `fwd_tf32x3<NTM, EXACT>`, `dq_tf32x3<NTM, EXACT>` and
// `dkv_tf32x3<NTM, EXACT>` run the f32 forward, dQ and dK/dV on the
// tensor cores at f32 accuracy (3xTF32, tf32x3.cuh), for Dh up to 8 NTM
// (NTM 8 for Dh <= 64, 16 up to 128); EXACT copies serve Dh = 8 NTM
// (BERT's 64, and 128), the others any smaller Dh.  One TF32 pass would
// miss the f32 tolerances (the CPU test
// `test_tf32x3_error_budget_fits_the_f32_tolerance` holds the budget of
// each kernel's chain of products).  mma.sync and not wgmma: wgmma takes
// TF32 operands from shared memory K-major only, and V (forward), K (dQ),
// dO and Q (dK/dV) enter their products MN-major, which TMA cannot
// transpose for f32.
//   - one CTA of 4 warps per 64 rows (queries in the forward and dQ, keys
//     in dK/dV); warp w owns rows 16 w .. 16 w + 15, an m16 tile, so its
//     scores against a 64-row tile are one accumulator fragment in
//     registers, and the online softmax (forward), P and dS (dQ), P^T and
//     dS^T (dK/dV) run on it with quad shuffles; the nt = Dh / 8 blocks of
//     8 columns in use guard each unrolled block loop, so the
//     accumulators' indices stay fixed at compile time (in registers) and
//     no block past Dh is loaded or multiplied; in an EXACT copy nt = NTM
//     is a constant and the guards fold away (run-time guards made the
//     forward and dK/dV 1.3-2.2x slower at Dh 64 and 128, and a test left
//     around each copy of copy_rows 1.1-1.5x);
//   - the streamed tiles (the forward's and dQ's K and V; dK/dV's Q and
//     dO with their LSE and delta rows) come through a 2-stage cp.async
//     ring, 16-byte copies where every row is 16-byte aligned, else
//     4-byte ones, zeros past S; the resident tiles (Q; Q and dO; K and
//     V) come the same way, in the first stage's group; dQ at Dh <= 64
//     keeps one stage (69,632 bytes, 165 registers: three CTAs an SM,
//     whose loads overlap each other's products), which measured 1.33x
//     faster at the scoring shape than two stages at two CTAs an SM;
//   - the weights go from the accumulator to the A operand of the next
//     product (P V; dS K; P^T dO and dS^T Q) with no shuffle
//     (`split_acc`): the sum over keys (queries) runs in the order
//     2t -> t, 2t + 1 -> t + 4 inside each block of 8 and the B operand is
//     read from rows 2t and 2t + 1; the forward's Q K^T takes its sum over
//     Dh in the same order, so a thread's two columns of Q or K are one
//     8-byte load;
//   - row pitches, fixed by NTM, give every fragment read 32 distinct
//     banks: the forward's Q and K = 8 (mod 32) floats (8-byte loads of
//     rows g), its V and every dQ and dK/dV tile 8 NTM + 4 = 4 (mod 8)
//     (4-byte loads of rows g, or of rows 2t and 2t + 1: dQ's K is read
//     both ways);
//   - the forward keeps Q's split fragments in registers across the key
//     loop at Dh <= 64 and re-reads them from shared memory above; dQ,
//     with three accumulators (S, dP, dQ), re-reads Q and dO;
//   - causal: tiles past the diagonal are never loaded; only the
//     diagonal and the ragged S tile test elements; dQ's and dK/dV's
//     query rows past S carry LSE = +inf, so their weights are 0.
// dQ computes delta = rowsum(dO * O) for its 64 rows first, from global
// memory (a quad of threads per row, each a quarter of the columns),
// writes it for dK/dV, and keeps its two rows' delta in registers; O is
// never staged.  Deterministic: one CTA per output tile, every sum in a
// fixed order, no atomics.

constexpr int TC_THREADS = 128;  // 4 warps of 16 rows

// the forward's Q and K pitch: the least >= Dh that is 8 (mod 32)
__host__ __device__ constexpr int pitch_qk(int dh) {
  return dh + ((8 - dh) % 32 + 32) % 32;
}
template <int NTM>
constexpr size_t fwd_tf32x3_smem() {  // Q, then 2 stages of K and of V
  return (size_t)BT * (3 * pitch_qk(8 * NTM) + 2 * (8 * NTM + 4)) * 4;
}
// dQ's K / V ring: one stage at Dh <= 64, so three CTAs share an SM
// (their registers allow it), else two stages
__host__ __device__ constexpr int dq_stages(int ntm) {
  return ntm <= 8 ? 1 : 2;
}
template <int NTM>
constexpr size_t dq_tf32x3_smem() {  // Q and dO, then the stages of K, V
  return (size_t)BT * (2 + 2 * dq_stages(NTM)) * (8 * NTM + 4) * 4;
}
template <int NTM>
constexpr size_t dkv_tf32x3_smem() {
  // K and V, then 2 stages of Q, dO and the LSE and delta rows
  return (size_t)BT * (6 * (8 * NTM + 4) + 4) * 4;
}

// rows row0 .. row0 + 63, columns 0 .. dh - 1, of one (b, h) slice of a
// (B, S, H, dh) f32 tensor into dst (pitch P floats) by cp.async: 16-byte
// copies when `vec`, else 4-byte ones; zeros past S.  The loop runs over
// DHM >= dh columns, fixed at compile time; those past dh are skipped,
// unless EXACT (dh = DHM), where no test is made.
template <int DHM, int P, bool EXACT>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          Strides st, int b, int h,
                                          int row0, int S, int dh,
                                          int vec) {
  const float* base = src + b * st.b + h * st.h;
  if (vec) {
    constexpr int U = DHM / 4;  // 16-byte units of a row
#pragma unroll
    for (int it = 0; it < BT * U / TC_THREADS; ++it) {
      const int i = threadIdx.x + it * TC_THREADS;
      const int r = i / U, c = (i - r * U) * 4, s = row0 + r;
      if (EXACT || c < dh)
        cp_async<16>(dst + r * P + c,
                     base + (long long)min(s, S - 1) * st.s + c, s < S);
    }
    return;
  }
  for (int it = 0; it < BT * DHM / TC_THREADS; ++it) {
    const int i = threadIdx.x + it * TC_THREADS;
    const int r = i / DHM, c = i - r * DHM, s = row0 + r;
    if (EXACT || c < dh)
      cp_async<4>(dst + r * P + c,
                  base + (long long)min(s, S - 1) * st.s + c, s < S);
  }
}

// the A fragment of a row-major tile A (pitch P), split: rows r and
// r + 8, columns c and c + 4
template <int P>
__device__ __forceinline__ void a_frag(const float* A, int r, int c,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split(A[r * P + c], ab[0], as[0]);
  split(A[(r + 8) * P + c], ab[1], as[1]);
  split(A[r * P + c + 4], ab[2], as[2]);
  split(A[(r + 8) * P + c + 4], ab[3], as[3]);
}
// two adjacent outputs: one 8-byte store when `vec`
__device__ __forceinline__ void put2(float* p, float x, float y, int vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    p[0] = x;
    p[1] = y;
  }
}

// This CTA's 64-row tile and b * H + h.  Causal: the heaviest tiles of
// every (b, h) first (the forward's last query tiles, dK/dV's first key
// tiles); else the tiles of one (b, h) side by side, so they find its
// streamed tiles in L2.
__device__ __forceinline__ void cta_tile(int n_t, int BH, int causal,
                                         bool last_first, int& tile,
                                         int& bh) {
  if (causal) {
    const int i = blockIdx.x / BH;
    tile = last_first ? n_t - 1 - i : i;
    bh = blockIdx.x % BH;
  } else {
    tile = blockIdx.x % n_t;
    bh = blockIdx.x / n_t;
  }
}

template <int NTM, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS)
fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
           Strides so, int B, int H, int S, int n_blocks, float scale,
           int causal, int vec) {
  constexpr int DHM = 8 * NTM, PQ = pitch_qk(DHM), PV = DHM + 4;
  constexpr bool QREG = NTM <= 8;  // Q's split fragments in registers
  const int nt = EXACT ? NTM : n_blocks, dh = 8 * nt;
  extern __shared__ float4 smem_tc[];
  float* Qs = reinterpret_cast<float*>(smem_tc);
  float* Ks = Qs + BT * PQ;      // 2 stages
  float* Vs = Ks + 2 * BT * PQ;  // 2 stages
  const int n_t = (S + BT - 1) / BT;
  int qt, bh;
  cta_tile(n_t, B * H, causal, true, qt, bh);
  const int b = bh / H, h = bh % H, q0 = qt * BT;
  const int n_kt = key_tiles(q0, S, causal);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // rows q0 + r0, q0 + r0 + 8
  const float sl2 = scale * LOG2E;

  copy_rows<DHM, PQ, EXACT>(Qs, q, sq, b, h, q0, S, dh, vec);
  copy_rows<DHM, PQ, EXACT>(Ks, k, sk, b, h, 0, S, dh, vec);
  copy_rows<DHM, PV, EXACT>(Vs, v, sv, b, h, 0, S, dh, vec);
  cp_commit();
  uint32_t qb[QREG ? NTM : 1][4], qs[QREG ? NTM : 1][4];
  float oacc[NTM][4];
#pragma unroll
  for (int c = 0; c < NTM; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[c][e] = 0.f;
  float m2[2] = {NEG, NEG}, lsum[2] = {0.f, 0.f};  // base-2 max, row sums
  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1, k0 = j * BT;
    if (j + 1 < n_kt) {  // the next K and V into the other stage
      copy_rows<DHM, PQ, EXACT>(Ks + (st ^ 1) * BT * PQ, k, sk, b, h,
                                k0 + BT, S, dh, vec);
      copy_rows<DHM, PV, EXACT>(Vs + (st ^ 1) * BT * PV, v, sv, b, h,
                                k0 + BT, S, dh, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < NTM; ++kk)
          if (kk < nt)
            a_frag_pair<PQ>(Qs, r0, 8 * kk + 2 * t, qb[kk], qs[kk]);
      }
    }
    const float* Kt = Ks + st * BT * PQ;
    const float* Vt = Vs + st * BT * PV;
    // S = Q K^T: rows r0 (+ 8), keys 8 n + 2t (+ 1)
    float sacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NTM; ++kk) {
      if (kk < nt) {
        uint32_t ab[4], as[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ab[e] = qb[kk][e];
            as[e] = qs[kk][e];
          }
        } else {
          a_frag_pair<PQ>(Qs, r0, 8 * kk + 2 * t, ab, as);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {  // B = K^T: keys 8 n + g
          const float2 x = *reinterpret_cast<const float2*>(
              Kt + (8 * n + g) * PQ + 8 * kk + 2 * t);
          uint32_t bb[2], bs[2];
          split(x.x, bb[0], bs[0]);
          split(x.y, bb[1], bs[1]);
          mma3(sacc[n], ab, as, bb, bs);
        }
      }
    }
    // the online softmax in base 2, the diagonal and ragged tiles masked
    const bool masked = (causal && j == qt) || k0 + BT > S;
    float mx[2] = {m2[0], m2[1]}, alpha[2];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[n][e] * sl2;
        if (masked) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const int qp = q0 + r0 + 8 * (e >> 1);
          if (kp >= S || (causal && kp > qp)) x = NEG;
        }
        sacc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = fast_exp2(m2[r] - mx[r]);
      m2[r] = mx[r];
      lsum[r] *= alpha[r];
    }
#pragma unroll
    for (int c = 0; c < NTM; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[c][e] *= alpha[e >> 1];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(sacc[n][e] - m2[e >> 1]);
        lsum[e >> 1] += p;
        sacc[n][e] = p;
      }
    // O += P V: the keys of block n in the order 2t -> t, 2t + 1 -> t + 4
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t ab[4], as[4];
      split_acc(sacc[n], ab, as);
      const float* vr = Vt + (8 * n + 2 * t) * PV + g;
#pragma unroll
      for (int c = 0; c < NTM; ++c) {  // B = V: columns 8 c + g
        if (c < nt) {
          uint32_t bb[2], bs[2];
          split(vr[8 * c], bb[0], bs[0]);
          split(vr[PV + 8 * c], bb[1], bs[1]);
          mma3(oacc[c], ab, as, bb, bs);
        }
      }
    }
    __syncthreads();  // this stage is free for tile j + 2
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + r0 + 8 * r;
    const float l = quad_sum(lsum[r]);
    if (qp >= S) continue;
    const float inv = 1.f / l;
    float* row = o + b * so.b + (long long)qp * so.s + h * so.h + 2 * t;
#pragma unroll
    for (int c = 0; c < NTM; ++c)
      if (c < nt)
        put2(row + 8 * c, oacc[c][2 * r] * inv, oacc[c][2 * r + 1] * inv,
             vec);
    if (lse != nullptr && t == 0)
      lse[((long long)b * H + h) * S + qp] = (m2[r] + log2f(l)) * LN2;
  }
}

template <int NTM, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS, NTM <= 8 ? 3 : 1)
dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ dq, float* __restrict__ delta, Strides sq,
          Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq,
          int B, int H, int S, int n_blocks, float scale, int causal,
          int vec) {
  constexpr int DHM = 8 * NTM, P = DHM + 4, TILE = BT * P;
  constexpr int STAGES = dq_stages(NTM);
  const int nt = EXACT ? NTM : n_blocks, dh = 8 * nt;
  extern __shared__ float4 smem_tc[];
  float* Qs = reinterpret_cast<float*>(smem_tc);
  float* Gs = Qs + TILE;           // dO
  float* Ks = Gs + TILE;           // STAGES stages
  float* Vs = Ks + STAGES * TILE;  // STAGES stages
  const int n_t = (S + BT - 1) / BT;
  int qt, bh;
  cta_tile(n_t, B * H, causal, true, qt, bh);
  const int b = bh / H, h = bh % H, q0 = qt * BT;
  const int n_kt = key_tiles(q0, S, causal);
  const long long row_bh = ((long long)b * H + h) * S;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // rows q0 + r0, q0 + r0 + 8
  const float sl2 = scale * LOG2E;

  copy_rows<DHM, P, EXACT>(Qs, q, sq, b, h, q0, S, dh, vec);
  copy_rows<DHM, P, EXACT>(Gs, dout, sdo, b, h, q0, S, dh, vec);
  copy_rows<DHM, P, EXACT>(Ks, k, sk, b, h, 0, S, dh, vec);
  copy_rows<DHM, P, EXACT>(Vs, v, sv, b, h, 0, S, dh, vec);
  cp_commit();
  // while the copies fly: delta = rowsum(dO * O) of rows r0 and r0 + 8
  // from global memory, the quad's thread t a quarter of the columns, in
  // a fixed order; LSE in base 2 (rows past S: LSE +inf, so their weights
  // are 0, and delta 0)
  float dl[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + r0 + 8 * r;
    float part = 0.f;
    if (qp < S) {
      const float* orow = o + b * so.b + (long long)qp * so.s + h * so.h;
      const float* grow =
          dout + b * sdo.b + (long long)qp * sdo.s + h * sdo.h;
      if (vec) {
#pragma unroll
        for (int c = 4 * t; c < DHM; c += 16) {
          if (EXACT || c < dh) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(grow + c));
            const float4 y = __ldg(reinterpret_cast<const float4*>(orow + c));
            part = fmaf(x.x, y.x, part);
            part = fmaf(x.y, y.y, part);
            part = fmaf(x.z, y.z, part);
            part = fmaf(x.w, y.w, part);
          }
        }
      } else {
#pragma unroll
        for (int c = t; c < DHM; c += 4)
          if (EXACT || c < dh)
            part = fmaf(__ldg(grow + c), __ldg(orow + c), part);
      }
    }
    dl[r] = quad_sum(part);
    l2[r] = qp < S ? lse[row_bh + qp] * LOG2E : __int_as_float(0x7f800000);
    if (t == 0 && qp < S) delta[row_bh + qp] = dl[r];
  }
  // dQ: rows r0 (+ 8), columns 8 c + 2t (+ 1)
  float acc[NTM][4];
#pragma unroll
  for (int c = 0; c < NTM; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  for (int j = 0; j < n_kt; ++j) {
    const int st = STAGES == 2 ? j & 1 : 0, k0 = j * BT;
    if constexpr (STAGES == 2) {
      if (j + 1 < n_kt) {  // the next K and V into the other stage
        copy_rows<DHM, P, EXACT>(Ks + (st ^ 1) * TILE, k, sk, b, h, k0 + BT,
                                 S, dh, vec);
        copy_rows<DHM, P, EXACT>(Vs + (st ^ 1) * TILE, v, sv, b, h, k0 + BT,
                                 S, dh, vec);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    } else {  // one stage: this tile's K and V once the last one is read
      if (j > 0) {
        copy_rows<DHM, P, EXACT>(Ks, k, sk, b, h, k0, S, dh, vec);
        copy_rows<DHM, P, EXACT>(Vs, v, sv, b, h, k0, S, dh, vec);
        cp_commit();
      }
      cp_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * TILE;
    const float* Vt = Vs + st * TILE;
    // S = Q K^T and dP = dO V^T: rows r0 (+ 8), keys 8 n + 2t (+ 1)
    float sacc[8][4], pacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NTM; ++kk) {
      if (kk < nt) {
        uint32_t qb[4], qs[4], gb[4], gs[4];
        a_frag<P>(Qs, r0, 8 * kk + t, qb, qs);
        a_frag<P>(Gs, r0, 8 * kk + t, gb, gs);
#pragma unroll
        for (int n = 0; n < 8; ++n) {  // B = K^T, V^T: keys 8 n + g
          const float* kr = Kt + (8 * n + g) * P + 8 * kk + t;
          const float* vr = Vt + (8 * n + g) * P + 8 * kk + t;
          uint32_t bb[2], bs[2];
          split(kr[0], bb[0], bs[0]);
          split(kr[4], bb[1], bs[1]);
          mma3(sacc[n], qb, qs, bb, bs);
          split(vr[0], bb[0], bs[0]);
          split(vr[4], bb[1], bs[1]);
          mma3(pacc[n], gb, gs, bb, bs);
        }
      }
    }
    // P = exp(S scale - LSE), dS = P (dP - delta) scale; the diagonal and
    // ragged tiles masked
    const bool diag = causal && j == qt;
    const bool masked = diag || k0 + BT > S;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * n + 2 * t + (e & 1), qr = r0 + 8 * (e >> 1);
        float p = fast_exp2(fmaf(sacc[n][e], sl2, -l2[e >> 1]));
        if (masked && (k0 + kc >= S || (diag && kc > qr))) p = 0.f;
        pacc[n][e] = p * (pacc[n][e] - dl[e >> 1]) * scale;
      }
    // dQ += dS K: the keys of block n in the order 2t -> t, 2t + 1 -> t + 4
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t sb[4], ss[4];
      split_acc(pacc[n], sb, ss);
      const float* kr = Kt + (8 * n + 2 * t) * P + g;
#pragma unroll
      for (int c = 0; c < NTM; ++c) {  // B = K: columns 8 c + g
        if (c < nt) {
          uint32_t bb[2], bs[2];
          split(kr[8 * c], bb[0], bs[0]);
          split(kr[P + 8 * c], bb[1], bs[1]);
          mma3(acc[c], sb, ss, bb, bs);
        }
      }
    }
    __syncthreads();  // this stage is free for tile j + STAGES
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + r0 + 8 * r;
    if (qp >= S) continue;
    float* row = dq + b * sdq.b + (long long)qp * sdq.s + h * sdq.h + 2 * t;
#pragma unroll
    for (int c = 0; c < NTM; ++c)
      if (c < nt) put2(row + 8 * c, acc[c][2 * r], acc[c][2 * r + 1], vec);
  }
}

template <int NTM, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS)
dkv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, Strides sq,
           Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
           int B, int H, int S, int n_blocks, float scale, int causal,
           int vec) {
  constexpr int DHM = 8 * NTM, P = DHM + 4, TILE = BT * P;
  const int nt = EXACT ? NTM : n_blocks, dh = 8 * nt;
  extern __shared__ float4 smem_tc[];
  float* Ks = reinterpret_cast<float*>(smem_tc);
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;      // 2 stages
  float* Gs = Qs + 2 * TILE;  // dO, 2 stages
  float* Ls = Gs + 2 * TILE;  // LSE rows, 2 stages
  float* Ds = Ls + 2 * BT;    // delta rows, 2 stages
  const int n_t = (S + BT - 1) / BT;
  int kt, bh;
  cta_tile(n_t, B * H, causal, false, kt, bh);
  const int b = bh / H, h = bh % H, k0 = kt * BT;
  const int qt0 = causal ? kt : 0;  // earlier queries see no key here
  const int n_q = n_t - qt0;
  const long long row_bh = ((long long)b * H + h) * S;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // keys k0 + r0, k0 + r0 + 8
  const float sl2 = scale * LOG2E;

  // a query tile's Q, dO, LSE and delta rows into stage `st`, one group;
  // rows past S: LSE +inf (their weights are 0), delta 0
  auto load_q = [&](int st, int q0) {
    copy_rows<DHM, P, EXACT>(Qs + st * TILE, q, sq, b, h, q0, S, dh, vec);
    copy_rows<DHM, P, EXACT>(Gs + st * TILE, dout, sdo, b, h, q0, S, dh,
                             vec);
    if (threadIdx.x < BT) {
      const int qp = q0 + threadIdx.x, i = st * BT + threadIdx.x;
      if (qp < S)
        cp_async<4>(Ls + i, lse + row_bh + qp, true);
      else
        Ls[i] = __int_as_float(0x7f800000);
      cp_async<4>(Ds + i, delta + row_bh + min(qp, S - 1), qp < S);
    }
    cp_commit();
  };
  copy_rows<DHM, P, EXACT>(Ks, k, sk, b, h, k0, S, dh, vec);
  copy_rows<DHM, P, EXACT>(Vs, v, sv, b, h, k0, S, dh, vec);
  load_q(0, qt0 * BT);
  // dK, dV: keys r0 (+ 8), columns 8 c + 2t (+ 1)
  float gk[NTM][4], gv[NTM][4];
#pragma unroll
  for (int c = 0; c < NTM; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.f;
  for (int j = 0; j < n_q; ++j) {
    const int st = j & 1, q0 = (qt0 + j) * BT;
    if (j + 1 < n_q) {
      load_q(st ^ 1, q0 + BT);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + st * TILE;
    const float* Gt = Gs + st * TILE;
    const float* L = Ls + st * BT;
    const float* D = Ds + st * BT;
    // S^T = K Q^T and dP^T = V dO^T: keys r0 (+ 8), queries 8 n + 2t (+ 1)
    float sacc[8][4], pacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NTM; ++kk) {
      if (kk < nt) {
        uint32_t kb[4], ks[4], vb[4], vs[4];
        a_frag<P>(Ks, r0, 8 * kk + t, kb, ks);
        a_frag<P>(Vs, r0, 8 * kk + t, vb, vs);
#pragma unroll
        for (int n = 0; n < 8; ++n) {  // B = Q^T, dO^T: queries 8 n + g
          const float* qr = Qt + (8 * n + g) * P + 8 * kk + t;
          const float* gr = Gt + (8 * n + g) * P + 8 * kk + t;
          uint32_t bb[2], bs[2];
          split(qr[0], bb[0], bs[0]);
          split(qr[4], bb[1], bs[1]);
          mma3(sacc[n], kb, ks, bb, bs);
          split(gr[0], bb[0], bs[0]);
          split(gr[4], bb[1], bs[1]);
          mma3(pacc[n], vb, vs, bb, bs);
        }
      }
    }
    // P^T = exp(S^T scale - LSE), dS^T = P^T (dP^T - delta) scale; the
    // diagonal and ragged tiles masked
    const bool diag = causal && q0 == k0;
    const bool masked = diag || k0 + BT > S;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1), kr = r0 + 8 * (e >> 1);
        float p = fast_exp2(fmaf(sacc[n][e], sl2, -L[qc] * LOG2E));
        if (masked && (k0 + kr >= S || (diag && kr > qc))) p = 0.f;
        sacc[n][e] = p;
        pacc[n][e] = p * (pacc[n][e] - D[qc]) * scale;
      }
    // dV += P^T dO, dK += dS^T Q: the queries of block n in the order
    // 2t -> t, 2t + 1 -> t + 4
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t pb[4], ps[4], sb[4], ss[4];
      split_acc(sacc[n], pb, ps);
      split_acc(pacc[n], sb, ss);
      const float* gr = Gt + (8 * n + 2 * t) * P + g;
      const float* qr = Qt + (8 * n + 2 * t) * P + g;
#pragma unroll
      for (int c = 0; c < NTM; ++c) {  // B = dO, Q: columns 8 c + g
        if (c < nt) {
          uint32_t bb[2], bs[2];
          split(gr[8 * c], bb[0], bs[0]);
          split(gr[P + 8 * c], bb[1], bs[1]);
          mma3(gv[c], pb, ps, bb, bs);
          split(qr[8 * c], bb[0], bs[0]);
          split(qr[P + 8 * c], bb[1], bs[1]);
          mma3(gk[c], sb, ss, bb, bs);
        }
      }
    }
    __syncthreads();  // this stage is free for tile j + 2
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + r0 + 8 * r;
    if (kp >= S) continue;
    float* krow = dk + b * sdk.b + (long long)kp * sdk.s + h * sdk.h + 2 * t;
    float* vrow = dv + b * sdv.b + (long long)kp * sdv.s + h * sdv.h + 2 * t;
#pragma unroll
    for (int c = 0; c < NTM; ++c) {
      if (c < nt) {
        put2(krow + 8 * c, gk[c][2 * r], gk[c][2 * r + 1], vec);
        put2(vrow + 8 * c, gv[c][2 * r], gv[c][2 * r + 1], vec);
      }
    }
  }
}

// ---------------------------------------------------------------- launch

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

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
  if (dtype == 0) {
    const int vec = vec_ok(ptrs, 4, st, 4);
    auto go = [&](auto kernel, size_t smem) {
      return (int)launch(kernel, TC_THREADS, smem, B, H, S, s, in<float>(q),
                         in<float>(k), in<float>(v), out<float>(o), l, a, b,
                         c, d, B, H, S, Dh / 8, scale, causal, vec);
    };
    if (Dh <= 64)
      return go(Dh == 64 ? fwd_tf32x3<8, true> : fwd_tf32x3<8, false>,
                fwd_tf32x3_smem<8>());
    return go(Dh == 128 ? fwd_tf32x3<16, true> : fwd_tf32x3<16, false>,
              fwd_tf32x3_smem<16>());
  }
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
  if (dtype == 0) {
    const void* ptrs[] = {q, k, v, o, dout, dq};
    const int vec = vec_ok(ptrs, 6, st, 4);
    auto go = [&](auto kernel, size_t smem) {
      return (int)launch(kernel, TC_THREADS, smem, B, H, S, s, in<float>(q),
                         in<float>(k), in<float>(v), in<float>(o),
                         in<float>(dout), l, out<float>(dq), dl, a, b, c, d,
                         e, f, B, H, S, Dh / 8, scale, causal, vec);
    };
    if (Dh <= 64)
      return go(Dh == 64 ? dq_tf32x3<8, true> : dq_tf32x3<8, false>,
                dq_tf32x3_smem<8>());
    return go(Dh == 128 ? dq_tf32x3<16, true> : dq_tf32x3<16, false>,
              dq_tf32x3_smem<16>());
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // dq is stored by TMA: its base and strides must be TMA's (the wrapper
  // allocates it contiguous); the inputs take TMA or the copy route
  const void* outs[] = {dq};
  if (!tma_ok(outs, 1, st + 15, B, H, S)) return (int)cudaErrorInvalidValue;
  const void* ins[] = {q, k, v, o, dout};
  const int tma = tma_ok(ins, 5, st, B, H, S);
  CUtensorMap mq{}, mk{}, mv{}, mo{}, mg{}, md{};  // loads: TMA route only
  int err = make_map(&md, dq, f, B, H, S, Dh, 64);
  if (!err && tma) {
    err = make_map(&mq, q, a, B, H, S, Dh, DQ_BM);
    if (!err) err = make_map(&mk, k, b, B, H, S, Dh, DQ_BN);
    if (!err) err = make_map(&mv, v, c, B, H, S, Dh, DQ_BN);
    if (!err) err = make_map(&mo, o, d, B, H, S, Dh, DQ_BM);
    if (!err) err = make_map(&mg, dout, e, B, H, S, Dh, DQ_BM);
  }
  if (err) return err;
  const int tiles = (S + DQ_BM - 1) / DQ_BM;
  if (Dh <= 64)
    return (int)launch_hopper(dq_wgmma<64>, dq_wgmma_smem<64>(), tiles, B, H,
                              s, mq, mk, mv, mo, mg, md, in<bf16>(q),
                              in<bf16>(k), in<bf16>(v), in<bf16>(o),
                              in<bf16>(dout), l, dl, a, b, c, d, e, B, H, S,
                              Dh, scale, causal, tma);
  return (int)launch_hopper(dq_wgmma<128>, dq_wgmma_smem<128>(), tiles, B, H,
                            s, mq, mk, mv, mo, mg, md, in<bf16>(q),
                            in<bf16>(k), in<bf16>(v), in<bf16>(o),
                            in<bf16>(dout), l, dl, a, b, c, d, e, B, H, S, Dh,
                            scale, causal, tma);
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
  if (dtype == 0) {
    const int vec = vec_ok(ptrs, 6, st, 4);
    auto go = [&](auto kernel, size_t smem) {
      return (int)launch(kernel, TC_THREADS, smem, B, H, S, s, in<float>(q),
                         in<float>(k), in<float>(v), in<float>(dout), l, dl,
                         out<float>(dk), out<float>(dv), a, b, c, d, e, f, B,
                         H, S, Dh / 8, scale, causal, vec);
    };
    if (Dh <= 64)
      return go(Dh == 64 ? dkv_tf32x3<8, true> : dkv_tf32x3<8, false>,
                dkv_tf32x3_smem<8>());
    return go(Dh == 128 ? dkv_tf32x3<16, true> : dkv_tf32x3<16, false>,
              dkv_tf32x3_smem<16>());
  }
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

// The bf16 kernels' copy route for n input tensors (pointers and (b, s,
// h) strides as above): 1 = TMA, 0 = the producer's own copies.
extern "C" int tp_flash_tma_route(const void* const* ptrs,
                                  const long long* st, int n, int B, int H,
                                  int S) {
  return tma_ok(ptrs, n, st, B, H, S);
}

// Dynamic shared memory of the bf16 forward (kernel 0), dK/dV (1) or dQ
// (2), or of the f32 forward (3), dK/dV (4) or dQ (5), at Dh.
extern "C" long long tp_flash_smem_bytes(int kernel, int Dh) {
  if (kernel == 5)
    return (long long)(Dh <= 64 ? dq_tf32x3_smem<8>() : dq_tf32x3_smem<16>());
  if (kernel == 3)
    return (long long)(Dh <= 64 ? fwd_tf32x3_smem<8>() : fwd_tf32x3_smem<16>());
  if (kernel == 4)
    return (long long)(Dh <= 64 ? dkv_tf32x3_smem<8>() : dkv_tf32x3_smem<16>());
  if (kernel == 0)
    return (long long)(Dh <= 64 ? fwd_wgmma_smem<64>() : fwd_wgmma_smem<128>());
  if (kernel == 2)
    return (long long)(Dh <= 64 ? dq_wgmma_smem<64>() : dq_wgmma_smem<128>());
  return (long long)(Dh <= 64 ? dkv_wgmma_smem<64>() : dkv_wgmma_smem<128>());
}
