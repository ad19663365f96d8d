// Decode attention for Hopper (sm_90a): one query per (row, head) against
// the static KV cache, up to each row's own position.
//
// Replaces the Pallas kernel `_decode_call` / `_decode_kernel` in
// torchpruner_tpu/ops/decode_attention.py.
//   q (B, 1, H, Dh) f32|bf16;  k, v (B, T, H, Dh) f32|bf16 (the cache);
//   pos (B,) int32;  out (B, 1, H, Dh) in the cache dtype.
//
// Bound on the H100: bytes.  Each (b, h) reads its K and V rows 0..pos[b]
// once and does ~4 operations per element read, far below the card's
// ~295 operations per byte; the floor is the live cache bytes over the
// 3.35 TB/s memory rate.  Design against that bound:
//   - positions past pos[b] are never read (the TPU kernel re-addressed
//     its last live block for them; here the loop simply stops), so the
//     bytes read scale with pos, not with T;
//   - one thread block per (b, h), 4 warps: scores with one warp per
//     position and 4 positions in flight per warp (lanes across Dh,
//     contiguous 64/128-byte reads), values with one thread per head-dim
//     element (a warp reads a contiguous slice of each V row, 8 rows in
//     flight); an online softmax in f32 carries (m, l, acc) across KV
//     blocks in registers, so nothing but the output is written.
// Bit-stability: the KV block partition is `block`, a function of T alone
// (ops/decode_attention.py `_block_for`), and every sum is taken in a
// fixed order inside one thread block, so a row's result depends only on
// its own positions 0..pos and on T - never on B, its neighbours, or
// stale K/V past pos.  The same contract as the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SG = 4;             // positions a warp scores at once
constexpr int MAX_DH = 256;       // two head-dim elements per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
decode_attn(const TQ* __restrict__ q, const TKV* __restrict__ k,
            const TKV* __restrict__ v, const int* __restrict__ pos,
            TKV* __restrict__ out, int H, int T, int Dh, int block,
            float scale) {
  extern __shared__ float smem[];
  float* qs = smem;        // (Dh,)
  float* ps = smem + Dh;   // (block,) scores, then probabilities
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row_stride = (size_t)H * Dh;  // one cache position
  const TKV* kb = k + (size_t)b * T * row_stride + (size_t)h * Dh;
  const TKV* vb = v + (size_t)b * T * row_stride + (size_t)h * Dh;

  for (int d = tid; d < Dh; d += THREADS)
    qs[d] = to_f(q[((size_t)b * H + h) * Dh + d]);
  int p = pos[b];
  p = p < 0 ? 0 : (p > T - 1 ? T - 1 : p);
  const int n_run = p / block + 1;  // blocks holding positions <= p

  float m = NEG_INF, l = 0.f;
  float acc0 = 0.f, acc1 = 0.f;     // head-dim elements tid, tid + 128
  __syncthreads();

  for (int kb_i = 0; kb_i < n_run; ++kb_i) {
    const int t0 = kb_i * block;
    const int live = min(block, p - t0 + 1);  // positions <= p here
    // scores: each warp takes SG positions at a time, their K loads all
    // in flight together; one position's dot is lane-serial over Dh,
    // then a butterfly across the warp (a fixed order)
    for (int j0 = warp; j0 < block; j0 += SG * WARPS) {
      float s[SG];
      const TKV* kr[SG];
#pragma unroll
      for (int u = 0; u < SG; ++u) {
        const int j = j0 + u * WARPS;
        s[u] = 0.f;
        kr[u] = j < live ? kb + (size_t)(t0 + j) * row_stride : nullptr;
      }
      for (int d = lane; d < Dh; d += 32) {
        const float qd = qs[d];
#pragma unroll
        for (int u = 0; u < SG; ++u)
          if (kr[u] != nullptr) s[u] = fmaf(qd, to_f(kr[u][d]), s[u]);
      }
#pragma unroll
      for (int u = 0; u < SG; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
        const int j = j0 + u * WARPS;
        if (lane == 0 && j < block) ps[j] = j < live ? s[u] * scale : NEG_INF;
      }
    }
    __syncthreads();
    float mb = NEG_INF;
    for (int j = 0; j < block; ++j) mb = fmaxf(mb, ps[j]);
    const float m_new = fmaxf(m, mb);
    const float alpha = expf(m - m_new);
    __syncthreads();  // every thread has read the raw scores
    for (int j = tid; j < block; j += THREADS) ps[j] = expf(ps[j] - m_new);
    __syncthreads();
    float lsum = 0.f;
    for (int j = 0; j < block; ++j) lsum += ps[j];
    l = alpha * l + lsum;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int j = 0; j < live; ++j) {
      const TKV* vr = vb + (size_t)(t0 + j) * row_stride;
      const float pj = ps[j];
      if (tid < Dh) a0 = fmaf(pj, to_f(vr[tid]), a0);
      if (tid + THREADS < Dh) a1 = fmaf(pj, to_f(vr[tid + THREADS]), a1);
    }
    acc0 = acc0 * alpha + a0;
    acc1 = acc1 * alpha + a1;
    m = m_new;
    __syncthreads();  // ps is rewritten by the next block
  }
  TKV* o = out + ((size_t)b * H + h) * Dh;
  if (tid < Dh) from_f(acc0 / l, o + tid);
  if (tid + THREADS < Dh) from_f(acc1 / l, o + tid + THREADS);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, void* out, int B, int H, int T, int Dh,
                   int block, float scale, cudaStream_t s) {
  const size_t smem = (size_t)(Dh + block) * sizeof(float);
  decode_attn<TQ, TKV><<<B * H, THREADS, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pos),
      static_cast<TKV*>(out), H, T, Dh, block, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `scale` is 1/sqrt(Dh) as the
// caller rounds it.  Requires Dh <= 256 and contiguous tensors (checked by
// the Python wrapper).  Returns the cudaError_t of the launch.
extern "C" int tp_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   void* out, int B, int H, int T, int Dh,
                                   int block, float scale, int q_dtype,
                                   int kv_dtype, void* stream) {
  if (Dh > MAX_DH || block <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch<float, float>(q, k, v, pos, out, B, H, T, Dh, block, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(q, k, v, pos, out, B, H, T, Dh,
                                             block, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(q, k, v, pos, out, B, H, T, Dh,
                                             block, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pos, out, B, H,
                                                     T, Dh, block, scale, s);
  return (int)cudaErrorInvalidValue;
}
