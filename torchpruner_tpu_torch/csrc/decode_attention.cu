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
// 3.35 TB/s memory rate.  A decode step's calls are small (15 MB at
// Llama-3-8B's 4 slots), so what costs is latency: how many CTAs read at
// once and how many dependent trips to memory each one makes.  Design
// against that ("split-KV", one launch):
//   - a row's positions are cut into `n_split` chunks of `chunk`
//     positions, a function of T alone (`make_plan`, mirrored by
//     ops/decode_attention.py `decode_plan`), and one CTA of 256 threads
//     runs per (b, h, chunk), so a step's bytes are read by many CTAs at
//     once however few rows and heads it has;
//   - a chunk that starts past pos[b] returns at once; positions past
//     pos[b] are never read, so the bytes read scale with pos, not T;
//   - K and V rows are read as 16-byte vectors (8 bf16 or 4 f32 a lane;
//     element by element only where Dh or a base breaks the alignment),
//     G lanes to a row; a thread issues the K and the V loads of 4 rows
//     together, so a 64-position chunk is one trip to memory;
//   - each G-lane group keeps an online softmax (m, l, acc) in registers
//     over its rows, the score a butterfly over the group; the groups
//     are merged in group order through shared memory into the CTA's f32
//     partial (m, l, acc[Dh]);
//   - a row that fits one chunk writes its output from that CTA; else
//     each live CTA writes its partial to a scratch tensor and counts
//     itself in on the (b, h)'s counter, and the last to arrive merges
//     the partials in chunk order, writes the row and sets the counter
//     back to 0 for the next call: one launch a call, no atomics on data.
// Bit-stability: every sum is taken in an order fixed by T and the
// thread layout (never by which CTA arrives last), so a row's result
// depends only on its own positions 0..pos and on T - never on B, its
// neighbours, or stale K/V past pos - and two runs are bit-equal.  The
// same contract as the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;         // K / V rows a thread has in flight
constexpr int MAX_DH = 256;
constexpr int MIN_CHUNK = 64;     // positions of a chunk: a multiple of 64
constexpr int MAX_SPLIT = 16;     // chunks a row is cut into, at most
constexpr int MAX_CHUNK = 4096;   // so T <= 65536
constexpr float NEG_INF = -1e30f;

// The launch plan of a length-T cache: at most MAX_SPLIT chunks of a
// multiple of MIN_CHUNK positions, the last one clipped at T.
void make_plan(int T, int* chunk, int* n_split) {
  const int n = (T + MIN_CHUNK - 1) / MIN_CHUNK;
  const int want = n < MAX_SPLIT ? n : MAX_SPLIT;
  const int per = (T + want - 1) / want;
  *chunk = (per + MIN_CHUNK - 1) / MIN_CHUNK * MIN_CHUNK;
  *n_split = (T + *chunk - 1) / *chunk;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

// VEC consecutive elements of a K or V row: one 16-byte load when VEC is
// 16 / sizeof(T), else one element (VEC 1); widened to f32 on use
template <typename T, int VEC>
struct Vec {
  T x;
  __device__ __forceinline__ void load(const T* p) { x = __ldg(p); }
  __device__ __forceinline__ void get(float (&f)[VEC]) const { f[0] = to_f(x); }
};
template <>
struct Vec<float, 4> {
  float4 x;
  __device__ __forceinline__ void load(const float* p) {
    x = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void get(float (&f)[4]) const {
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 x;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    x = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 h;
      memcpy(&h, &w[e], sizeof(h));
      const float2 t = __bfloat1622float2(h);
      f[2 * e] = t.x;
      f[2 * e + 1] = t.y;
    }
  }
};

// One CTA per (b, h, chunk): blockIdx.x = (b * H + h) * n_split + chunk.
// G lanes (a power of two <= 32) read one K or V row, VEC elements each
// per load, at most MAXU loads a lane (a template argument, so the
// registers held are those the head dimension needs).  `part` holds
// (B * H * n_split, Dh + 2) f32 partials, `cnt` (B * H) counters that
// are 0 between calls.
template <typename TQ, typename TKV, int VEC, int MAXU>
__global__ void __launch_bounds__(THREADS)
decode_split(const TQ* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const int* __restrict__ pos,
             TKV* __restrict__ out, float* __restrict__ part,
             int* __restrict__ cnt, int H, int T, int Dh, int chunk,
             int n_split, int G, float scale) {
  extern __shared__ float smem[];
  __shared__ int last;
  __shared__ float wts[MAX_SPLIT];  // the merge's chunk weights
  const int groups = THREADS / G;  // rows read at once
  float* gm = smem;                // (groups,) the groups' max, then weight
  float* gl = gm + groups;         // (groups,) sums of weights
  float* ga = gl + groups;         // (groups, Dh) weighted sums of V rows
  const int c = blockIdx.x % n_split;
  const int bh = blockIdx.x / n_split;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, gi = tid / G, li = tid % G;
  const int units = Dh / VEC;
  const size_t row_stride = (size_t)H * Dh;  // one cache position
  // this lane's query elements (issued beside the position's load)
  float qv[MAXU][VEC];
#pragma unroll
  for (int w = 0; w < MAXU; ++w)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int d = (li + w * G) * VEC + e;
      qv[w][e] = d < Dh ? to_f(q[(size_t)bh * Dh + d]) * scale : 0.f;
    }
  int p = pos[b];
  p = p < 0 ? 0 : (p > T - 1 ? T - 1 : p);
  const int t0 = c * chunk;
  const int live = min(chunk, p - t0 + 1);
  if (live <= 0) return;  // the chunk starts past pos: nothing to read
  const int n_live = p / chunk + 1;

  const TKV* kb = k + ((size_t)b * T + t0) * row_stride + (size_t)h * Dh;
  const TKV* vb = v + ((size_t)b * T + t0) * row_stride + (size_t)h * Dh;
  float m = NEG_INF, l = 0.f, acc[MAXU][VEC];
#pragma unroll
  for (int w = 0; w < MAXU; ++w)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[w][e] = 0.f;
  // group gi takes rows gi, gi + groups, ...; the loop bound is
  // CTA-uniform, so every lane shuffles
  for (int base = 0; base < live; base += groups * UNROLL) {
    Vec<TKV, VEC> kr[UNROLL][MAXU], vr[UNROLL][MAXU];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int j = base + gi + r * groups;
#pragma unroll
      for (int w = 0; w < MAXU; ++w) {
        const int u = li + w * G;
        if (j < live && u < units) {
          kr[r][w].load(kb + (size_t)j * row_stride + u * VEC);
          vr[r][w].load(vb + (size_t)j * row_stride + u * VEC);
        }
      }
    }
    float s[UNROLL], mb = m;
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int j = base + gi + r * groups;
      s[r] = 0.f;
#pragma unroll
      for (int w = 0; w < MAXU; ++w) {
        if (j < live && li + w * G < units) {
          float kf[VEC];
          kr[r][w].get(kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[r] = fmaf(qv[w][e], kf[e], s[r]);
        }
      }
      for (int off = G / 2; off > 0; off >>= 1)
        s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
      if (j < live) mb = fmaxf(mb, s[r]);
    }
    const float alpha = expf(m - mb);
    l *= alpha;
#pragma unroll
    for (int w = 0; w < MAXU; ++w)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[w][e] *= alpha;
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int j = base + gi + r * groups;
      if (j >= live) continue;
      const float pr = expf(s[r] - mb);
      l += pr;
#pragma unroll
      for (int w = 0; w < MAXU; ++w) {
        if (li + w * G < units) {
          float vf[VEC];
          vr[r][w].get(vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[w][e] = fmaf(pr, vf[e], acc[w][e]);
        }
      }
    }
    m = mb;
  }
  // the groups merged in group order: one max, each group's weight
  if (li == 0) {
    gm[gi] = m;
    gl[gi] = l;
  }
#pragma unroll
  for (int w = 0; w < MAXU; ++w) {
    const int u = li + w * G;
    if (u < units)
#pragma unroll
      for (int e = 0; e < VEC; ++e) ga[gi * Dh + u * VEC + e] = acc[w][e];
  }
  __syncthreads();
  float mc = gm[0];
  for (int g = 1; g < groups; ++g) mc = fmaxf(mc, gm[g]);
  __syncthreads();  // every thread has read the maxima
  if (tid < groups) gm[tid] = expf(gm[tid] - mc);
  __syncthreads();
  float lc = 0.f;
  for (int g = 0; g < groups; ++g) lc += gl[g] * gm[g];
  if (n_live == 1) {  // the row is this chunk
    TKV* o = out + (size_t)bh * Dh;
    for (int d = tid; d < Dh; d += THREADS) {
      float a = 0.f;
      for (int g = 0; g < groups; ++g) a += ga[g * Dh + d] * gm[g];
      from_f(a / lc, o + d);
    }
    return;
  }
  float* mine = part + ((size_t)bh * n_split + c) * (Dh + 2);
  for (int d = tid; d < Dh; d += THREADS) {
    float a = 0.f;
    for (int g = 0; g < groups; ++g) a += ga[g * Dh + d] * gm[g];
    mine[2 + d] = a;
  }
  if (tid == 0) {
    mine[0] = mc;
    mine[1] = lc;
  }
  // the last live CTA of (b, h) to arrive merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&cnt[bh], 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = part + (size_t)bh * n_split * (Dh + 2);
  float M = __ldcg(parts);
  for (int r = 1; r < n_live; ++r) M = fmaxf(M, __ldcg(parts + r * (Dh + 2)));
  if (tid < n_live) wts[tid] = expf(__ldcg(parts + tid * (Dh + 2)) - M);
  __syncthreads();
  float L = 0.f;
  for (int r = 0; r < n_live; ++r)
    L += __ldcg(parts + r * (Dh + 2) + 1) * wts[r];
  TKV* o = out + (size_t)bh * Dh;
  for (int d = tid; d < Dh; d += THREADS) {
    float a = 0.f;
    for (int r = 0; r < n_live; ++r)
      a += __ldcg(parts + r * (Dh + 2) + 2 + d) * wts[r];
    from_f(a / L, o + d);
  }
  if (tid == 0) cnt[bh] = 0;  // ready for the next call on this stream
}

int pow2_at_least(int n) {
  int g = 1;
  while (g < n) g *= 2;
  return g;
}

// dynamic shared memory of a launch with G lanes a row
size_t smem_bytes(int Dh, int G) {
  const int groups = THREADS / G;
  return (size_t)groups * (2 + Dh) * sizeof(float);
}

template <typename TQ, typename TKV, int VEC, int MAXU>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, void* out, void* part, void* cnt, int B,
                   int H, int T, int Dh, int chunk, int n_split, float scale,
                   cudaStream_t s) {
  const int G = pow2_at_least(Dh / VEC) < 32 ? pow2_at_least(Dh / VEC) : 32;
  // 256 / G groups of Dh + 2 floats: at most 10 KB, under the 48 KB default
  const unsigned grid = (unsigned)((long long)B * H * n_split);
  decode_split<TQ, TKV, VEC, MAXU><<<grid, THREADS, smem_bytes(Dh, G), s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pos),
      static_cast<TKV*>(out), static_cast<float*>(part),
      static_cast<int*>(cnt), H, T, Dh, chunk, n_split, G, scale);
  return cudaGetLastError();
}

// 16-byte vectors when both caches start 16-byte aligned and a head's row
// is a whole number of vectors (every row then starts aligned)
template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* pos, void* out, void* part, void* cnt, int B,
                     int H, int T, int Dh, int chunk, int n_split, float scale,
                     cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(TKV);
  const bool vec = Dh % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  // a lane's vectors: one up to 32 a row (bf16 always; f32 up to Dh 128)
  if (vec && Dh <= 32 * VEC)
    return launch<TQ, TKV, VEC, 1>(q, k, v, pos, out, part, cnt, B, H, T, Dh,
                                   chunk, n_split, scale, s);
  if (vec)
    return launch<TQ, TKV, VEC, (MAX_DH / VEC + 31) / 32>(
        q, k, v, pos, out, part, cnt, B, H, T, Dh, chunk, n_split, scale, s);
  return launch<TQ, TKV, 1, MAX_DH / 32>(q, k, v, pos, out, part, cnt, B, H,
                                         T, Dh, chunk, n_split, scale, s);
}

}  // namespace

// The launch plan of a length-T cache: positions per chunk and chunks.
// 0, or cudaErrorInvalidValue when T is outside 1..MAX_SPLIT * MAX_CHUNK.
extern "C" int tp_decode_plan(int T, int* chunk, int* n_split) {
  if (T <= 0 || T > MAX_SPLIT * MAX_CHUNK) return (int)cudaErrorInvalidValue;
  make_plan(T, chunk, n_split);
  return 0;
}

// dtype codes: 0 = float32, 1 = bfloat16.  `chunk` / `n_split` must be
// the plan of T (tp_decode_plan; the Python wrapper passes its mirror,
// and a disagreement is refused).  `part` is f32 scratch of at least
// B * H * n_split * (Dh + 2) elements; `cnt` B * H int32 counters, 0 at
// the call, left 0 by it (the wrapper keeps one zeroed set per stream).
// `scale` is 1/sqrt(Dh) as the caller rounds it.  Requires Dh <= 256 and
// contiguous tensors (checked by the Python wrapper).  Returns the
// cudaError_t of the launch.
extern "C" int tp_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   void* out, void* part, void* cnt, int B,
                                   int H, int T, int Dh, int chunk,
                                   int n_split, float scale, int q_dtype,
                                   int kv_dtype, void* stream) {
  int want_chunk = 0, want_split = 0;
  if (B <= 0 || H <= 0 || Dh <= 0 || Dh > MAX_DH ||
      tp_decode_plan(T, &want_chunk, &want_split) != 0 ||
      chunk != want_chunk || n_split != want_split)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)dispatch<float, float>(q, k, v, pos, out, part, cnt, B, H, T,
                                       Dh, chunk, n_split, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)dispatch<float, __nv_bfloat16>(q, k, v, pos, out, part, cnt,
                                               B, H, T, Dh, chunk, n_split,
                                               scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return (int)dispatch<__nv_bfloat16, float>(q, k, v, pos, out, part, cnt,
                                               B, H, T, Dh, chunk, n_split,
                                               scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, pos, out, part, cnt, B, H, T, Dh, chunk, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}
