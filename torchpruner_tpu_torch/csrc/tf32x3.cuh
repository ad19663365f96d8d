// f32 products on Hopper's tensor cores at f32 accuracy (3xTF32), shared
// by the port's f32 kernels (flash_attention.cu: the forward, dQ and
// dK/dV; blocksparse_matmul.cu: the forward, dx and dW): cp.async copies
// into shared memory, the split of an f32 value into two TF32 halves, and
// mma.sync.m16n8k8 products of split operands.
//
// Each f32 operand x is split into big = tf32(x) (rounded to nearest)
// and small = x - big, and each product is the sum of three TF32
// products, small big + big small + big big (the small terms first), with
// f32 sums.  What the split drops, small small and the low bits of small
// that the tensor core truncates, is below 2^-21 of each term, near f32's
// own rounding; one TF32 pass carries 2^-11.
//
// Fragments of m16n8k8 (lane = 4 g + t): A (16 x 8, row-major) a0 = (g,
// t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8)
// b0 = (t, g), b1 = (t + 4, g); C (16 x 8) c0 = (g, 2t), c1 = (g, 2t + 1),
// c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1).  The kernels sum each block of
// 8 contracted elements in the order 2t -> k-index t, 2t + 1 -> t + 4:
// then an accumulator's two columns are an A fragment's two k-indices
// (`split_acc`), and two neighbouring elements of a row are one 8-byte
// load.

#pragma once

#include <stdint.h>

#include "sm90.cuh"

namespace {

// one cp.async of W (16 or 4) bytes; zeros in place of the source when
// !ok
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small + (below 2^-21 |x|): big is x rounded to TF32,
// nearest with ties away (cvt.rna.tf32's bit trick without its Inf/NaN
// guard, 2 instructions for its 4), small = x - big, exact in f32, whose
// low 13 bits the tensor core drops
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
// d += a b, one m16n8k8 product of TF32 operands
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in 3xTF32, a = (ab, as) and b = (bb, bs) split, small terms
// first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}
// the A fragment of an accumulator block c (rows g, g, g + 8, g + 8 by
// columns 2t, 2t + 1, 2t, 2t + 1), split: k-index t <- column 2t,
// t + 4 <- 2t + 1
__device__ __forceinline__ void split_acc(const float (&c)[4],
                                          uint32_t (&ab)[4],
                                          uint32_t (&as)[4]) {
  split(c[0], ab[0], as[0]);
  split(c[2], ab[1], as[1]);
  split(c[1], ab[2], as[2]);
  split(c[3], ab[3], as[3]);
}
// the A fragment of rows r and r + 8 of a row-major tile (pitch P) whose
// contracted elements c and c + 1 are neighbours (one 8-byte load a row),
// split: k-index t <- column c, t + 4 <- c + 1
template <int P>
__device__ __forceinline__ void a_frag_pair(const float* A, int r, int c,
                                            uint32_t (&ab)[4],
                                            uint32_t (&as)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(A + r * P + c);
  const float2 x1 = *reinterpret_cast<const float2*>(A + (r + 8) * P + c);
  split(x0.x, ab[0], as[0]);
  split(x1.x, ab[1], as[1]);
  split(x0.y, ab[2], as[2]);
  split(x1.y, ab[3], as[3]);
}

}  // namespace
