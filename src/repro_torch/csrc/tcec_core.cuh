// K1 — the shared TCEC split/accumulate core, inlined by every kernel of the
// port (tcec_matmul.cu, flash_attention.cu, paged_attention.cu), as
// repro/kernels/tcec_core.py (split_vregs, mma_passes, policy_dot) is shared
// by the Pallas kernels of the JAX package.
//
// Replaces: repro/kernels/tcec_core.py::split_vregs, ::mma_passes, ::policy_dot
// (bf16 arms; the int8 arm, ::mma_passes_int8, is not ported yet).
//
// The paper's point (WMMAe's foreach_ij): the bf16 words of an fp32 tile are
// made in registers and never staged in shared memory.  mma.sync takes both
// operands from registers, so each thread splits the fp32 values it holds
// and writes the words straight into its A/B fragment registers.  wgmma is
// not used: it reads B only from shared memory, which would stage B's words.
//
// Accumulation (decided here, recorded in PERF.md): tensor-core accumulation
// does not round like an fp32 FMA (it aligns and truncates), which is why the
// schedule runs smallest-magnitude terms first.  Every pass of a k16 step
// gets a fresh zero accumulator; the pass results are summed in fp32 outside
// the tensor core in schedule order and the k-step's sum is then added to the
// running fp32 accumulator.  This mirrors the reference, which sums the
// scheduled passes of each k-tile in order before adding them to its
// accumulator, and keeps the tensor core's truncation confined to 16 exact
// products per pass.
#pragma once

// Each library is built for one pass count (-DREPRO_PASSES=1, 3 or 6), so
// the builds of the schedules run as parallel compiler processes; an entry
// point called with another count returns cudaErrorInvalidValue.
#ifndef REPRO_PASSES
#error "build with -DREPRO_PASSES=<1|3|6>"
#endif

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tcec {

// Largest finite bf16 value, (2 - 2^-7) * 2^127.
__device__ __forceinline__ float bf16_max() { return __uint_as_float(0x7F7F0000u); }

// Plain round-to-nearest-even bf16 cast, returned as the (exact) fp32 value.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 rounding of a split residual that saturates finite overflow: a finite
// value above BF16_MAX becomes +-BF16_MAX, not +-inf (an inf word would make
// the next residual inf - inf = NaN).  Non-finite inputs pass through.
__device__ __forceinline__ float bf16_word(float rest) {
  float w = bf16_round(rest);
  if (isinf(w) && isfinite(rest)) w = rest > 0.f ? bf16_max() : -bf16_max();
  return w;
}

// Words per operand for a pass count (the SCHEDULES table of
// repro_torch/core/policy.py): 1 -> 1, 3 -> 2, 6 -> 3.  bf16x9 (nine passes
// over three words) is not built yet.
__host__ __device__ constexpr int n_words(int passes) {
  return passes == 1 ? 1 : passes == 3 ? 2 : 3;
}

// The cross-term schedule, smallest magnitude first: pass p multiplies word
// sched_a(P, p) of A by word sched_b(P, p) of B.
//   P=1: (0,0)
//   P=3: (1,0) (0,1) (0,0)
//   P=6: (2,0) (1,1) (0,2) (1,0) (0,1) (0,0)
__host__ __device__ constexpr int sched_a(int passes, int p) {
  return passes == 1 ? 0
       : passes == 3 ? (p == 0 ? 1 : 0)
       : (p == 0 ? 2 : p == 1 ? 1 : p == 3 ? 1 : 0);
}
__host__ __device__ constexpr int sched_b(int passes, int p) {
  return passes == 1 ? 0
       : passes == 3 ? (p == 1 ? 1 : 0)
       : (p == 2 ? 2 : p == 1 || p == 4 ? 1 : 0);
}

// Split one fp32 value into NW bf16 words (as exact fp32 values): every word
// but the last is the saturating bf16_word of the running residual, the last
// a plain cast; NW == 1 is the plain cast.  Bitwise the same words as
// split_vregs in the reference.
template <int NW>
__device__ __forceinline__ void split_words(float x, float (&w)[NW]) {
  if (NW == 1) {
    w[0] = bf16_round(x);
    return;
  }
  float rest = x;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
    w[i] = bf16_word(rest);
    rest = rest - w[i];
  }
  w[NW - 1] = bf16_round(rest);
}

// Two bf16-exact fp32 values -> one 32-bit fragment register (lower column
// index in the low half).  The low 16 bits of a bf16-exact float are zero.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

// Split a pair of fp32 values and write word w of each into frag[w].
template <int NW>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&frag)[NW]) {
  float w0[NW], w1[NW];
  split_words<NW>(x0, w0);
  split_words<NW>(x1, w1);
#pragma unroll
  for (int i = 0; i < NW; ++i) frag[i] = pack2(w0[i], w1[i]);
}

// A fragment of m16n8k16 (row major), per thread: a[0..7] are the fp32
// values at (g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9)
// with g = lane / 4, t = lane % 4.  Produces the NW word fragments.
template <int NW>
__device__ __forceinline__ void split_a_frag(const float (&a)[8], uint32_t (&fa)[NW][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t tmp[NW];
    split_pair<NW>(a[2 * r], a[2 * r + 1], tmp);
#pragma unroll
    for (int i = 0; i < NW; ++i) fa[i][r] = tmp[i];
  }
}

// B fragment (col major, k x n = 16 x 8), per thread: b[0..3] are the fp32
// values at (k=2t..2t+1, n=g) and (k=2t+8..2t+9, n=g).
template <int NW>
__device__ __forceinline__ void split_b_frag(const float (&b)[4], uint32_t (&fb)[NW][2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t tmp[NW];
    split_pair<NW>(b[2 * r], b[2 * r + 1], tmp);
#pragma unroll
    for (int i = 0; i < NW; ++i) fb[i][r] = tmp[i];
  }
}

// One bf16 tensor-core pass with a fresh zero accumulator:
// d = A (16x16) * B (16x8), fp32 out.  C/D layout per thread:
// d[0..1] at (g, 2t..2t+1), d[2..3] at (g+8, 2t..2t+1).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// The pass schedule of one k16 step for one 16x8 output tile: fresh
// accumulator per pass, pass results summed in schedule order in fp32, the
// step's sum added to acc.
template <int PASSES>
__device__ __forceinline__ void mma_passes(float (&acc)[4],
                                           const uint32_t (&fa)[n_words(PASSES)][4],
                                           const uint32_t (&fb)[n_words(PASSES)][2]) {
  static_assert(PASSES == 1 || PASSES == 3 || PASSES == 6, "schedules: 1, 3 or 6 passes");
  float part[4];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    float d[4];
    mma_16816(d, fa[sched_a(PASSES, p)], fb[sched_b(PASSES, p)]);
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i] = (p == 0) ? d[i] : part[i] + d[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += part[i];
}

// Element loads at the input dtype, converted to fp32.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

}  // namespace tcec
