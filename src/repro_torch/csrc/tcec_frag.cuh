// Fragment and copy helpers shared by the kernels that stage source tiles
// with cp.async and feed mma.sync from shared memory: K2
// (tcec_matmul_k2.cu), K2b (tcec_matmul.cu), K3 (flash_attention.cu), K4
// (paged_attention.cu) and K7-K9 (structured.cu).  The split words are still made in registers (K1,
// tcec_core.cuh; K2b and K3 make the same words two values at a time);
// nothing here stages a word.
#pragma once

#include <type_traits>

#include "tcec_core.cuh"

namespace frag {

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;

// Words of an operand at dtype T under a PASSES schedule that can be nonzero:
// a bf16 value is its own word 0 and its other words are exactly 0.
template <typename T, int PASSES>
__host__ __device__ constexpr int op_words() {
  return is_bf16<T> ? 1 : tcec::n_words(PASSES);
}

// 16-byte asynchronous copy global -> shared; .cg keeps it out of L1.  With
// ok false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4-byte asynchronous copy global -> shared (.ca: the only class that
// takes 4 bytes), for a source that is not 16-byte aligned; with ok false
// nothing is read and the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// Two fp32 values rounded to bf16 (RNE) by one cvt.rn.bf16x2.f32: lo in the
// low half, as K1's pack2 packs them.
__device__ __forceinline__ uint32_t cvt2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The NW word registers of the pair (x0, x1), two values per conversion:
// bitwise K1's split_pair for finite values (a guarded split sanitizes
// first; one word is K1's plain cast of any value).  Only word 0 of a
// multi-word split can overflow (the residuals are at most half a bf16 ulp
// of the value), so only it is clamped to +-BF16_MAX, which is K1's
// saturating bf16_word for a finite value; CLAMP false skips the clamp for
// values known to lie within +-BF16_MAX.
template <int NW, bool CLAMP = true>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&f)[NW]) {
  const float m = tcec::bf16_max();
  uint32_t w = NW > 1 && CLAMP ? cvt2(fminf(fmaxf(x0, -m), m), fminf(fmaxf(x1, -m), m))
                               : cvt2(x0, x1);
  f[0] = w;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    x0 -= __uint_as_float(w << 16);
    x1 -= __uint_as_float(w & 0xFFFF0000u);
    w = cvt2(x0, x1);
    f[i] = w;
  }
}

// Programmatic dependent launch: a dependent grid may be scheduled once every
// block of this grid has called launch_dependents (or exited); wait_primary
// blocks until the grid this one depends on has completed and its memory is
// visible (a no-op in a grid launched without the attribute).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_primary() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// Four 8x8 bf16 matrices, transposed on the way: lane L addresses row L % 8
// of matrix L / 8, and receives elements (2t, g), (2t + 1, g) of each.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// The same without the transpose: lane L receives elements (g, 2t), (g, 2t +
// 1) of each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// The schedule's passes of one k16 step that can be nonzero, in schedule
// order: pass p multiplies n8-operand word sched_a(p) (the reference's lhs)
// by m16-operand word sched_b(p) (its rhs); it runs when both are below the
// operands' word counts.  Fresh accumulator per pass, passes summed in fp32,
// the sum added to acc (K1).
template <int PASSES, int NWX, int NWW>
__device__ __forceinline__ void run_passes(float (&acc)[4], const uint32_t (&fw)[NWW][4],
                                           const uint32_t (&fx)[NWX][2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  int done = 0;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int i = tcec::sched_a(PASSES, p), j = tcec::sched_b(PASSES, p);
    if (i < NWX && j < NWW) {
      float d[4];
      tcec::mma_16816(d, fw[j < NWW ? j : 0], fx[i < NWX ? i : 0]);
#pragma unroll
      for (int e = 0; e < 4; ++e) part[e] = done ? part[e] + d[e] : d[e];
      ++done;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// The same with the operands in the reference's roles: pass p multiplies
// m16-operand (lhs) word sched_a(p) by n8-operand (rhs) word sched_b(p).
template <int PASSES, int NWA, int NWB>
__device__ __forceinline__ void run_passes_ab(float (&acc)[4], const uint32_t (&fa)[NWA][4],
                                              const uint32_t (&fb)[NWB][2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  int done = 0;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int i = tcec::sched_a(PASSES, p), j = tcec::sched_b(PASSES, p);
    if (i < NWA && j < NWB) {
      float d[4];
      tcec::mma_16816(d, fa[i < NWA ? i : 0], fb[j < NWB ? j : 0]);
#pragma unroll
      for (int e = 0; e < 4; ++e) part[e] = done ? part[e] + d[e] : d[e];
      ++done;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// Passes run_passes runs under PASSES for operand word counts (NWX, NWW).
__host__ __device__ constexpr int passes_run(int passes, int nwx, int nww) {
  int n = 0;
  for (int p = 0; p < passes; ++p)
    if (tcec::sched_a(passes, p) < nwx && tcec::sched_b(passes, p) < nww) ++n;
  return n;
}

}  // namespace frag
