// The non-finite fix-up: the device half of a corrected policy's guard.
//
// Replaces: the host branch of repro_torch/core/tcec.py::nonfinite_guard on
// the card, i.e. the reference's lax.cond in repro/core/tcec.py::
// nonfinite_guard.  A corrected split schedule runs on sanitized operands (a
// split word of +-inf/NaN would poison every later word); where the fp32 dot
// of the original operands is not finite, that dot, put through the call's
// epilogue, replaces the schedule's value.  The reference keeps the check on
// the device in a lax.cond; this kernel does the same without a host read:
// it runs on the stream after the call's last kernel, reads the call's int32
// flag (set by the matmul kernel while it split the fragments, or by torch
// ops on the inputs) and, when the flag is 0, every block returns at once.
//
// When the flag is set, each output element's fp32 dot is recomputed from
// the original operands in k order (acc = acc + a_k * b_k, rounded at each
// step, no FMA contraction) and, where it is not finite, stored through the
// epilogue.  Mixed +-inf and NaN inputs give the same NaN/inf pattern in any
// order of summation; only the overflow of a sum of finite values to +-inf
// can depend on the order, so on such inputs the pattern may differ from a
// cuBLAS product in which the partial sums are taken in another order.  The
// fix-up needs no tensor core and no speed: it does work only on inputs that
// hold +-inf or NaN.
//
// Operands are given by element strides, A (batch, M, K) and B (batch, K, N),
// so a transposed B (the tied head's ...y,zy->...z) is a stride.  K2's frag=
// arm has no B in memory (b null): B's values then come from the same menu
// rule (rule_menu.cuh) the kernel made them from.
#pragma once

#include "epilogue.cuh"
#include "rule_menu.cuh"
#include "tcec_frag.cuh"

namespace fixup {
namespace {

struct Operands {
  const void* a;
  const void* b;
  int a_bf16, b_bf16;
  int M, N, K;
  long long sab, sam, sak, sbb, sbk, sbn;
  menu::Spec rule{menu::NONE, 0, 0};  // B's values where b is null
};

// The fp32 dot of output element (bi, m, n) over k, in k order.
__device__ __forceinline__ float ref_dot(const Operands& P, long long bi, int m, int n) {
  const long long ao = bi * P.sab + m * P.sam;
  const long long bo = bi * P.sbb + n * P.sbn;
  float acc = 0.f;
  for (int k = 0; k < P.K; ++k) {
    const float b = P.b != nullptr ? epi::load_any(P.b, bo + k * P.sbk, P.b_bf16)
                                   : menu::rule_at(P.rule, k, n);
    acc = __fadd_rn(acc, __fmul_rn(epi::load_any(P.a, ao + k * P.sak, P.a_bf16), b));
  }
  return acc;
}

constexpr int THREADS = 256;
// Blocks of a fix-up launch: with the flag clear each only reads it.
constexpr int MAX_BLOCKS = 1024;

// Output element o = (bi * M + m) * N + n is stored at bi * sob + m * som +
// n * son (the residual, if any, is read at o).
__global__ void __launch_bounds__(THREADS)
nonfinite_fixup_kernel(const int* __restrict__ flag, Operands P, long long total,
                       long long sob, long long som, long long son, epi::Epilogue ep) {
  frag::wait_primary();
  if (*flag == 0) return;
  const long long mn = static_cast<long long>(P.M) * P.N;
  for (long long o = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; o < total;
       o += static_cast<long long>(gridDim.x) * THREADS) {
    const long long bi = o / mn;
    const int m = static_cast<int>(o % mn / P.N), n = static_cast<int>(o % P.N);
    const float ref = ref_dot(P, bi, m, n);
    if (!isfinite(ref)) ep.store_at(bi * sob + m * som + n * son, o, n, ref);
  }
}

// Enqueue the fix-up of a (batch, M, N) output on `stream`; with `dependent`
// as a programmatic dependent launch of the kernel just before it.
cudaError_t launch(const int* flag, const Operands& P, long long batch, long long sob,
                   long long som, long long son, const epi::Epilogue& ep, bool dependent,
                   cudaStream_t stream) {
  const long long total = batch * P.M * P.N;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, nonfinite_fixup_kernel, flag, P, total, sob, som, son, ep);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace fixup
