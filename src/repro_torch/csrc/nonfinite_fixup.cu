// The non-finite fix-up on its own (nonfinite_fixup.cuh), for the guarded
// calls whose kernel does not enqueue it itself: K2b (tcec_matmul.cu), K5/K6
// (tcec_staged.cu) and the twin's split schedule (guarded through
// repro_torch/tcec/frontend.py, e.g. the tied LM head).  K2 enqueues the same kernel from
// its own entry point, or folds it into its reduce kernel.
#include "nonfinite_fixup.cuh"

extern "C" {

// flag: int32 on the device, nonzero when an input held +-inf/NaN.  A (batch,
// M, K) and B (batch, K, N) at fp32 or bf16 (a_bf16, b_bf16) and O (batch, M,
// N) fp32, each given by element strides (batch, row, column): strides[0..2]
// for A, [3..5] for B, [6..8] for O.  Where the fp32 dot of A and B is not
// finite, O takes it; nothing else changes.  Enqueues on `stream`; returns
// cudaGetLastError() after the launch.
int repro_nonfinite_fixup(const int* flag, const void* A, int a_bf16, const void* B,
                          int b_bf16, float* O, int batch, int M, int N, int K,
                          const long long* strides, void* stream) {
  if (flag == nullptr || batch < 0 || M < 0 || N < 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const fixup::Operands P{A, B, a_bf16, b_bf16, M, N, K, strides[0], strides[1],
                          strides[2], strides[3], strides[4], strides[5]};
  const epi::Epilogue ep{O, nullptr, nullptr, 1.f, epi::ACT_NONE, 0, 0, 0};
  return static_cast<int>(fixup::launch(flag, P, batch, strides[6], strides[7], strides[8],
                                        ep, false, static_cast<cudaStream_t>(stream)));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
