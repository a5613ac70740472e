// The TCEC matmul's fused epilogue, shared by K2 (tcec_matmul_k2.cu) and the
// non-finite fix-up (nonfinite_fixup.cuh): scale -> bias -> activation ->
// residual -> out dtype, in the order of the reference's store
// (repro/kernels/tcec_matmul.py::_fused_kernel).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace epi {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_TANH = 4 };

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case ACT_RELU: return y < 0.f ? 0.f : y;
    case ACT_GELU: {
      // jax.nn.gelu default: the tanh approximation.
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return y * (0.5f * (1.f + tanhf(c * (y + 0.044715f * (y * y * y)))));
    }
    case ACT_SILU: return y * (1.f / (1.f + expf(-y)));
    case ACT_TANH: return tanhf(y);
    default: return y;
  }
}

__device__ __forceinline__ float load_any(const void* p, long long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// The epilogue of one output element (column n): the result goes to out[o],
// the residual is read at res[r] (both o for a contiguous output).
struct Epilogue {
  void* out;
  const void* bias;
  const void* res;
  float scale;
  int act, bias_bf16, res_bf16, out_bf16;

  __device__ __forceinline__ void store_at(long long o, long long r, int n, float y) const {
    if (scale != 1.f) y = y * scale;
    if (bias != nullptr) y = y + load_any(bias, n, bias_bf16);
    y = apply_act(y, act);
    if (res != nullptr) y = y + load_any(res, r, res_bf16);
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[o] = y;
  }
  __device__ __forceinline__ void store(long long o, int n, float y) const {
    store_at(o, o, n, y);
  }
};

}  // namespace epi
