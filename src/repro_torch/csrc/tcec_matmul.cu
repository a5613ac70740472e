// K2 — fused TCEC matmul: C = act(sum_sched A_i * B_j * scale + bias) + residual,
// and K2b — the same body with no epilogue, fp32 in and out, over a menu of
// tiles, plus its vpu arm.
//
// Replaces: repro/kernels/tcec_matmul.py::_fused_kernel (the pallas_call in
// _tcec_matmul_fused), bf16-word arms — K2; and ::_tcec_kernel (the
// pallas_call in _tcec_matmul_pallas), bf16-word and vpu arms — K2b.  Not
// ported yet: the int8 words and K2's in-kernel fragment rhs (the wrappers
// raise NotImplementedError).  One source, two libraries: built without
// REPRO_K2B it holds K2's entry point, with -DREPRO_K2B K2b's, so the two
// compile in parallel.
//
// What bounds it on an H100: on the serving path the lhs has few rows
// (decode: one row per slot; prefill: the prompt), so K2 streams the weight
// matrix once and is bound by its bytes; at bf16x6 a large-m call becomes
// bound by the six tensor-core passes (K2b's batched and square products are
// such calls).  What the design does about it: the weights are read at their
// own dtype (bf16 parameters are never widened to fp32 on the host, which
// would double the bytes and add a launch), only the source tiles are staged
// in shared memory at their input dtype, and the bf16 words of both operands
// are made in registers straight into the mma.sync fragments (K1), so the
// staged footprint does not grow with the number of words — the paper's
// WMMAe data flow, against the staged baseline K5/K6 (tcec_staged.cu).  The
// epilogue runs at the store, so the fp32 accumulator never goes through
// device memory.  This first version loads tiles synchronously (no
// cp.async/TMA pipeline yet).
//
// The vpu arm (K2b under fp32_vpu, the paper's "FP32 SIMT" baseline) stages
// the same fp32 tiles and runs a plain FFMA product on the SIMT cores: no
// split, no tensor core.  Each output element is one fp32 FMA chain in k
// order, so it too is the same bits at every tile.
//
// Grid: (n tiles, m tiles, batch); the k loop runs inside the block (it
// replaces the TPU grid's sequential k axis).  Ragged m/n/k edges are masked
// in-kernel: out-of-range loads read 0, out-of-range stores are skipped.
// Corrected policies (passes > 1) sanitize non-finite inputs to 0 while
// splitting and raise a flag; the host wrapper then restores the fp32
// reference's exact +-inf/NaN pattern (the reference's host-level guard).
#include "tcec_core.cuh"
#include "tcec_tile.cuh"

namespace {

constexpr int BK = tile::BK;
// Row padding of the staged fp32/bf16 source tiles (elements); the footprint
// model (repro_torch/core/roofline.py::CUDA_FP32_PAD) counts the same.
constexpr int APAD = 4;
constexpr int BPAD = 4;

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

// Fragment value at the input dtype -> fp32, sanitized when GUARD.
template <bool GUARD, typename T>
__device__ __forceinline__ float frag_val(T x, bool& bad) {
  float v = tcec::to_f32(x);
  if (GUARD && !isfinite(v)) {
    bad = true;
    v = 0.f;
  }
  return v;
}

template <typename TA, typename TB, int PASSES, bool VPU, int BM, int BN>
__global__ void __launch_bounds__(tile::threads(BM, BN))
tcec_matmul_kernel(const TA* __restrict__ A, const TB* __restrict__ B, void* __restrict__ C,
                   const void* __restrict__ bias, const void* __restrict__ res,
                   int* __restrict__ nonfinite, int M, int N, int K,
                   long long sAb, long long sBb, long long sCb, float scale, int act,
                   int bias_bf16, int res_bf16, int out_bf16) {
  constexpr int THREADS = tile::threads(BM, BN);
  constexpr int NW = tcec::n_words(PASSES);
  constexpr bool GUARD = !VPU && PASSES > 1;
  __shared__ TA As[BM][BK + APAD];
  __shared__ TB Bs[BK][BN + BPAD];

  const int tid = threadIdx.x;
  const tile::Lane l = tile::lane_of<BN>(tid);
  const int g = l.g, t = l.t, wm = l.wm, wn = l.wn;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long bi = blockIdx.z;
  const TA* Ab = A + bi * sAb;
  const TB* Bb = B + bi * sBb;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  bool bad = false;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage the source tiles at their input dtype (zero outside the matrix).
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int gr = m0 + r, gc = k0 + c;
      As[r][c] = (gr < M && gc < K) ? Ab[(long long)gr * K + gc] : TA(0.f);
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < K && gc < N) ? Bb[(long long)gr * N + gc] : TB(0.f);
    }
    __syncthreads();

    if constexpr (VPU) {
      // Plain fp32 FFMA, one chain per output element in k order.
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[2][2], bv[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          av[mt][0] = tcec::to_f32(As[wm + mt * 16 + g][kk]);
          av[mt][1] = tcec::to_f32(As[wm + mt * 16 + g + 8][kk]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bv[nt][0] = tcec::to_f32(Bs[kk][wn + nt * 8 + 2 * t]);
          bv[nt][1] = tcec::to_f32(Bs[kk][wn + nt * 8 + 2 * t + 1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] = fmaf(av[mt][e >> 1], bv[nt][e & 1], acc[mt][nt][e]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t fa[2][NW][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm + mt * 16 + g;
          float a[8];
          a[0] = frag_val<GUARD>(As[r][kk + 2 * t], bad);
          a[1] = frag_val<GUARD>(As[r][kk + 2 * t + 1], bad);
          a[2] = frag_val<GUARD>(As[r + 8][kk + 2 * t], bad);
          a[3] = frag_val<GUARD>(As[r + 8][kk + 2 * t + 1], bad);
          a[4] = frag_val<GUARD>(As[r][kk + 2 * t + 8], bad);
          a[5] = frag_val<GUARD>(As[r][kk + 2 * t + 9], bad);
          a[6] = frag_val<GUARD>(As[r + 8][kk + 2 * t + 8], bad);
          a[7] = frag_val<GUARD>(As[r + 8][kk + 2 * t + 9], bad);
          tcec::split_a_frag<NW>(a, fa[mt]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn + nt * 8 + g;
          float b[4];
          b[0] = frag_val<GUARD>(Bs[kk + 2 * t][c], bad);
          b[1] = frag_val<GUARD>(Bs[kk + 2 * t + 1][c], bad);
          b[2] = frag_val<GUARD>(Bs[kk + 2 * t + 8][c], bad);
          b[3] = frag_val<GUARD>(Bs[kk + 2 * t + 9][c], bad);
          uint32_t fb[NW][2];
          tcec::split_b_frag<NW>(b, fb);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) tcec::mma_passes<PASSES>(acc[mt][nt], fa[mt], fb);
        }
      }
    }
    __syncthreads();
  }
  if (GUARD && bad && nonfinite != nullptr) atomicExch(nonfinite, 1);

  // Epilogue at the store: scale -> bias -> act -> residual -> out dtype.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + tile::acc_row(l, mt, e);
        const int c = n0 + tile::acc_col(l, nt, e);
        if (r >= M || c >= N) continue;
        float y = acc[mt][nt][e];
        if (scale != 1.f) y = y * scale;
        if (bias != nullptr) y = y + load_any(bias, c, bias_bf16);
        y = apply_act(y, act);
        const long long o = bi * sCb + (long long)r * N + c;
        if (res != nullptr) y = y + load_any(res, o, res_bf16);
        if (out_bf16)
          static_cast<__nv_bfloat16*>(C)[o] = __float2bfloat16_rn(y);
        else
          static_cast<float*>(C)[o] = y;
      }
    }
  }
}

#ifndef REPRO_K2B

// K2's tile (K2b's default): 4 warps as 2 x 2.
constexpr int K2_BM = 64;
constexpr int K2_BN = 64;

template <typename TA, typename TB>
cudaError_t launch_typed(const void* A, const void* B, void* C, const void* bias,
                         const void* res, int* nonfinite, int M, int N, int K, int batch,
                         long long sAb, long long sBb, long long sCb, int passes,
                         float scale, int act, int bias_bf16, int res_bf16, int out_bf16,
                         cudaStream_t stream) {
  if (passes != REPRO_PASSES) return cudaErrorInvalidValue;
  dim3 grid((N + K2_BN - 1) / K2_BN, (M + K2_BM - 1) / K2_BM, batch);
  tcec_matmul_kernel<TA, TB, REPRO_PASSES, false, K2_BM, K2_BN>
      <<<grid, tile::threads(K2_BM, K2_BN), 0, stream>>>(
          static_cast<const TA*>(A), static_cast<const TB*>(B), C, bias, res, nonfinite, M, N,
          K, sAb, sBb, sCb, scale, act, bias_bf16, res_bf16, out_bf16);
  return cudaGetLastError();
}

#else  // REPRO_K2B

template <bool VPU, int BM, int BN>
cudaError_t launch_k2b(const float* A, const float* B, float* C, int* nonfinite, int M, int N,
                       int K, int batch, long long sAb, long long sBb, long long sCb,
                       cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  tcec_matmul_kernel<float, float, REPRO_PASSES, VPU, BM, BN>
      <<<grid, tile::threads(BM, BN), 0, stream>>>(A, B, C, nullptr, nullptr, nonfinite, M,
                                                   N, K, sAb, sBb, sCb, 1.f, ACT_NONE, 0, 0,
                                                   0);
  return cudaGetLastError();
}

template <bool VPU, int BM, int BN>
cudaError_t attrs_k2b(int* smem_bytes, int* threads, int* regs, int* blocks_per_sm) {
  *threads = tile::threads(BM, BN);
  return tile::attrs(tcec_matmul_kernel<float, float, REPRO_PASSES, VPU, BM, BN>, *threads, 0,
                     smem_bytes, regs, blocks_per_sm);
}

#endif

}  // namespace

extern "C" {

#ifndef REPRO_K2B

// K2.  A: (batch, M, K) row major at fp32 or bf16 (a_bf16); B: (K, N) shared
// by every batch (sBb == 0) or (batch, K, N); C: (batch, M, N) fp32 or bf16;
// bias (N,) and residual (batch, M, N) optional (null), either dtype.
// Returns cudaGetLastError() after the launch (0 on success).
int repro_tcec_matmul(const void* A, const void* B, void* C, const void* bias,
                      const void* res, int* nonfinite, int M, int N, int K, int batch,
                      long long sAb, long long sBb, long long sCb, int a_bf16, int b_bf16,
                      int passes, float scale, int act, int bias_bf16, int res_bf16,
                      int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_bf16 && b_bf16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(A, B, C, bias, res, nonfinite, M, N, K,
        batch, sAb, sBb, sCb, passes, scale, act, bias_bf16, res_bf16, out_bf16, s);
  else if (a_bf16)
    err = launch_typed<__nv_bfloat16, float>(A, B, C, bias, res, nonfinite, M, N, K,
        batch, sAb, sBb, sCb, passes, scale, act, bias_bf16, res_bf16, out_bf16, s);
  else if (b_bf16)
    err = launch_typed<float, __nv_bfloat16>(A, B, C, bias, res, nonfinite, M, N, K,
        batch, sAb, sBb, sCb, passes, scale, act, bias_bf16, res_bf16, out_bf16, s);
  else
    err = launch_typed<float, float>(A, B, C, bias, res, nonfinite, M, N, K,
        batch, sAb, sBb, sCb, passes, scale, act, bias_bf16, res_bf16, out_bf16, s);
  return static_cast<int>(err);
}

#else  // REPRO_K2B

// K2b.  A: (batch, M, K) fp32 row major; B: (K, N) shared by every batch
// (sBb == 0) or (batch, K, N), fp32; C: (batch, M, N) fp32.  vpu selects the
// plain FFMA arm, built into the 1-pass library only; otherwise `passes`
// must be this library's pass count.
// (bm, bn) is a tile of the menu (tcec_tile.cuh).  Returns
// cudaGetLastError() after the launch (0 on success).
int repro_tcec_matmul_pallas(const float* A, const float* B, float* C, int* nonfinite, int M,
                             int N, int K, int batch, long long sAb, long long sBb,
                             long long sCb, int passes, int vpu, int bm, int bn,
                             void* stream) {
  if (!vpu && passes != REPRO_PASSES) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = tile::dispatch(bm, bn, [&](auto shape) {
    using S = decltype(shape);
    if (!vpu)
      return launch_k2b<false, S::BM, S::BN>(A, B, C, nonfinite, M, N, K, batch, sAb, sBb,
                                             sCb, s);
    if constexpr (REPRO_PASSES == 1)
      return launch_k2b<true, S::BM, S::BN>(A, B, C, nullptr, M, N, K, batch, sAb, sBb, sCb,
                                            s);
    return cudaErrorInvalidValue;
  });
  return static_cast<int>(err);
}

// Shared memory per block (static; K2b asks for no dynamic memory),
// registers per thread and resident blocks per SM of K2b at tile (bm, bn).
int repro_tcec_matmul_pallas_attrs(int vpu, int bm, int bn, int* smem_bytes, int* threads,
                                   int* regs, int* blocks_per_sm) {
  cudaError_t err = tile::dispatch(bm, bn, [&](auto shape) {
    using S = decltype(shape);
    if (!vpu) return attrs_k2b<false, S::BM, S::BN>(smem_bytes, threads, regs, blocks_per_sm);
    if constexpr (REPRO_PASSES == 1)
      return attrs_k2b<true, S::BM, S::BN>(smem_bytes, threads, regs, blocks_per_sm);
    return cudaErrorInvalidValue;
  });
  return static_cast<int>(err);
}

#endif

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
