// K2b — the TCEC matmul with no epilogue, fp32 in and out, over a menu of
// tiles, plus its vpu arm.  (K2, the serving path's fused matmul, has its own
// source, tcec_matmul_k2.cu, designed for decode shapes.)
//
// Replaces: repro/kernels/tcec_matmul.py::_tcec_kernel (the pallas_call in
// _tcec_matmul_pallas), bf16-word and vpu arms.  Not ported yet: the int8
// words (the wrapper raises NotImplementedError).
//
// What bounds it on an H100: at bf16x6 a large-m call is bound by the six
// tensor-core passes (the batched and square products of tcec_matmul_auto
// are such calls); a small one by its bytes.  What the design does about it:
// only the fp32 source tiles are staged in shared memory, and the bf16 words
// of both operands are made in registers straight into the mma.sync
// fragments (K1), so the staged footprint does not grow with the number of
// words — the paper's WMMAe data flow, against the staged baseline K5/K6
// (tcec_staged.cu).  This version loads tiles synchronously (no cp.async/TMA
// pipeline yet).
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
// Row padding of the staged fp32 source tiles (elements); the footprint
// model (repro_torch/core/roofline.py::CUDA_FP32_PAD) counts the same.
constexpr int APAD = 4;
constexpr int BPAD = 4;

// Fragment value, sanitized when GUARD.
template <bool GUARD>
__device__ __forceinline__ float frag_val(float v, bool& bad) {
  if (GUARD && !isfinite(v)) {
    bad = true;
    v = 0.f;
  }
  return v;
}

template <int PASSES, bool VPU, int BM, int BN>
__global__ void __launch_bounds__(tile::threads(BM, BN))
tcec_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int* __restrict__ nonfinite, int M, int N, int K,
                   long long sAb, long long sBb, long long sCb) {
  constexpr int THREADS = tile::threads(BM, BN);
  constexpr int NW = tcec::n_words(PASSES);
  constexpr bool GUARD = !VPU && PASSES > 1;
  __shared__ float As[BM][BK + APAD];
  __shared__ float Bs[BK][BN + BPAD];

  const int tid = threadIdx.x;
  const tile::Lane l = tile::lane_of<BN>(tid);
  const int g = l.g, t = l.t, wm = l.wm, wn = l.wn;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long bi = blockIdx.z;
  const float* Ab = A + bi * sAb;
  const float* Bb = B + bi * sBb;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  bool bad = false;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage the fp32 source tiles (zero outside the matrix).
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int gr = m0 + r, gc = k0 + c;
      As[r][c] = (gr < M && gc < K) ? Ab[(long long)gr * K + gc] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < K && gc < N) ? Bb[(long long)gr * N + gc] : 0.f;
    }
    __syncthreads();

    if constexpr (VPU) {
      // Plain fp32 FFMA, one chain per output element in k order.
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[2][2], bv[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          av[mt][0] = As[wm + mt * 16 + g][kk];
          av[mt][1] = As[wm + mt * 16 + g + 8][kk];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bv[nt][0] = Bs[kk][wn + nt * 8 + 2 * t];
          bv[nt][1] = Bs[kk][wn + nt * 8 + 2 * t + 1];
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

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + tile::acc_row(l, mt, e);
        const int c = n0 + tile::acc_col(l, nt, e);
        if (r < M && c < N) C[bi * sCb + (long long)r * N + c] = acc[mt][nt][e];
      }
    }
  }
}

template <bool VPU, int BM, int BN>
cudaError_t launch_k2b(const float* A, const float* B, float* C, int* nonfinite, int M, int N,
                       int K, int batch, long long sAb, long long sBb, long long sCb,
                       cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  tcec_matmul_kernel<REPRO_PASSES, VPU, BM, BN>
      <<<grid, tile::threads(BM, BN), 0, stream>>>(A, B, C, nonfinite, M, N, K, sAb, sBb, sCb);
  return cudaGetLastError();
}

template <bool VPU, int BM, int BN>
cudaError_t attrs_k2b(int* smem_bytes, int* threads, int* regs, int* blocks_per_sm) {
  *threads = tile::threads(BM, BN);
  return tile::attrs(tcec_matmul_kernel<REPRO_PASSES, VPU, BM, BN>, *threads, 0,
                     smem_bytes, regs, blocks_per_sm);
}

}  // namespace

extern "C" {

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

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
