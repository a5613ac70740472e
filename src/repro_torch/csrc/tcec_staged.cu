// K5 — staged TCEC matmul (the paper's WMMA-API baseline, Fig. 6 top), and
// K6 — the same with a two-slot cp.async pipeline over the k loop.
//
// Replaces: repro/kernels/tcec_matmul.py::_staged_kernel (the pallas_call in
// _tcec_matmul_staged) — K5; and ::_staged_db_kernel (the pallas_call in
// _tcec_matmul_staged_db) — K6.  bf16 words only, as in the reference.
//
// The data flow is the baseline's by design: the host splits both fp32
// operands into n_words bf16 word arrays (repro_torch.core.precision.
// split_words, bitwise K1's in-register split), and the kernel stages every
// word tile — 2 * n_words of them per k step — in shared memory before it
// loads the mma.sync fragments from there.  The footprint therefore grows
// with the number of words: 1.5x K2b's fp32 tiles at three words (paper
// §4.4), and K6 holds two slots of it.  That is the quantity the paper's
// WMMAe data flow (K2b, tcec_matmul.cu) reduces; the two are compared on
// the same tile menu (tcec_tile.cuh).  The scheduled passes run through K1's
// mma_passes in the same order as K2b, so K2b, K5 and K6 give the same bits.
//
// What bounds it on an H100: at bf16x6 and large shapes, the six tensor-core
// passes; at the small batched shapes, the words' bytes (the host writes
// 2 * n_words bytes per element per operand and the kernel reads them back)
// and the shared-memory round trip.  K5 loads each tile synchronously; K6
// issues the 16-byte cp.async.cg copies of tile k+1 into the other slot
// before it computes tile k, so the copy overlaps the passes.  TMA and
// mbarriers are later work.
//
// Layout: A words (n_words, batch, M, ldk), B words (n_words, [batch,] K,
// ldn), bf16, with ldk = K and ldn = N rounded up to 8 elements (the host
// zero-fills the pad), so every row and every 16-byte chunk is 16-byte
// aligned.  A chunk is either inside its row or, past M / K / ldk / ldn,
// zero-filled.  Grid: (n tiles, m tiles, batch); fp32 out.
#include "tcec_core.cuh"
#include "tcec_tile.cuh"

namespace {

constexpr int BK = tile::BK;
// Row padding of the staged word tiles (bf16 elements, 16 bytes): rows stay
// 16-byte aligned for cp.async and the fragment loads avoid bank conflicts.
// The footprint model (repro_torch/core/roofline.py::CUDA_WORD_PAD) counts
// the same.
constexpr int WPAD = 8;
constexpr int LDA = BK + WPAD;

// One slot: the n_words A word tiles [BM][LDA], then the n_words B word
// tiles [BK][BN + WPAD].
template <int NW, int BM, int BN>
struct Slot {
  static constexpr int LDB = BN + WPAD;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int ELEMS = NW * (A_ELEMS + B_ELEMS);
  static constexpr int BYTES = ELEMS * 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;  // src-size 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool ASYNC>
__device__ __forceinline__ void copy16(uint16_t* dst, const uint16_t* src, bool ok) {
  if constexpr (ASYNC) {
    cp_async16(dst, src, ok);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Stage the word tiles of k tile k0 into `slot`, 16 bytes per copy.
template <int NW, int BM, int BN, bool ASYNC>
__device__ __forceinline__ void load_slot(uint16_t* slot, const uint16_t* Aw,
                                          const uint16_t* Bw, long long wsA, long long wsB,
                                          int m0, int n0, int k0, int M, int K, int ldk,
                                          int ldn, int tid) {
  using S = Slot<NW, BM, BN>;
  constexpr int THREADS = tile::threads(BM, BN);
  constexpr int A_CH = BM * BK / 8;  // 16-byte chunks per A word tile
  constexpr int B_CH = BK * BN / 8;
  for (int i = tid; i < NW * A_CH; i += THREADS) {
    const int w = i / A_CH, c = i % A_CH;
    const int r = c / (BK / 8), c8 = (c % (BK / 8)) * 8;
    const int gr = m0 + r, gc = k0 + c8;
    const bool ok = gr < M && gc < ldk;
    copy16<ASYNC>(slot + w * S::A_ELEMS + r * LDA + c8,
                  ok ? Aw + w * wsA + (long long)gr * ldk + gc : Aw, ok);
  }
  uint16_t* bslot = slot + NW * S::A_ELEMS;
  for (int i = tid; i < NW * B_CH; i += THREADS) {
    const int w = i / B_CH, c = i % B_CH;
    const int r = c / (BN / 8), c8 = (c % (BN / 8)) * 8;
    const int gr = k0 + r, gc = n0 + c8;
    const bool ok = gr < K && gc < ldn;
    copy16<ASYNC>(bslot + w * S::B_ELEMS + r * S::LDB + c8,
                  ok ? Bw + w * wsB + (long long)gr * ldn + gc : Bw, ok);
  }
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// The scheduled passes of one staged k tile: fragments loaded from the word
// tiles in shared memory (the same registers K1's split writes in K2b).
template <int PASSES, int BM, int BN>
__device__ __forceinline__ void compute_slot(const uint16_t* slot, float (&acc)[2][4][4],
                                             const tile::Lane& l) {
  constexpr int NW = tcec::n_words(PASSES);
  using S = Slot<NW, BM, BN>;
  const uint16_t* bslot = slot + NW * S::A_ELEMS;
  const int g = l.g, t = l.t;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t fa[2][NW][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = l.wm + mt * 16 + g;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint16_t* a = slot + w * S::A_ELEMS;
        fa[mt][w][0] = ld_pair(a + r * LDA + kk + 2 * t);
        fa[mt][w][1] = ld_pair(a + (r + 8) * LDA + kk + 2 * t);
        fa[mt][w][2] = ld_pair(a + r * LDA + kk + 2 * t + 8);
        fa[mt][w][3] = ld_pair(a + (r + 8) * LDA + kk + 2 * t + 8);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = l.wn + nt * 8 + g;
      uint32_t fb[NW][2];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint16_t* b = bslot + w * S::B_ELEMS + c;
        fb[w][0] = pack16(b[(kk + 2 * t) * S::LDB], b[(kk + 2 * t + 1) * S::LDB]);
        fb[w][1] = pack16(b[(kk + 2 * t + 8) * S::LDB], b[(kk + 2 * t + 9) * S::LDB]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) tcec::mma_passes<PASSES>(acc[mt][nt], fa[mt], fb);
    }
  }
}

template <int PASSES, int BM, int BN, bool DB>
__global__ void __launch_bounds__(tile::threads(BM, BN))
tcec_staged_kernel(const uint16_t* __restrict__ Aw, const uint16_t* __restrict__ Bw,
                   float* __restrict__ C, int M, int N, int K, int ldk, int ldn,
                   long long wsA, long long wsB, long long sAb, long long sBb, long long sCb) {
  constexpr int NW = tcec::n_words(PASSES);
  using S = Slot<NW, BM, BN>;
  extern __shared__ __align__(16) uint16_t smem[];

  const int tid = threadIdx.x;
  const tile::Lane l = tile::lane_of<BN>(tid);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long bi = blockIdx.z;
  const uint16_t* Ab = Aw + bi * sAb;
  const uint16_t* Bb = Bw + bi * sBb;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  if constexpr (!DB) {
    for (int kt = 0; kt < nk; ++kt) {
      load_slot<NW, BM, BN, false>(smem, Ab, Bb, wsA, wsB, m0, n0, kt * BK, M, K, ldk, ldn,
                                   tid);
      __syncthreads();
      compute_slot<PASSES, BM, BN>(smem, acc, l);
      __syncthreads();
    }
  } else {
    if (nk > 0) {
      load_slot<NW, BM, BN, true>(smem, Ab, Bb, wsA, wsB, m0, n0, 0, M, K, ldk, ldn, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        // Prefetch tile k+1 into the other slot, then wait for tile k only.
        load_slot<NW, BM, BN, true>(smem + ((kt + 1) & 1) * S::ELEMS, Ab, Bb, wsA, wsB, m0,
                                    n0, (kt + 1) * BK, M, K, ldk, ldn, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      compute_slot<PASSES, BM, BN>(smem + (kt & 1) * S::ELEMS, acc, l);
      __syncthreads();  // the next prefetch overwrites this slot
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + tile::acc_row(l, mt, e);
        const int c = n0 + tile::acc_col(l, nt, e);
        if (r < M && c < N) C[bi * sCb + (long long)r * N + c] = acc[mt][nt][e];
      }
}

// The kernel of (BM, BN, DB) and its dynamic shared memory, with the opt-in
// above 48 KB made (once per kernel).
template <int BM, int BN, bool DB>
cudaError_t prepare(int* dyn_smem) {
  constexpr int NW = tcec::n_words(REPRO_PASSES);
  constexpr int bytes = (DB ? 2 : 1) * Slot<NW, BM, BN>::BYTES;
  static const cudaError_t err = cudaFuncSetAttribute(
      tcec_staged_kernel<REPRO_PASSES, BM, BN, DB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *dyn_smem = bytes;
  return err;
}

template <int BM, int BN, bool DB>
cudaError_t launch(const uint16_t* Aw, const uint16_t* Bw, float* C, int M, int N, int K,
                   int ldk, int ldn, int batch, long long wsA, long long wsB, long long sAb,
                   long long sBb, long long sCb, cudaStream_t stream) {
  int dyn = 0;
  cudaError_t err = prepare<BM, BN, DB>(&dyn);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  tcec_staged_kernel<REPRO_PASSES, BM, BN, DB><<<grid, tile::threads(BM, BN), dyn, stream>>>(
      Aw, Bw, C, M, N, K, ldk, ldn, wsA, wsB, sAb, sBb, sCb);
  return cudaGetLastError();
}

template <int BM, int BN, bool DB>
cudaError_t attrs(int* smem_bytes, int* threads, int* regs, int* blocks_per_sm) {
  int dyn = 0;
  cudaError_t err = prepare<BM, BN, DB>(&dyn);
  if (err != cudaSuccess) return err;
  *threads = tile::threads(BM, BN);
  return tile::attrs(tcec_staged_kernel<REPRO_PASSES, BM, BN, DB>, *threads, dyn, smem_bytes,
                     regs, blocks_per_sm);
}

}  // namespace

extern "C" {

// K5 (double_buffer 0) / K6 (1).  Aw: n_words bf16 word arrays of A, each
// (batch, M, ldk), word stride wsA, batch stride sAb; Bw: of B, each
// ([batch,] K, ldn), word stride wsB, batch stride sBb (0: shared rhs);
// C: (batch, M, N) fp32.  `passes` must be this library's pass count and
// (bm, bn) a tile of the menu.  Returns cudaGetLastError() after the launch.
int repro_tcec_staged(const void* Aw, const void* Bw, float* C, int M, int N, int K, int ldk,
                      int ldn, int batch, long long wsA, long long wsB, long long sAb,
                      long long sBb, long long sCb, int passes, int bm, int bn,
                      int double_buffer, void* stream) {
  if (passes != REPRO_PASSES) return static_cast<int>(cudaErrorInvalidValue);
  const uint16_t* a = static_cast<const uint16_t*>(Aw);
  const uint16_t* b = static_cast<const uint16_t*>(Bw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = tile::dispatch(bm, bn, [&](auto shape) {
    using T = decltype(shape);
    return double_buffer
               ? launch<T::BM, T::BN, true>(a, b, C, M, N, K, ldk, ldn, batch, wsA, wsB, sAb,
                                            sBb, sCb, s)
               : launch<T::BM, T::BN, false>(a, b, C, M, N, K, ldk, ldn, batch, wsA, wsB, sAb,
                                             sBb, sCb, s);
  });
  return static_cast<int>(err);
}

// Shared memory per block (static + the dynamic size the launch asks for),
// registers per thread and resident blocks per SM of K5/K6 at (bm, bn).
int repro_tcec_staged_attrs(int double_buffer, int bm, int bn, int* smem_bytes, int* threads,
                            int* regs, int* blocks_per_sm) {
  cudaError_t err = tile::dispatch(bm, bn, [&](auto shape) {
    using T = decltype(shape);
    return double_buffer ? attrs<T::BM, T::BN, true>(smem_bytes, threads, regs, blocks_per_sm)
                         : attrs<T::BM, T::BN, false>(smem_bytes, threads, regs, blocks_per_sm);
  });
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
