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
// Layout: A words (n_words, batch, M, ldk), B words (n_words, [batch,] K,
// ldn), bf16, with ldk = K and ldn = N rounded up to 8 elements (the host
// zero-fills the pad), so every row and every 16-byte chunk is 16-byte
// aligned.  A chunk is either inside its row or, past M / K / ldk / ldn,
// zero-filled.  Grid: (n tiles, m tiles, batch); one warp per 32 x 32
// outputs (tile::threads); fp32 out.
//
// K5 on an H100.  What bounds it: by the roofline, the words' bytes at the
// paper's small batched shapes (the host writes 2 * n_words bytes per
// element per operand and the kernel reads them back) and the passes on
// the tensor cores at the large ones; as measured, the wait for each k
// tile's copies, which one buffer cannot overlap with its own passes, and
// the ALU work around each mma.sync (K1's four FADDs).  What the design
// does about it while it stays the baseline (one slot, every word tile
// staged, words made on the host):
//
// * Staging: every 16-byte chunk of the 2 * n_words word tiles of a k step
//   is issued at once as cp.async.cg into the one slot (a fixed count per
//   thread), then one commit and one wait: the copies fly together.  No
//   copy of the next k tile is issued before this one's passes end (that
//   is K6).
// * Fragments by ldmatrix, the instruction wmma::load_matrix_sync becomes
//   on sm_80 and later: per k16 step a warp loads A's words with one
//   ldmatrix.x4 per m16 tile and word and B's with one ldmatrix.x4.trans
//   per pair of n8 tiles and word (12 loads for 48 mma.sync at bf16x6).
//   The rows' 16-byte pad (WPAD) puts the eight row addresses of every
//   ldmatrix phase in distinct banks at every tile (A's pitch 80 bytes;
//   B's 80, 144 and 272: 20 and 4 words apart mod 32).
// * Occupancy is the only latency hiding one buffer has: the copies of one
//   block fly while another's passes run.  The word loop of the staging is
//   not unrolled, so a thread keeps one address per chunk of a word tile,
//   and the launch bounds name the block size alone: 92-139 registers and
//   no spill at every tile and pass count; 3 blocks of 4 warps per SM at
//   64 x 64 under bf16x6, 1-2 blocks at the 128-row tiles.  A register cap
//   asking for more blocks per SM made ptxas spill and gained nothing.
// * Warps whose outputs lie wholly outside the matrix skip their passes;
//   outputs are stored as pairs where N is even.
//
// K6 is K5 with two slots, the reference's software pipeline: the copies of
// k tile k+1 are issued into the other slot before the passes of tile k, and
// the wait (cp.async.wait_group 1) leaves them in flight, so within one
// block the copies overlap the passes that K5 can only overlap across
// blocks.  Everything else is K5's, by the same device functions: staging,
// ldmatrix fragments, passes, the skip of dead warps, paired stores and
// launch bounds of the block size alone.  Its footprint is two slots
// (58,368 B at 64 x 64 under bf16x6, so three blocks per SM, as many as
// K5's registers allow there); 95-151 registers and no spill at every tile
// and pass count.  With the copy wait hidden, what bounds it on an H100 is
// K5's instruction mix around each mma.sync (K1's four FADDs): below K5 at
// the large shapes, above fp32 cuBLAS at 4096^3.
#include "tcec_frag.cuh"
#include "tcec_tile.cuh"

namespace {

using frag::cp_async16;
using frag::cp_async_commit;
using frag::cp_async_wait;

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
  static constexpr int THREADS = tile::threads(BM, BN);
  static constexpr int A_CH = BM * BK / 8;  // 16-byte chunks per A word tile
  static constexpr int B_CH = BK * BN / 8;
  static_assert(A_CH % THREADS == 0 && B_CH % THREADS == 0, "whole copies per thread");
  static_assert((LDA * 2) % 16 == 0 && (LDB * 2) % 16 == 0,
                "16-byte rows for cp.async and ldmatrix");
};

// Issue the copies of every word tile of k tile k0 into the slot, 16 bytes
// each, all in flight together; the caller commits and waits.
template <int NW, int BM, int BN>
__device__ __forceinline__ void stage_slot(uint16_t* slot, const uint16_t* Aw,
                                           const uint16_t* Bw, long long wsA, long long wsB,
                                           int m0, int n0, int k0, int M, int K, int ldk,
                                           int ldn, int tid) {
  using S = Slot<NW, BM, BN>;
  // The word loop is not unrolled, so a thread keeps one address per chunk
  // of a word tile rather than one per chunk of the slot.
#pragma unroll 1
  for (int w = 0; w < NW; ++w) {
#pragma unroll
    for (int u = 0; u < S::A_CH / S::THREADS; ++u) {
      const int c = tid + u * S::THREADS;
      const int r = c / (BK / 8), c8 = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + c8;
      const bool ok = gr < M && gc < ldk;
      cp_async16(slot + w * S::A_ELEMS + r * LDA + c8,
                 ok ? Aw + w * wsA + (long long)gr * ldk + gc : Aw, ok);
    }
#pragma unroll
    for (int u = 0; u < S::B_CH / S::THREADS; ++u) {
      const int c = tid + u * S::THREADS;
      const int r = c / (BN / 8), c8 = (c % (BN / 8)) * 8;
      const int gr = k0 + r, gc = n0 + c8;
      const bool ok = gr < K && gc < ldn;
      cp_async16(slot + NW * S::A_ELEMS + w * S::B_ELEMS + r * S::LDB + c8,
                 ok ? Bw + w * wsB + (long long)gr * ldn + gc : Bw, ok);
    }
  }
}

// The scheduled passes of the staged k tile on this warp's 32 x 32 outputs.
// Lane L addresses row L % 8 of 8 x 8 matrix L / 8: for A, matrices (rows
// 0-7 | 8-15) x (k 0-7 | 8-15) of an m16 tile give a0..a3; for B,
// (k 0-7 | 8-15) x (columns of n8 tile 2j | 2j + 1), transposed, give b0, b1
// of both n8 tiles.
template <int PASSES, int BM, int BN>
__device__ __forceinline__ void slot_passes(const uint16_t* slot, float (&acc)[2][4][4],
                                            const tile::Lane& l) {
  constexpr int NW = tcec::n_words(PASSES);
  using S = Slot<NW, BM, BN>;
  const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
  const uint16_t* a = slot + (l.wm + (q & 1) * 8 + r8) * LDA + (q >> 1) * 8;
  const uint16_t* b =
      slot + NW * S::A_ELEMS + ((q & 1) * 8 + r8) * S::LDB + l.wn + (q >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t fa[2][NW][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int w = 0; w < NW; ++w)
        frag::ldsm_x4(fa[mt][w], a + w * S::A_ELEMS + mt * 16 * LDA + kk);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t fb0[NW][2], fb1[NW][2];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t r[4];
        frag::ldsm_x4_trans(r, b + w * S::B_ELEMS + kk * S::LDB + 16 * j);
        fb0[w][0] = r[0], fb0[w][1] = r[1], fb1[w][0] = r[2], fb1[w][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        tcec::mma_passes<PASSES>(acc[mt][2 * j], fa[mt], fb0);
        tcec::mma_passes<PASSES>(acc[mt][2 * j + 1], fa[mt], fb1);
      }
    }
  }
}

// K5 (SLOTS 1) or K6 (SLOTS 2): the same body but for the k loop.
template <int PASSES, int BM, int BN, int SLOTS>
__device__ __forceinline__ void staged_body(const uint16_t* __restrict__ Aw,
                                            const uint16_t* __restrict__ Bw,
                                            float* __restrict__ C, int M, int N, int K,
                                            int ldk, int ldn, long long wsA, long long wsB,
                                            long long sAb, long long sBb, long long sCb) {
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
  const bool live = m0 + l.wm < M && n0 + l.wn < N;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  if constexpr (SLOTS == 1) {
    for (int kt = 0; kt < nk; ++kt) {
      stage_slot<NW, BM, BN>(smem, Ab, Bb, wsA, wsB, m0, n0, kt * BK, M, K, ldk, ldn, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (live) slot_passes<PASSES, BM, BN>(smem, acc, l);
      __syncthreads();  // the next k tile's copies overwrite the slot
    }
  } else {
    if (nk > 0) {
      stage_slot<NW, BM, BN>(smem, Ab, Bb, wsA, wsB, m0, n0, 0, M, K, ldk, ldn, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        // Tile k+1 into the other slot, then wait for tile k only.
        stage_slot<NW, BM, BN>(smem + ((kt + 1) & 1) * S::ELEMS, Ab, Bb, wsA, wsB, m0, n0,
                               (kt + 1) * BK, M, K, ldk, ldn, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (live) slot_passes<PASSES, BM, BN>(smem + (kt & 1) * S::ELEMS, acc, l);
      __syncthreads();  // the next prefetch overwrites this slot
    }
  }

  if (!live) return;
  float* Cb = C + bi * sCb;
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + tile::acc_row(l, mt, 2 * h);
        const int c = n0 + tile::acc_col(l, nt, 0);
        if (r >= M || c >= N) continue;
        float* out = Cb + (long long)r * N + c;
        if (pairs) {
          *reinterpret_cast<float2*>(out) = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else {
          out[0] = acc[mt][nt][2 * h];
          if (c + 1 < N) out[1] = acc[mt][nt][2 * h + 1];
        }
      }
}

template <int PASSES, int BM, int BN>
__global__ void __launch_bounds__(tile::threads(BM, BN))
tcec_staged_k5_kernel(const uint16_t* __restrict__ Aw, const uint16_t* __restrict__ Bw,
                      float* __restrict__ C, int M, int N, int K, int ldk, int ldn,
                      long long wsA, long long wsB, long long sAb, long long sBb,
                      long long sCb) {
  staged_body<PASSES, BM, BN, 1>(Aw, Bw, C, M, N, K, ldk, ldn, wsA, wsB, sAb, sBb, sCb);
}

template <int PASSES, int BM, int BN>
__global__ void __launch_bounds__(tile::threads(BM, BN))
tcec_staged_db_kernel(const uint16_t* __restrict__ Aw, const uint16_t* __restrict__ Bw,
                      float* __restrict__ C, int M, int N, int K, int ldk, int ldn,
                      long long wsA, long long wsB, long long sAb, long long sBb,
                      long long sCb) {
  staged_body<PASSES, BM, BN, 2>(Aw, Bw, C, M, N, K, ldk, ldn, wsA, wsB, sAb, sBb, sCb);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The kernel of (BM, BN, DB): K5 (DB false) or K6, its dynamic shared memory
// (one slot, or two) and threads, with the opt-in above 48 KB made (once per
// kernel).
template <int BM, int BN, bool DB>
struct Kernel {
  static constexpr int NW = tcec::n_words(REPRO_PASSES);
  static constexpr int SMEM = (DB ? 2 : 1) * Slot<NW, BM, BN>::BYTES;
  static constexpr int THREADS = tile::threads(BM, BN);
  static auto fn() {
    if constexpr (DB)
      return tcec_staged_db_kernel<REPRO_PASSES, BM, BN>;
    else
      return tcec_staged_k5_kernel<REPRO_PASSES, BM, BN>;
  }
  static cudaError_t prepare() {
    static const cudaError_t err =
        cudaFuncSetAttribute(fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    return err;
  }
};

template <int BM, int BN, bool DB>
cudaError_t launch(const uint16_t* Aw, const uint16_t* Bw, float* C, int M, int N, int K,
                   int ldk, int ldn, int batch, long long wsA, long long wsB, long long sAb,
                   long long sBb, long long sCb, cudaStream_t stream) {
  using Kn = Kernel<BM, BN, DB>;
  cudaError_t err = Kn::prepare();
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  const auto kernel = Kn::fn();
  kernel<<<grid, Kn::THREADS, Kn::SMEM, stream>>>(Aw, Bw, C, M, N, K, ldk, ldn, wsA, wsB, sAb,
                                                  sBb, sCb);
  return cudaGetLastError();
}

template <int BM, int BN, bool DB>
cudaError_t attrs(int* smem_bytes, int* threads, int* regs, int* blocks_per_sm,
                  int* local_bytes) {
  using Kn = Kernel<BM, BN, DB>;
  cudaError_t err = Kn::prepare();
  if (err != cudaSuccess) return err;
  *threads = Kn::THREADS;
  return tile::attrs(Kn::fn(), *threads, Kn::SMEM, smem_bytes, regs, blocks_per_sm,
                     local_bytes);
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
// threads, registers per thread, resident blocks per SM and local memory per
// thread (spills and stack) of K5/K6 at (bm, bn).
int repro_tcec_staged_attrs(int double_buffer, int bm, int bn, int* smem_bytes, int* threads,
                            int* regs, int* blocks_per_sm, int* local_bytes) {
  cudaError_t err = tile::dispatch(bm, bn, [&](auto shape) {
    using T = decltype(shape);
    return double_buffer
               ? attrs<T::BM, T::BN, true>(smem_bytes, threads, regs, blocks_per_sm,
                                           local_bytes)
               : attrs<T::BM, T::BN, false>(smem_bytes, threads, regs, blocks_per_sm,
                                            local_bytes);
  });
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
