// K2b — the TCEC matmul with no epilogue, fp32 in and out, over a menu of
// tiles, plus its vpu arm.  (K2, the serving path's fused matmul, has its own
// source, tcec_matmul_k2.cu, designed for decode shapes.)
//
// Replaces: repro/kernels/tcec_matmul.py::_tcec_kernel (the pallas_call in
// _tcec_matmul_pallas), bf16-word and vpu arms.  Not ported yet: the int8
// words (the wrapper raises NotImplementedError).
//
// The data flow is the paper's WMMAe: only the fp32 source tiles are staged
// in shared memory, and the bf16 words of both operands are made in
// registers straight into the mma.sync fragments, so the staged footprint
// does not grow with the number of words (against the staged baseline K5/K6,
// tcec_staged.cu, which stages every word tile).
//
// What bounds it on an H100: by the roofline, the bytes at the paper's small
// batched shapes and the passes on the tensor cores at the large ones.  As
// measured (PERF.md), issuing the ALU work around each mma.sync bounds
// a large call: at bf16x6 the fp32 sum of each k16 step's passes (4 FADDs
// per mma: K1's rule) and the words of every fp32 value a warp reads; the
// chain of one block bounds a small one (a global load, then 1-4 k tiles).
// Synchronous 4-byte loads, and a split of one value per conversion with a
// guard per value, cost a simpler version of this kernel most of its time.
//
// What the design does about it (kernels/tcec_matmul.py::k2b_plan chooses the
// grid and the copy widths):
//
// * Warp tiles by tile (warp_rows/warp_cols): the large tiles, which large
//   calls take, give each warp 32 x 64 outputs, so each split A fragment
//   feeds 8 n8 tiles and each split B fragment 2 m16 tiles: 48 fp32 values
//   made into words per 96 mma.sync at bf16x6 (a 32 x 32 warp tile makes 32
//   per 48).  The small tiles, which the small batched calls take, give
//   their four warps 16 x 16 (32 x 32 tile) or 32 x 32 (64 x 64) outputs, so
//   a block's chain is short.  A warp whose rows or columns lie wholly
//   outside the matrix skips its passes.
// * Words two values per cvt.rn.bf16x2.f32 (frag::split2), bitwise K1's.
// * The guard in one pass per block over the staged tile (scan_tile): each
//   thread checks the values it copied, zeroes a non-finite one and raises
//   the device flag, and the block learns (__syncthreads_or) whether any
//   value lies beyond +-BF16_MAX, the rare case whose word 0 the split must
//   clamp; the split itself then carries neither check nor clamp.
// * Loads: a ring of NSLOT slots of fp32 (A, B) k tiles filled by cp.async,
//   16-byte .cg copies where k (for A) or n (for B) is a multiple of 4 and
//   the base 16-byte aligned, else 4-byte .ca copies (the plan decides; never
//   a host-side pad); out-of-range chunks are zero-filled.
// * Persistent blocks: the grid is at most the blocks that fit on the card
//   at once, and a block walks the flat sequence of (output tile, k tile)
//   steps of its tiles (block b takes tiles b, b + grid, ...).  The ring runs
//   over that whole sequence, so the next output tile's copies are in flight
//   while this one's passes run; at K = 32-128 a k loop alone has 1-4 tiles
//   and nothing to overlap.
// * Columns of an n8 pair are interleaved (n8 tile 2j + h holds columns 16j +
//   2c + h), so a thread reads B as 8-byte pairs and stores C 16 bytes at a
//   time; a column's sum is the same sum (K1's rule: each output adds its k16
//   steps in k order, each step's passes in schedule order), so K2b, K5 and
//   K6 give the same bits at every tile.
// * Shared-memory reads free of bank conflicts: A rows at a pitch of 8 (mod
//   32) words, B rows at 4 (mod 32), every fragment read an 8-byte pair.
// * Registers: the launch bounds ask for as many blocks per SM as the shared
//   memory allows while a thread keeps what its warp tile needs, so nothing
//   spills (32 x 64 warp tiles take up to 255 registers: one block of 8
//   warps per SM at 128 x 128).
// * Instruction: mma.sync m16n8k16 (bf16 in, fp32 out), both operands in
//   registers.  Not wgmma: it reads B from shared memory, so B's words would
//   be staged, which is K5's data flow.  Staged: the fp32 source tiles only.
//
// The vpu arm (K2b under fp32_vpu, the paper's "FP32 SIMT" baseline) takes
// the same loads and runs a plain FFMA product on the SIMT cores: no split,
// no tensor core, no guard.  Each output element is one fp32 FMA chain in k
// order, so it too is the same bits at every tile.
//
// Corrected policies (passes > 1) sanitize non-finite inputs to 0 (the
// scan) and raise a flag; the fix-up kernel then restores the fp32
// reference's exact +-inf/NaN pattern (the reference's host-level guard).
#include "tcec_frag.cuh"
#include "tcec_tile.cuh"

namespace {

using frag::cp_async16;
using frag::cp_async4;
using frag::cp_async_commit;
using frag::cp_async_wait;

constexpr int BK = tile::BK;
// Row padding of the staged fp32 tiles (elements): A at a pitch of 8 (mod
// 32) words, B at 4 (mod 32).  The footprint model
// (repro_torch/core/roofline.py::CUDA_FP32_PAD_A/_B) counts the same.
constexpr int APAD = 8;
constexpr int BPAD = 4;
// Ring slots (k tiles in flight or in use); the footprint model
// (repro_torch/core/roofline.py::CUDA_K2B_SLOTS) counts the same.
constexpr int NSLOT = 2;
// Shared memory of an sm_90 SM and reserved per block (bytes).
constexpr int SM_SMEM = 228 * 1024;
constexpr int SMEM_RESERVED = 1024;

// The warp tile (rows, columns) of each tile (bm, bn) of the menu: 16 x 16
// at 32 x 32, 32 x 32 at 64 x 64, 32 x 64 at 128 x 64 and 128 x 128;
// repro_torch/kernels/_build.py::K2B_WARP_TILES holds the same table.
__host__ __device__ constexpr int warp_rows(int bm, int bn) {
  return bm == 32 ? 16 : 32;
}
__host__ __device__ constexpr int warp_cols(int bm, int bn) {
  return bm == 32 ? 16 : bm == 64 ? 32 : 64;
}

template <int BM, int BN>
struct Geo {
  static constexpr int WM = warp_rows(BM, BN);
  static constexpr int WN = warp_cols(BM, BN);
  static constexpr int MT = WM / 16;  // m16 tiles of a warp
  static constexpr int NT = WN / 8;   // n8 tiles of a warp (pairs of)
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  static constexpr int LDA = BK + APAD;
  static constexpr int LDB = BN + BPAD;
  static constexpr int SLOT = BM * LDA + BK * LDB;  // floats
  static constexpr int SMEM = NSLOT * SLOT * 4;
  // Blocks per SM the launch bounds ask for: as many as the shared memory
  // allows, as long as a thread keeps the registers its tile needs
  // (accumulators, A words at bf16x6, one n8 pair's B words, and the rest).
  static constexpr int REGS = (MT * NT * 4 + MT * 3 * 4 + 12 + 80 + 7) / 8 * 8;
  static constexpr int BY_SMEM = SM_SMEM / (SMEM + SMEM_RESERVED);
  static constexpr int BY_REGS = 65536 / (THREADS * REGS);
  static constexpr int MIN_BLOCKS =
      BY_SMEM < BY_REGS ? BY_SMEM : BY_REGS > 0 ? BY_REGS : 1;
  static_assert(NT % 2 == 0, "n8 tiles in pairs");
  static_assert(LDA % 32 == 8 && LDB % 32 == 4, "conflict-free pitches");
  static_assert(SMEM <= 227 * 1024, "shared memory of a block");
  static_assert((BM * BK / 4) % THREADS == 0 && (BK * BN / 4) % THREADS == 0, "whole copies");
};

// Stage k tile k0 of output tile (m0, n0) into a slot: A rows [m0, m0 + BM)
// x [k0, k0 + BK), B rows [k0, k0 + BK) x [n0, n0 + BN); zero outside the
// matrices.  VEC: 16-byte copies (k, n multiples of 4, aligned bases).
template <int BM, int BN, bool VEC_A, bool VEC_B>
__device__ __forceinline__ void load_tile(float* slot, const float* __restrict__ A,
                                          const float* __restrict__ B, int m0, int n0, int k0,
                                          int M, int N, int K, int tid) {
  using G = Geo<BM, BN>;
  float* As = slot;
  float* Bs = slot + BM * G::LDA;
  if constexpr (VEC_A) {
#pragma unroll
    for (int u = 0; u < BM * BK / 4 / G::THREADS; ++u) {
      const int i = tid + u * G::THREADS;
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(As + r * G::LDA + c, ok ? A + (long long)(m0 + r) * K + k0 + c : A, ok);
    }
  } else {
#pragma unroll 8
    for (int u = 0; u < BM * BK / G::THREADS; ++u) {
      const int i = tid + u * G::THREADS;
      const int r = i / BK, c = i % BK;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async4(As + r * G::LDA + c, ok ? A + (long long)(m0 + r) * K + k0 + c : A, ok);
    }
  }
  if constexpr (VEC_B) {
#pragma unroll
    for (int u = 0; u < BK * BN / 4 / G::THREADS; ++u) {
      const int i = tid + u * G::THREADS;
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(Bs + r * G::LDB + c, ok ? B + (long long)(k0 + r) * N + n0 + c : B, ok);
    }
  } else {
#pragma unroll 8
    for (int u = 0; u < BK * BN / G::THREADS; ++u) {
      const int i = tid + u * G::THREADS;
      const int r = i / BN, c = i % BN;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async4(Bs + r * G::LDB + c, ok ? B + (long long)(k0 + r) * N + n0 + c : B, ok);
    }
  }
}

// The guard, on the values this thread copied into a slot (visible to it
// once its copies have landed): a non-finite value becomes 0 and raises bad;
// scan_tile returns whether a value it copied is finite and beyond
// +-BF16_MAX, whose word 0 the split must clamp.  One pass over the staged
// tile per block, so the split itself carries no guard.  scan_vals takes
// the n (1, or 4 16-byte aligned) values at p; the common case, every
// value finite and within +-BF16_MAX, costs one compare each.
__device__ __forceinline__ void scan_vals(float* p, int n, bool& bad, bool& big) {
  const float m = tcec::bf16_max();
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (n == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = p[0];
  }
  bool ok = true;
#pragma unroll
  for (int i = 0; i < n; ++i) ok = ok && fabsf(v[i]) <= m;
  if (ok) return;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    if (fabsf(v[i]) <= 3.40282347e38f) {  // finite (NaN compares false)
      big = big || fabsf(v[i]) > m;
    } else {
      p[i] = 0.f;
      bad = true;
    }
  }
}

template <int BM, int BN, bool VEC_A, bool VEC_B>
__device__ __forceinline__ bool scan_tile(float* slot, int tid, bool& bad) {
  using G = Geo<BM, BN>;
  float* As = slot;
  float* Bs = slot + BM * G::LDA;
  bool big = false;
  if constexpr (VEC_A) {
#pragma unroll
    for (int u = 0; u < BM * BK / 4 / G::THREADS; ++u) {
      const int i = tid + u * G::THREADS;
      scan_vals(As + (i / (BK / 4)) * G::LDA + (i % (BK / 4)) * 4, 4, bad, big);
    }
  } else {
#pragma unroll 8
    for (int u = 0; u < BM * BK / G::THREADS; ++u) {
      const int i = tid + u * G::THREADS;
      scan_vals(As + (i / BK) * G::LDA + i % BK, 1, bad, big);
    }
  }
  if constexpr (VEC_B) {
#pragma unroll
    for (int u = 0; u < BK * BN / 4 / G::THREADS; ++u) {
      const int i = tid + u * G::THREADS;
      scan_vals(Bs + (i / (BN / 4)) * G::LDB + (i % (BN / 4)) * 4, 4, bad, big);
    }
  } else {
#pragma unroll 8
    for (int u = 0; u < BK * BN / G::THREADS; ++u) {
      const int i = tid + u * G::THREADS;
      scan_vals(Bs + (i / BN) * G::LDB + i % BN, 1, bad, big);
    }
  }
  return big;
}

// Words of the pair (x0, x1) into word fragments f[w][reg].
template <int NW, bool CLAMP, int R>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&f)[NW][R], int reg) {
  uint32_t w[NW];
  frag::split2<NW, CLAMP>(x0, x1, w);
#pragma unroll
  for (int i = 0; i < NW; ++i) f[i][reg] = w[i];
}

// The passes of one staged k tile on this warp's WM x WN outputs.
template <int PASSES, bool CLAMP, int BM, int BN>
__device__ __forceinline__ void mma_tile(const float* As, const float* Bs,
                                         float (&acc)[Geo<BM, BN>::MT][Geo<BM, BN>::NT][4],
                                         int wm, int wn) {
  using G = Geo<BM, BN>;
  constexpr int NW = tcec::n_words(PASSES);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t fa[G::MT][NW][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const float* p = As + (wm + mt * 16 + g) * G::LDA + kk + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(p);
      const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * G::LDA);
      const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * G::LDA + 8);
      split_pair<NW, CLAMP>(x0.x, x0.y, fa[mt], 0);
      split_pair<NW, CLAMP>(x1.x, x1.y, fa[mt], 1);
      split_pair<NW, CLAMP>(x2.x, x2.y, fa[mt], 2);
      split_pair<NW, CLAMP>(x3.x, x3.y, fa[mt], 3);
    }
#pragma unroll
    for (int j = 0; j < G::NT / 2; ++j) {
      // Rows kk + 2t, +1, +8, +9 of columns wn + 16j + 2g, +1: the B values
      // of this lane in n8 tiles 2j (.x) and 2j + 1 (.y).
      const float* q = Bs + (kk + 2 * t) * G::LDB + wn + 16 * j + 2 * g;
      const float2 r0 = *reinterpret_cast<const float2*>(q);
      const float2 r1 = *reinterpret_cast<const float2*>(q + G::LDB);
      const float2 r8 = *reinterpret_cast<const float2*>(q + 8 * G::LDB);
      const float2 r9 = *reinterpret_cast<const float2*>(q + 9 * G::LDB);
      uint32_t fb0[NW][2], fb1[NW][2];
      split_pair<NW, CLAMP>(r0.x, r1.x, fb0, 0);
      split_pair<NW, CLAMP>(r8.x, r9.x, fb0, 1);
      split_pair<NW, CLAMP>(r0.y, r1.y, fb1, 0);
      split_pair<NW, CLAMP>(r8.y, r9.y, fb1, 1);
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        tcec::mma_passes<PASSES>(acc[mt][2 * j], fa[mt], fb0);
        tcec::mma_passes<PASSES>(acc[mt][2 * j + 1], fa[mt], fb1);
      }
    }
  }
}

// The vpu arm on one staged k tile: one FFMA chain per output in k order.
template <int BM, int BN>
__device__ __forceinline__ void ffma_tile(const float* As, const float* Bs,
                                          float (&acc)[Geo<BM, BN>::MT][Geo<BM, BN>::NT][4],
                                          int wm, int wn) {
  using G = Geo<BM, BN>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float av[G::MT][2];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      av[mt][0] = As[(wm + mt * 16 + g) * G::LDA + kk];
      av[mt][1] = As[(wm + mt * 16 + g + 8) * G::LDA + kk];
    }
#pragma unroll
    for (int j = 0; j < G::NT / 2; ++j) {
      // Columns wn + 16j + 4t .. +3: element 2p + h is column 2t + p of n8
      // tile 2j + h.
      const float4 b4 = *reinterpret_cast<const float4*>(Bs + kk * G::LDB + wn + 16 * j + 4 * t);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][2 * j + h][e] =
                fmaf(av[mt][e >> 1], bv[2 * (e & 1) + h], acc[mt][2 * j + h][e]);
    }
  }
}

// Store this warp's outputs of output tile (m0, n0) and zero them: lane (g,
// t) holds rows g, g + 8 of each m16 tile and columns 16j + 4t .. +3 of each
// n8 pair j.
template <int BM, int BN>
__device__ __forceinline__ void store_tile(float* C,
                                           float (&acc)[Geo<BM, BN>::MT][Geo<BM, BN>::NT][4],
                                           int m0, int n0, int M, int N, bool vec) {
  using G = Geo<BM, BN>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = m0 + mt * 16 + g + 8 * hr;
#pragma unroll
      for (int j = 0; j < G::NT / 2; ++j) {
        const int c = n0 + 16 * j + 4 * t;
        const float v[4] = {acc[mt][2 * j][2 * hr], acc[mt][2 * j + 1][2 * hr],
                            acc[mt][2 * j][2 * hr + 1], acc[mt][2 * j + 1][2 * hr + 1]};
        if (r < M) {
          float* out = C + (long long)r * N + c;
          if (vec && c < N) {
            *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (c + i < N) out[i] = v[i];
          }
        }
      }
    }
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// Where step s of a block lies: its output tile's batch entry and origin,
// and its k tile.  (The wrapper keeps batch * tiles below 2^31.)
struct Item {
  int bi, m0, n0, kt;
};

__device__ __forceinline__ Item item_of(int s, int nk, int tiles_m, int tiles_n, int bm, int bn) {
  const int q = s / nk;
  const int item = blockIdx.x + q * gridDim.x;
  const int per_b = tiles_m * tiles_n;
  const int bi = item / per_b, in_b = item - bi * per_b;
  return Item{bi, (in_b / tiles_n) * bm, (in_b % tiles_n) * bn, s - q * nk};
}

// Grid: persistent blocks (at most the card's resident blocks); block b
// takes output tiles b, b + gridDim.x, ... of the (batch, m tiles, n tiles)
// sequence, n fastest, and runs their k tiles as one flat sequence of steps
// through the ring.
template <int PASSES, bool VPU, int BM, int BN, bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(Geo<BM, BN>::THREADS, Geo<BM, BN>::MIN_BLOCKS)
tcec_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int* __restrict__ nonfinite, int M, int N, int K,
                   int batch, long long sAb, long long sBb, long long sCb) {
  using G = Geo<BM, BN>;
  constexpr int NS = NSLOT;
  constexpr bool GUARD = !VPU && PASSES > 1;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp / G::WARPS_N) * G::WM, wn = (warp % G::WARPS_N) * G::WN;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int items = batch * tiles_m * tiles_n;
  const int nk = K > 0 ? (K + BK - 1) / BK : 1;  // K == 0: one zero tile
  const int b = static_cast<int>(blockIdx.x);
  const int steps = b < items ? ((items - 1 - b) / static_cast<int>(gridDim.x) + 1) * nk : 0;
  const bool vec_c = N % 4 == 0 && (reinterpret_cast<uintptr_t>(C) & 15) == 0;

  auto fetch = [&](int s) {
    if (s < steps) {
      const Item it = item_of(s, nk, tiles_m, tiles_n, BM, BN);
      load_tile<BM, BN, VEC_A, VEC_B>(smem + (s % NS) * G::SLOT, A + it.bi * sAb,
                                      B + it.bi * sBb, it.m0, it.n0, it.kt * BK, M, N, K,
                                      tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  float acc[G::MT][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  bool bad = false;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) fetch(s);
  for (int s = 0; s < steps; ++s) {
    float* As = smem + (s % NS) * G::SLOT;
    const float* Bs = As + BM * G::LDA;
    cp_async_wait<NS - 2>();  // step s's tiles have landed (this thread's copies)
    // ... everyone's (and step s - 1's slot is free), after the guard
    bool big = false;
    if constexpr (GUARD)
      big = __syncthreads_or(scan_tile<BM, BN, VEC_A, VEC_B>(As, tid, bad));
    else
      __syncthreads();
    fetch(s + NS - 1);
    const Item it = item_of(s, nk, tiles_m, tiles_n, BM, BN);
    if (it.m0 + wm < M && it.n0 + wn < N) {
      if constexpr (VPU)
        ffma_tile<BM, BN>(As, Bs, acc, wm, wn);
      else if (big)
        mma_tile<PASSES, true, BM, BN>(As, Bs, acc, wm, wn);
      else
        mma_tile<PASSES, false, BM, BN>(As, Bs, acc, wm, wn);
    }
    if (it.kt == nk - 1)
      store_tile<BM, BN>(C + it.bi * sCb, acc, it.m0 + wm, it.n0 + wn, M, N, vec_c);
  }
  cp_async_wait<0>();
  if (GUARD && bad && nonfinite != nullptr) atomicExch(nonfinite, 1);
}

// The kernel of (VPU, BM, BN, vec) with the opt-in above 48 KB of shared
// memory made (once per kernel).
template <bool VPU, int BM, int BN, bool VEC_A, bool VEC_B>
cudaError_t prepare() {
  static const cudaError_t err =
      cudaFuncSetAttribute(tcec_matmul_kernel<REPRO_PASSES, VPU, BM, BN, VEC_A, VEC_B>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<BM, BN>::SMEM);
  return err;
}

template <bool VPU, int BM, int BN, bool VEC_A, bool VEC_B>
cudaError_t launch_k2b(const float* A, const float* B, float* C, int* nonfinite, int M, int N,
                       int K, int batch, long long sAb, long long sBb, long long sCb, int grid,
                       cudaStream_t stream) {
  cudaError_t err = prepare<VPU, BM, BN, VEC_A, VEC_B>();
  if (err != cudaSuccess) return err;
  tcec_matmul_kernel<REPRO_PASSES, VPU, BM, BN, VEC_A, VEC_B>
      <<<grid, Geo<BM, BN>::THREADS, Geo<BM, BN>::SMEM, stream>>>(A, B, C, nonfinite, M, N, K,
                                                                 batch, sAb, sBb, sCb);
  return cudaGetLastError();
}

template <bool VPU, int BM, int BN>
cudaError_t launch_vec(int vec, const float* A, const float* B, float* C, int* nonfinite, int M,
                       int N, int K, int batch, long long sAb, long long sBb, long long sCb,
                       int grid, cudaStream_t s) {
  switch (vec) {
    case 3:
      return launch_k2b<VPU, BM, BN, true, true>(A, B, C, nonfinite, M, N, K, batch, sAb, sBb,
                                                 sCb, grid, s);
    case 2:
      return launch_k2b<VPU, BM, BN, false, true>(A, B, C, nonfinite, M, N, K, batch, sAb, sBb,
                                                  sCb, grid, s);
    case 1:
      return launch_k2b<VPU, BM, BN, true, false>(A, B, C, nonfinite, M, N, K, batch, sAb, sBb,
                                                  sCb, grid, s);
    case 0:
      return launch_k2b<VPU, BM, BN, false, false>(A, B, C, nonfinite, M, N, K, batch, sAb,
                                                   sBb, sCb, grid, s);
  }
  return cudaErrorInvalidValue;
}

template <bool VPU, int BM, int BN>
cudaError_t attrs_k2b(int* smem_bytes, int* threads, int* regs, int* blocks_per_sm) {
  cudaError_t err = prepare<VPU, BM, BN, true, true>();
  if (err != cudaSuccess) return err;
  *threads = Geo<BM, BN>::THREADS;
  return tile::attrs(tcec_matmul_kernel<REPRO_PASSES, VPU, BM, BN, true, true>, *threads,
                     Geo<BM, BN>::SMEM, smem_bytes, regs, blocks_per_sm);
}

}  // namespace

extern "C" {

// K2b.  A: (batch, M, K) fp32 row major; B: (K, N) shared by every batch
// (sBb == 0) or (batch, K, N), fp32; C: (batch, M, N) fp32, 16-byte aligned.
// vpu selects the plain FFMA arm, built into the 1-pass library only;
// otherwise `passes` must be this library's pass count.  (bm, bn) is a tile
// of the menu (tcec_tile.cuh); `grid` the persistent blocks and `vec` the
// copy widths, bit 0 for A and bit 1 for B set where that operand takes
// 16-byte copies (kernels/tcec_matmul.py::k2b_plan).  Returns
// cudaGetLastError() after the launch (0 on success).
int repro_tcec_matmul_pallas(const float* A, const float* B, float* C, int* nonfinite, int M,
                             int N, int K, int batch, long long sAb, long long sBb,
                             long long sCb, int passes, int vpu, int bm, int bn, int grid,
                             int vec, void* stream) {
  if (!vpu && passes != REPRO_PASSES) return static_cast<int>(cudaErrorInvalidValue);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = tile::dispatch(bm, bn, [&](auto shape) {
    using S = decltype(shape);
    if (!vpu)
      return launch_vec<false, S::BM, S::BN>(vec, A, B, C, nonfinite, M, N, K, batch, sAb, sBb,
                                             sCb, grid, s);
    if constexpr (REPRO_PASSES == 1)
      return launch_vec<true, S::BM, S::BN>(vec, A, B, C, nullptr, M, N, K, batch, sAb, sBb,
                                            sCb, grid, s);
    return cudaErrorInvalidValue;
  });
  return static_cast<int>(err);
}

// Shared memory per block (the dynamic ring; K2b has no static shared
// memory), threads, registers per thread and resident blocks per SM of K2b
// at tile (bm, bn) (the 16-byte-copy instantiation; the 4-byte ones use the
// same shared memory).
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
