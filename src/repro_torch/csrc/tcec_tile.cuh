// Block tiling shared by the TCEC matmul kernels (K2/K2b in tcec_matmul.cu,
// K5/K6 in tcec_staged.cu): the compiled tile menu, the warp layout and the
// mma.sync fragment coordinates.
//
// Every block tile is (BM, BN, BK = 32) and every warp owns a 32 x 32 output
// tile (2 m16 x 4 n8 mma tiles), so a block has (BM / 32) * (BN / 32) warps.
// Each output element sums its k16 steps in k order (K1's accumulation rule),
// so the tile shape changes no bit of the result.
#pragma once

#include <cuda_runtime.h>

namespace tile {

constexpr int BK = 32;

__host__ __device__ constexpr int threads(int bm, int bn) { return (bm / 32) * (bn / 32) * 32; }

template <int M, int N>
struct Shape {
  static constexpr int BM = M;
  static constexpr int BN = N;
};

// The compiled menu, (BM, BN) with BK = 32 — the same list as
// repro_torch/kernels/_build.py::TILES.  f(Shape<BM, BN>{}) for a listed
// tile; cudaErrorInvalidValue otherwise.
template <class F>
cudaError_t dispatch(int bm, int bn, F&& f) {
  if (bm == 32 && bn == 32) return f(Shape<32, 32>{});
  if (bm == 64 && bn == 64) return f(Shape<64, 64>{});
  if (bm == 128 && bn == 64) return f(Shape<128, 64>{});
  if (bm == 128 && bn == 128) return f(Shape<128, 128>{});
  return cudaErrorInvalidValue;
}

// Where this thread sits: warp origin (wm, wn) in the block tile, and the
// mma.sync lane coordinates g = lane / 4, t = lane % 4.
struct Lane {
  int g, t, wm, wn;
};

template <int BN>
__device__ __forceinline__ Lane lane_of(int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int WARPS_N = BN / 32;
  return Lane{lane >> 2, lane & 3, (warp / WARPS_N) * 32, (warp % WARPS_N) * 32};
}

// Accumulator element e of mma tile (mt, nt) sits at block-tile row
// wm + mt*16 + g (+8 for e >= 2) and column wn + nt*8 + 2t (+1 for odd e).
__device__ __forceinline__ int acc_row(const Lane& l, int mt, int e) {
  return l.wm + mt * 16 + l.g + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(const Lane& l, int nt, int e) {
  return l.wn + nt * 8 + 2 * l.t + (e & 1);
}

// Function attributes of a kernel and how many of its blocks fit on one SM
// at once, for `dyn_smem` bytes of dynamic shared memory per block; with
// `local_bytes`, also its local memory per thread (spills and stack).
template <class K>
cudaError_t attrs(K kernel, int threads, int dyn_smem, int* smem_bytes, int* regs,
                  int* blocks_per_sm, int* local_bytes = nullptr) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(a.sharedSizeBytes) + dyn_smem;
  *regs = a.numRegs;
  if (local_bytes != nullptr) *local_bytes = static_cast<int>(a.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads,
                                                       dyn_smem);
}

}  // namespace tile
