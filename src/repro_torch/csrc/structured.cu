// K7 — batched Householder H·A, K8 — batched Givens G·A, and K9 — row-wise
// cumsum as blockwise x·U: the paper's structured-fragment workloads (§4,
// Fig. 4, Fig. 5, Eq. 3).
//
// Replaces: repro/kernels/structured.py::_householder_kernel (K7),
// ::_givens_kernel (K8) and ::_scan_kernel (K9).
//
// The paper's point (WMMAe's foreach_ij/map): the structured operand — H, G
// or the triangular ones U — is never stored.  Each thread evaluates the
// rule at the (row, col) positions its own m16n8k16 fragment registers hold
// (layouts in tcec_core.cuh), rounds each value to bf16 with the plain RNE
// cast (tcec::bf16_round) and packs it straight into the register: H, G and
// U reach neither shared nor global memory.  The data operand (A or x) is
// cast to bf16 in registers with the same RNE cast.  One bf16 pass, as in
// the reference: each k16 step is one mma.sync on a fresh zero accumulator,
// and the steps are added in fp32 in k order (K1's mma_passes<1>), so the
// tensor core's truncating accumulation covers 16 exact products only.
//
// Element arithmetic as the reference's: K7's h(i, j) = (i == j) - (2 v_i) v_j
// with no FMA contraction; K8's c = cosf(theta), s = sinf(theta) (accurate
// functions; never build with --use_fast_math), G the identity with c, c, s,
// -s set in the reference's order.  The reference bakes K8's (gi, gj) into
// the kernel at trace time; a library built ahead of time takes them as
// runtime arguments.  Nothing is skipped: K8 multiplies G's zero entries and
// K9 U's zero triangle, so a non-finite input gives the full product's
// ±inf/NaN pattern (inf · 0 = NaN).
//
// What bounds them on an H100: bytes.  K7/K8 move the fp32 A in and the fp32
// result out (8 bytes per element against 2·m operations); K9 the same for x
// against 2·block_n operations per element, below the card's ≈ 295
// operations per byte.  This first version loads A with 4-byte loads straight
// into the fragment registers (K7/K8) and stages x through shared memory as
// bf16 words with synchronous 4-byte loads (K9, in k-slices of at most 4096
// columns); vectorised or asynchronous copies are later work.
//
// Ragged shapes are masked in the kernels: rows, columns and the contraction
// past m, k, rows or block_n read as zero and are not stored.
#include "tcec_core.cuh"

namespace {

using tcec::bf16_round;
using tcec::pack2;

// K7/K8: one warp computes a 16 x 32 tile of one batch's output (four n8
// tiles); a block holds four independent warps.
constexpr int RULE_WARPS = 4;
constexpr int NT = 4;

// K7's rule.  v: (batch, M).
struct Householder {
  const float* v;
  int M;
  const float* vb;  // this batch's vector
  float vi[2];      // v at the thread's rows i0 and i0 + 8

  __device__ void start(int b, int i0) {
    vb = v + static_cast<long long>(b) * M;
    vi[0] = i0 < M ? vb[i0] : 0.f;
    vi[1] = i0 + 8 < M ? vb[i0 + 8] : 0.f;
  }
  // h(i, j) at row i = i0 + 8 * half; zero outside M x M.
  __device__ float at(int i, int half, int j) const {
    if (i >= M || j >= M) return 0.f;
    return __fsub_rn(i == j ? 1.f : 0.f, __fmul_rn(__fmul_rn(2.f, vi[half]), vb[j]));
  }
};

// K8's rule.  theta: (batch,).
struct Givens {
  const float* theta;
  int M, gi, gj;
  float c, s;

  __device__ void start(int b, int) {
    const float th = theta[b];
    c = cosf(th);
    s = sinf(th);
  }
  __device__ float at(int i, int, int j) const {
    if (i >= M || j >= M) return 0.f;
    float g = i == j ? 1.f : 0.f;
    if (i == gi && j == gi) g = c;
    if (i == gj && j == gj) g = c;
    if (i == gi && j == gj) g = s;
    if (i == gj && j == gi) g = -s;
    return g;
  }
};

// The rule's A fragment (16 x 16, row major) of k step kk: register q holds
// row i0 + 8 (q & 1), columns j and j + 1 with j = kk + 2t + 8 (q >> 1).
template <class Rule>
__device__ __forceinline__ void rule_frag(const Rule& r, int i0, int kk, int t,
                                          uint32_t (&fa)[1][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int half = q & 1, i = i0 + 8 * half, j = kk + 2 * t + 8 * (q >> 1);
    fa[0][q] = pack2(bf16_round(r.at(i, half, j)), bf16_round(r.at(i, half, j + 1)));
  }
}

// The data operand's B fragment (16 x 8, col major) of k step kk for column
// c: rows kk + 2t + {0, 1} and kk + 2t + {8, 9} of A (M x K, row major).
__device__ __forceinline__ void data_frag(const float* A, int M, int K, int kk, int t, int c,
                                          uint32_t (&fb)[1][2]) {
  float x[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = kk + 2 * t + (q & 1) + 8 * (q >> 1);
    x[q] = (j < M && c < K) ? A[static_cast<long long>(j) * K + c] : 0.f;
  }
  fb[0][0] = pack2(bf16_round(x[0]), bf16_round(x[1]));
  fb[0][1] = pack2(bf16_round(x[2]), bf16_round(x[3]));
}

// O_b = R_b · A_b for a rule-made R (M x M) and A (batch, M, K), fp32 out.
// Work item of a warp: (batch, 16-row tile, 32-column group), row tiles
// fastest so the warps of a block share their A columns in L1.
template <class Rule>
__global__ void __launch_bounds__(RULE_WARPS * 32)
    rule_apply_kernel(Rule rule, const float* __restrict__ A, float* __restrict__ O, int batch,
                      int M, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m_tiles = (M + 15) / 16, n_groups = (K + 8 * NT - 1) / (8 * NT);
  const long long item = static_cast<long long>(blockIdx.x) * RULE_WARPS + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(batch) * m_tiles * n_groups) return;  // whole warps
  const int i0 = static_cast<int>(item % m_tiles) * 16 + g;
  const long long rest = item / m_tiles;
  const int c0 = static_cast<int>(rest % n_groups) * 8 * NT;
  const int b = static_cast<int>(rest / n_groups);
  const float* Ab = A + static_cast<long long>(b) * M * K;
  float* Ob = O + static_cast<long long>(b) * M * K;
  Rule r = rule;
  r.start(b, i0);

  float acc[NT][4] = {};
  for (int kk = 0; kk < M; kk += 16) {
    uint32_t fa[1][4];
    rule_frag(r, i0, kk, t, fa);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t fb[1][2];
      data_frag(Ab, M, K, kk, t, c0 + 8 * nt + g, fb);
      tcec::mma_passes<1>(acc[nt], fa, fb);
    }
  }
  // acc[nt][e] is at row i0 + 8 (e >> 1), column c0 + 8 nt + 2t + (e & 1).
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = i0 + 8 * (e >> 1), col = c0 + 8 * nt + 2 * t + (e & 1);
      if (row < M && col < K) Ob[static_cast<long long>(row) * K + col] = acc[nt][e];
    }
}

// K9: a block owns 16 rows and walks the column blocks in order, carrying
// each row's fp32 offset (the reference's (rows, 1) scratch).  Per column
// block the 16 x block_n tile of x is staged in shared memory as bf16 words
// (rows padded to SCAN_PAD more elements), a k-slice of at most SCAN_SLICE
// columns at a time, so any block_n fits; each warp computes 32-column groups
// of partial = bf16(x) · U, one k16 step after another in k order, adds the
// carry and stores; the value at column block_n - 1 becomes the carry.  With
// more than one slice a group's running sum waits in the output between
// slices (fp32, so exactly), and the next slice goes on adding to it: the
// same sums in the same order as one slice.
constexpr int SCAN_WARPS = 8;
constexpr int SCAN_ROWS = 16;
constexpr int SCAN_PAD = 8;
constexpr int SCAN_SLICE = 4096;  // 16 x (4096 + 8) bf16 = 131 KB of shared memory

__host__ __device__ constexpr int scan_kpad(int bn) { return (bn + 15) / 16 * 16; }
__host__ __device__ constexpr int scan_slice(int bn) {
  return scan_kpad(bn) < SCAN_SLICE ? scan_kpad(bn) : SCAN_SLICE;
}
__host__ __device__ constexpr int scan_lds(int bn) { return scan_slice(bn) + SCAN_PAD; }

// u(k, c) = [k <= c] inside the block_n x block_n block, zero outside.
__device__ __forceinline__ float tri(int k, int c, int bn) {
  return bf16_round(k <= c && c < bn ? 1.f : 0.f);
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(SCAN_WARPS * 32)
    scan_kernel(const float* __restrict__ X, float* __restrict__ O, int rows, int n, int bn) {
  extern __shared__ __align__(16) uint16_t xs[];  // [SCAN_ROWS][lds]
  __shared__ float carry_next[SCAN_ROWS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * SCAN_ROWS;
  const int kpad = scan_kpad(bn), slice = scan_slice(bn), lds = scan_lds(bn);
  const int groups = (bn + 31) / 32;
  float carry[2] = {0.f, 0.f};  // rows r0 + g and r0 + g + 8

  for (int j0 = 0; j0 < n; j0 += bn) {
    for (int k0 = 0; k0 < kpad; k0 += slice) {
      const int kend = k0 + slice < kpad ? k0 + slice : kpad;
      const bool first = k0 == 0, last = kend == kpad;
      __syncthreads();  // every warp is done reading the previous tile
      for (int c = tid; c < kend - k0; c += SCAN_WARPS * 32) {
        const int col = k0 + c;
        float x[SCAN_ROWS];
#pragma unroll
        for (int r = 0; r < SCAN_ROWS; ++r)
          x[r] = (r0 + r < rows && col < bn) ? X[static_cast<long long>(r0 + r) * n + j0 + col]
                                             : 0.f;
#pragma unroll
        for (int r = 0; r < SCAN_ROWS; ++r)
          xs[r * lds + c] = __bfloat16_as_ushort(__float2bfloat16_rn(x[r]));
      }
      __syncthreads();

      for (int grp = warp; grp < groups; grp += SCAN_WARPS) {
        const int c0 = 32 * grp;
        // The group's running sum: zero on the first slice, else what the
        // previous slice stored (the same thread stored it).
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = g + 8 * (e >> 1), col = c0 + 8 * nt + 2 * t + (e & 1);
            acc[nt][e] = !first && col < bn && r0 + rr < rows
                             ? O[static_cast<long long>(r0 + rr) * n + j0 + col]
                             : 0.f;
          }
        for (int kk = k0; kk < kend; kk += 16) {
          // x's A fragment: (g, 2t..2t+1), (g+8, ...), (g, 2t+8..2t+9), (g+8, ...).
          uint32_t fa[1][4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            fa[0][q] = ld_pair(xs + (g + 8 * (q & 1)) * lds + kk - k0 + 2 * t + 8 * (q >> 1));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // U's B fragment: (k = kk + 2t + {0, 1}, c) and (k = kk + 2t + {8, 9}, c).
            const int c = c0 + 8 * nt + g, k = kk + 2 * t;
            uint32_t fb[1][2] = {{pack2(tri(k, c, bn), tri(k + 1, c, bn)),
                                  pack2(tri(k + 8, c, bn), tri(k + 9, c, bn))}};
            tcec::mma_passes<1>(acc[nt], fa, fb);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = g + 8 * (e >> 1), col = c0 + 8 * nt + 2 * t + (e & 1);
            if (col >= bn) continue;
            const long long at = static_cast<long long>(r0 + rr) * n + j0 + col;
            if (!last) {
              if (r0 + rr < rows) O[at] = acc[nt][e];  // the running sum, for the next slice
              continue;
            }
            const float o = acc[nt][e] + carry[e >> 1];  // o = partial + carry
            if (r0 + rr < rows) O[at] = o;
            if (col == bn - 1) carry_next[rr] = o;       // then carry = o[:, -1]
          }
      }
    }
    __syncthreads();
    carry[0] = carry_next[g];
    carry[1] = carry_next[g + 8];
  }
}

// Opt the scan kernel in to the card's largest dynamic shared memory (once).
cudaError_t scan_prepare() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(SCAN_ROWS * sizeof(float)));
    return e;
  }();
  return err;
}

template <class Rule>
cudaError_t launch_rule(const Rule& rule, const float* A, float* O, int batch, int M, int K,
                        cudaStream_t stream) {
  const long long items =
      static_cast<long long>(batch) * ((M + 15) / 16) * ((K + 8 * NT - 1) / (8 * NT));
  const long long blocks = (items + RULE_WARPS - 1) / RULE_WARPS;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  rule_apply_kernel<Rule><<<static_cast<unsigned>(blocks), RULE_WARPS * 32, 0, stream>>>(
      rule, A, O, batch, M, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: O = (I - 2 v v^T) A per batch.  v (batch, M), A and O (batch, M, K),
// fp32, contiguous.  Returns cudaGetLastError() after the launch.
int repro_householder_apply(const float* v, const float* A, float* O, int batch, int M, int K,
                            void* stream) {
  const Householder rule{v, M, nullptr, {0.f, 0.f}};
  return static_cast<int>(
      launch_rule(rule, A, O, batch, M, K, static_cast<cudaStream_t>(stream)));
}

// K8: O = G(gi, gj, theta_b) A per batch.  theta (batch,), A and O (batch, M,
// K), fp32, contiguous.
int repro_givens_apply(const float* theta, const float* A, float* O, int batch, int M, int K,
                       int gi, int gj, void* stream) {
  const Givens rule{theta, M, gi, gj, 0.f, 0.f};
  return static_cast<int>(
      launch_rule(rule, A, O, batch, M, K, static_cast<cudaStream_t>(stream)));
}

// K9: O = row-wise cumsum of X (rows, n) as blockwise X·U with a carried
// offset; block_n divides n.  fp32, contiguous.
int repro_scan_cumsum(const float* X, float* O, int rows, int n, int block_n, void* stream) {
  if (block_n <= 0 || n % block_n != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = scan_prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint16_t) * SCAN_ROWS * scan_lds(block_n);
  scan_kernel<<<(rows + SCAN_ROWS - 1) / SCAN_ROWS, SCAN_WARPS * 32, smem,
                static_cast<cudaStream_t>(stream)>>>(X, O, rows, n, block_n);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
