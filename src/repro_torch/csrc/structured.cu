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
// runtime arguments.  K7 and K8 skip nothing (K8 multiplies G's zero
// entries), so a non-finite input gives the full product's ±inf/NaN pattern
// (inf · 0 = NaN); K9 skips U's zero triangle and keeps that pattern by the
// rule stated at scan_kernel.
//
// What bounds them on an H100: bytes.  K7/K8 move the fp32 A in and the fp32
// result out (8 bytes per element against 2·m operations), below the card's
// ≈ 295 operations per byte; they load A with 4-byte loads straight into the
// fragment registers.  K9 reads x once and writes the result once (8 bytes
// per element against one add of the function, 32 tensor-core operations
// of this design): a streaming pass, described at scan_kernel below.
//
// Ragged shapes are masked in the kernels: rows, columns and the contraction
// past m, k, rows or block_n read as zero and are not stored.
#include "tcec_frag.cuh"

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

// K9 as a streaming scan.  Column c of a block_n block receives u(k, c) =
// [k <= c], so of the full product x·U's k16 steps, in the reference's
// order (K1's mma_passes<1>: each step on a fresh accumulator, the steps
// added in fp32 in k order), column c sees: all-ones steps, each giving the
// same tensor-core sum S(kk) of its 16 bf16 values in every column; then its
// diagonal step, giving D(c); then zero steps.  So per row a running fp32
// prefix R over the steps' S, in k order and restarting at each column
// block, gives every column the same sums in the same order:
//   o(c) = (R_before(step(c)) + D(c)) + carry,   carry = o(block_n - 1),
// with finite inputs the full product's bits up to the sign of zero (the
// zero steps add +-0).  Per k16 step a warp runs two mma.sync against the
// diagonal step's triangle fragments, made once per thread from the rule in
// registers (U reaches neither shared nor device memory); S(kk) is the
// second's column 15, whose U column is all ones.  No mma touches the zero
// triangle: 32 operations per element instead of 2 block_n.
//
// Data flow: a block owns 16 rows and walks all their k16 steps in order
// (every column block, steps anchored at the block's start, a ragged last
// step zero-padded).  A ring of SCAN_SLOTS slots of SCAN_STEPS steps (16 rows
// x 128 fp32 columns) is filled by 16-byte cp.async copies (4-byte ones when
// x or block_n is not 16-byte aligned), the next slots' copies in flight
// while a slot is computed: each warp takes one step of the slot (A
// fragments two values per cvt.rn.bf16x2.f32, bitwise K1's plain cast), and
// writes S to shared memory; then warp 0 runs the slot's prefix chain (one
// lane per row, the serial fp32 adds off the copy path) while the other
// warps fill NaN where the previous slot asks it (below); after the next
// barrier each warp writes its step's outputs once, as paired stores.
// Nothing is read back from O.
//
// The non-finite rule.  In the full product a non-finite bf16(x) at k > c
// (a finite fp32 value that rounds to +-inf in bf16 included) makes column
// c NaN (inf * 0).  Inside c's step D(c) carries it and across earlier steps
// R does; for a later step of the same block, a warp that finds a
// non-finite value in its step's fragment marks the step in a per-row mask,
// and the block (told by __syncthreads_or) sets to NaN, once the outputs are
// written, every column of that row and block before the last marked step.
// So the result has the full product's +-inf/NaN pattern.
constexpr int SCAN_WARPS = 8;
constexpr int SCAN_ROWS = 16;
constexpr int SCAN_STEPS = SCAN_WARPS;  // k16 steps per slot: one per warp
constexpr int SCAN_SLOTS = 3;           // ring depth: two slots in flight
constexpr int SCAN_LD = SCAN_STEPS * 16 + 8;  // fp32 row stride, = 8 mod 32
constexpr int SCAN_SLD = SCAN_STEPS + 1;      // row stride of the chain arrays

// The rule: u(k, c) = [k <= c] at step-local positions.
__device__ __forceinline__ float tri(int k, int c) { return bf16_round(k <= c ? 1.f : 0.f); }

// Either half of a bf16 pair is inf or NaN.
__device__ __forceinline__ bool nonfinite2(uint32_t w) {
  return (w & 0x7F80u) == 0x7F80u || (w & 0x7F800000u) == 0x7F800000u;
}

// The row geometry shared by every thread of a call.
struct ScanDims {
  int rows, n, bn, spb, total;  // spb: k16 steps per block; total: steps per row
  // First column of step q (in order over the blocks) and its columns.
  __device__ int col(int q, int& valid) const {
    const int b = q / spb, s = q - b * spb;
    valid = min(16, bn - 16 * s);
    return b * bn + 16 * s;
  }
};

// Start slot j's copies into ring slot j % SCAN_SLOTS (none past the end;
// the group is committed either way, so the wait counts stay fixed).
template <bool VEC>
__device__ __forceinline__ void scan_copy(const ScanDims& d, const float* X, float* ring, int r0,
                                          int j, int tid) {
  constexpr int PER = VEC ? 4 : 1, CHUNKS = SCAN_ROWS * SCAN_STEPS * 16 / PER;
  float* slot = ring + (j % SCAN_SLOTS) * SCAN_ROWS * SCAN_LD;
#pragma unroll
  for (int u = 0; u < CHUNKS / (SCAN_WARPS * 32); ++u) {
    const int idx = tid + u * SCAN_WARPS * 32;
    const int row = idx / (CHUNKS / SCAN_ROWS), e = idx % (CHUNKS / SCAN_ROWS) * PER;
    const int q = j * SCAN_STEPS + e / 16;
    int valid = 0;
    const int c0 = q < d.total ? d.col(q, valid) : 0;
    const bool ok = r0 + row < d.rows && e % 16 < valid;
    const float* src = ok ? X + static_cast<long long>(r0 + row) * d.n + c0 + e % 16 : X;
    if (VEC)
      frag::cp_async16(slot + row * SCAN_LD + e, src, ok);
    else
      frag::cp_async4(slot + row * SCAN_LD + e, src, ok);
  }
  frag::cp_async_commit();
}

// NaN where slot i's marks ask for it (see the non-finite rule): warps 1..7
// own rows warp - 1, warp + 6, ...; nan_to[r] is the end of what row r has
// already set, so every column is set once.  Clears the marks it read.
__device__ void scan_fill(const ScanDims& d, float* O, uint32_t* mask, int* nan_to, int r0,
                          int i, int warp, int lane) {
  for (int r = warp - 1; r < SCAN_ROWS; r += SCAN_WARPS - 1) {
    const uint32_t m = mask[r];
    if (m == 0) continue;
    float* orow = O + static_cast<long long>(r0 + r) * d.n;
    int to = nan_to[r], last = -1;
    for (int s = 0; s < SCAN_STEPS; ++s) {
      const int q = i * SCAN_STEPS + s;
      if (q >= d.total) break;
      const int b = q / d.spb, sb = q - b * d.spb;
      if (m >> s & 1) last = sb;
      if (last >= 0 && (s == SCAN_STEPS - 1 || q + 1 == d.total || sb == d.spb - 1)) {
        const int from = max(b * d.bn, to), upto = b * d.bn + 16 * last;
        for (int c = from + lane; c < upto; c += 32) orow[c] = __int_as_float(0x7FFFFFFF);
        to = max(to, upto);
        last = -1;
      }
      if (sb == d.spb - 1) last = -1;
    }
    __syncwarp();
    if (lane == 0) {
      mask[r] = 0;
      nan_to[r] = to;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(SCAN_WARPS * 32)
    scan_kernel(const float* __restrict__ X, float* __restrict__ O, ScanDims d) {
  __shared__ __align__(16) float ring[SCAN_SLOTS * SCAN_ROWS * SCAN_LD];
  __shared__ float s_sum[SCAN_ROWS * SCAN_SLD];   // S of each step of the slot
  __shared__ float s_pre[SCAN_ROWS * SCAN_SLD];   // R before each step
  __shared__ float s_car[SCAN_ROWS * SCAN_SLD];   // the block's carry at each step
  __shared__ uint32_t s_mask[2][SCAN_ROWS];       // steps with a non-finite value
  __shared__ int s_nan_to[SCAN_ROWS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * SCAN_ROWS;
  const int slots = (d.total + SCAN_STEPS - 1) / SCAN_STEPS;
  if (tid < SCAN_ROWS) {
    s_mask[0][tid] = s_mask[1][tid] = 0;
    s_nan_to[tid] = 0;
  }
  // The diagonal step's U fragments (16 x 8, col major): columns g and 8 + g.
  const uint32_t diag[2][2] = {
      {pack2(tri(2 * t, g), tri(2 * t + 1, g)), pack2(tri(2 * t + 8, g), tri(2 * t + 9, g))},
      {pack2(tri(2 * t, 8 + g), tri(2 * t + 1, 8 + g)),
       pack2(tri(2 * t + 8, 8 + g), tri(2 * t + 9, 8 + g))}};
  float pre = 0.f, carry = 0.f;  // warp 0, lane r < 16: row r's chain
  int step_in_block = 0;
  float dv[2][4] = {};  // this warp's D of the previous slot's step
  int marked = 0;       // the previous slot marked a non-finite value

#pragma unroll 1
  for (int j = 0; j < SCAN_SLOTS; ++j) scan_copy<VEC>(d, X, ring, r0, j, tid);

#pragma unroll 1
  for (int i = 0; i <= slots; ++i) {
    frag::cp_async_wait<SCAN_SLOTS - 1>();
    __syncthreads();  // slot i landed; the chain of slot i - 1 is in shared memory
    if (i > 0 && (i - 1) * SCAN_STEPS + warp < d.total) {
      // The outputs of slot i - 1's step: o = (R_before + D) + carry.
      int valid;
      const int c0 = d.col((i - 1) * SCAN_STEPS + warp, valid);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = g + 8 * h;
        if (r0 + rr >= d.rows) continue;
        const float p = s_pre[rr * SCAN_SLD + warp], cy = s_car[rr * SCAN_SLD + warp];
        float* orow = O + static_cast<long long>(r0 + rr) * d.n + c0;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = 8 * nt + 2 * t;
          const float o0 = (p + dv[nt][2 * h]) + cy, o1 = (p + dv[nt][2 * h + 1]) + cy;
          if (VEC) {
            if (c < valid) *reinterpret_cast<float2*>(orow + c) = make_float2(o0, o1);
          } else {
            if (c < valid) orow[c] = o0;
            if (c + 1 < valid) orow[c + 1] = o1;
          }
        }
      }
    }
    if (i == slots) {
      if (marked) {
        __syncthreads();  // the outputs are written before any NaN lands on them
        if (warp > 0) scan_fill(d, O, s_mask[(i - 1) & 1], s_nan_to, r0, i - 1, warp, lane);
      }
      break;
    }

    // This warp's step of slot i: D for its 16 columns, S for the chain.
    bool bad = false;
    if (i * SCAN_STEPS + warp < d.total) {
      const float* xs = ring + (i % SCAN_SLOTS) * SCAN_ROWS * SCAN_LD + 16 * warp + 2 * t;
      uint32_t fa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(xs + (g + 8 * (r & 1)) * SCAN_LD +
                                                          8 * (r >> 1));
        fa[r] = frag::cvt2(v.x, v.y);
      }
      tcec::mma_16816(dv[0], fa, diag[0]);
      tcec::mma_16816(dv[1], fa, diag[1]);
      if (t == 3) {  // column 15: S of rows g and g + 8
        s_sum[g * SCAN_SLD + warp] = dv[1][1];
        s_sum[(g + 8) * SCAN_SLD + warp] = dv[1][3];
      }
      const bool bad_g = nonfinite2(fa[0]) || nonfinite2(fa[2]);
      const bool bad_g8 = nonfinite2(fa[1]) || nonfinite2(fa[3]);
      if (bad_g) atomicOr(&s_mask[i & 1][g], 1u << warp);
      if (bad_g8) atomicOr(&s_mask[i & 1][g + 8], 1u << warp);
      bad = bad_g || bad_g8;
    }
    const int marks = __syncthreads_or(bad);  // S in shared memory; slot i's x read
    scan_copy<VEC>(d, X, ring, r0, i + SCAN_SLOTS, tid);
    if (warp == 0) {
      if (lane < SCAN_ROWS) {
        // Row lane's prefix chain over slot i's steps, in k order.
#pragma unroll
        for (int s = 0; s < SCAN_STEPS; ++s) {
          if (i * SCAN_STEPS + s >= d.total) break;
          s_pre[lane * SCAN_SLD + s] = pre;
          s_car[lane * SCAN_SLD + s] = carry;
          pre = pre + s_sum[lane * SCAN_SLD + s];
          if (++step_in_block == d.spb) {  // the block's last column: o = pre + carry
            carry = pre + carry;
            pre = 0.f;
            step_in_block = 0;
          }
        }
      }
    } else if (marked) {
      scan_fill(d, O, s_mask[(i - 1) & 1], s_nan_to, r0, i - 1, warp, lane);
    }
    marked = marks;
  }
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
  const int spb = (block_n + 15) / 16;
  const ScanDims d{rows, n, block_n, spb, n / block_n * spb};
  const unsigned blocks = (rows + SCAN_ROWS - 1) / SCAN_ROWS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row, step and x itself 16-byte aligned.
  if (block_n % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(O) % 8 == 0)
    scan_kernel<true><<<blocks, SCAN_WARPS * 32, 0, st>>>(X, O, d);
  else
    scan_kernel<false><<<blocks, SCAN_WARPS * 32, 0, st>>>(X, O, d);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
