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
// cast (tcec::bf16_round, or frag::cvt2 two values at a time, the same
// bits) and packs it straight into the register: H, G and
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
// ≈ 295 operations per byte: a staged, pipelined pass that reads each
// element of A from device memory once, described at rule_apply_kernel
// below.  K9 reads x once and writes the result once (8 bytes per element
// against one add of the function, 32 tensor-core operations of this
// design): a streaming pass, described at scan_kernel below.
//
// Ragged shapes are masked in the kernels: rows, columns and the contraction
// past m, k, rows or block_n read as zero and are not stored.
#include <algorithm>

#include "tcec_frag.cuh"

namespace {

using tcec::bf16_round;
using tcec::pack2;

// K7/K8 as a staged, pipelined pass.  Each element of A comes from device
// memory once (at M <= 128; above, once per row group of 128 rows, below),
// staged in shared memory and read from there by every row tile; the
// rule's operand is made in registers once per unit and stage; outputs go
// out as paired stores; a ring keeps the next stages' copies in flight.
//
// Work: a work item is NB whole batches (when a batch's A fits one slice),
// or one batch's column slice of W columns, W a power of two >= 32, with
// all M rows (M <= 128), or, above M = 128, one batch's 32-column slice and
// one row group of 128 output rows, its contraction streamed through the
// ring in k16 slabs of 128 rows (each row group re-reads its slice, mostly
// from L2), the slabs in k order.  A stage is one item's slab (the whole
// item at M <= 128).  Of an item's output, a unit is one 16-row tile of one
// batch times one 32-column group (four n8 tiles); a block's four warps
// take two units each (units w and w + 4), so an item has at most 8 units.
// W is as wide and NB as large as that allows (larger items measured
// faster), except that NB halves while the batch count would leave fewer
// than RULE_ITEMS_PER_SM items per SM.
//
// Data flow: a persistent grid (blocks per SM from the occupancy of this
// call's shared memory) walks items with a stride of the grid.  A ring of
// RULE_SLOTS slots per block; a slot holds a stage's A rows (fp32, row
// stride W + 4, = 4 mod 32 words, so a B fragment's reads of rows 2t, 2t + 1
// of a column hit 32 banks) by 16-byte cp.async (4-byte where A or K is not
// aligned for them), zero-filled past M, K and the last batch, and the
// rule's inputs: v at the staged rows and at the item's output rows (K7),
// theta of the item's batches (K8), by 4-byte cp.async.  One barrier per
// stage: wait for stage j, barrier, start stage j + 2's copies into the slot
// stage j - 1 used, compute stage j; stages j + 1 and j + 2 are in flight
// meanwhile.  Per unit and stage a warp makes the rule's A fragments of all
// the slab's k16 steps (K7: v from the slot, no FMA contraction; K8: cosf and
// sinf of the staged angle, G's four entries set in the reference's order),
// then per step and n8 tile the B fragment from the slot (two values per
// cvt.rn.bf16x2.f32, bitwise K1's plain cast) and one mma.sync on a fresh
// accumulator, added in fp32 in k order (K1's mma_passes<1>): the same
// fragments, mma's and sums in the same order whatever the item, slab or
// unit, so the bits depend on the shape alone.  After an
// item's last slab the unit's 16 x 32 outputs are stored as float2 pairs
// (whole 32-byte sectors; staging them for 16-byte stores measured no
// faster).
//
// Footprint (H100): a slot is rows x (W + 4) + Rule::PARAMS floats (K7 256,
// K8 8), rows x W <= 4096, so <= 19,456 B; three slots <= 58,368 B of
// dynamic shared memory per block.  At K7's (16384, 32, 64) (NB 2) and K8's
// (32768, 32, 32) (NB 4) a slot is 18,432 and 18,464 B, a block 55,296 and
// 55,392 B, so 4 blocks per SM (shared memory; 116 registers a thread
// would allow 4 as well), each keeping two 16 KB stages in flight: 128 KB of
// copies in flight per SM (3.35 TB/s x ~1.3 us / 132 SMs ~ 32 KB).
constexpr int RULE_WARPS = 4;
constexpr int RULE_THREADS = RULE_WARPS * 32;
constexpr int NT = 4;                             // n8 tiles of a unit
constexpr int RULE_UNITS = 2;                     // units per warp and stage
constexpr int RULE_SLAB = 128;                    // most A rows a stage holds
constexpr int RULE_STEPS = RULE_SLAB / 16;        // k16 steps of a slab
constexpr int RULE_SLOTS = 3;                     // ring depth: two in flight
constexpr int RULE_MAX_SLOT = RULE_SLAB * (32 + 4) + 2 * RULE_SLAB;  // floats
constexpr int RULE_ITEMS_PER_SM = 16;  // NB shrinks until there are this many

// The call's geometry, made on the host by rule_dims.
struct RuleDims {
  int batch, M, K;
  int W, ncg;          // slice width and its 32-column groups
  int nb;              // batches per item
  int rg_tiles, n_rg;  // row tiles per item, row groups per batch
  int n_slices, n_slabs;
  int rows, ld;        // A rows a slot holds, and their stride (W + 4)
  int params;          // floats of the rule's inputs in a slot (Rule::PARAMS)
  int items;
  __host__ __device__ int slot_floats() const { return rows * ld + params; }
};

// What a stage copies and computes (all indices from its stage number).
struct RuleStage {
  long long row0, irow0;  // A/v rows (of the batch * M rows) of the slab and
                          // of the item's first output row
  int nrows, nirows;      // how many of each exist
  int b0, nbv;            // the item's first batch, its batches that exist
  int rg, k0, c0, ncols;  // row group, first k of the slab, slice columns
  bool last;              // the item's last slab
};

__device__ __forceinline__ RuleStage rule_stage(const RuleDims& d, int j) {
  RuleStage s;
  // (a divisor of 1, the common case, skips its division)
  const int il = d.n_slabs == 1 ? j : j / d.n_slabs, slab = j - il * d.n_slabs;
  const int item = blockIdx.x + il * gridDim.x, rest = d.n_rg == 1 ? item : item / d.n_rg;
  s.rg = item - rest * d.n_rg;
  const int bg = d.n_slices == 1 ? rest : rest / d.n_slices;
  s.c0 = (rest - bg * d.n_slices) * d.W;
  s.b0 = bg * d.nb;
  s.nbv = min(d.nb, d.batch - s.b0);
  s.k0 = slab * RULE_SLAB;
  s.row0 = static_cast<long long>(s.b0) * d.M + s.k0;
  s.nrows = min(d.rows, s.nbv * d.M - s.k0);
  s.irow0 = static_cast<long long>(s.b0) * d.M + s.rg * RULE_SLAB;
  s.nirows = min(RULE_SLAB, s.nbv * d.M - s.rg * RULE_SLAB);
  s.ncols = min(d.W, d.K - s.c0);
  s.last = slab == d.n_slabs - 1;
  return s;
}

// K7's rule, h(i, j) = (i == j) - (2 v_i) v_j, zero outside M x M.
struct Householder {
  static constexpr int PARAMS = 2 * RULE_SLAB;
  const float* v;  // (batch, M)

  // The stage's v: at its staged rows (p[0..128)) and at its item's output
  // rows (p[128..256)).
  __device__ void copy(float* p, const RuleStage& s, int tid) const {
#pragma unroll
    for (int r = tid; r < PARAMS; r += RULE_THREADS) {
      const bool out = r >= RULE_SLAB;
      const int rr = out ? r - RULE_SLAB : r;
      const bool ok = rr < (out ? s.nirows : s.nrows);
      frag::cp_async4(p + r, ok ? v + (out ? s.irow0 : s.row0) + rr : v, ok);
    }
  }
  // One unit's rule: its batch nb in the item, its rows i0 and i0 + 8
  // (il0: i0 within the row group).
  struct Unit {
    const float* vk;  // v at the slab's k positions of the unit's batch
    float two_vi[2];  // 2 v_i at the thread's rows
    int M;
    __device__ float at(int i, int half, int j, int jl) const {
      if (i >= M || j >= M) return 0.f;
      return __fsub_rn(i == j ? 1.f : 0.f, __fmul_rn(two_vi[half], vk[jl]));
    }
  };
  __device__ Unit unit(const float* p, int M, int nb, int i0, int il0) const {
    Unit u;
    u.vk = p + nb * M;
    u.M = M;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      u.two_vi[h] = i0 + 8 * h < M ? __fmul_rn(2.f, p[RULE_SLAB + nb * M + il0 + 8 * h]) : 0.f;
    return u;
  }
};

// K8's rule: the identity with c, c, s, -s set in the reference's order.
struct Givens {
  static constexpr int PARAMS = RULE_WARPS * RULE_UNITS;  // an angle per batch
  const float* theta;  // (batch,)
  int gi, gj;

  __device__ void copy(float* p, const RuleStage& s, int tid) const {
    if (tid < PARAMS) {  // at most one batch per unit
      const bool ok = tid < s.nbv;
      frag::cp_async4(p + tid, ok ? theta + s.b0 + tid : theta, ok);
    }
  }
  struct Unit {
    float c, s;
    int M, gi, gj;
    __device__ float at(int i, int, int j, int) const {
      if (i >= M || j >= M) return 0.f;
      float g = i == j ? 1.f : 0.f;
      if (i == gi && j == gi) g = c;
      if (i == gj && j == gj) g = c;
      if (i == gi && j == gj) g = s;
      if (i == gj && j == gi) g = -s;
      return g;
    }
  };
  __device__ Unit unit(const float* p, int M, int nb, int, int) const {
    const float th = p[nb];
    return Unit{cosf(th), sinf(th), M, gi, gj};
  }
};

// Start stage j's copies into its slot (none past the block's last stage;
// the group is committed either way, so the wait counts stay fixed).
template <bool VEC, class Rule>
__device__ __forceinline__ void rule_copy(const RuleDims& d, const Rule& rule, const float* A,
                                          float* slot, int j, int stages, int tid) {
  if (j < stages) {
    constexpr int PER = VEC ? 4 : 1;
    const RuleStage s = rule_stage(d, j);
    const int cpr = d.W / PER, shift = __ffs(cpr) - 1;  // chunks per row (a power of two)
    const int chunks = d.rows * cpr;
#pragma unroll 4
    for (int idx = tid; idx < chunks; idx += RULE_THREADS) {
      const int r = idx >> shift, c = (idx & (cpr - 1)) * PER;
      const bool ok = r < s.nrows && c < s.ncols;
      const float* src = ok ? A + (s.row0 + r) * d.K + s.c0 + c : A;
      if (VEC)
        frag::cp_async16(slot + r * d.ld + c, src, ok);
      else
        frag::cp_async4(slot + r * d.ld + c, src, ok);
    }
    rule.copy(slot + d.rows * d.ld, s, tid);
  }
  frag::cp_async_commit();
}

// O_b = R_b · A_b for a rule-made R (M x M) and A (batch, M, K), fp32 out.
// VEC: A 16-byte aligned with K % 4 == 0 and O 8-byte aligned (16-byte
// copies, paired stores); else 4-byte copies and single stores.
template <class Rule, bool VEC>
__global__ void __launch_bounds__(RULE_THREADS)
    rule_apply_kernel(Rule rule, const float* __restrict__ A, float* __restrict__ O, RuleDims d) {
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int stages = (d.items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                     static_cast<int>(gridDim.x) * d.n_slabs;
  const int K = d.K, M = d.M, slot_floats = d.slot_floats();

#pragma unroll 1
  for (int j = 0; j < RULE_SLOTS - 1; ++j)
    rule_copy<VEC>(d, rule, A, ring + j * slot_floats, j, stages, tid);

  float acc[RULE_UNITS][NT][4];
  int cur = 0;  // stage j's slot, j % RULE_SLOTS
#pragma unroll 1
  for (int j = 0; j < stages; ++j, cur = cur == RULE_SLOTS - 1 ? 0 : cur + 1) {
    frag::cp_async_wait<RULE_SLOTS - 2>();
    __syncthreads();  // stage j landed; every warp is done with stage j - 1's slot
    rule_copy<VEC>(d, rule, A, ring + (cur == 0 ? RULE_SLOTS - 1 : cur - 1) * slot_floats,
                   j + RULE_SLOTS - 1, stages, tid);
    const RuleStage s = rule_stage(d, j);
    const float* slot = ring + cur * slot_floats;
    const float* p = slot + d.rows * d.ld;
    const int steps = min(RULE_STEPS, (M - s.k0 + 15) / 16);
#pragma unroll
    for (int q = 0; q < RULE_UNITS; ++q) {
      // Unit -> (batch in the item, row tile in the group, column group).
      const int u = warp + q * RULE_WARPS, cg = u % d.ncg, rest = u / d.ncg;
      const int rt = rest % d.rg_tiles, nb = rest / d.rg_tiles;
      const int il0 = rt * 16 + g, i0 = s.rg * RULE_SLAB + il0;  // the thread's first row
      if (nb >= s.nbv || i0 - g >= M || cg * 32 >= s.ncols) continue;  // whole warps
      if (s.k0 == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.f;
      }
      // The rule's A fragments (16 x 16, row major) of every step of the
      // slab: register r holds row i0 + 8 (r & 1), columns j and j + 1 with
      // j = k0 + 16 st + 2t + 8 (r >> 1).
      const typename Rule::Unit ru = rule.unit(p, M, nb, i0, il0);
      uint32_t fa[RULE_STEPS][1][4];
#pragma unroll
      for (int st = 0; st < RULE_STEPS; ++st) {
        if (st >= steps) break;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int half = r & 1, i = i0 + 8 * half, jl = 16 * st + 2 * t + 8 * (r >> 1);
          fa[st][0][r] = frag::cvt2(ru.at(i, half, s.k0 + jl, jl),
                                    ru.at(i, half, s.k0 + jl + 1, jl + 1));
        }
      }
      // The data's B fragments (16 x 8, col major) from the slot: rows
      // 16 st + 2t + {0, 1, 8, 9} of the unit's batch, column g of each n8
      // tile; rows past M read as zero.
      const float* xs = slot + nb * M * d.ld + cg * 32 + g;
#pragma unroll
      for (int st = 0; st < RULE_STEPS; ++st) {
        if (st >= steps) break;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jl = 16 * st + 2 * t + (e & 1) + 8 * (e >> 1);
            x[e] = s.k0 + jl < M ? xs[jl * d.ld + 8 * nt] : 0.f;
          }
          const uint32_t fb[1][2] = {{frag::cvt2(x[0], x[1]), frag::cvt2(x[2], x[3])}};
          tcec::mma_passes<1>(acc[q][nt], fa[st], fb);
        }
      }
      if (!s.last) continue;
      // acc[q][nt][e] is at row i0 + 8 (e >> 1), column 8 nt + 2t + (e & 1).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (i0 + 8 * h >= M) continue;
        float* orow = O + (static_cast<long long>(s.b0 + nb) * M + i0 + 8 * h) * K + s.c0 + cg * 32;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = 8 * nt + 2 * t;
          if (VEC) {
            if (cg * 32 + c < s.ncols)
              *reinterpret_cast<float2*>(orow + c) = make_float2(acc[q][nt][2 * h], acc[q][nt][2 * h + 1]);
          } else {
            if (cg * 32 + c < s.ncols) orow[c] = acc[q][nt][2 * h];
            if (cg * 32 + c + 1 < s.ncols) orow[c + 1] = acc[q][nt][2 * h + 1];
          }
        }
      }
    }
  }
  frag::cp_async_wait<0>();
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

// The geometry of a K7/K8 call (see rule_apply_kernel) on a card of `sms`
// SMs.  Returns false when the work items do not fit an int.
bool rule_dims(int batch, int M, int K, int params, int sms, RuleDims& d) {
  d.batch = batch;
  d.M = M;
  d.K = K;
  d.params = params;
  const int m_tiles = (M + 15) / 16, kcg = (K + 31) / 32;
  long long items;
  if (m_tiles <= RULE_STEPS) {  // all rows in one item: A read once
    const int cap = RULE_WARPS * RULE_UNITS / m_tiles;  // column groups an item can take
    d.ncg = 1;
    while (2 * d.ncg <= cap && d.ncg < kcg) d.ncg *= 2;
    d.W = 32 * d.ncg;
    d.n_slices = (K + d.W - 1) / d.W;
    // Whole batches per item: as many as the units allow, fewer where the
    // batch count would leave fewer than RULE_ITEMS_PER_SM items per SM.
    d.nb = d.n_slices == 1 ? RULE_WARPS * RULE_UNITS / (m_tiles * d.ncg) : 1;
    while (d.nb > 1 && (batch + d.nb - 1) / d.nb < RULE_ITEMS_PER_SM * sms) d.nb /= 2;
    d.rg_tiles = m_tiles;
    d.n_rg = 1;
    d.rows = d.nb * M;
    d.n_slabs = 1;
    items = static_cast<long long>((batch + d.nb - 1) / d.nb) * d.n_slices;
  } else {  // row groups of 128 rows, the contraction in slabs of 128 rows
    d.ncg = 1;
    d.W = 32;
    d.n_slices = kcg;
    d.nb = 1;
    d.rg_tiles = RULE_STEPS;
    d.n_rg = (m_tiles + RULE_STEPS - 1) / RULE_STEPS;
    d.rows = RULE_SLAB;
    d.n_slabs = d.n_rg;
    items = static_cast<long long>(batch) * d.n_slices * d.n_rg;
  }
  d.ld = d.W + 4;
  d.items = static_cast<int>(items);
  return items <= 0x7FFFFFFFLL;
}

template <class Rule, bool VEC>
cudaError_t launch_rule_t(const Rule& rule, const float* A, float* O, const RuleDims& d, int sms,
                          cudaStream_t stream) {
  const auto kernel = rule_apply_kernel<Rule, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RULE_SLOTS * RULE_MAX_SLOT * 4);
  if (attr != cudaSuccess) return attr;
  const int smem = RULE_SLOTS * d.slot_floats() * 4;
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, RULE_THREADS, smem);
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(
      std::min<long long>(d.items, static_cast<long long>(std::max(per_sm, 1)) * sms));
  kernel<<<grid, RULE_THREADS, smem, stream>>>(rule, A, O, d);
  return cudaGetLastError();
}

// 16-byte copies need K % 4 == 0 and A 16-byte aligned; paired stores O
// 8-byte aligned.
template <class Rule>
cudaError_t launch_rule(const Rule& rule, const float* A, float* O, int batch, int M, int K,
                        cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  RuleDims d;
  if (!rule_dims(batch, M, K, Rule::PARAMS, sms, d)) return cudaErrorInvalidValue;
  if (K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(O) % 8 == 0)
    return launch_rule_t<Rule, true>(rule, A, O, d, sms, stream);
  return launch_rule_t<Rule, false>(rule, A, O, d, sms, stream);
}

}  // namespace

extern "C" {

// K7: O = (I - 2 v v^T) A per batch.  v (batch, M), A and O (batch, M, K),
// fp32, contiguous.  Returns cudaGetLastError() after the launch.
int repro_householder_apply(const float* v, const float* A, float* O, int batch, int M, int K,
                            void* stream) {
  const Householder rule{v};
  return static_cast<int>(
      launch_rule(rule, A, O, batch, M, K, static_cast<cudaStream_t>(stream)));
}

// K8: O = G(gi, gj, theta_b) A per batch.  theta (batch,), A and O (batch, M,
// K), fp32, contiguous.
int repro_givens_apply(const float* theta, const float* A, float* O, int batch, int M, int K,
                       int gi, int gj, void* stream) {
  const Givens rule{theta, gi, gj};
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
