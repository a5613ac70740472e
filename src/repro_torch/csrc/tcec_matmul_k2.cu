// K2 — the serving path's fused TCEC matmul:
//   C = act(scale * sum_sched A_i B_j + bias) + residual, at the out dtype,
// A (batch, M, K) at fp32 or bf16, B (K, N) shared or (batch, K, N) at fp32
// or bf16, each read at its own dtype, or B made in registers from a menu
// rule (the frag= arm, below).
//
// Replaces: repro/kernels/tcec_matmul.py::_fused_kernel (the pallas_call in
// _tcec_matmul_fused), bf16-word arms, with its in-kernel fragment rhs
// (frag=) for the rules of rule_menu.cuh.  Not ported yet: the int8 words,
// the vpu arm, bf16x9 and rules off the menu (the wrapper raises; the
// frontend sends such rules to the twin).  K2b, the epilogue-free product
// over a tile menu, keeps its own source (tcec_matmul.cu).
//
// What bounds it on an H100: the serving path's lhs has few rows (decode: one
// row per slot, m = 4; prefill: the prompt, m = 64-288), so K2 streams the
// weight matrix once and is bound by its bytes (bf16 weights: 2 bytes per
// element against 2 m flops per element and pass).  At decode the call is a
// few microseconds of HBM time, so what matters is enough blocks and enough
// bytes in flight, not tensor-core throughput.
//
// The data flow is the paper's WMMAe flow: only the source tiles are staged
// in shared memory, at their input dtype, and the bf16 words of both operands
// are made in registers straight into the mma.sync fragments (K1,
// tcec_core.cuh); no word is staged.  The design for Hopper's decode shapes:
//
// * Operand roles swapped.  The weight tile is mma.sync's m16 operand (16
//   output columns per tile, loaded from the [k][n] smem tile with
//   ldmatrix.trans for bf16), the activation rows its n8 operand, so m = 4
//   fills 4 of 8 lanes of a tile, not 4 of 16 rows.
// * Two tiles, chosen by the host from m (kernels/tcec_matmul.py::k2_plan):
//   DECODE (m <= 16): 32 columns x 8 rows, 4 warps: 2 of 16 columns each,
//   times 2 that take turns over the k16 steps, so twice as many warps hide
//   the latency of each step's fragment loads; PREFILL: 64 x 64, 4 warps of
//   32 x 32.
// * Split k across blocks, so that a call launches about two blocks per SM
//   (w_down at m = 4: 28 column tiles x 11 splits).  Each split writes its
//   fp32 partial sum to a workspace the wrapper allocates; a second kernel
//   (k2_reduce), enqueued by the same call as a programmatic dependent
//   launch (its blocks wait on the card, not behind a launch), adds the
//   partials in split order and applies the epilogue once.  No float
//   atomics: the result is the same bits run to run.  One split: the
//   epilogue runs at the store.
// * cp.async 16-byte copies (.cg: the weights bypass L1) into a ring of 2-4
//   stages with zero-fill past the edges; a tile whose rows are not 16-byte
//   aligned (N or K not a multiple of 16 bytes) falls back to element loads.
// * Only passes whose words can be nonzero run.  A bf16 operand is its own
//   word 0 and its other words are exactly 0, so a pass (i, j) with i or j at
//   or above that operand's word count added exact zeros: bf16 x bf16 runs
//   one pass, fp32 x bf16 under bf16x6 runs (2,0), (1,0), (0,0), in schedule
//   order.  No value changes (the accumulator starts at +0, so not even the
//   sign of a zero).
//
// * The frag= arm (the paper's rule-made operand, Code 4/5): B is a menu rule
//   (rule_menu.cuh; id and two ints are runtime arguments, so the arm is
//   one more B type per (A type, pass count, tile), not one per rule).  Each
//   thread makes the rule's values at the global (k, n) positions of its m16
//   fragment straight into the bf16x2 registers, zero past the split's k end
//   and past N as a loaded tile is zero-filled; no rule value is read or
//   staged, so a stage holds the activation tile alone.  The values 0 and 1
//   are one bf16 word, so the passes run are those of a bf16 B, and the
//   result is bitwise K2's on the rule built as a bf16 (K, N) tensor.
//
// Accumulation is K1's: each pass of a k16 step gets a fresh accumulator, the
// step's passes are summed in fp32 in schedule order and added to the running
// sum.  Ragged m/n/k edges are masked in-kernel.  Corrected policies (passes
// > 1) sanitize non-finite inputs to 0 while loading fragments and raise a
// device flag; the non-finite fix-up (nonfinite_fixup.cuh) then restores the
// fp32 reference's +-inf/NaN pattern on the card, with no host read: folded
// into k2_reduce where the call has splits, else launched after k2_kernel as
// its programmatic dependent.  Both come from the one host call.
#include "epilogue.cuh"
#include "nonfinite_fixup.cuh"
#include "rule_menu.cuh"
#include "tcec_frag.cuh"

namespace {

using epi::Epilogue;
using frag::cp_async16;
using frag::cp_async_commit;
using frag::cp_async_wait;
using frag::is_bf16;
using frag::ldsm_x4_trans;
using frag::op_words;
using frag::run_passes;

// The tiles.  WN x WM warps, each FN m16 tiles (16 output columns) by FM n8
// tiles (8 output rows), times WK warps that take turns over the k16 steps
// of each stage (their sums are added at the end); BK k rows per stage.
template <int WN_, int WM_, int FN_, int FM_, int BK_, int WK_>
struct Cfg {
  static constexpr int WN = WN_, WM = WM_, FN = FN_, FM = FM_, BK = BK_, WK = WK_;
  static constexpr int THREADS = WN * WM * WK * 32;
  static constexpr int BN = WN * FN * 16;
  static constexpr int BM = WM * FM * 8;
  static_assert(BK % (16 * WK) == 0, "whole k16 steps per warp");
};
using Decode = Cfg<2, 1, 1, 1, 64, 2>;   // 32 columns x 8 rows, 4 warps
using Prefill = Cfg<2, 2, 2, 4, 32, 1>;  // 64 x 64, 4 warps

// The B "type" of the frag= arm: a menu rule, nothing in memory.
struct RuleRhs {};
template <typename TW>
constexpr bool is_rule = std::is_same<TW, RuleRhs>::value;

// Shared memory of one pipeline stage: the weight tile [BK][LDW] at TW (none
// in the frag= arm), then the activation tile [BM][LDX] at TX.  Row pitches
// are multiples of 16 bytes (cp.async) chosen so the fragment reads hit 32
// distinct banks: LDW = BN + 8 bf16 (ldmatrix rows 16 bytes apart modulo
// 128) or BN + 4 fp32; LDX = BK + 8.  As many stages (2-4) as fit in 44 KB
// of static shared memory.
template <class C, typename TX, typename TW>
struct Smem {
  static constexpr int LDW = C::BN + (is_bf16<TW> ? 8 : 4);
  static constexpr int LDX = C::BK + 8;
  static constexpr int W_BYTES =
      is_rule<TW> ? 0 : C::BK * LDW * static_cast<int>(sizeof(TW));
  static constexpr int STAGE = W_BYTES + C::BM * LDX * static_cast<int>(sizeof(TX));
  static constexpr int FIT = 45056 / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT < 2 ? 2 : FIT;
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(W_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte aligned tiles");
};

// A pair of bf16 values with each non-finite half zeroed when GUARD; `bad`
// collects a nonzero bit for every non-finite value.  Adding 0x80 to a
// half's exponent bits carries into its bit 15 only when they are all ones
// (inf or NaN), and never into the other half; no branch.
template <bool GUARD>
__device__ __forceinline__ uint32_t guard_bf16x2(uint32_t v, uint32_t& bad) {
  if (GUARD) {
    const uint32_t t = ((v & 0x7F807F80u) + 0x00800080u) & 0x80008000u;
    bad |= t;
    v &= ~(t | (t - (t >> 15)));  // 0xFFFF over each flagged half
  }
  return v;
}

template <bool GUARD>
__device__ __forceinline__ float guard_f32(float v, uint32_t& bad) {
  if (GUARD) {
    const uint32_t t = ((__float_as_uint(v) & 0x7F800000u) + 0x00800000u) & 0x80000000u;
    bad |= t;
    v = t ? 0.f : v;
  }
  return v;
}

// The weight fragment (mma's A operand: 16 output columns x k16) of word
// count NWW, from the [k][n] tile `w` at rows kk.., columns nb..nb+15.
template <int NWW, bool GUARD>
__device__ __forceinline__ void w_frag(const __nv_bfloat16* w, int ldw, int kk, int nb,
                                       int lane, uint32_t (&f)[NWW][4], uint32_t& bad) {
  const int mat = lane >> 3;
  ldsm_x4_trans(f[0], w + (kk + (mat >> 1) * 8 + (lane & 7)) * ldw + nb + (mat & 1) * 8);
#pragma unroll
  for (int r = 0; r < 4; ++r) f[0][r] = guard_bf16x2<GUARD>(f[0][r], bad);
}
template <int NWW, bool GUARD>
__device__ __forceinline__ void w_frag(const float* w, int ldw, int kk, int nb, int lane,
                                       uint32_t (&f)[NWW][4], uint32_t& bad) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = w + (kk + 2 * t) * ldw + nb + g;
  const float v[8] = {p[0],       p[ldw],       p[8],           p[ldw + 8],
                      p[8 * ldw], p[9 * ldw], p[8 * ldw + 8], p[9 * ldw + 8]};
  float a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = guard_f32<GUARD>(v[i], bad);
  tcec::split_a_frag<NWW>(a, f);
}

// The frag= arm's weight fragment: the rule's values at global rows k0 + 2t +
// {0, 1, 8, 9} and columns n0 + g + {0, 8}, in the fp32 overload's order
// (register r holds rows 2t, 2t + 1 (+ 8 for r >= 2) of column g (+ 8 for
// odd r)), zero at k >= kend or n >= N; one bf16 word, 1.0 = 0x3F80.  A value
// depends on its diagonal d = n - k alone: a 16 x 16 tile inside the bounds
// whose diagonals n0 - k0 - 15 .. n0 - k0 + 15 lie all inside or all outside
// the band is one constant (the same for the whole warp); one that crosses
// the band's edge costs six band tests, registers 0 and 3 sharing theirs.
__device__ __forceinline__ uint32_t rule_pair(const menu::Band& b, int d, bool lo_ok,
                                              bool hi_ok) {
  return (lo_ok && b.holds(d) ? 0x3F80u : 0u) | (hi_ok && b.holds(d - 1) ? 0x3F800000u : 0u);
}
__device__ __forceinline__ void rule_frag(const menu::Band& b, int k0, int n0, int kend, int N,
                                          int lane, uint32_t (&f)[1][4]) {
  const int k = k0 + 2 * (lane & 3), n = n0 + (lane >> 2);
  const int d = n - k;
  if (k0 + 16 <= kend && n0 + 16 <= N) {
    const int d0 = n0 - k0;
    const bool all = b.lo <= d0 - 15 && d0 + 15 <= b.hi;
    if (all || d0 + 15 < b.lo || d0 - 15 > b.hi) {
      f[0][0] = f[0][1] = f[0][2] = f[0][3] = all ? 0x3F803F80u : 0u;
      return;
    }
    f[0][0] = f[0][3] = rule_pair(b, d, true, true);
    f[0][1] = rule_pair(b, d + 8, true, true);
    f[0][2] = rule_pair(b, d - 8, true, true);
  } else {
    const bool n_lo = n < N, n_hi = n + 8 < N;
    f[0][0] = rule_pair(b, d, n_lo && k < kend, n_lo && k + 1 < kend);
    f[0][1] = rule_pair(b, d + 8, n_hi && k < kend, n_hi && k + 1 < kend);
    f[0][2] = rule_pair(b, d - 8, n_lo && k + 8 < kend, n_lo && k + 9 < kend);
    f[0][3] = rule_pair(b, d, n_hi && k + 8 < kend, n_hi && k + 9 < kend);
  }
}

// The activation fragment (mma's B operand: k16 x 8 rows) of word count NWX,
// from the [m][k] tile `x` at rows mb.., columns kk...
template <int NWX, bool GUARD>
__device__ __forceinline__ void x_frag(const __nv_bfloat16* x, int ldx, int kk, int mb,
                                       int lane, uint32_t (&f)[NWX][2], uint32_t& bad) {
  const __nv_bfloat16* p = x + (mb + (lane >> 2)) * ldx + kk + 2 * (lane & 3);
  f[0][0] = guard_bf16x2<GUARD>(*reinterpret_cast<const uint32_t*>(p), bad);
  f[0][1] = guard_bf16x2<GUARD>(*reinterpret_cast<const uint32_t*>(p + 8), bad);
}
template <int NWX, bool GUARD>
__device__ __forceinline__ void x_frag(const float* x, int ldx, int kk, int mb, int lane,
                                       uint32_t (&f)[NWX][2], uint32_t& bad) {
  const float* p = x + (mb + (lane >> 2)) * ldx + kk + 2 * (lane & 3);
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 8);
  float b[4] = {guard_f32<GUARD>(lo.x, bad), guard_f32<GUARD>(lo.y, bad),
                guard_f32<GUARD>(hi.x, bad), guard_f32<GUARD>(hi.y, bad)};
  tcec::split_b_frag<NWX>(b, f);
}

struct Problem {
  int M, N, K, splits, chunk;
  long long sXb, sWb;  // batch strides (elements); sWb == 0: W shared
  int vec;             // 16-byte copies (rows and bases 16-byte aligned)
};

// One pipeline stage: k rows [k0, k0 + BK) of the block's weight columns
// (none in the frag= arm) and activation rows into `stage` (zero outside
// [.., kend) x the matrix), through 16-byte cp.async copies when P.vec, else
// element by element.
template <class C, typename TX, typename TW>
__device__ __forceinline__ void load_stage(unsigned char* stage, const TX* Xb, const TW* Wb,
                                           const Problem& P, int m0, int n0, int k0,
                                           int kend) {
  using S = Smem<C, TX, TW>;
  const int tid = threadIdx.x;
  TW* wt = reinterpret_cast<TW*>(stage);
  TX* xt = reinterpret_cast<TX*>(stage + S::W_BYTES);
  if (P.vec) {
    if constexpr (!is_rule<TW>) {
      constexpr int EW = 16 / sizeof(TW), CW = C::BN / EW;
      for (int c = tid; c < C::BK * CW; c += C::THREADS) {
        const int r = c / CW, q = c % CW;
        const int gk = k0 + r, gn = n0 + q * EW;
        const bool ok = gk < kend && gn < P.N;
        cp_async16(wt + r * S::LDW + q * EW, ok ? Wb + (long long)gk * P.N + gn : Wb, ok);
      }
    }
    constexpr int EX = 16 / sizeof(TX), CX = C::BK / EX;
    for (int c = tid; c < C::BM * CX; c += C::THREADS) {
      const int r = c / CX, q = c % CX;
      const int gm = m0 + r, gk = k0 + q * EX;
      const bool ok = gm < P.M && gk < kend;
      cp_async16(xt + r * S::LDX + q * EX, ok ? Xb + (long long)gm * P.K + gk : Xb, ok);
    }
  } else {
    if constexpr (!is_rule<TW>) {
      for (int e = tid; e < C::BK * C::BN; e += C::THREADS) {
        const int r = e / C::BN, c = e % C::BN;
        const int gk = k0 + r, gn = n0 + c;
        wt[r * S::LDW + c] = (gk < kend && gn < P.N) ? Wb[(long long)gk * P.N + gn] : TW(0.f);
      }
    }
    for (int e = tid; e < C::BM * C::BK; e += C::THREADS) {
      const int r = e / C::BK, c = e % C::BK;
      const int gm = m0 + r, gk = k0 + c;
      xt[r * S::LDX + c] = (gm < P.M && gk < kend) ? Xb[(long long)gm * P.K + gk] : TX(0.f);
    }
  }
}

// Grid: (column tiles, row tiles, batch * splits); block z = batch index *
// splits + split.  Split s sums k in [s * chunk, min(K, (s + 1) * chunk));
// with splits > 1 it writes its partial to ws, (splits, batch * M * N).  TW
// RuleRhs: B is `rule` (W unused).
template <typename TX, typename TW, int PASSES, class C>
__global__ void __launch_bounds__(C::THREADS)
k2_kernel(const TX* __restrict__ X, const TW* __restrict__ W, float* __restrict__ ws,
          int* __restrict__ nonfinite, Problem P, Epilogue ep, menu::Spec rule) {
  using S = Smem<C, TX, TW>;
  constexpr int NWX = op_words<TX, PASSES>();
  constexpr int NWW = is_rule<TW> ? 1 : op_words<TW, PASSES>();
  constexpr bool GUARD = PASSES > 1;
  constexpr int STAGES = S::STAGES;
  __shared__ __align__(128) unsigned char smem[S::BYTES];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp / (C::WN * C::WM), wtile = warp % (C::WN * C::WM);
  const int wn = (wtile % C::WN) * C::FN * 16;
  const int wm = (wtile / C::WN) * C::FM * 8;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const int split = blockIdx.z % P.splits;
  const long long bi = blockIdx.z / P.splits;
  const int M = P.M, N = P.N, K = P.K;
  const int kbeg = split * P.chunk;
  const int kend = min(K, kbeg + P.chunk);
  const int nst = kend > kbeg ? (kend - kbeg + C::BK - 1) / C::BK : 0;
  const TX* Xb = X + bi * P.sXb;
  const TW* Wb = W + bi * P.sWb;
  const menu::Band band = menu::band(rule);

  float acc[C::FN][C::FM][4];
#pragma unroll
  for (int fn = 0; fn < C::FN; ++fn)
#pragma unroll
    for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[fn][fm][e] = 0.f;
  uint32_t bad = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage<C>(smem + s * S::STAGE, Xb, Wb, P, m0, n0, kbeg + s * C::BK, kend);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // Slot (st - 1) % STAGES was last read in the previous step, which every
    // warp has finished: refill it with stage st + STAGES - 1.
    if (st + STAGES - 1 < nst)
      load_stage<C>(smem + (st + STAGES - 1) % STAGES * S::STAGE, Xb, Wb, P, m0, n0,
                    kbeg + (st + STAGES - 1) * C::BK, kend);
    cp_async_commit();
    const int slot = st % STAGES;
    const TW* wt = reinterpret_cast<const TW*>(smem + slot * S::STAGE);
    const TX* xt = reinterpret_cast<const TX*>(smem + slot * S::STAGE + S::W_BYTES);
#pragma unroll
    for (int j = 0; j < C::BK / (16 * C::WK); ++j) {
      const int kk = (j * C::WK + wk) * 16;
      uint32_t fw[C::FN][NWW][4];
#pragma unroll
      for (int fn = 0; fn < C::FN; ++fn) {
        if constexpr (is_rule<TW>)
          rule_frag(band, kbeg + st * C::BK + kk, n0 + wn + fn * 16, kend, N, lane, fw[fn]);
        else
          w_frag<NWW, GUARD>(wt, S::LDW, kk, wn + fn * 16, lane, fw[fn], bad);
      }
#pragma unroll
      for (int fm = 0; fm < C::FM; ++fm) {
        uint32_t fx[NWX][2];
        x_frag<NWX, GUARD>(xt, S::LDX, kk, wm + fm * 8, lane, fx, bad);
#pragma unroll
        for (int fn = 0; fn < C::FN; ++fn)
          run_passes<PASSES, NWX, NWW>(acc[fn][fm], fw[fn], fx);
      }
    }
  }
  cp_async_wait<0>();
  // The reduce kernel of a split call may be scheduled now; it waits for
  // this grid's completion before it reads the partials.
  asm volatile("griddepcontrol.launch_dependents;");
  if (GUARD && bad && nonfinite != nullptr) atomicExch(nonfinite, 1);
  if (C::WK > 1) {
    // The k-turn warps' sums, added in turn order into turn 0's registers
    // through the (now idle) ring.
    constexpr int NA = C::FN * C::FM * 4, LANES = C::WN * C::WM * 32;
    static_assert((C::WK - 1) * LANES * NA * 4 <= S::BYTES, "k-turn sums fit the ring");
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (wk > 0) {
#pragma unroll
      for (int i = 0; i < NA; ++i)
        red[((wk - 1) * NA + i) * LANES + wtile * 32 + lane] = (&acc[0][0][0])[i];
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int w = 1; w < C::WK; ++w)
#pragma unroll
      for (int i = 0; i < NA; ++i)
        (&acc[0][0][0])[i] += red[((w - 1) * NA + i) * LANES + wtile * 32 + lane];
  }

  // Accumulator element e of tile (fn, fm) sits at column g (+8 for e >= 2)
  // and row 2t (+1 for odd e) of that tile.
  const long long total = (long long)(gridDim.z / P.splits) * M * N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int fn = 0; fn < C::FN; ++fn)
#pragma unroll
    for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + wn + fn * 16 + g + (e >= 2 ? 8 : 0);
        const int m = m0 + wm + fm * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        const long long o = (bi * M + m) * N + n;
        if (P.splits > 1)
          ws[split * total + o] = acc[fn][fm][e];
        else
          ep.store(o, n, acc[fn][fm][e]);
      }
}

// The split partials of every output element added in split order, then the
// epilogue.  ws: (splits, total) fp32.  Launched as a programmatic dependent
// of k2_kernel, so its blocks are resident before k2_kernel ends; it waits
// for k2_kernel's completion and memory here.  A guarded call (nonfinite not
// null) folds in the non-finite fix-up: when k2_kernel raised the flag, an
// element whose fp32 reference dot is not finite stores that dot instead.
__global__ void __launch_bounds__(256)
k2_reduce(const float* __restrict__ ws, long long total, int N, int splits, Epilogue ep,
          const int* __restrict__ nonfinite, fixup::Operands F) {
  frag::wait_primary();
  const long long o = blockIdx.x * 256LL + threadIdx.x;
  if (o >= total) return;
  float y = ws[o];
  for (int s = 1; s < splits; ++s) y += ws[s * total + o];
  const int n = static_cast<int>(o % N);
  if (nonfinite != nullptr && *nonfinite != 0) {
    const long long mn = static_cast<long long>(F.M) * N;
    const float ref = fixup::ref_dot(F, o / mn, static_cast<int>(o % mn / N), n);
    if (!isfinite(ref)) y = ref;
  }
  ep.store(o, n, y);
}

// K2's kernel, then with splits its reduce, else (a guarded call) the
// fix-up; the second kernel is a programmatic dependent of the first.
template <typename TX, typename TW, class C>
cudaError_t launch(const void* A, const void* B, float* ws, int* nonfinite, int batch,
                   const Problem& P, const Epilogue& ep, const menu::Spec& rule,
                   cudaStream_t stream) {
  dim3 grid((P.N + C::BN - 1) / C::BN, (P.M + C::BM - 1) / C::BM, batch * P.splits);
  k2_kernel<TX, TW, REPRO_PASSES, C><<<grid, C::THREADS, 0, stream>>>(
      static_cast<const TX*>(A), static_cast<const TW*>(B), ws, nonfinite, P, ep, rule);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const fixup::Operands F{A,   is_rule<TW> ? nullptr : B, is_bf16<TX>, is_bf16<TW>, P.M, P.N,
                          P.K, P.sXb, P.K, 1, P.sWb, P.N, 1, rule};
  if (P.splits == 1) {
    if (nonfinite == nullptr) return err;
    return fixup::launch(nonfinite, F, batch, static_cast<long long>(P.M) * P.N, P.N, 1, ep,
                         true, stream);
  }
  const long long total = (long long)batch * P.M * P.N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((total + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k2_reduce, static_cast<const float*>(ws), total, P.N,
                           P.splits, ep, static_cast<const int*>(nonfinite), F);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_tile(int tile, const void* A, const void* B, float* ws, int* nonfinite,
                        int batch, const Problem& P, const Epilogue& ep,
                        const menu::Spec& rule, cudaStream_t s) {
  if (tile == 0) return launch<TX, TW, Decode>(A, B, ws, nonfinite, batch, P, ep, rule, s);
  return launch<TX, TW, Prefill>(A, B, ws, nonfinite, batch, P, ep, rule, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename TX, typename TW, class C>
cudaError_t attrs(int* smem_bytes, int* threads, int* regs, int* blocks_per_sm) {
  const auto kernel = k2_kernel<TX, TW, REPRO_PASSES, C>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(a.sharedSizeBytes);
  *threads = C::THREADS;
  *regs = a.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, C::THREADS, 0);
}

template <typename TX, typename TW>
cudaError_t attrs_tile(int tile, int* smem_bytes, int* threads, int* regs, int* blocks_per_sm) {
  if (tile == 0) return attrs<TX, TW, Decode>(smem_bytes, threads, regs, blocks_per_sm);
  return attrs<TX, TW, Prefill>(smem_bytes, threads, regs, blocks_per_sm);
}

}  // namespace

extern "C" {

// K2.  A: (batch, M, K) row major at fp32 or bf16 (a_bf16); B: (K, N) shared
// by every batch (sBb == 0) or (batch, K, N); C: (batch, M, N) contiguous,
// fp32 or bf16; bias (N,) and residual (batch, M, N) optional (null), either
// dtype.  The plan (kernels/tcec_matmul.py::k2_plan): tile 0 (decode) or 1
// (prefill), `splits` k ranges of `chunk` elements (a multiple of 16) each;
// with splits > 1, ws holds splits * batch * M * N floats and a second kernel
// reduces it.  nonfinite (a zeroed device int, or null for an unguarded
// policy) is raised by the kernel on a non-finite input; the reduce kernel,
// or with one split a fix-up kernel, then restores the fp32 reference's
// +-inf/NaN pattern.  rule >= 0 (a menu::RuleId, arguments r0 and r1): the frag=
// arm, B made from that rule (B null, sBb 0, b_bf16 ignored).  Enqueues
// everything on `stream`; returns cudaGetLastError() after the launches (0 on
// success).
int repro_tcec_matmul(const void* A, const void* B, void* C, const void* bias,
                      const void* res, int* nonfinite, int M, int N, int K, int batch,
                      long long sAb, long long sBb, int a_bf16, int b_bf16, int passes,
                      float scale, int act, int bias_bf16, int res_bf16, int out_bf16,
                      int tile, int splits, int chunk, float* ws, int rule, int r0, int r1,
                      void* stream) {
  const bool frag = rule != menu::NONE;
  if (passes != REPRO_PASSES || (tile != 0 && tile != 1) || splits < 1 || chunk < 16 ||
      chunk % 16 != 0 || (long long)chunk * splits < K ||
      (long long)chunk * (splits - 1) >= (K > 0 ? K : 1) || (splits > 1 && ws == nullptr) ||
      (long long)batch * splits > 65535 || rule < menu::NONE || rule > menu::BANDED ||
      (frag ? (B != nullptr || sBb != 0) : B == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int xb = a_bf16 ? 2 : 4, wb = b_bf16 ? 2 : 4;
  Problem P{M, N, K, splits, chunk, sAb, sBb,
            aligned16(A) && (long long)K * xb % 16 == 0 && sAb * xb % 16 == 0 &&
                (frag || (aligned16(B) && (long long)N * wb % 16 == 0 && sBb * wb % 16 == 0))};
  Epilogue ep{C, bias, res, scale, act, bias_bf16, res_bf16, out_bf16};
  const menu::Spec spec{rule, r0, r1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (frag && a_bf16)
    err = launch_tile<bf, RuleRhs>(tile, A, B, ws, nonfinite, batch, P, ep, spec, s);
  else if (frag)
    err = launch_tile<float, RuleRhs>(tile, A, B, ws, nonfinite, batch, P, ep, spec, s);
  else if (a_bf16 && b_bf16)
    err = launch_tile<bf, bf>(tile, A, B, ws, nonfinite, batch, P, ep, spec, s);
  else if (a_bf16)
    err = launch_tile<bf, float>(tile, A, B, ws, nonfinite, batch, P, ep, spec, s);
  else if (b_bf16)
    err = launch_tile<float, bf>(tile, A, B, ws, nonfinite, batch, P, ep, spec, s);
  else
    err = launch_tile<float, float>(tile, A, B, ws, nonfinite, batch, P, ep, spec, s);
  return static_cast<int>(err);
}

// Shared memory per block (all static), threads, registers per thread and
// resident blocks per SM of K2's kernel at tile (bm, bn), (8, 32) decode or
// (64, 64) prefill, as the other attrs entries take a tile: `which` is
// 2 * b_kind + a_bf16, for an fp32 or bf16 A and B of kind b_kind: 0 fp32,
// 1 bf16, 2 the frag= arm's menu rule.
int repro_tcec_matmul_attrs(int which, int bm, int bn, int* smem_bytes, int* threads,
                            int* regs, int* blocks_per_sm) {
  const int tile = bm == Decode::BM && bn == Decode::BN     ? 0
                   : bm == Prefill::BM && bn == Prefill::BN ? 1
                                                            : -1;
  if (tile < 0 || which < 0 || which > 5) return static_cast<int>(cudaErrorInvalidValue);
  const bool a_bf16 = which & 1;
  const int b_kind = which >> 1;
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (b_kind == 2)
    err = a_bf16 ? attrs_tile<bf, RuleRhs>(tile, smem_bytes, threads, regs, blocks_per_sm)
                 : attrs_tile<float, RuleRhs>(tile, smem_bytes, threads, regs, blocks_per_sm);
  else if (b_kind == 1)
    err = a_bf16 ? attrs_tile<bf, bf>(tile, smem_bytes, threads, regs, blocks_per_sm)
                 : attrs_tile<float, bf>(tile, smem_bytes, threads, regs, blocks_per_sm);
  else
    err = a_bf16 ? attrs_tile<bf, float>(tile, smem_bytes, threads, regs, blocks_per_sm)
                 : attrs_tile<float, float>(tile, smem_bytes, threads, regs, blocks_per_sm);
  return static_cast<int>(err);
}

// How many passes of this library's schedule K2 runs for the operand dtypes
// (a bf16 operand has one nonzero word).
int repro_tcec_matmul_passes_run(int a_bf16, int b_bf16) {
  const int nw = tcec::n_words(REPRO_PASSES);
  return frag::passes_run(REPRO_PASSES, a_bf16 ? 1 : nw, b_bf16 ? 1 : nw);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
