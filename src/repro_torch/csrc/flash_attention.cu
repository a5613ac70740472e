// K3 — flash attention forward (prefill) with TCEC-policy QK^T and PV.
//
// Replaces: repro/kernels/flash_attention.py::_flash_kernel (the pallas_call
// in _flash_attention), head dims d <= 256 and dv <= 256 (d != dv allowed).
// The backward (a recompute through the dense twin in the reference) comes
// with the training slice.
//
// What bounds it on an H100: the score work is 2 pairs (d + dv) products
// per head, times the passes each contraction runs, on the tensor cores; the
// inputs are small next to that, so by the roofline it is bound by
// operations.  In practice a call is bound by the serial chain of its longest
// block (the causal range of the last q tile) and by the ALU work of making
// the bf16 words of K, V and P (each fp32 value split into three words under
// bf16x6), not by the tensor cores.
//
// The design (kernels/flash_attention.py::k3_plan chooses its numbers):
//
// * Row groups of four warps over 16 query rows; a block holds one or two
//   groups (a q tile of 16 or 32 rows) of one (b, h).  The kv loop runs over
//   64-wide kv tiles (BLOCK_KV, the reference's block_k in the parity tests).
//   For S = Q K^T each warp of a group takes 16 of a tile's columns, so it
//   splits only its 16 rows of K into words (each value once per group, not
//   once per warp); the quarters' row maxima meet in shared memory, so the
//   running max moves one whole kv tile at a time, as the reference's does.
//   P goes through shared memory as fp32 (a 16 x 64 tile per group), and for
//   P V each warp takes a quarter of dv's columns over all 64 kv rows: it
//   splits only its columns of V, holds a quarter of the output
//   accumulators, and writes its own columns at the end (no combine).  GQA
//   reads kv head h / rep, no copies.
// * Splits.  Where the (b, h, q tile) grid gives fewer than two blocks per
//   SM, each q tile's causal kv range is split, in whole kv tiles (`per`
//   each), across blocks.  A split that started its running max afresh would
//   round P at other places than the reference, so a max pass (this kernel
//   with max_only set, QK^T alone) writes each split's row max first, and
//   split s starts from the max of the splits before it: every P is the
//   reference's.  A merge kernel combines the (m, l, acc) partials in split
//   order, no float atomics.  The three kernels come from one host call; the
//   second and third are programmatic dependents of the one before (a split
//   loads its Q, K and V before it waits for the maxima).  With one split the
//   kernel writes the output itself and runs alone.
// * Launch order: blockIdx.y counts q tiles from the last, so the longest
//   causal chains start first.
// * Loads: Q once per block; K and V tiles through a ring of 16-byte
//   cp.async.cg copies (4 slots up to d 64, else 2; zero-filled past the
//   sequence and past d, dv), so the next tiles are in flight while one is
//   computed; element loads where a row is not 16-byte aligned.
// * Words: a warp splits its Q rows into A-fragment words once, before the
//   kv loop, and keeps them in registers (QREGS: d <= 128, and d 256 where q
//   is one word); otherwise it splits them again per kv tile, by k16 slice.
//   K, V and P are split in registers by the warp that uses them; no word
//   is staged in shared memory.  Two values are rounded per
//   cvt.rn.bf16x2.f32, bitwise K1's words (only word 0 can overflow, so
//   only it saturates).
// * Shared-memory reads: fp32 Q, K and P rows as 8-byte (2t, 2t+1) pairs at
//   a pitch of 8 (mod 32) words, fp32 V down a column at a pitch of 4 (mod
//   32): free of bank conflicts; bf16 tiles by ldmatrix (V transposed) at a
//   pitch of 16 bytes (mod 128).
// * Passes: only those whose words can be nonzero (k3_passes: a bf16 q, k or
//   v is its own word 0), each k16 step's passes summed in fp32 in schedule
//   order outside the tensor core (K1's rule); the serving path's q, k, v
//   are fp32 (the projections emit fp32 under a corrected policy), so it
//   runs all the passes.
// * Instruction: mma.sync m16n8k16 (bf16 in, fp32 out) with both operands in
//   registers; nothing is staged but the source tiles (fp32 or bf16) and
//   the fp32 P tile.
// * Registers: PV runs straight into the output registers after they are
//   scaled by alpha (no second set), and a warp holds only its quarter of
//   them, so no bucket spills and d <= 64 fits two blocks of 8 warps per SM.
//
// NEG_INF = -1e30 and the m_new > 0.5 NEG_INF rule are the reference's; rows
// with no valid column emit exact zeros.  Output fp32 through strides.
// Head dims: one build per bucket DMAX in {32, 64, 128, 256} of max(d, dv);
// d and dv are runtime arguments.
#include "tcec_frag.cuh"

namespace {

using frag::cp_async16;
using frag::cp_async_commit;
using frag::cp_async_wait;
using frag::is_bf16;
using frag::op_words;
using frag::run_passes_ab;

constexpr int BKV = 64;       // kv tile (columns of a score tile)
constexpr int QUARTERS = 4;   // warps of a row group, one per 16 columns of a kv tile
constexpr int MAX_RG = 2;     // row groups of a block at most (16 rows each)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Shapes, strides and the plan of one call.
struct Geometry {
  int H, rep, SQ, SKV, d, dv, kv_len, causal;
  float scale;
  int bq;             // q rows per block (16 per row group)
  int splits, per;    // kv splits per q tile, kv tiles per split
  int vec_q, vec_k, vec_v;  // 16-byte copies possible
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
};

// The workspace of a call with splits, fp32; a row id is bh * SQ + row.
struct Work {
  float* smax;  // (rows, splits - 1) each split's row max (the max pass)
  float* pm;    // (rows, splits) each split's running max at its end
  float* pl;    // (rows, splits) its softmax denominator
  float* pacc;  // (rows, splits, dv) its P V
};

template <typename T, int DMAX, int PASSES>
struct Cfg {
  static constexpr bool BF = is_bf16<T>;
  static constexpr int NW = op_words<T, PASSES>();   // words of q, k and v
  static constexpr int NWP = tcec::n_words(PASSES);  // words of P (fp32)
  // Ring slots of K or V tiles (64 rows each): 4 up to DMAX 64, else 2.
  static constexpr int NSLOT = DMAX <= 64 ? 4 : 2;
  // Row pitches in elements (see the header).
  static constexpr int LDQ = DMAX + 8;
  static constexpr int LDK = DMAX + 8;
  static constexpr int LDV = BF ? DMAX + 8 : DMAX + 4;
  static constexpr int SLOT = BKV * (LDK > LDV ? LDK : LDV);
  static constexpr int Q_BYTES = static_cast<int>(sizeof(T)) * MAX_RG * 16 * LDQ;
  static constexpr int SMEM = Q_BYTES + static_cast<int>(sizeof(T)) * NSLOT * SLOT;
  // Output n8 tiles a warp owns at most: its quarter of dv.
  static constexpr int NTW = DMAX / 32;
  // Q's words stay in registers where they fit beside the accumulators.
  static constexpr bool QREGS = (DMAX / 16) * NW * 4 + DMAX / 8 <= 112;
  // Two blocks of 8 warps per SM where the registers allow it.
  static constexpr int MIN_BLOCKS = DMAX <= 64 ? 2 : 1;
  static_assert(SMEM <= 227 * 1024, "shared memory of a block");
  static_assert((LDK * sizeof(T)) % 16 == 0 && (LDV * sizeof(T)) % 16 == 0, "16-byte rows");
};

// rows [row0, row0 + nrows) of a (rows, width) source with row stride
// `stride` into dst (pitch ld), zero past row_end and past width up to the
// next multiple of 16 columns.  16-byte cp.async copies when `vec`, element
// loads otherwise.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, long long stride,
                                          int row0, int nrows, int row_end, int width, int ld,
                                          int vec) {
  const int wpad = (width + 15) & ~15;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int segs = wpad / E;
    for (int i = tid; i < nrows * segs; i += nthreads) {
      const int r = i / segs, c = (i - r * segs) * E;
      const bool ok = row0 + r < row_end && c < width;
      cp_async16(dst + r * ld + c, ok ? src + (long long)(row0 + r) * stride + c : src, ok);
    }
  } else {
    for (int i = tid; i < nrows * wpad; i += nthreads) {
      const int r = i / wpad, c = i - r * wpad;
      dst[r * ld + c] =
          row0 + r < row_end && c < width ? src[(long long)(row0 + r) * stride + c] : T(0.f);
    }
  }
}

// Two fp32 values rounded to bf16 (RNE) in one instruction: lo in the low
// half, as K1's pack2 packs them.
__device__ __forceinline__ uint32_t cvt2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// A finite value clamped to +-BF16_MAX (inf and NaN kept): its bf16 rounding
// is K1's saturating bf16_word.
__device__ __forceinline__ float saturate(float x) {
  const float m = tcec::bf16_max();
  return fabsf(x) <= 3.40282347e38f ? fminf(fmaxf(x, -m), m) : x;
}

// The NW word fragments of the pair (x0, x1): bitwise K1's split_pair, two
// values per conversion.  Only word 0 of a multi-word split can overflow
// (the residuals are at most half a bf16 ulp of the value), so only it is
// saturated; SAT false for values known to be finite and below BF16_MAX
// (P is in [0, 1]).
template <int NW, bool SAT>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&f)[NW]) {
  const bool sat = SAT && NW > 1;  // one word is K1's plain cast
  uint32_t w = cvt2(sat ? saturate(x0) : x0, sat ? saturate(x1) : x1);
  f[0] = w;
  if (NW == 1) return;
  float r0 = x0 - __uint_as_float(w << 16), r1 = x1 - __uint_as_float(w & 0xFFFF0000u);
  w = cvt2(r0, r1);
  f[NW > 1 ? 1 : 0] = w;
  if (NW == 2) return;
  r0 -= __uint_as_float(w << 16);
  r1 -= __uint_as_float(w & 0xFFFF0000u);
  f[NW - 1] = cvt2(r0, r1);
}

// K1's split_a_frag / split_b_frag through split2.
template <int NW, bool SAT>
__device__ __forceinline__ void split_a(const float (&a)[8], uint32_t (&f)[NW][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t w[NW];
    split2<NW, SAT>(a[2 * r], a[2 * r + 1], w);
#pragma unroll
    for (int i = 0; i < NW; ++i) f[i][r] = w[i];
  }
}
template <int NW>
__device__ __forceinline__ void split_b(const float (&b)[4], uint32_t (&f)[NW][2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t w[NW];
    split2<NW, true>(b[2 * r], b[2 * r + 1], w);
#pragma unroll
    for (int i = 0; i < NW; ++i) f[i][r] = w[i];
  }
}

// A fragment (16 rows x k16 at column kk) of a [row][col] tile, split.
template <int NW>
__device__ __forceinline__ void a_frag(const float* q, int ld, int kk, uint32_t (&f)[NW][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = q + g * ld + kk + 2 * t;
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  const float a[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
  split_a<NW, true>(a, f);
}
template <int NW>
__device__ __forceinline__ void a_frag(const __nv_bfloat16* q, int ld, int kk,
                                       uint32_t (&f)[NW][4]) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  frag::ldsm_x4(f[0], q + ((m & 1) * 8 + (lane & 7)) * ld + kk + (m >> 1) * 8);
}

// bf16 B fragments of K^T for the n8 tiles of kv rows [n0, n0 + 8) and
// [n0 + 8, n0 + 16), k16 at column kk, from a [kv][d] tile (ldmatrix).
template <int NW>
__device__ __forceinline__ void k_frags(const __nv_bfloat16* k, int ld, int n0, int kk,
                                        uint32_t (&f0)[NW][2], uint32_t (&f1)[NW][2]) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  uint32_t r[4];
  frag::ldsm_x4(r, k + (n0 + (m >> 1) * 8 + (lane & 7)) * ld + kk + (m & 1) * 8);
  f0[0][0] = r[0];
  f0[0][1] = r[1];
  f1[0][0] = r[2];
  f1[0][1] = r[3];
}

// The fp32 values of K^T's B fragment for the n8 tile of kv rows [n0, n0 +
// 8), k16 at column kk: one tile at a time, so fewer words are live at once.
__device__ __forceinline__ void k_frag_in(const float* k, int ld, int n0, int kk, float (&b)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = k + (n0 + g) * ld + kk + 2 * t;
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8);
  b[0] = x0.x;
  b[1] = x0.y;
  b[2] = x1.x;
  b[3] = x1.y;
}

// The fp32 values of V's B fragment for the n8 tile of dv columns [n0, n0 +
// 8), k16 at kv row kr, from a [kv][dv] tile.
__device__ __forceinline__ void v_frag_in(const float* v, int ld, int kr, int n0, float (&b)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = v + (kr + 2 * t) * ld + n0 + g;
  b[0] = p[0];
  b[1] = p[ld];
  b[2] = p[8 * ld];
  b[3] = p[9 * ld];
}
// bf16 B fragment of V for the n8 tile of dv columns [n0, n0 + 8), k16 at
// kv row kr (ldmatrix .x2, transposed: lanes 0-15 address the 16 rows).
template <int NW>
__device__ __forceinline__ void v_frag(const __nv_bfloat16* v, int ld, int kr, int n0,
                                       uint32_t (&f)[NW][2]) {
  const int lane = threadIdx.x & 31;
  const unsigned a = static_cast<unsigned>(
      __cvta_generic_to_shared(v + (kr + (lane & 15)) * ld + n0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(f[0][0]), "=r"(f[0][1])
               : "r"(a)
               : "memory");
}
template <int NW>
__device__ __forceinline__ void v_frag(const float* v, int ld, int kr, int n0,
                                       uint32_t (&f)[NW][2]) {
  float b[4];
  v_frag_in(v, ld, kr, n0, b);
  split_b<NW>(b, f);
}

// The kv range [0, kv_end) of q tile qt and its tile count.
__device__ __forceinline__ int tiles_of(int qt, const Geometry& G) {
  int kv_end = min(G.kv_len, G.SKV);
  if (G.causal) kv_end = min(kv_end, min((qt + 1) * G.bq, G.SQ));
  return kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
}

// One block: q tile qt = gridDim.y - 1 - blockIdx.y of (b, h) = blockIdx.z,
// split blockIdx.x; row group rg = warp / 4 owns 16 q rows, and its warp
// quarter qw = warp % 4 the kv columns [16 qw, 16 qw + 16) of every kv tile.
// max_only: the max pass (QK^T alone, writes the split's row max);
// otherwise the split's (m, l, acc) partial, or with one split the output.
template <typename T, int DMAX, int PASSES>
__global__ void __launch_bounds__(MAX_RG * QUARTERS * 32, (Cfg<T, DMAX, PASSES>::MIN_BLOCKS))
k3_fwd(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
       float* __restrict__ O, Geometry G, Work W, int max_only) {
  using C = Cfg<T, DMAX, PASSES>;
  constexpr int NW = C::NW, NWP = C::NWP, NSLOT = C::NSLOT;
  constexpr int NKS = DMAX / 16;  // k16 steps of q k^T
  constexpr int NTW = C::NTW;     // output n8 tiles of a warp at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[MAX_RG][QUARTERS][16];  // row maxima of a tile's quarters
  // A row group's P tile (16 x 64, fp32), rows at a pitch of 8 (mod 32).
  __shared__ __align__(16) float pbuf[MAX_RG][16][BKV + 8];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw + C::Q_BYTES);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp / QUARTERS, qw = warp % QUARTERS;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, bh = blockIdx.z;
  const int b = bh / G.H, h = bh % G.H, kvh = h / G.rep;
  const int q0 = qt * G.bq;
  const int nt = tiles_of(qt, G);
  const int t0 = split * G.per, t1 = min(nt, t0 + G.per);
  const int row0 = q0 + rg * 16 + g;  // this thread's rows: row0, row0 + 8
  const long long rid0 = (long long)bh * G.SQ;

  if (max_only && split >= (nt + G.per - 1) / G.per - 1) return;  // no later split reads it
  if (t0 >= t1) {  // wholly past this q tile's range
    if (G.splits == 1) {
      for (int i = threadIdx.x; i < G.bq * G.dv; i += blockDim.x) {
        const int r = q0 + i / G.dv, c = i % G.dv;
        if (r < G.SQ) O[b * G.osb + h * G.osh + r * G.oss + c] = 0.f;
      }
    } else {
      for (int r = threadIdx.x; r < G.bq; r += blockDim.x)
        if (q0 + r < G.SQ) {
          W.pm[(rid0 + q0 + r) * G.splits + split] = NEG_INF;
          W.pl[(rid0 + q0 + r) * G.splits + split] = 0.f;
        }
    }
    return;
  }

  const T* Qb = Q + b * G.qsb + h * G.qsh;
  const T* Kb = K + b * G.ksb + kvh * G.ksh;
  const T* Vb = V + b * G.vsb + kvh * G.vsh;
  const int ppt = max_only ? 1 : 2;  // K (and V) tiles per kv tile
  const int npieces = (t1 - t0) * ppt;
  auto slot = [&](int p) { return ring + (p % NSLOT) * C::SLOT; };
  auto load = [&](int p) {
    const int row = (t0 + p / ppt) * BKV;
    if (p % ppt == 0)
      load_rows(slot(p), Kb, G.kss, row, BKV, G.SKV, G.d, C::LDK, G.vec_k);
    else
      load_rows(slot(p), Vb, G.vss, row, BKV, G.SKV, G.dv, C::LDV, G.vec_v);
  };
  // Wait for tile p (and Q), free the slot of tile p - 1, and start the load
  // of tile p + NSLOT - 1 into it.
  auto acquire = [&](int p) {
    cp_async_wait<NSLOT - 2>();
    __syncthreads();
    if (p + NSLOT - 1 < npieces) load(p + NSLOT - 1);
    cp_async_commit();
  };

  load_rows(qs, Qb, G.qss, q0, G.bq, G.SQ, G.d, C::LDQ, G.vec_q);
  for (int p = 0; p < NSLOT - 1; ++p) {
    if (p < npieces) load(p);
    cp_async_commit();
  }
  frag::launch_dependents();

  // The running max: the max pass starts afresh over its split; split s
  // starts from the max of the splits before it (the reference's m there).
  float m_i[2] = {NEG_INF, NEG_INF};
  if (!max_only && split > 0) {
    frag::wait_primary();
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < G.SQ)
        for (int s = 0; s < split; ++s)
          m_i[i] = fmaxf(m_i[i], W.smax[(rid0 + row) * (G.splits - 1) + s]);
    }
  }
  float l_i[2] = {0.f, 0.f};
  // This warp's output columns: n8 tiles [j0, j0 + nw) of dv.
  const int nw = ((G.dv + 7) / 8 + QUARTERS - 1) / QUARTERS, j0 = qw * nw;
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const T* qw_rows = qs + rg * 16 * C::LDQ;  // this row group's 16 rows of Q
  uint32_t qf[C::QREGS ? NKS : 1][NW][4];
  cp_async_wait<NSLOT - 2>();  // Q (and tile 0)
  __syncthreads();
  if constexpr (C::QREGS) {
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)
      if (kk * 16 < G.d) a_frag<NW>(qw_rows, C::LDQ, kk * 16, qf[kk]);
  }

  int p = 0;
  for (int tile = t0; tile < t1; ++tile) {
    const int kv0 = tile * BKV + qw * 16;  // this warp's first column
    // S = Q K^T at the policy's precision, this warp's 16 columns.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    acquire(p);
    {
      const T* ks = slot(p++);
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        if (kk * 16 >= G.d) break;
        uint32_t fq[NW][4];
        if constexpr (C::QREGS) {
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int r = 0; r < 4; ++r) fq[w][r] = qf[kk][w][r];
        } else {
          a_frag<NW>(qw_rows, C::LDQ, kk * 16, fq);
        }
        if constexpr (C::BF) {
          uint32_t f0[NW][2], f1[NW][2];
          k_frags<NW>(ks, C::LDK, qw * 16, kk * 16, f0, f1);
          run_passes_ab<PASSES, NW, NW>(s[0], fq, f0);
          run_passes_ab<PASSES, NW, NW>(s[1], fq, f1);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float bv[4];
            uint32_t f[NW][2];
            k_frag_in(ks, C::LDK, qw * 16 + 8 * j, kk * 16, bv);
            split_b<NW>(bv, f);
            run_passes_ab<PASSES, NW, NW>(s[j], fq, f);
          }
        }
      }
    }

    // Scale, structural-rule mask, the row max of this warp's columns.
    float m_cur[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >= 2 ? 8 : 0);
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        bool valid = col < G.kv_len;
        if (G.causal) valid = valid && row >= col;
        const float x = valid ? s[j][e] * G.scale : NEG_INF;
        s[j][e] = x;
        m_cur[e >> 1] = fmaxf(m_cur[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(FULL, m_cur[i], 1));
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(FULL, m_cur[i], 2));
    }
    if (max_only) {
      m_i[0] = fmaxf(m_i[0], m_cur[0]);
      m_i[1] = fmaxf(m_i[1], m_cur[1]);
      continue;
    }
    if (t == 0) {
      red[rg][qw][g] = m_cur[0];
      red[rg][qw][g + 8] = m_cur[1];
    }
    acquire(p);  // V's tile, and its barrier publishes the quarters' maxima
    const T* vs = slot(p++);
    // The tile's row max over its four quarters: the reference's m moves
    // one whole kv tile at a time.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = red[rg][0][g + 8 * i];
#pragma unroll
      for (int w = 1; w < QUARTERS; ++w) mt = fmaxf(mt, red[rg][w][g + 8 * i]);
      m_cur[i] = mt;
    }

    // Online softmax: this warp's 16 columns of P, into the row group's P
    // tile.
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_i[i], m_cur[i]);
      alpha[i] = expf(m_i[i] - m_new);
      m_i[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        // Rows with no valid column so far must not attend (exp(0) == 1).
        pr[e] = m_i[i] > 0.5f * NEG_INF ? expf(s[j][e] - m_i[i]) : 0.f;
      }
      float* pw = &pbuf[rg][g][qw * 16 + j * 8 + 2 * t];
      *reinterpret_cast<float2*>(pw) = make_float2(pr[0], pr[1]);
      *reinterpret_cast<float2*>(pw + 8 * (BKV + 8)) = make_float2(pr[2], pr[3]);
    }
    __syncthreads();  // the whole P tile

    // acc = acc alpha + P V at the same policy, over the tile's 64 kv rows
    // and this warp's columns: P is split like any fp32 operand (it is in
    // [0, 1]: no saturation); l gathers the row sums on the way.
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      const float* pr = &pbuf[rg][g][ks * 16 + 2 * t];
      const float2 x0 = *reinterpret_cast<const float2*>(pr);
      const float2 x1 = *reinterpret_cast<const float2*>(pr + 8 * (BKV + 8));
      const float2 x2 = *reinterpret_cast<const float2*>(pr + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(pr + 8 * (BKV + 8) + 8);
      rowsum[0] += (x0.x + x0.y) + (x2.x + x2.y);
      rowsum[1] += (x1.x + x1.y) + (x3.x + x3.y);
      const float a[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
      uint32_t fp[NWP][4];
      split_a<NWP, false>(a, fp);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if (j >= nw || (j0 + j) * 8 >= G.dv) break;
        uint32_t f[NW][2];
        v_frag<NW>(vs, C::LDV, ks * 16, (j0 + j) * 8, f);
        run_passes_ab<PASSES, NWP, NW>(acc[j], fp, f);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rowsum[i] += __shfl_xor_sync(FULL, rowsum[i], 1);
      rowsum[i] += __shfl_xor_sync(FULL, rowsum[i], 2);
      l_i[i] = l_i[i] * alpha[i] + rowsum[i];
    }
  }
  cp_async_wait<0>();

  if (max_only) {
    __syncthreads();
    if (t == 0) {
      red[rg][qw][g] = m_i[0];
      red[rg][qw][g + 8] = m_i[1];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < G.bq; r += blockDim.x) {
      float m = red[r / 16][0][r % 16];
      for (int w = 1; w < QUARTERS; ++w) m = fmaxf(m, red[r / 16][w][r % 16]);
      if (q0 + r < G.SQ) W.smax[(rid0 + q0 + r) * (G.splits - 1) + split] = m;
    }
    return;
  }
  // Every quarter holds the rows' m and l; each writes its own columns.
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (j >= nw || (j0 + j) * 8 >= G.dv) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, row = row0 + 8 * i, c = (j0 + j) * 8 + 2 * t + (e & 1);
      if (row >= G.SQ || c >= G.dv) continue;
      if (G.splits == 1)  // fully masked rows (l == 0) emit exact zeros
        O[b * G.osb + h * G.osh + row * G.oss + c] = l_i[i] > 0.f ? acc[j][e] / l_i[i] : 0.f;
      else
        W.pacc[((rid0 + row) * G.splits + split) * G.dv + c] = acc[j][e];
    }
  }
  if (G.splits > 1 && qw == 0 && t == 0)
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < G.SQ) {
        W.pm[(rid0 + row0 + 8 * i) * G.splits + split] = m_i[i];
        W.pl[(rid0 + row0 + 8 * i) * G.splits + split] = l_i[i];
      }
}

// The partials of every output element (row id, column of dv) combined in
// split order, then acc / l; one thread each.
__global__ void __launch_bounds__(256)
k3_merge(float* __restrict__ O, long long total, Geometry G, Work W) {
  frag::wait_primary();
  const long long o = blockIdx.x * 256LL + threadIdx.x;
  if (o >= total) return;
  const long long rid = o / G.dv;
  const int col = static_cast<int>(o % G.dv);
  const int bh = static_cast<int>(rid / G.SQ), row = static_cast<int>(rid % G.SQ);
  const float* pm = W.pm + rid * G.splits;
  const float* pl = W.pl + rid * G.splits;
  const float* pa = W.pacc + rid * G.splits * G.dv + col;
  float M = NEG_INF;
  for (int s = 0; s < G.splits; ++s) M = fmaxf(M, pm[s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < G.splits; ++s) {
    const float ms = pm[s];
    if (ms > 0.5f * NEG_INF) {
      const float w = expf(ms - M);
      l += pl[s] * w;
      acc += pa[(long long)s * G.dv] * w;
    }
  }
  O[(bh / G.H) * G.osb + (bh % G.H) * G.osh + row * G.oss + col] = l > 0.f ? acc / l : 0.f;
}

cudaLaunchConfig_t dependent(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int DMAX>
cudaError_t launch(const void* Qv, const void* Kv, const void* Vv, float* O, int B,
                   const Geometry& G, const Work& W, cudaStream_t s) {
  using C = Cfg<T, DMAX, REPRO_PASSES>;
  auto kern = k3_fwd<T, DMAX, REPRO_PASSES>;
  // Above 48 KB of dynamic shared memory a kernel must opt in; once per
  // instantiation.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (opt_in != cudaSuccess) return opt_in;
  const T* Q = static_cast<const T*>(Qv);
  const T* K = static_cast<const T*>(Kv);
  const T* V = static_cast<const T*>(Vv);
  const unsigned qtiles = (G.SQ + G.bq - 1) / G.bq, bh = B * G.H;
  const dim3 block(8 * G.bq);  // four warps per 16 rows
  if (G.splits == 1) {
    kern<<<dim3(1, qtiles, bh), block, C::SMEM, s>>>(Q, K, V, O, G, W, 0);
    return cudaGetLastError();
  }
  kern<<<dim3(G.splits - 1, qtiles, bh), block, C::SMEM, s>>>(Q, K, V, O, G, W, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = dependent(dim3(G.splits, qtiles, bh), block, C::SMEM, s, attr);
  err = cudaLaunchKernelEx(&cfg, kern, Q, K, V, O, G, W, 0);
  if (err != cudaSuccess) return err;
  const long long total = (long long)bh * G.SQ * G.dv;
  cfg = dependent(dim3(static_cast<unsigned>((total + 255) / 256)), dim3(256), 0, s, attr);
  err = cudaLaunchKernelEx(&cfg, k3_merge, O, total, G, W);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_dmax(const void* Q, const void* K, const void* V, float* O, int B,
                        const Geometry& G, const Work& W, cudaStream_t s) {
  const int dm = G.d > G.dv ? G.d : G.dv;
  if (dm <= 32) return launch<T, 32>(Q, K, V, O, B, G, W, s);
  if (dm <= 64) return launch<T, 64>(Q, K, V, O, B, G, W, s);
  if (dm <= 128) return launch<T, 128>(Q, K, V, O, B, G, W, s);
  return launch<T, 256>(Q, K, V, O, B, G, W, s);
}

long long round4(long long n) { return (n + 3) / 4 * 4; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte copies of rows of `width` elements need 16-byte aligned rows.
bool vec_ok(const void* p, int width, const long long* st, int esize) {
  return aligned16(p) && width * esize % 16 == 0 && st[0] * esize % 16 == 0 &&
         st[1] * esize % 16 == 0 && st[2] * esize % 16 == 0;
}

}  // namespace

extern "C" {

// q (B, H, SQ, d), k (B, H/rep, SKV, d) and v (B, H/rep, SKV, dv) given by
// element strides (batch, head, seq; the last dim contiguous), all fp32 or
// all bf16; o (B, H, SQ, dv) fp32 with strides (batch, head, seq).  d, dv <=
// 256.  strides: q[3], k[3], v[3], o[3].  The plan (k3_plan): `warps` per
// block (4 or 8: four per 16 q rows), `splits` kv ranges of `per` 64-wide kv
// tiles per q tile.  With splits > 1, ws holds ws_floats floats (at least the Work
// layout).  Enqueues the kernels of the plan on `stream`; returns
// cudaGetLastError() after the launches.
int repro_flash_attention(const void* Q, const void* K, const void* V, float* O, float* ws,
                          long long ws_floats, int B, int H, int rep, int SQ, int SKV, int d,
                          int dv, int kv_len, int causal, float scale, int is_bf16,
                          int passes, int warps, int splits, int per,
                          const long long* strides, void* stream) {
  Geometry G{};
  G.H = H;
  G.rep = rep;
  G.SQ = SQ;
  G.SKV = SKV;
  G.d = d;
  G.dv = dv;
  G.kv_len = kv_len;
  G.causal = causal;
  G.scale = scale;
  G.bq = 4 * warps;
  G.splits = splits;
  G.per = per;
  const long long rows = (long long)B * H * SQ;
  const long long need =
      splits > 1 ? round4(rows * (splits - 1)) + 2 * round4(rows * splits) + rows * splits * dv
                 : 0;
  if (passes != REPRO_PASSES || B < 1 || H < 1 || rep < 1 || H % rep || SQ < 1 || SKV < 1 ||
      d < 1 || d > 256 || dv < 1 || dv > 256 || kv_len < 0 || kv_len > SKV ||
      !(warps == 4 || warps == 8) || splits < 1 || per < 1 ||
      (long long)B * H > 65535 || ws_floats < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = is_bf16 ? 2 : 4;
  G.vec_q = vec_ok(Q, d, strides, esize);
  G.vec_k = vec_ok(K, d, strides + 3, esize);
  G.vec_v = vec_ok(V, dv, strides + 6, esize);
  G.qsb = strides[0];
  G.qsh = strides[1];
  G.qss = strides[2];
  G.ksb = strides[3];
  G.ksh = strides[4];
  G.kss = strides[5];
  G.vsb = strides[6];
  G.vsh = strides[7];
  G.vss = strides[8];
  G.osb = strides[9];
  G.osh = strides[10];
  G.oss = strides[11];
  Work W{};
  if (splits > 1) {
    W.smax = ws;
    W.pm = W.smax + round4(rows * (splits - 1));
    W.pl = W.pm + round4(rows * splits);
    W.pacc = W.pl + round4(rows * splits);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_dmax<__nv_bfloat16>(Q, K, V, O, B, G, W, s)
                                  : launch_dmax<float>(Q, K, V, O, B, G, W, s);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
