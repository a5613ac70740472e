// K4 — paged decode attention: one query token per request against its KV
// pages, resolved through the block table inside the kernels.
//
// Replaces: repro/serving/paged_attention.py::_paged_kernel (the pallas_call
// in _paged_pallas), GQA with bf16 or fp32 pages, head dims d <= 256 and
// dv <= 256 (d != dv allowed).  Not ported yet: the optional second score
// pair (MLA's rope term) and int8 pages with per-page scales (the wrapper
// raises NotImplementedError).
//
// What bounds it on an H100: per generated token the call reads each
// request's live cache once and does two rank-`rep` contractions on it, so
// by the roofline it is bound by the bytes of the pages it reads; at decode
// those are a few hundred KB, well under a microsecond of HBM time, so what
// sets its time is latency: how many blocks share the work, how many loads
// are in flight, how long each block's serial chain is.
//
// The design (flash-decoding), three kernels enqueued by one host call, each
// a programmatic dependent of the one before (its blocks are resident and
// start their independent loads while the previous kernel finishes):
//
// * k4_scores: S^T = K q^T for every live 16-position chunk, one warp per
//   chunk, four chunks per block.  The chunk's 16 positions are mma.sync's
//   m16 operand and the rep query heads of the kv head (up to 8 per group)
//   its n8 operand, so qwen2's rep = 7 fills 7 of 8 columns.  Writes the
//   scaled, length-masked scores S and each chunk's row max.
// * k4_pv: the page range split across blocks (the host's plan,
//   repro_torch/serving/paged_attention.py::k4_plan).  A block owns one
//   split and one 16-column tile of dv; two warps take the split's chunks in
//   turn.  Each split starts its running max from the max of the chunks
//   before it, so every chunk's P = exp(s - m) uses the same m, and is
//   rounded at the same places, as the reference's single pass over the
//   pages (with page_size 16, the reference's blocking); O^T = V^T P^T with
//   dv rows as the m16 operand.  Writes the split's (m, l, acc) partial.
// * k4_merge: the partials of every output element combined in split order,
//   then acc / l; no float atomics.
//
// Loads are 16-byte cp.async.cg copies of page rows (zero-filled past the
// live length and past d/dv), through a 4-stage ring in k4_pv; each page's
// block-table entry is read once per block from global memory into shared
// memory.  Only the schedule's passes whose words can be nonzero run: a bf16
// page (and a bf16-exact q) is its own word 0, so under bf16x6 q K^T and
// P V each run 3 of 6 passes (the rule of kernels/tcec_matmul.py::
// k2_passes).  NEG_INF = -1e30 and the m_new > 0.5 NEG_INF rule are the
// reference's; a zero length gives zeros; output fp32.
#include "tcec_frag.cuh"

namespace {

using frag::cp_async16;
using frag::cp_async_commit;
using frag::cp_async_wait;
using frag::is_bf16;
using frag::op_words;
using frag::run_passes;

constexpr int CHUNK = 16;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Shapes and the plan of one call.
struct Geometry {
  int KVH, rep, qg;       // kv heads, query heads per kv head, groups of 8 of them
  int d, dv, page, npages;
  int nchunks, npos;      // chunks of the block table (npos = 16 nchunks positions)
  int splits, per;        // split s covers chunks [s per, (s + 1) per)
  float scale;
  int vec_k, vec_v;       // 16-byte copies of k / v rows
};

// The workspace, fp32: rows are (b, kv head, query head of the kv head).
struct Work {
  float* S;     // (rows, npos) scaled, masked scores
  float* cmax;  // (rows, nchunks) each chunk's max of S
  float* pm;    // (rows, splits) each split's running max at its end
  float* pl;    // (rows, splits) its softmax denominator
  float* pacc;  // (rows, splits, dv) its P V
};

__device__ __forceinline__ int live_len(const int* seq_lens, int b, const Geometry& G) {
  return max(0, min(seq_lens[b], G.npages * G.page));
}

// ---------------------------------------------------------------------------
// k4_scores
// ---------------------------------------------------------------------------

template <typename TP, int DMAX>
struct ScoresCfg {
  // Chunks (warps) per block: four, two where four fp32 K tiles of 256
  // columns would not fit in 48 KB of static shared memory.
  static constexpr int CPB = (sizeof(TP) == 4 && DMAX == 256) ? 2 : 4;
  static constexpr int THREADS = CPB * 32;
  static constexpr int ROWS = CPB * CHUNK;
  // Row pitches: multiples of 16 bytes, rows of an ldmatrix 16 bytes apart
  // modulo 128.
  static constexpr int LDK = DMAX + (is_bf16<TP> ? 8 : 4);
  static constexpr int LDQ = DMAX + 4;
  static constexpr int TBL = ROWS + 2;  // pages a block's positions can touch
};

// K's A fragment (16 positions x k16) at column kk of a [pos][d] tile.
template <int NW>
__device__ __forceinline__ void k_frag(const __nv_bfloat16* k, int ld, int kk, int lane,
                                       uint32_t (&f)[NW][4]) {
  const int mat = lane >> 3;
  frag::ldsm_x4(f[0], k + ((mat & 1) * 8 + (lane & 7)) * ld + kk + (mat >> 1) * 8);
}
template <int NW>
__device__ __forceinline__ void k_frag(const float* k, int ld, int kk, int lane,
                                       uint32_t (&f)[NW][4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = k + g * ld + kk + 2 * t;
  const float a[8] = {p[0], p[1], p[8 * ld], p[8 * ld + 1],
                      p[8], p[9], p[8 * ld + 8], p[8 * ld + 9]};
  tcec::split_a_frag<NW>(a, f);
}

template <typename TP, int NWQ, int DMAX, int PASSES>
__global__ void __launch_bounds__(ScoresCfg<TP, DMAX>::THREADS)
k4_scores(const float* __restrict__ Q, const TP* __restrict__ Kp,
          const int* __restrict__ block_table, const int* __restrict__ seq_lens, Geometry G,
          Work W) {
  using C = ScoresCfg<TP, DMAX>;
  constexpr int NWK = op_words<TP, PASSES>();
  __shared__ __align__(16) TP ks[C::ROWS][C::LDK];
  __shared__ __align__(16) float qs[8][C::LDQ];
  __shared__ int tbl[C::TBL];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y / G.qg, r0 = (blockIdx.y % G.qg) * 8;
  const int nh = min(8, G.rep - r0);
  const int seq_len = live_len(seq_lens, b, G);
  const int p0 = blockIdx.x * C::ROWS;
  if (p0 >= seq_len) return;  // no live position: nothing to write
  const int pend = min(seq_len, p0 + C::ROWS);
  const int lp0 = p0 / G.page;
  for (int i = tid; i <= (pend - 1) / G.page - lp0; i += C::THREADS) {
    const int lp = lp0 + i;
    tbl[i] = lp < G.npages ? block_table[(long long)b * G.npages + lp] : -1;
  }
  const int dpad = (G.d + 15) / 16 * 16;  // the k16 steps cover [0, dpad)
  const long long row0 = ((long long)b * G.KVH + kvh) * G.rep + r0;
  const float* Qb = Q + row0 * G.d;
  for (int i = tid; i < 8 * dpad; i += C::THREADS) {
    const int j = i / dpad, c = i % dpad;
    qs[j][c] = (j < nh && c < G.d) ? Qb[(long long)j * G.d + c] : 0.f;
  }
  __syncthreads();
  if (G.vec_k) {
    constexpr int E = 16 / sizeof(TP);
    const int segs = dpad / E;
    for (int i = tid; i < C::ROWS * segs; i += C::THREADS) {
      const int r = i / segs, c = (i % segs) * E, pos = p0 + r;
      const int phys = pos < pend ? tbl[pos / G.page - lp0] : -1;
      const bool ok = phys >= 0 && c < G.d;
      cp_async16(&ks[r][c],
                 ok ? Kp + (((long long)phys * G.page + pos % G.page) * G.KVH + kvh) * G.d + c
                    : Kp,
                 ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = tid; i < C::ROWS * dpad; i += C::THREADS) {
      const int r = i / dpad, c = i % dpad, pos = p0 + r;
      const int phys = pos < pend && c < G.d ? tbl[pos / G.page - lp0] : -1;
      ks[r][c] = phys >= 0
                     ? Kp[(((long long)phys * G.page + pos % G.page) * G.KVH + kvh) * G.d + c]
                     : TP(0.f);
    }
  }
  __syncthreads();
  frag::launch_dependents();

  const int c0 = p0 + warp * CHUNK;  // this warp's chunk
  if (c0 >= seq_len) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kk = 0; kk < dpad; kk += 16) {
    uint32_t fk[NWK][4];
    k_frag<NWK>(&ks[warp * CHUNK][0], C::LDK, kk, lane, fk);
    const float bq[4] = {qs[g][kk + 2 * t], qs[g][kk + 2 * t + 1], qs[g][kk + 2 * t + 8],
                         qs[g][kk + 2 * t + 9]};
    uint32_t fq[NWQ][2];
    tcec::split_b_frag<NWQ>(bq, fq);
    run_passes<PASSES, NWQ, NWK>(acc, fk, fq);
  }
  // acc[e] is position c0 + g (+8 for e >= 2), head r0 + 2t + (e & 1).
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int pos = c0 + g + (e >= 2 ? 8 : 0), j = 2 * t + (e & 1);
    float x = acc[e] * G.scale;
    x = pos < seq_len ? x : NEG_INF;
    if (j < nh) W.S[(row0 + j) * G.npos + pos] = x;
    mx[e & 1] = fmaxf(mx[e & 1], x);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], o));
    const int j = 2 * t + i;
    if (g == 0 && j < nh) W.cmax[(row0 + j) * G.nchunks + c0 / CHUNK] = mx[i];
  }
}

// ---------------------------------------------------------------------------
// k4_pv
// ---------------------------------------------------------------------------

template <typename TP>
struct PvCfg {
  static constexpr int WARPS = 2;  // turns over a split's chunks
  static constexpr int THREADS = WARPS * 32;
  static constexpr int STAGES = 4;
  static constexpr int LDV = 16 + (is_bf16<TP> ? 8 : 4);
  static constexpr int S_BYTES = 8 * CHUNK * 4;  // [8 heads][16 positions] fp32
  static constexpr int V_BYTES = CHUNK * LDV * static_cast<int>(sizeof(TP));
  static constexpr int STAGE = S_BYTES + V_BYTES;
  static_assert(V_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte aligned stages");
};

// V^T's A fragment (16 dv columns x 16 positions) from a [pos][16] tile.
template <int NW>
__device__ __forceinline__ void v_frag(const __nv_bfloat16* v, int ld, int lane,
                                       uint32_t (&f)[NW][4]) {
  const int mat = lane >> 3;
  frag::ldsm_x4_trans(f[0], v + ((mat >> 1) * 8 + (lane & 7)) * ld + (mat & 1) * 8);
}
template <int NW>
__device__ __forceinline__ void v_frag(const float* v, int ld, int lane, uint32_t (&f)[NW][4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = v + 2 * t * ld + g;
  const float a[8] = {p[0],      p[ld],     p[8],          p[ld + 8],
                      p[8 * ld], p[9 * ld], p[8 * ld + 8], p[9 * ld + 8]};
  tcec::split_a_frag<NW>(a, f);
}

// The V rows of chunk c (this block's 16 columns of dv) into a stage.
template <typename TP>
__device__ __forceinline__ void load_v(TP* vs, const TP* __restrict__ Vp, const int* tbl,
                                       int lp0, int c, int seq_len, int kvh, int col0,
                                       const Geometry& G) {
  using C = PvCfg<TP>;
  if (G.vec_v) {
    constexpr int E = 16 / sizeof(TP), SEGS = 16 / E;
    for (int i = threadIdx.x; i < CHUNK * SEGS; i += C::THREADS) {
      const int r = i / SEGS, cc = (i % SEGS) * E, pos = c * CHUNK + r;
      const int phys = pos < seq_len ? tbl[pos / G.page - lp0] : -1;
      const bool ok = phys >= 0 && col0 + cc < G.dv;
      cp_async16(vs + r * C::LDV + cc,
                 ok ? Vp + (((long long)phys * G.page + pos % G.page) * G.KVH + kvh) * G.dv +
                          col0 + cc
                    : Vp,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < CHUNK * 16; i += C::THREADS) {
      const int r = i / 16, cc = i % 16, pos = c * CHUNK + r;
      const int phys = pos < seq_len && col0 + cc < G.dv ? tbl[pos / G.page - lp0] : -1;
      vs[r * C::LDV + cc] =
          phys >= 0
              ? Vp[(((long long)phys * G.page + pos % G.page) * G.KVH + kvh) * G.dv + col0 + cc]
              : TP(0.f);
    }
  }
}

// The scores of chunk c, heads [r0, r0 + nh) (zero past nh), into a stage.
__device__ __forceinline__ void load_s(float* ss, const float* __restrict__ S, long long row0,
                                       int nh, int c, const Geometry& G) {
  const int i = threadIdx.x;
  if (i < 8 * 4) {
    const int j = i / 4, q = (i % 4) * 4;
    const bool ok = j < nh;
    cp_async16(ss + j * CHUNK + q, ok ? S + (row0 + j) * G.npos + c * CHUNK + q : S, ok);
  }
}

template <typename TP, int PASSES>
__global__ void __launch_bounds__(PvCfg<TP>::THREADS)
k4_pv(const TP* __restrict__ Vp, const int* __restrict__ block_table,
      const int* __restrict__ seq_lens, Geometry G, Work W) {
  using C = PvCfg<TP>;
  constexpr int NWP = tcec::n_words(PASSES);  // P is fp32
  constexpr int NWV = op_words<TP, PASSES>();
  extern __shared__ int tbl[];  // the split's block-table entries
  __shared__ __align__(16) unsigned char ring[C::STAGES * C::STAGE];
  __shared__ float red[32][5];

  const int lane = threadIdx.x & 31, turn = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (G.dv + 15) / 16;
  const int split = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int b = blockIdx.z, kvh = blockIdx.y / G.qg, r0 = (blockIdx.y % G.qg) * 8;
  const int nh = min(8, G.rep - r0);
  const long long row0 = ((long long)b * G.KVH + kvh) * G.rep + r0;
  const int seq_len = live_len(seq_lens, b, G);
  const int c0 = split * G.per;
  const int c1 = min(min(c0 + G.per, G.nchunks), (seq_len + CHUNK - 1) / CHUNK);
  if (c0 >= c1) {  // wholly past the live length: an empty partial
    if (tile == 0 && turn == 0 && t == 0 && g < nh) {
      W.pm[(row0 + g) * G.splits + split] = NEG_INF;
      W.pl[(row0 + g) * G.splits + split] = 0.f;
    }
    return;
  }
  const int n = c1 - c0, col0 = tile * 16;
  const int lp0 = c0 * CHUNK / G.page;
  for (int i = threadIdx.x; i <= (min(c1 * CHUNK, seq_len) - 1) / G.page - lp0;
       i += C::THREADS) {
    const int lp = lp0 + i;
    tbl[i] = lp < G.npages ? block_table[(long long)b * G.npages + lp] : -1;
  }
  __syncthreads();
  auto stage_v = [&](int st) {
    return reinterpret_cast<TP*>(ring + (st % C::STAGES) * C::STAGE + C::S_BYTES);
  };
  auto stage_s = [&](int st) {
    return reinterpret_cast<float*>(ring + (st % C::STAGES) * C::STAGE);
  };
  // The pages were written before k4_scores started, so their loads need not
  // wait for it; the scores do.
  for (int st = 0; st < C::STAGES - 1 && st < n; ++st)
    load_v(stage_v(st), Vp, tbl, lp0, c0 + st, seq_len, kvh, col0, G);
  frag::wait_primary();
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < n) load_s(stage_s(st), W.S, row0, nh, c0 + st, G);
    cp_async_commit();
  }
  frag::launch_dependents();

  // The running max of the chunks before this split (the reference's m when
  // it reaches chunk c0), for head g.
  float m = NEG_INF;
  if (g < nh)
    for (int c = t; c < c0; c += 4) m = fmaxf(m, W.cmax[(row0 + g) * G.nchunks + c]);
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));

  float l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int st = 0; st < n; ++st) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    // Slot (st - 1) % STAGES was last read in the previous step: refill it.
    const int nx = st + C::STAGES - 1;
    if (nx < n) {
      load_v(stage_v(nx), Vp, tbl, lp0, c0 + nx, seq_len, kvh, col0, G);
      load_s(stage_s(nx), W.S, row0, nh, c0 + nx, G);
    }
    cp_async_commit();
    const float* ss = stage_s(st) + g * CHUNK + 2 * t;
    const float sv[4] = {ss[0], ss[1], ss[8], ss[9]};  // positions 2t, 2t+1, 2t+8, 2t+9
    float cm = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
    cm = fmaxf(cm, __shfl_xor_sync(FULL, cm, 1));
    cm = fmaxf(cm, __shfl_xor_sync(FULL, cm, 2));
    const float m_new = fmaxf(m, cm);
    const float alpha = expf(m - m_new);
    m = m_new;
    // acc[e] is dv column col0 + g (+8 for e >= 2), head 2t + (e & 1), whose
    // alpha is held by lanes 4 (2t + (e & 1)).
    const float a_even = __shfl_sync(FULL, alpha, 8 * t);
    const float a_odd = __shfl_sync(FULL, alpha, 8 * t + 4);
    float pv[4] = {0.f, 0.f, 0.f, 0.f};
    if ((st & 1) == turn) {
      float p[4], rs = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = m_new > 0.5f * NEG_INF ? expf(sv[i] - m_new) : 0.f;
        rs += p[i];
      }
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      l = l * alpha + rs;
      uint32_t fp[NWP][2];
      tcec::split_b_frag<NWP>(p, fp);
      uint32_t fv[NWV][4];
      v_frag<NWV>(stage_v(st), C::LDV, lane, fv);
      run_passes<PASSES, NWP, NWV>(pv, fv, fp);
    } else {
      l = l * alpha;
    }
    acc[0] = acc[0] * a_even + pv[0];
    acc[1] = acc[1] * a_odd + pv[1];
    acc[2] = acc[2] * a_even + pv[2];
    acc[3] = acc[3] * a_odd + pv[3];
  }
  cp_async_wait<0>();
  // Both turns scaled their sums by every chunk's alpha: add turn 1's to
  // turn 0's.
  if (turn == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[lane][e] = acc[e];
    red[lane][4] = l;
  }
  __syncthreads();
  if (turn == 1) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += red[lane][e];
  l += red[lane][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = col0 + g + (e >= 2 ? 8 : 0), j = 2 * t + (e & 1);
    if (col < G.dv && j < nh)
      W.pacc[((row0 + j) * G.splits + split) * G.dv + col] = acc[e];
  }
  if (tile == 0 && t == 0 && g < nh) {
    W.pm[(row0 + g) * G.splits + split] = m;
    W.pl[(row0 + g) * G.splits + split] = l;
  }
}

// ---------------------------------------------------------------------------
// k4_merge: one thread per output element (b, h, column of dv)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
k4_merge(float* __restrict__ O, long long total, Geometry G, Work W) {
  frag::wait_primary();
  const long long o = blockIdx.x * 256LL + threadIdx.x;
  if (o >= total) return;
  const long long row = o / G.dv;
  const int col = static_cast<int>(o % G.dv);
  const float* pm = W.pm + row * G.splits;
  const float* pl = W.pl + row * G.splits;
  const float* pa = W.pacc + row * G.splits * G.dv + col;
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
  O[o] = l > 0.f ? acc / l : 0.f;
}

// Floats of the workspace, each part starting on a 16-byte boundary.
long long round4(long long n) { return (n + 3) / 4 * 4; }
long long workspace_floats(long long rows, const Geometry& G) {
  return round4(rows * G.npos) + round4(rows * G.nchunks) + 2 * round4(rows * G.splits) +
         rows * G.splits * G.dv;
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

template <typename TP, int NWQ, int DMAX>
cudaError_t launch(const float* Q, const void* Kp, const void* Vp, const int* bt,
                   const int* sl, float* O, int B, const Geometry& G, const Work& W,
                   cudaStream_t s) {
  using SC = ScoresCfg<TP, DMAX>;
  dim3 grid_a((G.nchunks + SC::CPB - 1) / SC::CPB, G.KVH * G.qg, B);
  k4_scores<TP, NWQ, DMAX, REPRO_PASSES><<<grid_a, SC::THREADS, 0, s>>>(
      Q, static_cast<const TP*>(Kp), bt, sl, G, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const size_t tbl = sizeof(int) * (static_cast<size_t>(G.per) * CHUNK / G.page + 2);
  cudaLaunchConfig_t cfg =
      dependent(dim3(G.splits * ((G.dv + 15) / 16), G.KVH * G.qg, B),
                dim3(PvCfg<TP>::THREADS), tbl, s, attr);
  err = cudaLaunchKernelEx(&cfg, k4_pv<TP, REPRO_PASSES>, static_cast<const TP*>(Vp), bt, sl,
                           G, W);
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * G.KVH * G.rep * G.dv;
  cfg = dependent(dim3(static_cast<unsigned>((total + 255) / 256)), dim3(256), 0, s, attr);
  err = cudaLaunchKernelEx(&cfg, k4_merge, O, total, G, W);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TP, int NWQ>
cudaError_t launch_dmax(int dmax, const float* Q, const void* Kp, const void* Vp,
                        const int* bt, const int* sl, float* O, int B, const Geometry& G,
                        const Work& W, cudaStream_t s) {
  if (dmax == 32) return launch<TP, NWQ, 32>(Q, Kp, Vp, bt, sl, O, B, G, W, s);
  if (dmax == 64) return launch<TP, NWQ, 64>(Q, Kp, Vp, bt, sl, O, B, G, W, s);
  if (dmax == 128) return launch<TP, NWQ, 128>(Q, Kp, Vp, bt, sl, O, B, G, W, s);
  return launch<TP, NWQ, 256>(Q, Kp, Vp, bt, sl, O, B, G, W, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// q (B, KVH, rep, d) fp32 (q_bf16: its values are bf16-exact); pages (P,
// page, KVH, d) and (P, page, KVH, dv), both fp32 or both bf16 (pages_bf16);
// block_table (B, npages) int32; seq_lens (B,) int32; o (B, KVH, rep, dv)
// fp32.  The plan: `splits` ranges of `per` 16-position chunks over the
// npages * page / 16 (rounded up) chunks of the block table.  ws holds
// ws_floats floats (at least the layout of Work needs).  Enqueues the three
// kernels on `stream`; returns cudaGetLastError() after the launches.
int repro_paged_decode_attention(const float* Q, const void* Kp, const void* Vp,
                                 const int* block_table, const int* seq_lens, float* O,
                                 float* ws, long long ws_floats, int B, int KVH, int rep, int d,
                                 int dv, int page, int npages, int splits, int per, float scale,
                                 int pages_bf16, int q_bf16, int passes, void* stream) {
  Geometry G{};
  G.KVH = KVH;
  G.rep = rep;
  G.qg = (rep + 7) / 8;
  G.d = d;
  G.dv = dv;
  G.page = page;
  G.npages = npages;
  G.npos = (int)(((long long)npages * page + CHUNK - 1) / CHUNK * CHUNK);
  G.nchunks = G.npos / CHUNK;
  G.splits = splits;
  G.per = per;
  G.scale = scale;
  const long long rows = (long long)B * KVH * rep;
  if (passes != REPRO_PASSES || B < 1 || KVH < 1 || rep < 1 || d < 1 || d > 256 || dv < 1 ||
      dv > 256 || page < 1 || npages < 1 || splits < 1 || per < 1 ||
      (long long)splits * per < G.nchunks || (long long)(splits - 1) * per >= G.nchunks ||
      (long long)per * CHUNK / page + 2 > 12288 || ws_floats < workspace_floats(rows, G))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = pages_bf16 ? 2 : 4;
  G.vec_k = aligned16(Kp) && d * esize % 16 == 0;
  G.vec_v = aligned16(Vp) && dv * esize % 16 == 0;
  Work W{};
  W.S = ws;
  W.cmax = W.S + round4(rows * G.npos);
  W.pm = W.cmax + round4(rows * G.nchunks);
  W.pl = W.pm + round4(rows * splits);
  W.pacc = W.pl + round4(rows * splits);
  const int dmax = d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
  constexpr int NW = tcec::n_words(REPRO_PASSES);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (pages_bf16)
    err = q_bf16 ? launch_dmax<bf, 1>(dmax, Q, Kp, Vp, block_table, seq_lens, O, B, G, W, s)
                 : launch_dmax<bf, NW>(dmax, Q, Kp, Vp, block_table, seq_lens, O, B, G, W, s);
  else
    err = q_bf16 ? launch_dmax<float, 1>(dmax, Q, Kp, Vp, block_table, seq_lens, O, B, G, W, s)
                 : launch_dmax<float, NW>(dmax, Q, Kp, Vp, block_table, seq_lens, O, B, G, W, s);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
