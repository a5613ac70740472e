// K4 — paged decode attention: one query token per request against its KV
// pages, resolved through the block table inside the kernel.
//
// Replaces: repro/serving/paged_attention.py::_paged_kernel (the pallas_call
// in _paged_pallas), GQA with bf16 or fp32 pages.  Not ported yet: the
// optional second score pair (MLA's rope term) and int8 pages with per-page
// scales (the wrapper raises NotImplementedError).
//
// What bounds it on an H100: per generated token the kernel reads each
// request's live cache once and does two rank-`rep` contractions on it, so
// it is bound by the bytes of the pages it reads.  What the design does
// about it: the gathered cache is never built in device memory — each block
// reads block_table[b, pos / page] itself (this replaces the TPU's scalar
// prefetch) and loads only the positions below seq_len; scores, weights and
// the online-softmax state stay in registers.  This first version uses one
// warp per block and loads synchronously.
//
// One block per (slot, kv head, 16 query rows): the rep = h / kvh query
// heads of a kv head are the rows of one m16 tile; rows past rep (qwen2:
// rep = 7 fills half the tile) are zero and never stored.  The kv loop takes
// 16 positions per step — one m16n8k16 k-step for PV, and exactly one page
// when page_size == 16 (the reference's blocking).  Online softmax over the
// steps with the mask col < seq_len; a zero length emits zeros.  Output fp32.
#include "tcec_core.cuh"

namespace {

constexpr int ROWS = 16;
constexpr int CHUNK = 16;
constexpr int PAD = 4;
constexpr float NEG_INF = -1e30f;

template <typename TP, int D, int PASSES>
__global__ void __launch_bounds__(32)
paged_decode_kernel(const float* __restrict__ Q, const TP* __restrict__ Kp,
                    const TP* __restrict__ Vp, const int* __restrict__ block_table,
                    const int* __restrict__ seq_lens, float* __restrict__ O, int KVH, int rep,
                    int page, int npages, float scale) {
  constexpr int NW = tcec::n_words(PASSES);
  constexpr int NT_O = D / 8;
  __shared__ float qs[ROWS][D + PAD];
  __shared__ TP ks[CHUNK][D + PAD];
  __shared__ TP vs[CHUNK][D + PAD];

  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = blockIdx.x * ROWS;  // first query row (within rep) of this block
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int seq_len = seq_lens[b];
  const float* Qb = Q + ((long long)b * KVH + kvh) * rep * D;

  for (int idx = lane; idx < ROWS * D; idx += 32) {
    const int r = idx / D, c = idx % D;
    qs[r][c] = (r0 + r < rep) ? Qb[(long long)(r0 + r) * D + c] : 0.f;
  }
  __syncwarp();

  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int p0 = 0; p0 < seq_len; p0 += CHUNK) {
    __syncwarp();
    for (int idx = lane; idx < CHUNK * D; idx += 32) {
      const int r = idx / D, c = idx % D;
      const int pos = p0 + r;
      TP kx = TP(0.f), vx = TP(0.f);
      if (pos < seq_len) {
        const int lp = pos / page;
        const int phys = lp < npages ? block_table[(long long)b * npages + lp] : 0;
        const long long o = (((long long)phys * page + pos % page) * KVH + kvh) * D + c;
        kx = Kp[o];
        vx = Vp[o];
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncwarp();

    // S = q K^T over this chunk: 16 rows x 16 positions (two n8 tiles).
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      float a[8];
      a[0] = qs[g][kk + 2 * t];
      a[1] = qs[g][kk + 2 * t + 1];
      a[2] = qs[g + 8][kk + 2 * t];
      a[3] = qs[g + 8][kk + 2 * t + 1];
      a[4] = qs[g][kk + 2 * t + 8];
      a[5] = qs[g][kk + 2 * t + 9];
      a[6] = qs[g + 8][kk + 2 * t + 8];
      a[7] = qs[g + 8][kk + 2 * t + 9];
      uint32_t fa[NW][4];
      tcec::split_a_frag<NW>(a, fa);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j * 8 + g;
        float bb[4];
        bb[0] = tcec::to_f32(ks[c][kk + 2 * t]);
        bb[1] = tcec::to_f32(ks[c][kk + 2 * t + 1]);
        bb[2] = tcec::to_f32(ks[c][kk + 2 * t + 8]);
        bb[3] = tcec::to_f32(ks[c][kk + 2 * t + 9]);
        uint32_t fb[NW][2];
        tcec::split_b_frag<NW>(bb, fb);
        tcec::mma_passes<PASSES>(s[j], fa, fb);
      }
    }

    float m_cur[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = p0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        x = col < seq_len ? x : NEG_INF;
        s[j][e] = x;
        m_cur[e >> 1] = fmaxf(m_cur[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(0xffffffffu, m_cur[i], 1));
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(0xffffffffu, m_cur[i], 2));
      const float m_new = fmaxf(m_i[i], m_cur[i]);
      alpha[i] = expf(m_i[i] - m_new);
      m_cur[i] = m_new;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = m_cur[i] > 0.5f * NEG_INF ? expf(s[j][e] - m_cur[i]) : 0.f;
        s[j][e] = p;
        rowsum[i] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
      l_i[i] = l_i[i] * alpha[i] + rowsum[i];
      m_i[i] = m_cur[i];
    }

    // PV: the chunk's 16 positions are one k-step.
    float a[8];
    a[0] = s[0][0];
    a[1] = s[0][1];
    a[2] = s[0][2];
    a[3] = s[0][3];
    a[4] = s[1][0];
    a[5] = s[1][1];
    a[6] = s[1][2];
    a[7] = s[1][3];
    uint32_t fa[NW][4];
    tcec::split_a_frag<NW>(a, fa);
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      const int c = j * 8 + g;
      float bb[4];
      bb[0] = tcec::to_f32(vs[2 * t][c]);
      bb[1] = tcec::to_f32(vs[2 * t + 1][c]);
      bb[2] = tcec::to_f32(vs[2 * t + 8][c]);
      bb[3] = tcec::to_f32(vs[2 * t + 9][c]);
      uint32_t fb[NW][2];
      tcec::split_b_frag<NW>(bb, fb);
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
      tcec::mma_passes<PASSES>(pv, fa, fb);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] * alpha[e >> 1] + pv[e];
    }
  }

  float* Ob = O + ((long long)b * KVH + kvh) * rep * D;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int r = r0 + g + (i ? 8 : 0);
      if (r >= rep) continue;
      const int c = j * 8 + 2 * t + (e & 1);
      const float l = l_i[i];
      Ob[(long long)r * D + c] = l > 0.f ? acc[j][e] / l : 0.f;
    }
  }
}

template <typename TP>
cudaError_t launch_typed(const float* Q, const void* Kp, const void* Vp, const int* bt,
                         const int* sl, float* O, int B, int KVH, int rep, int page,
                         int npages, float scale, cudaStream_t s) {
  dim3 grid((rep + ROWS - 1) / ROWS, KVH, B);
  paged_decode_kernel<TP, 64, REPRO_PASSES><<<grid, 32, 0, s>>>(
      Q, static_cast<const TP*>(Kp), static_cast<const TP*>(Vp), bt, sl, O, KVH, rep, page,
      npages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, KVH, rep, D) fp32; pages (P, page, KVH, D) fp32 or bf16 (pages_bf16);
// block_table (B, npages) int32; seq_lens (B,) int32; o (B, KVH, rep, D) fp32.
int repro_paged_decode_attention(const float* Q, const void* Kp, const void* Vp,
                                 const int* block_table, const int* seq_lens, float* O, int B,
                                 int KVH, int rep, int D, int page, int npages, float scale,
                                 int pages_bf16, int passes, void* stream) {
  // Built for head dim 64 (qwen2's); other head dims are not instantiated.
  if (D != 64 || passes != REPRO_PASSES) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      pages_bf16 ? launch_typed<__nv_bfloat16>(Q, Kp, Vp, block_table, seq_lens, O, B, KVH,
                                               rep, page, npages, scale, s)
                 : launch_typed<float>(Q, Kp, Vp, block_table, seq_lens, O, B, KVH, rep, page,
                                       npages, scale, s);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
