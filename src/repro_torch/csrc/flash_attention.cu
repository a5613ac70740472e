// K3 — flash attention forward with TCEC-policy QK^T and PV.
//
// Replaces: repro/kernels/flash_attention.py::_flash_kernel (the pallas_call
// in _flash_attention), head dims d <= 256 and dv <= 256 (d != dv allowed).
// The backward (a recompute through the dense twin in the reference) comes
// with the training slice.
//
// What bounds it on an H100: at prefill lengths the score work is
// 2 * sq * skv * (d + dv) products per head, times the policy's passes, on
// the tensor cores (bf16x6: six bf16 passes per product); the inputs are
// small next to that, so it is bound by operations (tensor-core passes plus
// the exp of the online softmax).  What the design does about it: the
// (sq, skv) score matrix never reaches device memory — scores, probabilities
// and the (m, l, acc) online-softmax state stay in registers; the kv tiles
// past the causal diagonal or past kv_len are skipped (their contribution is
// exactly zero); P is split into bf16 words straight from the score
// registers into the A fragments of the PV pass, like any fp32 operand.
//
// One block per (b, h, 64-row q tile), 4 warps of 16 rows each; the loop
// over 64-wide kv tiles runs inside the block.  kv_len is a runtime argument
// (the Pallas kernel recompiles per value).  GQA reads kv head h / rep, no
// head copies.  NEG_INF = -1e30 and the m_new > 0.5 * NEG_INF guard are the
// reference's; rows with no valid column emit exact zeros.  Output is fp32.
//
// Head dims: the kernel is built for a bucket DMAX in {32, 64, 128, 256} of
// max(d, dv), which sizes the shared tiles and the output registers; d and dv
// are runtime arguments, loads past them read zero (the shared tiles are
// DMAX wide), k16 steps past d and output tiles past dv are skipped, and no
// padded copy of q, k or v is made.
// At DMAX = 256 the fp32 tiles take 195 KB of shared memory (one block per
// SM) and the 128 output accumulators per thread spill registers.
#include "tcec_core.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr int PAD = 4;
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
struct Smem {
  T q[BQ][D + PAD];
  T k[BKV][D + PAD];
  T v[BKV][D + PAD];
};

template <typename T, int D, int PASSES>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                 float* __restrict__ O, int H, int rep, int SQ, int SKV, int d, int dv,
                 int kv_len,
                 int causal, float scale, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                 long long vss, long long osb, long long osh, long long oss) {
  constexpr int NW = tcec::n_words(PASSES);
  constexpr int NT_S = BKV / 8;  // score n-tiles per kv tile
  constexpr int NT_O = D / 8;    // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, D>& sm = *reinterpret_cast<Smem<T, D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / rep;
  const T* Qb = Q + b * qsb + h * qsh;
  const T* Kb = K + b * ksb + kvh * ksh;
  const T* Vb = V + b * vsb + kvh * vsh;

  // Tiles are D columns wide (compile-time divisions), zero past d (dv).
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    sm.q[r][c] = (q0 + r < SQ && c < d) ? Qb[(long long)(q0 + r) * qss + c] : T(0.f);
  }

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int kv_end = kv_len < SKV ? kv_len : SKV;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // previous tile fully consumed (and q staged)
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const bool in = kv0 + r < SKV;
      sm.k[r][c] = (in && c < d) ? Kb[(long long)(kv0 + r) * kss + c] : T(0.f);
      sm.v[r][c] = (in && c < dv) ? Vb[(long long)(kv0 + r) * vss + c] : T(0.f);
    }
    __syncthreads();

    // S = Q K^T at the policy's precision.
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      if (kk >= d) break;
      const int r = warp * 16 + g;
      float a[8];
      a[0] = tcec::to_f32(sm.q[r][kk + 2 * t]);
      a[1] = tcec::to_f32(sm.q[r][kk + 2 * t + 1]);
      a[2] = tcec::to_f32(sm.q[r + 8][kk + 2 * t]);
      a[3] = tcec::to_f32(sm.q[r + 8][kk + 2 * t + 1]);
      a[4] = tcec::to_f32(sm.q[r][kk + 2 * t + 8]);
      a[5] = tcec::to_f32(sm.q[r][kk + 2 * t + 9]);
      a[6] = tcec::to_f32(sm.q[r + 8][kk + 2 * t + 8]);
      a[7] = tcec::to_f32(sm.q[r + 8][kk + 2 * t + 9]);
      uint32_t fa[NW][4];
      tcec::split_a_frag<NW>(a, fa);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const int c = j * 8 + g;  // kv row of this B column
        float bb[4];
        bb[0] = tcec::to_f32(sm.k[c][kk + 2 * t]);
        bb[1] = tcec::to_f32(sm.k[c][kk + 2 * t + 1]);
        bb[2] = tcec::to_f32(sm.k[c][kk + 2 * t + 8]);
        bb[3] = tcec::to_f32(sm.k[c][kk + 2 * t + 9]);
        uint32_t fb[NW][2];
        tcec::split_b_frag<NW>(bb, fb);
        tcec::mma_passes<PASSES>(s[j], fa, fb);
      }
    }

    // Scale, structural-rule mask, online softmax.
    float m_cur[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >= 2 ? 8 : 0);
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        bool valid = col < kv_len;
        if (causal) valid = valid && row >= col;
        float x = s[j][e] * scale;
        x = valid ? x : NEG_INF;
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
      m_cur[i] = m_new;  // now holds m_new
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        // Rows with no valid column so far must not attend (exp(0) == 1).
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

    // PV at the same policy: P is split like any fp32 operand, straight from
    // the score registers into the A fragments.
    float pv[NT_O][4];
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      float a[8];
      a[0] = s[2 * ks][0];
      a[1] = s[2 * ks][1];
      a[2] = s[2 * ks][2];
      a[3] = s[2 * ks][3];
      a[4] = s[2 * ks + 1][0];
      a[5] = s[2 * ks + 1][1];
      a[6] = s[2 * ks + 1][2];
      a[7] = s[2 * ks + 1][3];
      uint32_t fa[NW][4];
      tcec::split_a_frag<NW>(a, fa);
      const int kr = ks * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        if (j * 8 >= dv) break;
        const int c = j * 8 + g;
        float bb[4];
        bb[0] = tcec::to_f32(sm.v[kr][c]);
        bb[1] = tcec::to_f32(sm.v[kr + 1][c]);
        bb[2] = tcec::to_f32(sm.v[kr + 8][c]);
        bb[3] = tcec::to_f32(sm.v[kr + 9][c]);
        uint32_t fb[NW][2];
        tcec::split_b_frag<NW>(bb, fb);
        tcec::mma_passes<PASSES>(pv[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] * alpha[e >> 1] + pv[j][e];
  }

  // Fully masked rows (l == 0) emit exact zeros, not 0/0.
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int row = row0 + (i ? 8 : 0);
      if (row >= SQ) continue;
      const int c = j * 8 + 2 * t + (e & 1);
      if (c >= dv) continue;
      const float l = l_i[i];
      O[b * osb + h * osh + row * oss + c] = l > 0.f ? acc[j][e] / l : 0.f;
    }
  }
}

template <typename T, int D, int PASSES>
cudaError_t launch_one(const void* Q, const void* K, const void* V, float* O, int B, int H,
                       int rep, int SQ, int SKV, int d, int dv, int kv_len, int causal,
                       float scale, const long long* st, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<T, D>);
  auto kern = flash_fwd_kernel<T, D, PASSES>;
  // Above 48 KB of dynamic shared memory the kernel must opt in first.
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((SQ + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(Q), static_cast<const T*>(K), static_cast<const T*>(V), O, H, rep,
      SQ, SKV, d, dv, kv_len, causal, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dmax(const void* Q, const void* K, const void* V, float* O, int B, int H,
                        int rep, int SQ, int SKV, int d, int dv, int kv_len, int causal,
                        float scale, const long long* st, cudaStream_t s) {
  const int dm = d > dv ? d : dv;
  if (dm <= 32)
    return launch_one<T, 32, REPRO_PASSES>(Q, K, V, O, B, H, rep, SQ, SKV, d, dv, kv_len,
                                           causal, scale, st, s);
  if (dm <= 64)
    return launch_one<T, 64, REPRO_PASSES>(Q, K, V, O, B, H, rep, SQ, SKV, d, dv, kv_len,
                                           causal, scale, st, s);
  if (dm <= 128)
    return launch_one<T, 128, REPRO_PASSES>(Q, K, V, O, B, H, rep, SQ, SKV, d, dv, kv_len,
                                            causal, scale, st, s);
  return launch_one<T, 256, REPRO_PASSES>(Q, K, V, O, B, H, rep, SQ, SKV, d, dv, kv_len,
                                          causal, scale, st, s);
}

}  // namespace

extern "C" {

// q (B, H, SQ, d), k (B, H/rep, SKV, d) and v (B, H/rep, SKV, dv) given by
// element strides (batch, head, seq; the last dim contiguous), all fp32 or
// all bf16; o (B, H, SQ, dv) fp32 with strides (batch, head, seq).  d, dv <=
// 256.  strides: q[3], k[3], v[3], o[3].
int repro_flash_attention(const void* Q, const void* K, const void* V, float* O, int B,
                          int H, int rep, int SQ, int SKV, int d, int dv, int kv_len,
                          int causal, float scale, int is_bf16, int passes,
                          const long long* strides, void* stream) {
  if (d < 1 || d > 256 || dv < 1 || dv > 256 || passes != REPRO_PASSES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_dmax<__nv_bfloat16>(Q, K, V, O, B, H, rep, SQ, SKV, d, dv, kv_len,
                                          causal, scale, strides, s)
              : launch_dmax<float>(Q, K, V, O, B, H, rep, SQ, SKV, d, dv, kv_len, causal,
                                   scale, strides, s);
  return static_cast<int>(err);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
