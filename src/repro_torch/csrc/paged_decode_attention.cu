// K1: paged one-token GQA flash decode.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// _paged_decode_attn_kernel (launched by paged_decode_attention_pallas).
//
// What it computes: for slot b and KV head h, the G = nh / nkv query heads
// of h attend one query token over the slot's cache rows [0, lengths[b]).
// Row p of the slot lives in page block_tables[b, p / ps] at offset p % ps.
// Scores are f32, scaled by hd^-0.5, optionally tanh-capped; rows at or past
// the length are masked; an online softmax gives [B, nh, hd] in q's dtype,
// normalised by max(l, 1e-30) as on the TPU.
//
// Bound on the H100: bytes.  Each slot's live K and V rows are read once
// (2 * len * nkv * hd * 2 B in bf16) against ~4 FLOPs per cached element,
// far below the ~295 FLOP/B where the tensor cores would bind.
//
// Design: one block of 4 warps per (slot, KV head), so a block owns the G
// query heads that share its K/V rows and reads each row once.  Where the
// TPU grid walked every virtual block of the table (the null page included)
// in order and masked, here the warps split the ceil(lengths[b] / ps) live
// pages round-robin and each warp keeps its own online-softmax state in
// registers: lanes split head_dim (hd / 32 columns each), a row's G scores
// are warp-shuffle sums, and rows past the length are skipped, never read.
// The four warps' (max, sum, accumulator) are merged once at the end
// through shared memory.  No barrier sits inside the page loop: an earlier
// version that synchronised the whole block three times per page measured
// ~0.3 ms at 8 slots x up to 512 rows on the H100, latency-bound.  G and
// hd / 32 are template parameters (G in {1, 2, 4, 8}, hd in {64, 128, 256})
// so the per-lane state stays in registers.  No tensor cores or split-KV
// across blocks yet.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1.0e30f;  // the TPU kernel's mask constant

template <typename T, int G, int D>  // D = hd / 32 columns per lane
__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const T* __restrict__ q,             // [B, nh, hd]
    const T* __restrict__ k_pages,       // [P, ps, nkv, hd]
    const T* __restrict__ v_pages,       // [P, ps, nkv, hd]
    const int* __restrict__ block_tables,  // [B, nblk]
    const int* __restrict__ lengths,     // [B]
    T* __restrict__ out,                 // [B, nh, hd]
    int nh, int nkv, int ps, int nblk, float scale, float logit_cap) {
  using repro::from_f;
  using repro::to_f;
  constexpr int hd = 32 * D;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // this lane's columns of the G query heads
  float qv[G][D];
  const T* q_b = q + ((size_t)b * nh + (size_t)h * G) * hd + lane * D;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < D; ++i) qv[g][i] = to_f(q_b[g * hd + i]);

  float m[G], l[G], acc[G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[g][i] = 0.f;
  }

  const int len = lengths[b];
  int n_pages = (len + ps - 1) / ps;
  if (n_pages > nblk) n_pages = nblk;
  const size_t row_stride = (size_t)nkv * hd;  // elements between page rows

  for (int j = warp; j < n_pages; j += kWarps) {
    const size_t page = (size_t)block_tables[(size_t)b * nblk + j];
    const T* k_pg = k_pages + page * ps * row_stride + (size_t)h * hd + lane * D;
    const T* v_pg = v_pages + page * ps * row_stride + (size_t)h * hd + lane * D;
    const int rows = min(ps, len - j * ps);  // live rows of this page
    for (int r = 0; r < rows; ++r) {
      float kr[D], vr[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        kr[i] = to_f(k_pg[r * row_stride + i]);
        vr[i] = to_f(v_pg[r * row_stride + i]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) part += qv[g][i] * kr[i];
        float s = repro::warp_sum(part) * scale;
        if (logit_cap > 0.f) s = logit_cap * tanhf(s / logit_cap);
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int i = 0; i < D; ++i) acc[g][i] = acc[g][i] * corr + p * vr[i];
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float m_s[kWarps][G], l_s[kWarps][G], a_s[kWarps][G][hd];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) a_s[warp][g][lane * D + i] = acc[g][i];
  }
  __syncthreads();
  T* o_b = out + ((size_t)b * nh + (size_t)h * G) * hd;
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd, d = idx % hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][g] - mx);  // 0 for a warp that saw no row
      num += a_s[w][g][d] * c;
      den += l_s[w][g] * c;
    }
    o_b[idx] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int G>
int launch_d(int hd, const dim3& grid, cudaStream_t st, const void* q, const void* k,
             const void* v, const int* bt, const int* lengths, void* out, int nh, int nkv,
             int ps, int nblk, float scale, float cap) {
#define REPRO_K1(D)                                                                      \
  paged_decode_attention_kernel<T, G, D><<<grid, kThreads, 0, st>>>(                     \
      (const T*)q, (const T*)k, (const T*)v, bt, lengths, (T*)out, nh, nkv, ps, nblk, scale, \
      cap)
  switch (hd) {
    case 64: REPRO_K1(2); break;
    case 128: REPRO_K1(4); break;
    case 256: REPRO_K1(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_K1
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int G, int hd, const dim3& grid, cudaStream_t st, const void* q, const void* k,
           const void* v, const int* bt, const int* lengths, void* out, int nh, int nkv, int ps,
           int nblk, float scale, float cap) {
  switch (G) {
    case 1: return launch_d<T, 1>(hd, grid, st, q, k, v, bt, lengths, out, nh, nkv, ps, nblk, scale, cap);
    case 2: return launch_d<T, 2>(hd, grid, st, q, k, v, bt, lengths, out, nh, nkv, ps, nblk, scale, cap);
    case 4: return launch_d<T, 4>(hd, grid, st, q, k, v, bt, lengths, out, nh, nkv, ps, nblk, scale, cap);
    case 8: return launch_d<T, 8>(hd, grid, st, q, k, v, bt, lengths, out, nh, nkv, ps, nblk, scale, cap);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

REPRO_EXPORT int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                        const int* block_tables, const int* lengths, void* out,
                                        int B, int nh, int nkv, int hd, int ps, int nblk,
                                        float scale, float logit_cap, int dtype, int device,
                                        void* stream) {
  REPRO_SET_DEVICE(device);
  const dim3 grid(B, nkv);
  cudaStream_t st = (cudaStream_t)stream;
  const int G = nh / nkv;
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(G, hd, grid, st, q, k_pages, v_pages, block_tables, lengths,
                                 out, nh, nkv, ps, nblk, scale, logit_cap);
  if (dtype == REPRO_F32)
    return launch<float>(G, hd, grid, st, q, k_pages, v_pages, block_tables, lengths, out, nh,
                         nkv, ps, nblk, scale, logit_cap);
  return (int)cudaErrorInvalidValue;
}
