// One-token GQA flash decode over a KV cache: K1, K4 and K5.
//
// Replaces the TPU kernels of src/repro/kernels/decode_attention/kernel.py:
//   K1 _paged_decode_attn_kernel (paged_decode_attention_pallas): rows are
//      reached through a per-slot block table of pages [P, ps, nkv, hd];
//   K4 _decode_attn_kernel (decode_attention_pallas): rows of a contiguous
//      cache [B, S, nkv, hd] in q's dtype;
//   K5 _decode_attn_int8_kernel (decode_attention_int8_pallas): K4 over an
//      int8 cache, each row and head dequantised by its f32 scale
//      ([B, S, nkv]) inside the loop.
//
// What each computes: for slot b and KV head h, the G = nh / nkv query heads
// of h attend one query token over the slot's rows [0, lengths[b]).  Scores
// are f32, scaled by hd^-0.5, optionally tanh-capped; rows at or past the
// length are masked (never read); an online softmax gives [B, nh, hd] in
// q's dtype, normalised by max(l, 1e-30) as on the TPU.  K4 and K5 take the
// reference's scalar valid_len as per-slot lengths (the wrapper broadcasts a
// scalar), which is what the engine's per-slot positions need.  K5 keeps
// the dequantised rows in f32, as the TPU kernel does (kernel.py:102-103);
// the reference's oracle rounds them to q's dtype first.
//
// Bound on the H100: bytes.  Each live K and V row of a head is read once
// against ~4 FLOPs per cached element, far below the ~295 FLOP/B where the
// tensor cores would bind.  Per row and head, K1 and K4 read 2 * hd bytes of
// K and again of V in bf16; K5 reads hd + 4 (int8 values plus the f32
// scale), so its bound is about half of K4's.
//
// Design: one body (`attend`) for all three, parametrised by a row policy
// (where row p of slot b lives: a page of the block table, or the slot's
// contiguous rows) and a load policy (a row in q's dtype, or int8 times its
// scale).  The three kernels share it, so a fix or a speed-up of the loop
// reaches all of them; each keeps its own C launcher, Python wrapper and
// launch count.  One block per (slot, KV head) owns the G query heads that
// share its K/V rows and reads each row once.  Its warps split the live rows
// in chunks (a page for K1, 16 rows for K4/K5) round-robin and keep their
// own online-softmax state in registers: lanes split head_dim (hd / 32
// columns each, one vector load per row), a row's G scores are
// warp-shuffle sums.  Each warp loads a group of kUnroll rows at once,
// computes the group's scores with interleaved shuffles and folds the group
// in with one online-softmax update (max over the group, one rescale), as
// the TPU kernel does for each block of rows.  No barrier sits inside the
// loop; the warps' (max, sum, accumulator) are merged once at the end
// through shared memory.  G and hd / 32 are template parameters (G in
// {1, 2, 4, 8}, hd in {64, 128, 256}) so the per-lane state stays in
// registers.
//
// What the H100 showed (8 slots, 16 KV heads of 128, bf16): a warp's walk
// over its rows is a latency-bound chain, and with one block per SM the
// time goes with the rows per warp.  Updating row by row with 4 warps took
// 4.8 ms at 32768 rows a slot (bound 0.64 ms); group updates 4.3 ms;
// 16 rows in flight instead of 8, 4.0 ms; 8 warps a block instead of 4,
// 2.2 ms, and half the time at the serving shape too.  So blocks have 8
// warps.  No tensor cores and no split-KV across blocks yet: at batch 8 and
// 16 KV heads there are 128 blocks, fewer than the 132 SMs, and each walks
// its slot's whole context alone, so long contexts stay well below the
// memory rate.
#include "common.cuh"

namespace {

// Warps per block: 8, or 4 where G * hd is so large that the merge's
// shared arrays (warps * G * hd floats) would pass the 48 KB of static
// shared memory (G = 8, hd = 256).
template <int G, int D>
__host__ __device__ constexpr int warps_for() {
  return G * D <= 32 ? 8 : 4;
}
constexpr int kChunk = 16;            // contiguous rows a warp takes at a time (K4, K5)
constexpr float kNegInf = -1.0e30f;   // the TPU kernel's mask constant

enum { kPaged = 0, kContiguous = 1, kInt8 = 2 };

// Every launcher's arguments; a kernel reads the fields of its kind.
struct Args {
  const void* q;        // [B, nh, hd]
  const void* k;        // K1: pages [P, ps, nkv, hd]; K4/K5: [B, S, nkv, hd]
  const void* v;
  const float* k_scale;  // K5: [B, S, nkv]
  const float* v_scale;
  const int* block_tables;  // K1: [B, nblk]
  const int* lengths;   // [B]
  void* out;            // [B, nh, hd]
  int nh, nkv;
  int rows;             // K1: nblk (table entries per slot); K4/K5: S
  int ps;               // K1: page size
  float scale, logit_cap;
};

// D consecutive values at p (one lane's columns of a row), as f32, in one
// vector load: the wrapper checks that the cache is aligned to 32 bytes.
template <typename T, int D>
struct alignas(sizeof(T) * D) Vec {
  T v[D];
};

template <typename T, int D>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[D]) {
  const Vec<T, D> x = *reinterpret_cast<const Vec<T, D>*>(p);
#pragma unroll
  for (int i = 0; i < D; ++i) out[i] = repro::to_f(x.v[i]);
}

// ---- row policies: the global row index (into [rows, nkv, hd]) of the
// first row of chunk j of this block's slot; a chunk's rows are consecutive.
struct PagedRows {  // K1: chunk j is page block_tables[b, j]
  const int* table;  // the slot's row of the block table
  int ps;
  __device__ __forceinline__ int chunk() const { return ps; }
  __device__ __forceinline__ size_t first_row(int j) const { return (size_t)table[j] * ps; }
};

struct ContiguousRows {  // K4, K5: row p of slot b is row b * S + p
  size_t base;
  __device__ __forceinline__ int chunk() const { return kChunk; }
  __device__ __forceinline__ size_t first_row(int j) const { return base + (size_t)j * kChunk; }
};

// ---- load policies: this lane's D columns of K and V of one row, in f32.
template <typename T, int D>
struct PlainLoad {  // K1, K4: K and V in q's dtype
  const T* k;       // offset to this head and lane's columns
  const T* v;
  size_t row_stride;  // nkv * hd
  __device__ __forceinline__ void operator()(size_t row, float (&kr)[D], float (&vr)[D]) const {
    load_f32<T, D>(k + row * row_stride, kr);
    load_f32<T, D>(v + row * row_stride, vr);
  }
};

template <int D>
struct Int8Load {  // K5: int8 values times the f32 scale of (row, head)
  const int8_t* k;  // offset to this head and lane's columns
  const int8_t* v;
  const float* ks;  // offset to this head
  const float* vs;
  size_t row_stride;  // nkv * hd
  int nkv;
  __device__ __forceinline__ void operator()(size_t row, float (&kr)[D], float (&vr)[D]) const {
    load_f32<int8_t, D>(k + row * row_stride, kr);
    load_f32<int8_t, D>(v + row * row_stride, vr);
    const float a = ks[row * nkv], c = vs[row * nkv];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      kr[i] *= a;
      vr[i] *= c;
    }
  }
};

// The shared body: slot b, KV head h, rows [0, len) found by `rows` and read
// by `load`.  T is q's (and the output's) dtype.
template <typename T, int G, int D, typename Rows, typename Load>
__device__ __forceinline__ void attend(const Args& a, int b, int h, int len, const Rows& rows,
                                       const Load& load) {
  constexpr int hd = 32 * D;
  constexpr int kWarps = warps_for<G, D>();
  // rows a warp loads, then folds in with one softmax update; fewer where
  // G * D per-lane values of q and the accumulator already hold registers
  constexpr int kUnroll = G * D <= 8 ? 8 : (G * D <= 16 ? 4 : 2);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // this lane's columns of the G query heads
  float qv[G][D];
  const T* q_b = (const T*)a.q + ((size_t)b * a.nh + (size_t)h * G) * hd + lane * D;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < D; ++i) qv[g][i] = repro::to_f(q_b[g * hd + i]);

  float m[G], l[G], acc[G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[g][i] = 0.f;
  }

  const int C = rows.chunk();
  const int n_chunks = (len + C - 1) / C;
  for (int j = warp; j < n_chunks; j += kWarps) {
    const size_t r0 = rows.first_row(j);
    const int live = min(C, len - j * C);  // live rows of this chunk
    for (int r = 0; r < live; r += kUnroll) {
      const int n = min(kUnroll, live - r);  // rows of this group
      float kr[kUnroll][D], vr[kUnroll][D];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (u < n) load(r0 + r + u, kr[u], vr[u]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // the group's scores: independent dot products and warp sums,
        // interleaved so that their shuffles overlap
        float s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[u] = 0.f;
#pragma unroll
          for (int i = 0; i < D; ++i) s[u] += qv[g][i] * kr[u][i];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
        // one online-softmax update for the group, as the TPU kernel does
        // for each of its blocks
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[u] *= a.scale;
          if (a.logit_cap > 0.f) s[u] = a.logit_cap * tanhf(s[u] / a.logit_cap);
          if (u < n) m_new = fmaxf(m_new, s[u]);
        }
        const float corr = expf(m[g] - m_new);
        float p_sum = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) acc[g][i] *= corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u < n) {  // rows past the chunk were not loaded
            const float p = expf(s[u] - m_new);
            p_sum += p;
#pragma unroll
            for (int i = 0; i < D; ++i) acc[g][i] += p * vr[u][i];
          }
        }
        l[g] = l[g] * corr + p_sum;
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
  T* o_b = (T*)a.out + ((size_t)b * a.nh + (size_t)h * G) * hd;
  for (int idx = threadIdx.x; idx < G * hd; idx += 32 * kWarps) {
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
    o_b[idx] = repro::from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

// grid (B, nkv), 32 * warps_for<G, D>() threads; T is q's dtype
template <int Kind, typename T, int G, int D>
__global__ void __launch_bounds__(32 * warps_for<G, D>()) decode_attention_kernel(const Args a) {
  constexpr int hd = 32 * D;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t col = (size_t)h * hd + (threadIdx.x & 31) * D;  // this lane's columns
  const size_t row_stride = (size_t)a.nkv * hd;
  if constexpr (Kind == kPaged) {
    const int len = min(a.lengths[b], a.rows * a.ps);
    const PagedRows rows{a.block_tables + (size_t)b * a.rows, a.ps};
    const PlainLoad<T, D> load{(const T*)a.k + col, (const T*)a.v + col, row_stride};
    attend<T, G, D>(a, b, h, len, rows, load);
  } else if constexpr (Kind == kContiguous) {
    const int len = min(a.lengths[b], a.rows);
    const ContiguousRows rows{(size_t)b * a.rows};
    const PlainLoad<T, D> load{(const T*)a.k + col, (const T*)a.v + col, row_stride};
    attend<T, G, D>(a, b, h, len, rows, load);
  } else {
    const int len = min(a.lengths[b], a.rows);
    const ContiguousRows rows{(size_t)b * a.rows};
    const Int8Load<D> load{(const int8_t*)a.k + col, (const int8_t*)a.v + col, a.k_scale + h,
                           a.v_scale + h, row_stride, a.nkv};
    attend<T, G, D>(a, b, h, len, rows, load);
  }
}

template <int Kind, typename T, int G, int D>
void launch_one(const dim3& grid, cudaStream_t st, const Args& a) {
  decode_attention_kernel<Kind, T, G, D><<<grid, 32 * warps_for<G, D>(), 0, st>>>(a);
}

template <int Kind, typename T, int G>
int launch_d(int hd, const dim3& grid, cudaStream_t st, const Args& a) {
  switch (hd) {
    case 64: launch_one<Kind, T, G, 2>(grid, st, a); break;
    case 128: launch_one<Kind, T, G, 4>(grid, st, a); break;
    case 256: launch_one<Kind, T, G, 8>(grid, st, a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int Kind, typename T>
int launch_g(int hd, const dim3& grid, cudaStream_t st, const Args& a) {
  switch (a.nh / a.nkv) {
    case 1: return launch_d<Kind, T, 1>(hd, grid, st, a);
    case 2: return launch_d<Kind, T, 2>(hd, grid, st, a);
    case 4: return launch_d<Kind, T, 4>(hd, grid, st, a);
    case 8: return launch_d<Kind, T, 8>(hd, grid, st, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int Kind>
int launch(int dtype, int B, int hd, int device, void* stream, const Args& a) {
  REPRO_SET_DEVICE(device);
  const dim3 grid(B, a.nkv);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == REPRO_BF16) return launch_g<Kind, __nv_bfloat16>(hd, grid, st, a);
  if (dtype == REPRO_F32) return launch_g<Kind, float>(hd, grid, st, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1: q [B, nh, hd], page pools [P, ps, nkv, hd] in q's dtype, block tables
// [B, nblk] and lengths [B] int32.
REPRO_EXPORT int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                        const int* block_tables, const int* lengths, void* out,
                                        int B, int nh, int nkv, int hd, int ps, int nblk,
                                        float scale, float logit_cap, int dtype, int device,
                                        void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths, out,
               nh, nkv, nblk, ps, scale, logit_cap};
  return launch<kPaged>(dtype, B, hd, device, stream, a);
}

// K4: q [B, nh, hd], caches [B, S, nkv, hd] in q's dtype, lengths [B] int32.
REPRO_EXPORT int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                  const int* lengths, void* out, int B, int nh, int nkv, int hd,
                                  int S, float scale, float logit_cap, int dtype, int device,
                                  void* stream) {
  const Args a{q, k_cache, v_cache, nullptr, nullptr, nullptr, lengths, out,
               nh, nkv, S, 0, scale, logit_cap};
  return launch<kContiguous>(dtype, B, hd, device, stream, a);
}

// K5: q [B, nh, hd], int8 caches [B, S, nkv, hd], f32 scales [B, S, nkv],
// lengths [B] int32; the output is in q's dtype.
REPRO_EXPORT int decode_attention_int8(const void* q, const void* k_cache, const void* v_cache,
                                       const float* k_scale, const float* v_scale,
                                       const int* lengths, void* out, int B, int nh, int nkv,
                                       int hd, int S, float scale, float logit_cap, int dtype,
                                       int device, void* stream) {
  const Args a{q, k_cache, v_cache, k_scale, v_scale, nullptr, lengths, out,
               nh, nkv, S, 0, scale, logit_cap};
  return launch<kInt8>(dtype, B, hd, device, stream, a);
}
