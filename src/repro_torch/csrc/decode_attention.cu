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
// against ~4 FLOPs per cached element (G = 1 at dsv2-lite: 16 query heads
// over 16 KV heads), far below the ~295 FLOP/B where the tensor cores would
// bind, so no tensor cores: the work is to keep enough bytes in flight.
// Per row and head, K1 and K4 read 2 * hd bytes of K and again of V in
// bf16; K5 reads hd + 4 (int8 values plus the f32 scale).
//
// Design: one body (`attend`) for all three, parametrised by a row policy
// (where row p of slot b lives: a page of the block table, or the slot's
// contiguous rows) and a load policy (a row in the cache's dtype, or int8
// times its scale).  A block of 12 warps (fewer where G > 1) owns one range
// of the rows of a (slot, KV head) and the G query heads that share them,
// and reads each row once.  A lane loads D columns of a row as one vector, 16
// bytes (8 bf16 columns, 4 f32, 16 int8) where G is small (fewer for
// G >= 3, so that G * D values of q and the accumulator stay in registers;
// at least hd / 32), so a row takes hd / D lanes and one warp load covers
// 32 * D / hd rows (two bf16 rows of 128).  Each lane group of a row keeps
// its own online-softmax state in registers; a row's G scores are shuffle
// sums within the group.  Warps take the rows in chunks (a page for K1, 16
// rows for K4/K5) round-robin, group by group: a group is kUnroll rows a
// lane, loaded raw one group ahead of the one being folded in (one softmax
// update a group, as the TPU kernel does for each block of rows), so a
// warp always has a group in flight.  No barrier sits inside the loop; the
// lane groups' (max, sum, accumulator) are merged once at the end through
// shared memory.
//
// All three are split-KV (flash-decoding): a (B, nkv, n_split) grid,
// launched as (nkv, B, n_split) so that a slot's heads, which read the same
// rows of the cache, run side by side; block z walks chunks [z * cps,
// (z + 1) * cps) of the slot (pages for K1).  With n_split > 1 each block
// writes its unnormalised partial (m, l, acc[G, hd]) in f32 to a scratch the
// wrapper allocates, and a second small kernel merges a head's partials in
// split order (fixed, so results do not change from run to run) with the
// same math as the in-block merge.  A block whose range lies past the
// slot's length reads no row and writes the empty partial (m = -1e30, l = 0,
// acc = 0).  The wrapper picks n_split from B * nkv, the cache's rows (for
// K1 the block table's width times the page size) and the SM count, without
// reading the lengths: no split for S <= 512 (the serving cache, where the
// second launch costs more than the split saves), and at most ceil(S / 512)
// ranges beyond.
//
// K1 reads each page's id from the block table a chunk ahead of its rows,
// so a group's row loads wait only for memory, never behind that int32.
//
// K5 converts int8 to f32 without I2F, which issues at an eighth of the FMA
// rate on sm_90 and would take about what the memory allows: the byte,
// sign-flipped, becomes the low mantissa byte of 2^23 (one PRMT), and one
// FADD takes 2^23 + 128 off; the result is (float)v exactly for all 256
// values.  The row's scale multiplies its score once and its softmax weight
// once, not every element.  Rows hold 16 int8 columns a lane, and a group is
// as many rows as K4's, so a K5 warp keeps K4's bytes in flight.
//
// head_dim 80 (zamba2's shared attention block, 32 heads over 32 KV heads)
// is built for K4 and K5 at G = 1: a row of 80 columns splits over 8 lanes of
// 10 bf16 columns (16 of 5 f32, 4 of 20 int8), 20 bytes a lane at a 4-byte
// boundary, so a warp load covers 4 bf16 rows and the group sums stay
// shuffle trees; the in-block merge and the split layout (acc [.., hd], one
// thread a column) hold at any hd.  No path pages a head_dim-80 cache, so
// K1 keeps 64, 128 and 256.
//
// What the H100 showed (PERF.md §6): with one block per (slot, head) and
// rows loaded only after the last group was folded in, each warp's walk was
// a latency-bound chain (2.2 ms against a 0.64 ms bound at 8 x 32k rows).
// Keeping a group in flight removed the chain; the split fills the SMs that
// 32k contexts at the 1-8 slots one card holds beside dsv2-lite's weights
// leave idle.  K5's time at 8 x 32k went from 0.95 ms to 0.54 with the
// split, 0.49 with the PRMT conversion, 0.46 with K4's bytes in flight and
// 0.41 with 12 warps (bound 0.33).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kChunk = 16;            // contiguous rows a warp takes at a time (K4, K5)
constexpr float kNegInf = -1.0e30f;   // the TPU kernel's mask constant

// K5's int8 -> f32: the sign-flipped byte i of a word becomes the low byte
// of the f32 2^23 (selector kI8Sel + i), and the FADD of -(2^23 + 128)
// leaves v; tests/test_torch_kernels.py checks these constants on all 256
// byte values
constexpr uint32_t kI8Flip = 0x80808080u;
constexpr uint32_t kI8Magic = 0x4B000000u;
constexpr uint32_t kI8Sel = 0x7440u;
constexpr float kI8Bias = 8388736.0f;  // 2^23 + 128

enum { kPaged = 0, kContiguous = 1, kInt8 = 2 };

// The largest power of two <= n (n >= 1).
__host__ __device__ constexpr int floor_pow2(int n) { return n >= 2 ? 2 * floor_pow2(n / 2) : 1; }

// Columns a lane owns.  head_dim a power of two: 16 bytes of the cache's
// dtype, at least hd / 32 (a row fits one warp) and at most what keeps
// G * D per-lane values of q and the accumulator in registers.  The register
// share 16 / G is rounded down to a power of two (4 at G = 3, 2 at G = 7),
// so that D divides HD and a row's lanes are a power of two: the group sums
// are shuffle trees.  Any other head_dim (80: zamba2's shared block, G = 1):
// the fewest columns of at least a 16-byte vector that still split a row
// over a power of two of lanes, D = HD / 2^k (80 -> 10 bf16 columns over 8
// lanes, 5 f32 over 16, 20 int8 over 4).  Such a lane's 20 bytes sit at a
// 4-byte boundary and load as five 32-bit words (Vec's alignment).
__host__ __device__ constexpr bool is_pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

template <int G, int HD, int KvBytes>
__host__ __device__ constexpr int cols_per_lane() {
  constexpr int vec = 16 / KvBytes;
  if constexpr (is_pow2(HD)) {
    constexpr int regs = floor_pow2(16 / G);
    constexpr int d = vec < regs ? vec : regs;
    return d > HD / 32 ? d : HD / 32;
  } else {
    int d = HD;
    while (d % 2 == 0 && d / 2 >= vec) d /= 2;
    return d;
  }
}

// Warps per block: 12 at G = 1 (dsv2-lite's shape), where the launch bound
// of 384 threads caps an instance at 168 registers, which they fit without
// spilling (ptxas -v), so one block fills an SM's register file; 8 above,
// or 4 where G * D is so large that the merge's shared arrays (warps * G *
// 32 * D floats) would pass 48 KB (G = 8 or 7 at hd = 256; G = 7 at hd 128
// keeps 8 warps and 28 KB).  At G = 1 the 12
// warps shorten each warp's walk over a serving slot's rows and keep half
// as many bytes again in flight as 8 at long context.
template <int G, int D>
__host__ __device__ constexpr int warps_for() {
  return G == 1 ? 12 : (G * D <= 32 ? 8 : 4);
}

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
  float* part;          // with n_split > 1: partials, laid out as ml_offset says
  int nh, nkv;
  int rows;             // K1: nblk (table entries per slot); K4/K5: S
  int ps;               // K1: page size
  int chunks_per_split;  // chunks (K1: pages; K4/K5: 16 rows) a block walks
  float scale, logit_cap;
};

// The largest power of two dividing n (n >= 1).
__host__ __device__ constexpr int low_pow2(int n) { return n & -n; }

// D consecutive values of one lane's columns of a row, loaded as one
// vector (as words of its alignment, the largest power of two dividing its
// size: all of it for a power-of-two head_dim, 4 bytes at head_dim 80): the
// wrapper checks that the cache is aligned to 32 bytes.
template <typename T, int D>
struct alignas(low_pow2(sizeof(T) * D)) Vec {
  T v[D];
};

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

// ---- load policies: this lane's D columns of K and V of one row, loaded
// raw (`Raw`, in the cache's dtype, so a row in flight holds few registers)
// and read as f32 by kf / vf where the loop uses them; a scaled load's row
// scales (ks, vs) multiply the row's score and its softmax weight.
// kRawRegs counts the registers of a row's K and V values.
template <typename T, int D>
struct PlainLoad {  // K1, K4: K and V in q's dtype
  struct Raw {
    Vec<T, D> k, v;
  };
  static constexpr int kRawRegs = 2 * D * (int)sizeof(T) / 4;
  const T* k;       // offset to this head and lane's columns
  const T* v;
  size_t row_stride;  // nkv * hd
  __device__ __forceinline__ void operator()(size_t row, Raw& x) const {
    x.k = *reinterpret_cast<const Vec<T, D>*>(k + row * row_stride);
    x.v = *reinterpret_cast<const Vec<T, D>*>(v + row * row_stride);
  }
  __device__ __forceinline__ static float kf(const Raw& x, int i) { return repro::to_f(x.k.v[i]); }
  __device__ __forceinline__ static float vf(const Raw& x, int i) { return repro::to_f(x.v.v[i]); }
  __device__ __forceinline__ static float ks(const Raw&) { return 1.f; }  // x * 1.f folds away
  __device__ __forceinline__ static float vs(const Raw&) { return 1.f; }
};

// D int8 values as words: 4 a word (D a multiple of 4: 16 at a power-of-two
// head_dim, 20 at 80), or one 16-bit word where D = 2
template <int D>
using I8Words = Vec<typename std::conditional<(D >= 4), uint32_t, uint16_t>::type,
                    D >= 4 ? D / 4 : 1>;

// (float)v of int8 column i of x, by kI8Flip / kI8Magic / kI8Sel / kI8Bias
template <int D>
__device__ __forceinline__ float i8_to_f(const I8Words<D>& x, int i) {
  const uint32_t w = x.v[i / 4] ^ kI8Flip;
  return __uint_as_float(__byte_perm(w, kI8Magic, kI8Sel + (i & 3))) - kI8Bias;
}

template <int D>
struct Int8Load {  // K5: int8 values; the f32 scale of (row, head) apart
  struct Raw {
    I8Words<D> k, v;
    float ks, vs;
  };
  static constexpr int kRawRegs = D >= 4 ? 2 * D / 4 : 2;
  const int8_t* k;  // offset to this head and lane's columns
  const int8_t* v;
  const float* k_scale;  // offset to this head
  const float* v_scale;
  size_t row_stride;  // nkv * hd
  int nkv;
  __device__ __forceinline__ void operator()(size_t row, Raw& x) const {
    x.k = *reinterpret_cast<const I8Words<D>*>(k + row * row_stride);
    x.v = *reinterpret_cast<const I8Words<D>*>(v + row * row_stride);
    x.ks = k_scale[row * nkv];
    x.vs = v_scale[row * nkv];
  }
  __device__ __forceinline__ static float kf(const Raw& x, int i) { return i8_to_f<D>(x.k, i); }
  __device__ __forceinline__ static float vf(const Raw& x, int i) { return i8_to_f<D>(x.v, i); }
  __device__ __forceinline__ static float ks(const Raw& x) { return x.ks; }
  __device__ __forceinline__ static float vs(const Raw& x) { return x.vs; }
};

// The partials for B * nh heads and n_split ranges: acc [B * nh, n_split,
// hd], then (m, l) [B * nh, n_split, 2], all f32.
__host__ __device__ __forceinline__ size_t ml_offset(size_t heads, int n_split, int hd) {
  return heads * n_split * hd;
}

// The shared body: slot b, KV head h, chunks [j0, j1) of rows [0, len)
// found by `rows` and read by `load`.  T is q's (and the output's) dtype.
// Writes the normalised output, or (a.part set) block z's partial.
template <typename T, int G, int HD, int D, typename Rows, typename Load>
__device__ __forceinline__ void attend(const Args& a, int b, int h, int len, int j0, int j1,
                                       int z, const Rows& rows, const Load& load) {
  constexpr int kWarps = warps_for<G, D>();
  constexpr int kLanesPerRow = HD / D;
  constexpr int kRowsPerLoad = 32 / kLanesPerRow;  // rows one warp load covers
  constexpr int kGroups = kWarps * kRowsPerLoad;   // lane groups with their own state
  // rows a lane loads, then folds in with one softmax update: as many as
  // fit a register budget for the raw rows (two groups are in flight),
  // smaller where G * D values of q and the accumulator already hold many,
  // and no more than a 16-row chunk holds
  constexpr int kBudget = G * D > 16 ? 16 : 32;
  constexpr int kFit = kBudget / Load::kRawRegs;
  constexpr int kByRegs = kFit >= 8 ? 8 : (kFit >= 4 ? 4 : (kFit >= 2 ? 2 : 1));
  constexpr int kByChunk = kChunk / kRowsPerLoad > 0 ? kChunk / kRowsPerLoad : 1;
  constexpr int kUnroll = kByRegs < kByChunk ? kByRegs : kByChunk;
  constexpr int kStep = kUnroll * kRowsPerLoad;  // rows of a group
  using Raw = typename Load::Raw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / kLanesPerRow;  // this lane's row within a warp load
  const int col = (lane % kLanesPerRow) * D;
  const int grp = warp * kRowsPerLoad + sub;

  // this lane's columns of the G query heads
  float qv[G][D];
  const T* q_b = (const T*)a.q + ((size_t)b * a.nh + (size_t)h * G) * HD + col;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < D; ++i) qv[g][i] = repro::to_f(q_b[g * HD + i]);

  float m[G], l[G], acc[G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[g][i] = 0.f;
  }

  const int C = rows.chunk();
  const int j_end = min(j1, (len + C - 1) / C);
  auto live = [&](int j) { return min(C, len - j * C); };  // live rows of chunk j
  // rows [r, r + kStep) of the chunk whose first row is r0 and whose first
  // n rows are live; each lane loads its rows
  auto fetch = [&](size_t r0, int n, int r, Raw (&x)[kUnroll], bool (&ok)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kRowsPerLoad + sub;
      ok[u] = row < n;  // the same for every lane of the row's group
      if (ok[u]) load(r0 + row, x[u]);
    }
  };
  // The warp walks chunks j0 + warp, + kWarps, ... group by group, and
  // loads the next group before it folds in the current one.  The first row
  // of its next chunk is found a chunk ahead (K1: a load of the block table).
  Raw cur[kUnroll], nxt[kUnroll];
  bool ok_cur[kUnroll], ok_nxt[kUnroll];
  int j = j0 + warp, r = 0;
  size_t base = 0, base_next = 0;
  if (j < j_end) base = rows.first_row(j);
  if (j + kWarps < j_end) base_next = rows.first_row(j + kWarps);
  if (j < j_end) fetch(base, live(j), r, cur, ok_cur);
  while (j < j_end) {
    int jn = j, rn = r + kStep;
    size_t bn = base;
    if (rn >= live(j)) {
      jn += kWarps;
      rn = 0;
      bn = base_next;
      if (jn + kWarps < j_end) base_next = rows.first_row(jn + kWarps);
    }
    if (jn < j_end) fetch(bn, live(jn), rn, nxt, ok_nxt);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // the rows' scores: independent dot products and group sums,
      // interleaved so that their shuffles overlap
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) s[u] += qv[g][i] * Load::kf(cur[u], i);
      }
#pragma unroll
      for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      // one online-softmax update for the rows, as the TPU kernel does for
      // each of its blocks
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] *= Load::ks(cur[u]) * a.scale;
        if (a.logit_cap > 0.f) s[u] = a.logit_cap * tanhf(s[u] / a.logit_cap);
        if (ok_cur[u]) m_new = fmaxf(m_new, s[u]);
      }
      const float corr = expf(m[g] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok_cur[u]) {  // rows past the chunk were not loaded
          const float p = expf(s[u] - m_new);
          p_sum += p;
          const float pv = p * Load::vs(cur[u]);
#pragma unroll
          for (int i = 0; i < D; ++i) acc[g][i] += pv * Load::vf(cur[u], i);
        }
      }
      l[g] = l[g] * corr + p_sum;
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cur[u] = nxt[u];
      ok_cur[u] = ok_nxt[u];
    }
    j = jn;
    r = rn;
    base = bn;
  }

  // merge the lane groups' softmax states
  __shared__ float m_s[kGroups][G], l_s[kGroups][G], a_s[kGroups][G][HD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (col == 0) {
      m_s[grp][g] = m[g];
      l_s[grp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) a_s[grp][g][col + i] = acc[g][i];
  }
  __syncthreads();
  const size_t head0 = (size_t)b * a.nh + (size_t)h * G;  // first of the G heads
  for (int idx = threadIdx.x; idx < G * HD; idx += 32 * kWarps) {
    const int g = idx / HD, d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) mx = fmaxf(mx, m_s[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) {
      const float c = expf(m_s[w][g] - mx);  // 0 for a group that saw no row
      num += a_s[w][g][d] * c;
      den += l_s[w][g] * c;
    }
    if (a.part == nullptr) {
      ((T*)a.out)[head0 * HD + idx] = repro::from_f<T>(num / fmaxf(den, 1e-30f));
    } else {  // split z: the unnormalised partial
      const int n_split = gridDim.z;
      const size_t hz = (head0 + g) * n_split + z;
      a.part[hz * HD + d] = num;
      if (d == 0) {
        float* ml = a.part + ml_offset((size_t)gridDim.y * a.nh, n_split, HD) + hz * 2;
        ml[0] = mx;
        ml[1] = den;
      }
    }
  }
}

template <int Kind, typename T>
using kv_t = typename std::conditional<Kind == kInt8, int8_t, T>::type;

template <int Kind, typename T, int G, int HD>
__host__ __device__ constexpr int threads_for() {
  return 32 * warps_for<G, cols_per_lane<G, HD, sizeof(kv_t<Kind, T>)>()>();
}

// grid (nkv, B, n_split), threads_for<...>() threads; T is q's dtype
template <int Kind, typename T, int G, int HD>
__global__ void __launch_bounds__(threads_for<Kind, T, G, HD>()) decode_attention_kernel(
    const Args a) {
  constexpr int D = cols_per_lane<G, HD, sizeof(kv_t<Kind, T>)>();
  constexpr int kLanesPerRow = HD / D;
  const int h = blockIdx.x;  // a slot's heads launch side by side and read
  const int b = blockIdx.y;  // the same rows of the cache together
  const int z = blockIdx.z;
  const int j0 = z * a.chunks_per_split, j1 = j0 + a.chunks_per_split;
  const size_t col = (size_t)h * HD + (threadIdx.x & 31) % kLanesPerRow * D;  // lane's columns
  const size_t row_stride = (size_t)a.nkv * HD;
  if constexpr (Kind == kPaged) {
    const int len = min(a.lengths[b], a.rows * a.ps);
    const PagedRows rows{a.block_tables + (size_t)b * a.rows, a.ps};
    const PlainLoad<T, D> load{(const T*)a.k + col, (const T*)a.v + col, row_stride};
    attend<T, G, HD, D>(a, b, h, len, j0, j1, z, rows, load);
  } else if constexpr (Kind == kContiguous) {
    const int len = min(a.lengths[b], a.rows);
    const ContiguousRows rows{(size_t)b * a.rows};
    const PlainLoad<T, D> load{(const T*)a.k + col, (const T*)a.v + col, row_stride};
    attend<T, G, HD, D>(a, b, h, len, j0, j1, z, rows, load);
  } else {
    const int len = min(a.lengths[b], a.rows);
    const ContiguousRows rows{(size_t)b * a.rows};
    const Int8Load<D> load{(const int8_t*)a.k + col, (const int8_t*)a.v + col, a.k_scale + h,
                           a.v_scale + h, row_stride, a.nkv};
    attend<T, G, HD, D>(a, b, h, len, j0, j1, z, rows, load);
  }
}

// The second pass of a split launch: grid (B * nh), hd threads; out = the
// partials of one head merged in split order and normalised, as the
// in-block merge does.
template <typename T>
__global__ void merge_splits_kernel(const float* __restrict__ part, T* __restrict__ out,
                                    int n_split, int hd) {
  const size_t head = blockIdx.x;
  const int d = threadIdx.x;
  const float* acc = part + head * n_split * hd + d;
  const float* ml = part + ml_offset(gridDim.x, n_split, hd) + head * n_split * 2;
  float mx = kNegInf;
  for (int z = 0; z < n_split; ++z) mx = fmaxf(mx, ml[2 * z]);
  float num = 0.f, den = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float c = expf(ml[2 * z] - mx);  // 0 for a range past the length
    num += acc[(size_t)z * hd] * c;
    den += ml[2 * z + 1] * c;
  }
  out[head * hd + d] = repro::from_f<T>(num / fmaxf(den, 1e-30f));
}

template <int Kind, typename T, int G, int HD>
void launch_one(const dim3& grid, cudaStream_t st, const Args& a) {
  decode_attention_kernel<Kind, T, G, HD><<<grid, threads_for<Kind, T, G, HD>(), 0, st>>>(a);
}

// head_dim 80 is built for K4 and K5 at G = 1 only (zamba2's shared block,
// 32 heads over 32, contiguous caches); the wrapper refuses the rest
template <int Kind, typename T, int G>
int launch_d(int hd, const dim3& grid, cudaStream_t st, const Args& a) {
  switch (hd) {
    case 64: launch_one<Kind, T, G, 64>(grid, st, a); break;
    case 80:
      if constexpr (G == 1 && Kind != kPaged) {
        launch_one<Kind, T, G, 80>(grid, st, a);
        break;
      } else {
        return (int)cudaErrorInvalidValue;
      }
    case 128: launch_one<Kind, T, G, 128>(grid, st, a); break;
    case 256: launch_one<Kind, T, G, 256>(grid, st, a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int Kind, typename T>
int launch_g(int hd, const dim3& grid, cudaStream_t st, const Args& a) {
  switch (a.nh / a.nkv) {
    case 1: return launch_d<Kind, T, 1>(hd, grid, st, a);
    case 2: return launch_d<Kind, T, 2>(hd, grid, st, a);
    case 3: return launch_d<Kind, T, 3>(hd, grid, st, a);
    case 4: return launch_d<Kind, T, 4>(hd, grid, st, a);
    case 7: return launch_d<Kind, T, 7>(hd, grid, st, a);
    case 8: return launch_d<Kind, T, 8>(hd, grid, st, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int Kind, typename T>
int launch_t(int B, int hd, int n_split, cudaStream_t st, const Args& a) {
  const int err = launch_g<Kind, T>(hd, dim3(a.nkv, B, n_split), st, a);
  if (err || n_split == 1) return err;
  merge_splits_kernel<T><<<B * a.nh, hd, 0, st>>>(a.part, (T*)a.out, n_split, hd);
  return (int)cudaGetLastError();
}

template <int Kind>
int launch(int dtype, int B, int hd, int n_split, int device, void* stream, Args a) {
  REPRO_SET_DEVICE(device);
  if (n_split < 1 || a.chunks_per_split < 1 || (n_split > 1 && a.part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_split == 1) a.part = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == REPRO_BF16) return launch_t<Kind, __nv_bfloat16>(B, hd, n_split, st, a);
  if (dtype == REPRO_F32) return launch_t<Kind, float>(B, hd, n_split, st, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each launcher takes n_split ranges of chunks_per_split chunks (K1: pages,
// K4/K5: 16 rows) and, with n_split > 1, an f32 scratch `part` of
// B * nh * n_split * (hd + 2) floats.

// K1: q [B, nh, hd], page pools [P, ps, nkv, hd] in q's dtype, block tables
// [B, nblk] and lengths [B] int32.
REPRO_EXPORT int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                        const int* block_tables, const int* lengths, void* out,
                                        float* part, int B, int nh, int nkv, int hd, int ps,
                                        int nblk, int n_split, int chunks_per_split, float scale,
                                        float logit_cap, int dtype, int device, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths, out, part,
               nh, nkv, nblk, ps, chunks_per_split, scale, logit_cap};
  return launch<kPaged>(dtype, B, hd, n_split, device, stream, a);
}

// K4: q [B, nh, hd], caches [B, S, nkv, hd] in q's dtype, lengths [B] int32.
REPRO_EXPORT int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                  const int* lengths, void* out, float* part, int B, int nh,
                                  int nkv, int hd, int S, int n_split, int chunks_per_split,
                                  float scale, float logit_cap, int dtype, int device,
                                  void* stream) {
  const Args a{q, k_cache, v_cache, nullptr, nullptr, nullptr, lengths, out, part,
               nh, nkv, S, 0, chunks_per_split, scale, logit_cap};
  return launch<kContiguous>(dtype, B, hd, n_split, device, stream, a);
}

// K5: q [B, nh, hd], int8 caches [B, S, nkv, hd], f32 scales [B, S, nkv],
// lengths [B] int32; the output is in q's dtype.
REPRO_EXPORT int decode_attention_int8(const void* q, const void* k_cache, const void* v_cache,
                                       const float* k_scale, const float* v_scale,
                                       const int* lengths, void* out, float* part, int B, int nh,
                                       int nkv, int hd, int S, int n_split, int chunks_per_split,
                                       float scale, float logit_cap, int dtype, int device,
                                       void* stream) {
  const Args a{q, k_cache, v_cache, k_scale, v_scale, nullptr, lengths, out, part,
               nh, nkv, S, 0, chunks_per_split, scale, logit_cap};
  return launch<kInt8>(dtype, B, hd, n_split, device, stream, a);
}
