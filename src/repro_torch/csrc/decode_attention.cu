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
// length are masked; an online softmax gives [B, nh, hd] in q's dtype,
// normalised by max(l, 1e-30) as on the TPU.  K4 and K5 take the
// reference's scalar valid_len as per-slot lengths (the wrapper broadcasts a
// scalar), which is what the engine's per-slot positions need.  K5 keeps
// the dequantised rows in f32, as the TPU kernel does (kernel.py:102-103);
// the reference's oracle rounds them to q's dtype first.
//
// Bound on the H100: bytes.  Each live K and V row of a head is read once
// against ~4 G FLOPs per cached element (G <= 8), far below the ~295 FLOP/B
// where the tensor cores would bind, so the work is to keep the memory busy
// and the arithmetic off the critical path.  Per row and head, K1 and K4
// read 2 * hd bytes of K and again of V in bf16; K5 reads hd + 4 (int8
// values plus the f32 scale).
//
// Two bodies.  In bf16 at G >= 2 all three run the Hopper body (`tc`,
// below the other; ops.py k1_body and decode_body name the shapes); G = 1,
// float32 (which the parity phases hold to the CPU at 1e-5) and K4/K5 at
// head_dim 80 run `attend`, on CUDA cores.
//
// The Hopper body.  Grid (nkv, B, n_split), one block a range of a slot's
// chunks and one KV head (ops.py k1_plan, decode_plan).  A chunk is a page
// of K1's block table, or for K4 and K5 R = TC_CHUNK_BYTES / (hd * the
// cache's bytes a value) rows of the slot (ops.py tc_rows: 16-64, int8 at
// least 32): the
// contiguous cache [B, S, nkv, hd] is read as K1's pool [B * S, nkv, hd]
// with an implicit block table, chunk j of slot b at row b * S + j * R; a
// slot's last chunk runs into the next slot's rows (masked: they lie past
// the length) or past the cache, where TMA fills zeros.  The ranges are
// planned from S (K1: the table's width), never from the lengths.
//   * A producer warp (K1: reading the range's block-table entries beside
//     the slot's length) has one lane load each chunk's K and V rows of head
//     h by TMA into a ring of stages under full / empty mbarriers: the
//     caches are [rows, nkv, hd] tensor maps (csrc/tma.cuh, cached per
//     address and shape), a box is 128 bytes x 1 head x ps rows with the
//     128-byte swizzle (64 bf16 or 128 int8 columns; int8 at head_dim 64:
//     64 bytes, the 64-byte swizzle), so ldmatrix (or K5's 16-byte loads)
//     reads 8 rows of a column block without bank conflicts.  K1's pages
//     smaller than 16 rows pad a stage to one 16-row tile, their pad rows of
//     V zeroed once.  K5's f32 scales ([B, S, nkv]: a one-head box would be
//     4 bytes wide, under TMA's 16) come by cp.async, each producer lane
//     copying a share of the chunk's live rows' K and V scales into the
//     stage and arriving on its full barrier once they land.
//   * min(4, stages) consumer warps take the pages in turn (a stage's pages
//     are all one warp's, so a parity wait never passes a phase early).
//     Each 16-row tile runs on tensor cores, mma.sync m16n8k16 bf16 with f32
//     accumulators, for all G <= 8 heads of the group at once: scores with
//     the rows as M and the heads as N (q as the B operand, in registers;
//     K by ldmatrix; two accumulator chains over the k-steps), then
//     out^T += V^T . P^T with the head_dim as M (V by ldmatrix.trans) and
//     P^T as B, each 8 x 8 half of P transposed in registers by movmatrix.
//     Rows as M, not the heads (FlashAttention-2's orientation): at G <= 8
//     that halves the products and the accumulator registers (hd / 4 a
//     thread), and the row reductions of the softmax are three shuffles
//     over the tile's rows, two heads a lane, in the exp2 domain.
//   * P enters the product as two bf16 terms, P rounded and the rest
//     rounded, against the same V fragment: P keeps ~16 bits, and the
//     result stays within one bf16 rounding of the f32 oracle at 32k rows,
//     where one bf16 P does not (tests/test_torch_paged_decode_tc.py,
//     tests/test_torch_decode_tc.py).
//   * K5's int8 rows convert to bf16 exactly in registers (sm_90's ldmatrix
//     has no 8-bit form): 16-byte shared loads, then per value a PRMT into
//     the f32 2^23 and one FADD, as `attend` does, and one PRMT packs the
//     high halves of two such f32 (an int8 value has 8 significant bits,
//     so its f32's high half is its bf16).  K rows are read in the order
//     the bytes convert, a permutation of head_dim that q's fragment
//     follows; V rows in pairs of rows a lane, the M rows of a product
//     being columns kBox / 8 * g + 2 j and + 1 of a box, put back in place
//     by the merge.  A row's K scale multiplies its score once, before the
//     scale and the cap, and its V scale its weight once: P' = P * s_v
//     enters the sum as the two bf16 terms against the exact int8 values,
//     and l sums P.  (A conversion by two LOP3s and a bf16x2 subtraction,
//     2 instead of 2.75 instructions a value, measured no faster; PERF.md
//     §6.)
//   * Masking with whole tiles: a TMA box brings every row of the last live
//     chunk, and rows past the length may hold anything (a stale row, a
//     NaN; K5: a NaN or inf scale).  Their scores are replaced by the mask
//     constant with a select before the max, and their V rows are zeroed in
//     shared memory before the product, since a 0 weight times a NaN is
//     still NaN; K5's V rows are int8, finite, and its weights P' past the
//     length are set to 0 by a select.
//   * The warps' states merge in warp order through the ring.  With more
//     than one live range, each writes its f32 partial (m, l, acc) to a
//     scratch and counts itself done on its (slot, head)'s counter (an
//     acq_rel atomic after a barrier); the last to finish merges the
//     partials in range order and resets the counter: one launch, the same
//     sums whichever block ran last.  The counters are the wrapper's, one
//     buffer a (device, stream) that K1, K4 and K5 share: launches that run
//     at once on two streams never share one, but two replays of CUDA
//     graphs captured on one stream do, so such replays must not overlap.
//     In both merges a head's columns are
//     16 threads' and each thread finds its head's weights itself, reading
//     a batch of ranges' (m, l) and partials at once: no barrier waits on
//     a weight.  A block whose range lies past the slot's length returns at
//     once.  (A thread block cluster of a head's ranges, merging through
//     distributed shared memory, measured no faster: it caps a slot at 8
//     ranges and constrains where blocks run.)
//   * Plans.  K1 (ops.py k1_plan): ceil(2 SMs / (B * nkv)) ranges of whole
//     pages.  K4 and K5 (ops.py decode_plan): floor(resident blocks / (B *
//     nkv)) ranges, the instance's occupancy read from the card
//     (decode_attention_tc_blocks_per_sm), so that slots whose rows all
//     live take one wave and not one and a sliver.
//   * Shape dispatch.  K1 (ops.py k1_body): bf16 at G >= 2 with pages of up
//     to 256 rows (224 at head_dim 256, the shared memory's limit) takes
//     this body.  G = 1 takes `attend`: a product then carries one real
//     head of eight, and this body, timed in turns with `attend` on one
//     H100 (scripts/decode_attention_ab.py --k1-body), was as fast or slower
//     at the serving rows (8 x 512: 0.0091-0.0098 ms against 0.0091-0.0094;
//     whisper's 8 x 448: 0.0063-0.0064 against 0.0054) and at 4 x 32768
//     (0.3646-0.3656 against 0.3610-0.3613), faster only at dsv2's 128
//     heads (0.0625 against 0.0689) and gemma-7b's head_dim 256 (0.0152
//     against 0.0163).  float32 and larger pages take `attend` too.  K4 and
//     K5 (ops.py decode_body): bf16 at head_dim 64, 128 or 256 and G >= 2,
//     or G = 1 over at most SMs / 8 (slot, KV head) pairs of at least 8192
//     rows, where `attend` fills the card only by a long split and a second
//     merging launch (1 x 8192 to 1 x 32768), or at least 4 SMs (dsv2's 128
//     KV heads), where this body measured faster for both kernels (--body
//     in turns, PERF.md §6; at one slot of 512-4096 rows and whisper's 2 x
//     448 K5 was slower on it); float32 and head_dim 80 take `attend`.
//
// `attend` (K1 at G = 1, K4 and K5 at G = 1 outside the shapes above,
// float32 and K4/K5 at head_dim 80): one body parametrised by a row policy
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
// shared memory.  Rows at or past the length are never read.
//
// `attend` is split-KV (flash-decoding): a (B, nkv, n_split) grid, launched
// as (nkv, B, n_split) so that a slot's heads, which read the same rows of
// the cache, run side by side; block z walks chunks [z * cps, (z + 1) *
// cps) of the slot (pages for K1).  With n_split > 1 each block writes its
// unnormalised partial (m, l, acc[G, hd]) in f32 to a scratch the wrapper
// allocates, and a second small kernel merges a head's partials in split
// order (fixed, so results do not change from run to run) with the same
// math as the in-block merge.  A block whose range lies past the slot's
// length reads no row and writes the empty partial (m = -1e30, l = 0,
// acc = 0).  The wrapper picks n_split from B * nkv, the cache's rows (for
// K1 the block table's width times the page size) and the SM count, without
// reading the lengths: no split for S <= 512 (the serving cache, where the
// second launch costs more than the split saves), and at most ceil(S / 512)
// ranges beyond.  K1 reads each page's id from the block table a chunk
// ahead of its rows, so a group's row loads wait only for memory.
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
// What the H100 showed (PERF.md §6).  `attend`: with one block per (slot,
// head) and rows loaded only after the last group was folded in, each
// warp's walk was a latency-bound chain (2.2 ms against a 0.64 ms bound at
// 8 x 32k rows).  Keeping a group in flight removed the chain; the split
// fills the SMs that 32k contexts at the 1-8 slots one card holds beside
// dsv2-lite's weights leave idle.  K5's time at 8 x 32k went from 0.95 ms
// to 0.54 with the split, 0.49 with the PRMT conversion, 0.46 with K4's
// bytes in flight and 0.41 with 12 warps (bound 0.33).  Its per-head
// arithmetic grew with G at a fixed byte count (8 x 512 rows: 0.0094 ms at
// G 1, 0.0506 at G 7), which is what `tc` takes off the critical path.
// `tc` for K1, in turns with its parent on one H100 (PERF.md §6): 8 x 512
// at G 3 / 4 / 7 0.0080 / 0.0081 / 0.0088 ms against 0.0213 / 0.0274 /
// 0.0501 (bound ~0.003), pixtral's 8 x 2048 0.0165 against 0.0455,
// gemma2's 8 x 8192 0.0520 against 0.0840; for K4 and K5 see PERF.md §6.
// A clock trace of its first versions showed the
// data phase near the memory's rate and half of a serving-rows launch
// spent after a block's last page had landed: the last range's merge made
// dependent L2 round trips column by column and the in-block merge waited
// on a barrier for each head's weights.  Threads that own 16 columns of one
// head, find its weights themselves and load a batch of ranges at once cut
// that tail most.  Tried and dropped: a thread block cluster of a head's
// ranges merging through distributed shared memory (no faster; it caps a
// slot at 8 ranges and delayed some blocks by a wave), 8 consumer warps
// (half the resident blocks; slower everywhere), V fragments loaded before
// the softmax, and skipping the rescale while a warp's max holds (no
// change).
#include <type_traits>

#include "tma.cuh"

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

// ---------------------------------------------------------------------------
// The Hopper body (K1, K4, K5 in bf16 at G >= 2): chunks of rows through a
// TMA ring, the products of a KV group on tensor cores (the source note at
// the top says why)
// ---------------------------------------------------------------------------

namespace tc {

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;

constexpr int kWarps = 4;                    // consumer warps: min(4, stages) of them take chunks
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kHeads = 8;                    // N of every product: a KV group's heads, padded
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;   // [B, nh, hd]
  const int* block_tables;  // K1: [B, nblk]
  const float* k_scale;     // K5: [B, S, nkv]
  const float* v_scale;
  const int* lengths;       // [B]
  __nv_bfloat16* out;       // [B, nh, hd]
  float* part;              // ranges' partials (n_split > 1), laid out as ml_offset says
  unsigned* counters;       // [B * nkv] finished ranges of a (slot, KV head); 0 between launches
  int nh, nkv, G;
  int nblk;                 // chunks a slot: K1 the block table's width, K4/K5 ceil(S / ps)
  int ps;                   // rows a chunk: K1 the page size, K4/K5 the chunk rows (a multiple of 16)
  int S;                    // K4/K5: rows a slot
  int pps;                  // chunks a range (a block)
  int stages;               // ring depth
  float scale, logit_cap;
};

// How a row of one head sits in a stage: boxes of kBox bytes a row (64 bf16
// columns; 128 int8 columns, or all 64 at head_dim 64), each box its own
// block of rows under TMA's kBox-byte swizzle
template <int Kind, int HD>
struct Geo {
  static constexpr int kElem = Kind == kInt8 ? 1 : 2;  // bytes a value
  static constexpr int kBox = HD * kElem < 128 ? HD * kElem : 128;
  static constexpr int kBoxes = HD * kElem / kBox;
};

// One chunk's K (or V) rows of one head in a stage: 16 * ceil(ps / 16) rows
// (the rows past ps pad a page to whole 16-row tiles, and keep each box
// 1024-byte aligned for the swizzle) of hd values
__host__ __device__ constexpr uint32_t region_bytes(int hd, int ps, int elem) {
  return (uint32_t)(16 * ((ps + 15) / 16)) * hd * elem;
}
// the in-block merge's arrays, which reuse the ring: the warps' (m, l) and
// acc (rows of hd + 4)
__host__ __device__ constexpr uint32_t merge_bytes(int hd) { return (uint32_t)kWarps * kHeads * (hd + 6) * 4; }
__host__ __device__ constexpr uint32_t ring_bytes(int hd, int ps, int stages, int elem) {
  return 2 * region_bytes(hd, ps, elem) * stages > merge_bytes(hd) ? 2 * region_bytes(hd, ps, elem) * stages
                                                                   : merge_bytes(hd);
}
// K5's row scales, after the ring: a stage's K scales then its V scales
__host__ __device__ constexpr uint32_t scale_bytes(int ps, int stages, bool int8) {
  return int8 ? (uint32_t)stages * 2 * (16 * ((ps + 15) / 16)) * 4 : 0;
}
// K5 at head_dim 256 keeps q's B fragments in shared memory, not in
// registers (there ptxas's register target, 168 for two blocks an SM, would
// spill): hd / 16 k-steps x 32 lanes x 8 bytes
__host__ __device__ constexpr bool q_in_smem(int hd, bool int8) { return int8 && hd == 256; }
// dynamic shared memory: slack to align the ring to 1024 bytes, the ring,
// the scales, a full and an empty barrier a stage, then K5's q fragments
__host__ __device__ constexpr uint32_t smem_bytes(int hd, int ps, int stages, bool int8) {
  return 1024 + ring_bytes(hd, ps, stages, int8 ? 1 : 2) + scale_bytes(ps, stages, int8) + 16 * stages +
         (q_in_smem(hd, int8) ? hd / 16 * 256 : 0);
}

// byte offset in a region (boxes of rows_pad rows of kBox bytes) of byte cb
// of row r, under TMA's swizzle: with 128-byte rows, 16-byte piece j of row
// r lands at piece j ^ (r % 8); with 64-byte rows at j ^ ((r / 2) % 4)
template <int kBox>
__device__ __forceinline__ uint32_t swz(int rows_pad, int r, int cb) {
  if constexpr (kBox == 128)
    return (uint32_t)((cb >> 7) * rows_pad + r) * 128 + ((((cb & 127) >> 4) ^ (r & 7)) << 4) + (cb & 15);
  else
    return (uint32_t)r * 64 + ((((cb >> 4) & 3) ^ ((r >> 1) & 3)) << 4) + (cb & 15);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}
// d[16 x 8] += a[16 x 16] . b[16 x 8]: bf16 products, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the transpose of the 8 x 8 bf16 matrix whose row lane / 4 holds columns
// 2 (lane % 4) and + 1 in this lane's word, in the same layout
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// (lo, hi) rounded to bf16 in one word, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// K5's int8 -> bf16, exact: byte i of the sign-flipped word f as the f32 bits
// of (float)v (kI8Flip / kI8Magic / kI8Sel / kI8Bias, as `attend` does); an
// int8 value has at most 8 significant bits, so the high half of its f32 is
// its bf16, and a PRMT of two such f32 packs two values in one word
__device__ __forceinline__ uint32_t i8_f32_bits(uint32_t f, int i) {
  return __float_as_uint(__uint_as_float(__byte_perm(f, kI8Magic, kI8Sel + i)) - kI8Bias);
}
// the A fragments of 4 int8 columns of one K row: (columns 0, 1) in lo and
// (2, 3) in hi, bf16, the lower column in the low half
__device__ __forceinline__ void k_frag(uint32_t x, uint32_t& lo, uint32_t& hi) {
  const uint32_t f = x ^ kI8Flip;
  lo = __byte_perm(i8_f32_bits(f, 0), i8_f32_bits(f, 1), 0x7632);
  hi = __byte_perm(i8_f32_bits(f, 2), i8_f32_bits(f, 3), 0x7632);
}

// cp.async of 4 bytes, and the arrival on a barrier once this thread's
// cp.asyncs have landed (the barrier counts it among its expected arrivals)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// out[0, N) = bf16(num / max(den, 1e-30)), N a multiple of 4, as 8-byte stores
template <int N>
__device__ __forceinline__ void store_row(__nv_bfloat16* out, const float (&num)[N], float den) {
  const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    uint2 v;
    v.x = pack_bf16(num[j] * inv, num[j + 1] * inv);
    v.y = pack_bf16(num[j + 2] * inv, num[j + 3] * inv);
    *reinterpret_cast<uint2*>(out + j) = v;
  }
}

// grid (nkv, B, n_split), kThreads threads: block (h, b, z) reads chunks
// [z * pps, (z + 1) * pps) of slot b's live chunks for KV head h: K1's pages
// of the block table; K4's and K5's rows [j * ps, (j + 1) * ps) of the slot,
// row b * S + j * ps of the cache seen as [B * S, nkv, hd] (past the slot's
// S the next slot's rows, masked; past B * S, TMA's zero fill)
template <int Kind, int HD>
__global__ void __launch_bounds__(kThreads) tc_kernel(const __grid_constant__ CUtensorMap map_k,
                                                      const __grid_constant__ CUtensorMap map_v,
                                                      const Params p) {
  using L = Geo<Kind, HD>;
  constexpr bool kI8 = Kind == kInt8;
  constexpr int kSteps = HD / 16;  // k-steps of the scores, m-tiles of the output
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = z * p.pps;
  // K1: the producer's first 32 entries of the range's block table, loaded
  // beside the length rather than after it
  int id0 = 0;
  if constexpr (Kind == kPaged)
    if (warp == kWarps && lane < min(p.pps, p.nblk - j0)) id0 = p.block_tables[(size_t)b * p.nblk + j0 + lane];
  const int len = max(0, min(p.lengths[b], Kind == kPaged ? p.nblk * p.ps : p.S));
  const int live_pages = (len + p.ps - 1) / p.ps;
  // ranges holding a live row (one, writing zeros, for an empty slot)
  const int n_live = max(1, (live_pages + p.pps - 1) / p.pps);
  if (z >= n_live) return;
  const int n = max(0, min(j0 + p.pps, live_pages) - j0);  // this block's chunks

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int rows_pad = 16 * ((p.ps + 15) / 16);
  const uint32_t region = region_bytes(HD, p.ps, L::kElem);
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t ring_b = ring_bytes(HD, p.ps, p.stages, L::kElem);
  float* scales = reinterpret_cast<float*>(ring + ring_b);  // K5: stage st's at 2 * rows_pad * st
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ring_b + scale_bytes(p.ps, p.stages, kI8));
  uint64_t* empty = full + p.stages;
  constexpr bool kQs = q_in_smem(HD, kI8);
  uint2* qs = reinterpret_cast<uint2*>(empty + p.stages);  // [kSteps][32] where kQs
  const int g = lane >> 2, t = lane & 3;  // the fragments' row group and thread in it
  // q as the B operand of the scores (K = head_dim, N = heads): head g
  // (zero past G); bf16 kinds: columns 16 kk + 2 t + {0, 1} and + 8 of
  // k-step kk; K5: columns c + {0, 1} and c + {2, 3}, c = k_col(kk / 4) +
  // 4 (kk % 4) (the order in which its K bytes are read and converted: a
  // permutation of head_dim, the same for q and K)
  const __nv_bfloat16* qrow = p.q + ((size_t)b * p.nh + (size_t)h * p.G + min(g, p.G - 1)) * HD;
  // K5: the first column of the 16 bytes this lane reads of a K row in
  // step group s (k-steps 4 s to 4 s + 3, one 4-byte word each)
  auto k_col = [&](int s) { return L::kBox == 128 ? 128 * (s / 2) + 32 * t + 16 * (s % 2) : 16 * t; };
  auto q_frag = [&](int kk) {
    const int c0 = kI8 ? k_col(kk / 4) + 4 * (kk % 4) : 16 * kk + 2 * t;
    const int c1 = kI8 ? c0 + 2 : c0 + 8;
    return g < p.G ? make_uint2(*reinterpret_cast<const uint32_t*>(qrow + c0),
                                *reinterpret_cast<const uint32_t*>(qrow + c1))
                   : make_uint2(0u, 0u);
  };
  if constexpr (kQs) {
    if (warp == 0)
      for (int kk = 0; kk < kSteps; ++kk) qs[kk * 32 + lane] = q_frag(kk);
  }

  if (tid == 32 * kWarps) {
    for (int i = 0; i < p.stages; ++i) {
      // the TMA lane's arrival, and K5's 32 lanes' once their scales land
      mbar_init(smem_u32(full + i), kI8 ? 33 : 1);
      mbar_init(smem_u32(empty + i), 1);  // lane 0 of the chunk's consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_k) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_v) : "memory");
  }
  if (!kI8 && p.ps < rows_pad) {  // K1: V rows past a page's end pad its last tile: zeros (K's are masked)
    const int per_stage = (rows_pad - p.ps) * L::kBoxes * 8;  // 16-byte pieces
    for (int x = tid; x < p.stages * per_stage; x += kThreads) {
      const int st = x / per_stage, y = x % per_stage;
      const int r = p.ps + y / (L::kBoxes * 8), c = (y / 8) % L::kBoxes;
      *reinterpret_cast<uint4*>(ring + st * 2 * region + region + (c * rows_pad + r) * 128 + (y % 8) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // heads 2 (lane % 4) and + 1
  float acc[kSteps][4];
#pragma unroll
  for (int mt = 0; mt < kSteps; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  if (warp == kWarps) {
    // the producer: K1's block table entries 32 at a time, one a lane;
    // lane 0 loads each chunk's K and V boxes of head h into the next stage
    // once its last reader has released it, and for K5 every lane then
    // copies a share of the chunk's live rows' scales of head h
    const int* bt = Kind == kPaged ? p.block_tables + (size_t)b * p.nblk + j0 : nullptr;
    const uint32_t tx = 2u * p.ps * HD * L::kElem;
    const uint64_t policy = repro::evict_first_policy();  // each row is read once
    for (int base = 0; base < n; base += 32) {
      int id = 0;
      if constexpr (Kind == kPaged) id = base == 0 ? id0 : (base + lane < n ? bt[base + lane] : 0);
      const int m = min(32, n - base);
      for (int i = 0; i < m; ++i) {
        const int k = base + i, st = k % p.stages;
        int row0;  // the chunk's first row in the [rows, nkv, hd] view
        if constexpr (Kind == kPaged)
          row0 = __shfl_sync(0xffffffffu, id, i) * p.ps;
        else
          row0 = b * p.S + (j0 + k) * p.ps;
        if (lane == 0) {
          mbar_wait(smem_u32(empty + st), ((k / p.stages) & 1) ^ 1);
          const uint32_t bar = smem_u32(full + st), dst = ring_s + st * 2 * region;
          mbar_expect_tx(bar, tx);
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c) {
            const int col = c * L::kBox / L::kElem;
            repro::tma_load(dst + c * rows_pad * L::kBox, &map_k, bar, col, h, row0, policy);
            repro::tma_load(dst + region + c * rows_pad * L::kBox, &map_v, bar, col, h, row0, policy);
          }
        }
        if constexpr (kI8) {
          __syncwarp();  // no lane writes the stage before lane 0 saw it released
          const int live = min(p.ps, len - (j0 + k) * p.ps);
          const uint32_t dst = smem_u32(scales + st * 2 * rows_pad);
          for (int r = lane; r < live; r += 32) {
            const size_t at = ((size_t)row0 + r) * p.nkv + h;
            cp_async4(dst + 4 * r, p.k_scale + at);
            cp_async4(dst + 4 * (rows_pad + r), p.v_scale + at);
          }
          cp_async_arrive(smem_u32(full + st));
        }
      }
    }
  } else {
    const float scale_l2 = p.scale * kLog2e, cap_l2 = p.logit_cap * kLog2e;
    const float scale_cap = p.logit_cap > 0.f ? p.scale / p.logit_cap : 0.f;
    uint2 qb[kQs ? 1 : kSteps];  // q's fragments in registers, or read from qs a step at a time
    if constexpr (!kQs) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) qb[kk] = q_frag(kk);
    }
    auto qf = [&](int kk) { return kQs ? qs[kk * 32 + lane] : qb[kQs ? 0 : kk]; };
    // K5: the V rows this lane reads of a tile, 2 t and 2 t + 1 (+ 8), the
    // odd threads' pair in the other order (bank-conflict free at 64-byte
    // rows), and the PRMT that puts row 2 t in the low half
    const int va_r = 2 * t + (t & 1), vb_r = 2 * t + 1 - (t & 1);
    const uint32_t v_sel = (t & 1) ? 0x3276u : 0x7632u;
    // warp w of the first nw takes chunks w, w + nw, ...: with stages a
    // multiple of nw, the chunk that used a stage before chunk i is the same
    // warp's, so its parity wait on the stage can never see a phase early
    const int nw = min(kWarps, p.stages);
    for (int i = warp; warp < nw && i < n; i += nw) {
      const int st = i % p.stages;
      mbar_wait(smem_u32(full + st), (i / p.stages) & 1);
      const uint32_t kofs = st * 2 * region, vofs = kofs + region;
      const int valid = min(p.ps, len - (j0 + i) * p.ps);  // the chunk's live rows (>= 1)
      if (!kI8 && valid < p.ps) {
        // the slot's last live chunk, the block's last: its rows past the
        // length may hold anything (stale rows, a NaN), so their V is zeroed
        // and a masked row's 0 weight stays 0 through the product (K5's V
        // rows are int8, finite; its weights past the length are zeroed)
        unsigned char* v_rows = ring + vofs;
        for (int x = lane; x < (p.ps - valid) * L::kBoxes * 8; x += 32) {
          const int r = valid + x / (L::kBoxes * 8), c = (x / 8) % L::kBoxes;
          *reinterpret_cast<uint4*>(v_rows + (c * rows_pad + r) * 128 + (x % 8) * 16) = make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }
      const float* k_sc = scales + st * 2 * rows_pad;  // K5
      const float* v_sc = k_sc + rows_pad;
      for (int r0 = 0; r0 < valid; r0 += 16) {
        // scores of 16 rows (M) by 8 heads (N): row r0 + g (+ 8) in s[0..1]
        // (s[2..3]), heads 2 t and + 1 (two accumulator chains over the
        // k-steps, so that half as many products wait on one another)
        float s[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (kI8) {
          // rows r0 + g and + 8: 16 bytes a step group (4 k-steps), the
          // bytes converted to bf16 in registers
#pragma unroll
          for (int sg = 0; sg < kSteps / 4; ++sg) {
            const unsigned char* k_rows = ring + kofs;
            const uint4 xa = *reinterpret_cast<const uint4*>(k_rows + swz<L::kBox>(rows_pad, r0 + g, k_col(sg)));
            const uint4 xb = *reinterpret_cast<const uint4*>(k_rows + swz<L::kBox>(rows_pad, r0 + g + 8, k_col(sg)));
            const uint32_t wa[4] = {xa.x, xa.y, xa.z, xa.w}, wb[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              uint32_t a[4];
              k_frag(wa[w], a[0], a[2]);
              k_frag(wb[w], a[1], a[3]);
              const uint2 f = qf(4 * sg + w);
              mma_bf16(w % 2 ? s1 : s, a, f.x, f.y);
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, ring_s + kofs + swz<128>(rows_pad, r0 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                                32 * kk + (lane >> 4) * 16));
            mma_bf16(kk % 2 ? s1 : s, a, qb[kk].x, qb[kk].y);
          }
        }
        const bool va = r0 + g < valid, vb = r0 + g + 8 < valid;
        float ka = 1.f, kb = 1.f;  // K5: the rows' K scales, once a row
        if constexpr (kI8) {
          ka = k_sc[r0 + g];
          kb = k_sc[r0 + g + 8];
        }
        // scaled (and capped) scores, in units of log2 e: the softmax runs on exp2
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[e] = (s[e] + s1[e]) * (e < 2 ? ka : kb);
          s[e] = p.logit_cap > 0.f ? cap_l2 * tanhf(s[e] * scale_cap) : s[e] * scale_l2;
        }
        // masked before the max, by a select: a garbage score (or scale) never enters
        s[0] = va ? s[0] : kNegInf;
        s[1] = va ? s[1] : kNegInf;
        s[2] = vb ? s[2] : kNegInf;
        s[3] = vb ? s[3] : kNegInf;
        float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // over the tile's rows: the lanes of a column
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        const float p0 = va ? exp2f(s[0] - mn0) : 0.f, p1 = va ? exp2f(s[1] - mn1) : 0.f;
        const float p2 = vb ? exp2f(s[2] - mn0) : 0.f, p3 = vb ? exp2f(s[3] - mn1) : 0.f;
        l0 = l0 * c0 + (p0 + p2);  // this lane's rows; the column's lanes are summed at the end
        l1 = l1 * c1 + (p1 + p3);
#pragma unroll
        for (int mt = 0; mt < kSteps; ++mt) {
          acc[mt][0] *= c0;
          acc[mt][1] *= c1;
          acc[mt][2] *= c0;
          acc[mt][3] *= c1;
        }
        // the weights of the sum: P, or for K5 P' = P times the row's V
        // scale (once a row, against exact int8 V values), set to 0 by a
        // select past the length, where a scale may be NaN or inf
        float w0 = p0, w1 = p1, w2 = p2, w3 = p3;
        if constexpr (kI8) {
          const float sa = v_sc[r0 + g], sb = v_sc[r0 + g + 8];
          w0 = va ? p0 * sa : 0.f;
          w1 = va ? p1 * sa : 0.f;
          w2 = vb ? p2 * sb : 0.f;
          w3 = vb ? p3 * sb : 0.f;
        }
        // each weight = hi + lo, both bf16 (hi: the weight rounded; lo: the
        // rest, rounded), so that the weighted sum keeps it to ~2^-16; each
        // 8 x 8 half transposed into the B operand (K = rows, N = heads)
        const uint32_t h01 = pack_bf16(w0, w1), h23 = pack_bf16(w2, w3);
        const uint32_t o01 = pack_bf16(w0 - __uint_as_float(h01 << 16), w1 - __uint_as_float(h01 & 0xffff0000u));
        const uint32_t o23 = pack_bf16(w2 - __uint_as_float(h23 << 16), w3 - __uint_as_float(h23 & 0xffff0000u));
        const uint32_t ph0 = transpose8(h01), ph1 = transpose8(h23);
        const uint32_t pl0 = transpose8(o01), pl1 = transpose8(o23);
        // out^T (M = head_dim, N = heads) += V^T . P^T
        if constexpr (kI8) {
          // V^T's A fragments from 4 rows (2 t, 2 t + 1, + 8) of kBox / 8
          // columns a lane: columns kBox / 8 * g + 2 j and + 1 of a box are
          // the M rows g and g + 8 of its m-tile j (the merge maps them back)
          constexpr int kW = L::kBox / 8;  // bytes of a row a lane reads in a box
          using VRow = typename std::conditional<kW == 16, uint4, uint2>::type;
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c) {
            const int cb = c * 128 + kW * g;
            VRow x[4];
            x[0] = *reinterpret_cast<const VRow*>(ring + vofs + swz<L::kBox>(rows_pad, r0 + va_r, cb));
            x[1] = *reinterpret_cast<const VRow*>(ring + vofs + swz<L::kBox>(rows_pad, r0 + vb_r, cb));
            x[2] = *reinterpret_cast<const VRow*>(ring + vofs + swz<L::kBox>(rows_pad, r0 + 8 + va_r, cb));
            x[3] = *reinterpret_cast<const VRow*>(ring + vofs + swz<L::kBox>(rows_pad, r0 + 8 + vb_r, cb));
#pragma unroll
            for (int w = 0; w < kW / 4; ++w) {
              uint32_t f[4], lo[4], hi[4];
#pragma unroll
              for (int r = 0; r < 4; ++r) f[r] = reinterpret_cast<const uint32_t*>(&x[r])[w] ^ kI8Flip;
#pragma unroll
              for (int i = 0; i < 4; ++i) {  // column 4 w + i: rows 2 t, 2 t + 1 (lo) and + 8 (hi)
                lo[i] = __byte_perm(i8_f32_bits(f[0], i), i8_f32_bits(f[1], i), v_sel);
                hi[i] = __byte_perm(i8_f32_bits(f[2], i), i8_f32_bits(f[3], i), v_sel);
              }
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const uint32_t a[4] = {lo[2 * jj], lo[2 * jj + 1], hi[2 * jj], hi[2 * jj + 1]};
                const int mt = c * (L::kBox / 16) + 2 * w + jj;
                mma_bf16(acc[mt], a, ph0, ph1);
                mma_bf16(acc[mt], a, pl0, pl1);
              }
            }
          }
        } else {
#pragma unroll
          for (int mt = 0; mt < kSteps; ++mt) {
            uint32_t a[4];
            ldsm_x4_trans(a, ring_s + vofs + swz<128>(rows_pad, r0 + (lane >> 4) * 8 + (lane & 7),
                                                      32 * mt + ((lane >> 3) & 1) * 16));
            mma_bf16(acc[mt], a, ph0, ph1);
            mma_bf16(acc[mt], a, pl0, pl1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + st));
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
  }

  // Merge the warps' softmax states, in warp order, through the ring.  A
  // head's columns are 16 threads' (kCols consecutive columns each): each
  // thread finds its head's warp weights itself, so one barrier publishes
  // the warps' states and none waits on the weights.
  constexpr int kCols = HD / 16;
  constexpr int kRow = HD + 4;  // a row of `as`: the four heads a store writes hit four bank groups
  __syncthreads();              // every chunk has been read
  float* ms = reinterpret_cast<float*>(ring);  // [kWarps][kHeads]
  float* ls = ms + kWarps * kHeads;            // [kWarps][kHeads]
  float* as = ls + kWarps * kHeads;            // [kWarps][kHeads][kRow]
  if (warp < kWarps) {
    const int n0 = warp * kHeads + 2 * (lane & 3), row = lane >> 2;
    if (row == 0) {
      ms[n0] = m0;
      ms[n0 + 1] = m1;
      ls[n0] = l0;
      ls[n0 + 1] = l1;
    }
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) {
      // the output columns of the tile's M rows row and row + 8
      int c0 = 16 * mt + row, c1 = c0 + 8;
      if constexpr (kI8) {
        constexpr int kTiles = L::kBox / 16;  // m-tiles a box
        c0 = (mt / kTiles) * 128 + L::kBox / 8 * row + 2 * (mt % kTiles);
        c1 = c0 + 1;
      }
      as[n0 * kRow + c0] = acc[mt][0];
      as[(n0 + 1) * kRow + c0] = acc[mt][1];
      as[n0 * kRow + c1] = acc[mt][2];
      as[(n0 + 1) * kRow + c1] = acc[mt][3];
    }
  }
  __syncthreads();
  const int gh = tid >> 4, d0 = (tid & 15) * kCols;  // this thread's head and first column
  const bool mine = tid < 16 * p.G;
  const size_t head = (size_t)b * p.nh + (size_t)h * p.G + gh;
  const int n_split = gridDim.z;
  float* ml_all = p.part + ml_offset((size_t)gridDim.y * p.nh, n_split, HD);
  float num[kCols];
  if (mine) {
    float mx = kNegInf, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w * kHeads + gh]);
#pragma unroll
    for (int j = 0; j < kCols; ++j) num[j] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(ms[w * kHeads + gh] - mx);  // 0 for a warp that read no row
      den += ls[w * kHeads + gh] * c;
      const float4* a4 = reinterpret_cast<const float4*>(as + (w * kHeads + gh) * kRow + d0);
#pragma unroll
      for (int j = 0; j < kCols / 4; ++j) {
        const float4 a = a4[j];
        num[4 * j] += a.x * c;
        num[4 * j + 1] += a.y * c;
        num[4 * j + 2] += a.z * c;
        num[4 * j + 3] += a.w * c;
      }
    }
    if (n_live == 1) {
      store_row(p.out + head * HD + d0, num, den);
    } else {  // range z: the unnormalised partial
      const size_t hz = head * n_split + z;
      float4* dst = reinterpret_cast<float4*>(p.part + hz * HD + d0);
#pragma unroll
      for (int j = 0; j < kCols / 4; ++j) dst[j] = make_float4(num[4 * j], num[4 * j + 1], num[4 * j + 2], num[4 * j + 3]);
      if (d0 == 0) {
        ml_all[hz * 2] = mx;
        ml_all[hz * 2 + 1] = den;
      }
    }
  }
  if (n_live == 1) return;
  // The last of the head's live ranges to finish merges all of them, in
  // range order (the same sums whichever block is last), and resets the
  // counter for the next launch: no second kernel.  The block's partial is
  // released by thread 0's atomic after the barrier and acquired by the
  // last block's (the pattern of cutlass/barrier.h).
  __shared__ int last_s;
  __syncthreads();
  if (tid == 0) {
    unsigned* cnt = p.counters + (size_t)b * p.nkv + h;
    unsigned old;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(cnt) : "memory");
    const bool last = old == (unsigned)n_live - 1;
    if (last) atomicExch(cnt, 0u);
    last_s = last;
  }
  __syncthreads();
  if (!last_s || !mine) return;
  // each thread merges its columns over the ranges, kBatch ranges' (m, l)
  // and partials in flight at a time, with the same online rescaling as
  // the softmax (a fixed order: the same sums every run)
  constexpr int kBatch = kCols <= 8 ? 8 : 4;
  float mx = kNegInf, den = 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) num[j] = 0.f;
  for (int r0 = 0; r0 < n_live; r0 += kBatch) {
    float m[kBatch], l[kBatch];
    float4 a[kBatch][kCols / 4];
#pragma unroll
    for (int rr = 0; rr < kBatch; ++rr) {
      const bool ok = r0 + rr < n_live;
      const size_t hz = head * n_split + r0 + rr;
      m[rr] = ok ? __ldcg(ml_all + hz * 2) : kNegInf;
      l[rr] = ok ? __ldcg(ml_all + hz * 2 + 1) : 0.f;
#pragma unroll
      for (int j = 0; j < kCols / 4; ++j)
        a[rr][j] = ok ? __ldcg(reinterpret_cast<const float4*>(p.part + hz * HD + d0) + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float bm = mx;
#pragma unroll
    for (int rr = 0; rr < kBatch; ++rr) bm = fmaxf(bm, m[rr]);
    const float c = exp2f(mx - bm);
    den *= c;
#pragma unroll
    for (int j = 0; j < kCols; ++j) num[j] *= c;
#pragma unroll
    for (int rr = 0; rr < kBatch; ++rr) {
      const float w = exp2f(m[rr] - bm);  // 0 past n_live
      den += l[rr] * w;
#pragma unroll
      for (int j = 0; j < kCols / 4; ++j) {
        num[4 * j] += a[rr][j].x * w;
        num[4 * j + 1] += a[rr][j].y * w;
        num[4 * j + 2] += a[rr][j].z * w;
        num[4 * j + 3] += a[rr][j].w * w;
      }
    }
    mx = bm;
  }
  store_row(p.out + head * HD + d0, num, den);
}

// the instance allowed the most dynamic shared memory on `device` (callers
// hold tma_mutex)
template <int Kind, int HD>
cudaError_t prepared(int device) {
  static bool ready[repro::kMaxDevices] = {};
  return repro::allow_smem(tc_kernel<Kind, HD>, device, ready);
}

template <int Kind, int HD>
cudaError_t launch_hd(int device, const CUtensorMap* maps, const Params& p, const dim3& grid, uint32_t smem,
                      cudaStream_t st) {
  cudaError_t err = prepared<Kind, HD>(device);
  if (err != cudaSuccess) return err;
  tc_kernel<Kind, HD><<<grid, kThreads, smem, st>>>(maps[0], maps[1], p);
  return cudaGetLastError();
}

// the instance's resident blocks an SM with `smem` bytes of shared memory
template <int Kind>
int blocks_per_sm(int hd, uint32_t smem, int device, int* blocks) {
  std::lock_guard<std::mutex> lock(repro::tma_mutex());
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd) {
    case 64: err = prepared<Kind, 64>(device); break;
    case 128: err = prepared<Kind, 128>(device); break;
    case 256: err = prepared<Kind, 256>(device); break;
  }
  if (err != cudaSuccess) return (int)err;
  switch (hd) {
    case 64: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, tc_kernel<Kind, 64>, kThreads, smem);
    case 128: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, tc_kernel<Kind, 128>, kThreads, smem);
    default: return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, tc_kernel<Kind, 256>, kThreads, smem);
  }
}

// One launch of the body over `rows` rows of K and V, [rows, nkv, hd] each
// as tensor maps whose boxes are a chunk's ps rows of one head; the
// caller has checked p.
template <int Kind>
int launch(const void* k, const void* v, uint64_t rows, int hd, int B, int n_split, const Params& p, int device,
           void* stream) {
  constexpr int kElem = Kind == kInt8 ? 1 : 2;
  const uint32_t smem = smem_bytes(hd, p.ps, p.stages, Kind == kInt8);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nkv, B, n_split);
  cudaStream_t st = (cudaStream_t)stream;
  std::lock_guard<std::mutex> lock(repro::tma_mutex());
  CUtensorMap maps[2];
  if (!repro::tensor_map(&maps[0], k, hd, p.nkv, rows, 1, p.ps, kElem) ||
      !repro::tensor_map(&maps[1], v, hd, p.nkv, rows, 1, p.ps, kElem))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: return (int)launch_hd<Kind, 64>(device, maps, p, grid, smem, st);
    case 128: return (int)launch_hd<Kind, 128>(device, maps, p, grid, smem, st);
    case 256: return (int)launch_hd<Kind, 256>(device, maps, p, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the checks every launch of the body shares
inline bool plan_ok(int B, int G, int n_split, int pps, int stages, const float* part, const void* counters) {
  return B >= 1 && G >= 1 && G <= kHeads && n_split >= 1 && pps >= 1 && stages >= 1 &&
         !(stages > kWarps && stages % kWarps) && !(n_split > 1 && part == nullptr) && counters != nullptr;
}

}  // namespace tc

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

// K1's bf16 body (tc::tc_kernel): q [B, nh, hd], page pools [P, ps, nkv,
// hd] in bf16, block tables [B, nblk] and lengths [B] int32; n_split ranges
// of pps pages, a ring of `stages` pages; `part` as above (n_split > 1) and
// `counters`, B * nkv uint32 that are zero and left zero.
REPRO_EXPORT int paged_decode_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                             const int* block_tables, const int* lengths, void* out,
                                             float* part, void* counters, int B, int nh, int nkv, int hd,
                                             int ps, int P, int nblk, int n_split, int pps, int stages,
                                             float scale, float logit_cap, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  const int G = nkv > 0 && nh % nkv == 0 ? nh / nkv : 0;
  if (!tc::plan_ok(B, G, n_split, pps, stages, part, counters) || ps < 1 || ps > 256 || P < 1 ||
      (uint64_t)P * ps > INT32_MAX || nblk < 1)
    return (int)cudaErrorInvalidValue;
  const tc::Params p{(const __nv_bfloat16*)q, block_tables, nullptr, nullptr, lengths, (__nv_bfloat16*)out, part,
                     (unsigned*)counters, nh, nkv, G, nblk, ps, 0, pps, stages, scale, logit_cap};
  // the pools as [P * ps, nkv, hd]: boxes of one page's rows of one head
  return tc::launch<kPaged>(k_pages, v_pages, (uint64_t)P * ps, hd, B, n_split, p, device, stream);
}

// The blocks of K4's (int8 = 0) or K5's body at head_dim hd, chunks of
// `rows` rows and a ring of `stages` chunks that an SM holds at once, into
// *blocks: their plan fills the card with one wave of them.
REPRO_EXPORT int decode_attention_tc_blocks_per_sm(int hd, int rows, int stages, int int8, int device, int* blocks) {
  REPRO_SET_DEVICE(device);
  if (rows < 16 || rows > 256 || stages < 1 || blocks == nullptr) return (int)cudaErrorInvalidValue;
  const uint32_t smem = tc::smem_bytes(hd, rows, stages, int8);
  return int8 ? tc::blocks_per_sm<kInt8>(hd, smem, device, blocks)
              : tc::blocks_per_sm<kContiguous>(hd, smem, device, blocks);
}

// K4 (int8 = 0: caches [B, S, nkv, hd] in bf16) and K5 (int8 = 1: int8
// caches, f32 scales [B, S, nkv]) on the same body: q [B, nh, hd] bf16,
// lengths [B] int32; chunks of `rows` rows (a multiple of 16, at most 256),
// n_split ranges of cps chunks, a ring of `stages` chunks; `part` and
// `counters` as K1's.
REPRO_EXPORT int decode_attention_tc(const void* q, const void* k_cache, const void* v_cache,
                                     const float* k_scale, const float* v_scale, const int* lengths, void* out,
                                     float* part, void* counters, int B, int nh, int nkv, int hd, int S,
                                     int rows, int n_split, int cps, int stages, float scale, float logit_cap,
                                     int int8, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  const int G = nkv > 0 && nh % nkv == 0 ? nh / nkv : 0;
  if (!tc::plan_ok(B, G, n_split, cps, stages, part, counters) || S < 1 || rows < 16 || rows > 256 ||
      rows % 16 || (uint64_t)B * S + rows > INT32_MAX || (int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const tc::Params p{(const __nv_bfloat16*)q, nullptr, k_scale, v_scale, lengths, (__nv_bfloat16*)out, part,
                     (unsigned*)counters, nh, nkv, G, (S + rows - 1) / rows, rows, S, cps, stages, scale,
                     logit_cap};
  // the caches as [B * S, nkv, hd]: boxes of one chunk's rows of one head
  return int8 ? tc::launch<kInt8>(k_cache, v_cache, (uint64_t)B * S, hd, B, n_split, p, device, stream)
              : tc::launch<kContiguous>(k_cache, v_cache, (uint64_t)B * S, hd, B, n_split, p, device, stream);
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
