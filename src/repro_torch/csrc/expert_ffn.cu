// K3: grouped SwiGLU expert FFN with slot-indirect weights.
//
// Replaces the TPU kernel src/repro/kernels/expert_ffn/kernel.py::
// _expert_ffn_kernel (launched by expert_ffn_pallas).
//
// What it computes: for every slot s with active[s] != 0 and
// e = slot_to_expert[s] >= 0, over its capacity-packed rows x[s] [CAP, d]:
//   out[s] = (silu(x[s] @ Wg[e]) * (x[s] @ Wu[e])).astype(x.dtype) @ Wd[e]
// with logical weights Wg, Wu [E, d, f] and Wd [E, f, d] read through the
// slot map -- no per-slot weight copy.  Inactive or empty slots give zeros
// and read no weight, so the cost tracks the activated experts (the
// beta * a_max term of the paper's Eq. 1c).
//
// Rounding: h is rounded to x.dtype, as the TPU kernel does; the down
// product accumulates in f32 over all of f inside one block and rounds once
// (the TPU kernel rounds its output block after every d_ff tile, so the two
// differ within bf16 tolerance, not bitwise).  No sum uses atomics or
// crosses blocks, so a call gives the same bits every time.
//
// Bound on the H100: bytes.  Each activated expert streams 3 * d * f
// weights (17.3 MB in bf16 at dsv2-lite) for CAP rows: CAP FLOP per weight
// byte (2 FLOP a row for each 2-byte weight), 4 at decode (CAP 4), 64 at a
// 64-token prefill chunk and 128 at a batched 2 x 64 call, all below the
// ~295 FLOP/B where the tensor cores would bind (989 TFLOP/s over 3.35
// TB/s).  At dsv2-lite's decode (~30 experts) that is 520 MB, 0.155 ms; a
// CAP 64 chunk over all 64 experts, 1.11 GB plus 34 MB of x and out, 0.341
// ms (the bound counts x and out once; the kernel reads a slot's token
// rows once a column tile, from L2).  So every weight byte streams from
// device memory once a call, whatever CAP is, with enough bytes in flight
// to keep the memory busy, and nothing else (token rows, h) may take the
// copy or issue slots the weights need.
//
// Design (bf16), replacing PR 13's mma.sync + cp.async kernels (two
// launches, a 2-stage ring whose bytes in flight were tied to resident
// blocks, token rows re-staged by every thread, a grid over every slot):
//   * One launch does both phases (design (a) of the two the redesign
//     weighed).  Its persistent grid (one block an SM, all resident) walks
//     a work list built on the device from `active` and `slot_to_expert`
//     (the host never reads them): every live slot's phase-A items (64 * C
//     columns of h: x @ Wg and x @ Wu, silu * mul, h rounded to bf16),
//     then its phase-B items (128 * C columns of out: h @ Wd).  The blocks
//     take items in list order: at 33+ rows from one counter (an atomic
//     add that no sum depends on, so the bits do not change), so a block
//     that finishes an item early takes the next one, phase A or B, and
//     the blocks end within one item of each other however the items'
//     lengths differ (a static round robin left up to 9% of a block's
//     share of imbalance at CAP 64); at decode block b takes items b,
//     b + G, ..., which keeps a slot's column tiles in lockstep.  Either
//     way no wave is cut at the phase boundary.  A phase-B item
//     waits, in its producer, on its slot's count of finished phase-A
//     items (release / acquire, then a proxy fence before TMA reads h); the
//     last phase-B item of a slot resets the counts, and the last block to
//     find the list spent resets its counter, so each launch (and each
//     replay of a CUDA graph) starts from zero with no memset.  Weight
//     streaming never drains between the phases: a block that runs out of
//     phase-A work goes straight on to phase B.  Two launches joined by
//     programmatic dependent launch (design (b)) would still drain phase
//     A's last partial wave before phase B's blocks find room.  Slots that
//     do no work appear in no item; the consumers write their zeros first.
//     A spin that lasts ~17 s traps: a fault, not a hang.
//   * Warp specialisation: one producer thread keeps a ring of 4-12 stages
//     (as many as fit in 227 KB, at most 12) full with TMA loads, each
//     stage guarded by full / empty mbarriers.  A stage holds 2C weight
//     boxes (64 columns x 64 reduction rows, 128-byte rows with 128-byte
//     swizzle; the expert is the third coordinate of a 3-D tensor map over
//     [E, K, N], so the slot indirection costs nothing; L2 evict-first)
//     and R boxes of the item's token rows (x, or h in phase B; L2
//     evict-last, as every column tile of the slot reads them).  TMA uses
//     no thread's registers or issue slots, so bytes in flight follow the
//     ring's depth (~190 KB an SM), not the number of resident blocks.
//   * Products run on wgmma, R x C consumer warpgroups: the weights are A
//     (64 output columns, MN-major, transposed by the descriptor), the
//     token rows are B (N = CAP rounded up to 8, 16, 32, 64 or 128,
//     K-major), f32 accumulators, so a weight box serves every row and rows
//     pad to 8, not to 64 (out^T = W^T . x^T).  Up to 32 rows one
//     warpgroup (items stay small, for balance over ~30 live slots at
//     decode); at 33-128 rows two split the columns (C = 2: a token box
//     serves 128 columns of h, and the weights stream in 256- and 512-byte
//     runs of a row, which measured 2-6% faster at prefill); above 128 two
//     split the rows (R = 2, 256 rows a row block).  A CAP above 256 runs
//     in row blocks of 256 (an item is one row block), each streaming the
//     weights once.  No branch surrounds a wgmma (one serialises them), and
//     no instance needs setmaxnreg: the accumulators take N (<= 128)
//     registers a thread, and ptxas fits every instance without spills.
//   * The tensor maps are built once per (address, shape, box) and cached
//     on the host (an encoding depends on nothing else); the
//     shared-memory attribute is set once a device and instance.
// The wrapper checks what TMA needs (d and f multiples of 8, 16-byte-
// aligned tensors).
//
// float32 stays on CUDA cores in full f32 (no TF32): the first version's
// kernels, two launches of plain FMAs over row groups of 8.
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;
using repro::spin_check;
using repro::tma_load;

__device__ __forceinline__ bool slot_live(const int* s2e, const int* active, int s) {
  return active[s] != 0 && s2e[s] >= 0;
}

// ---------------------------------------------------------------- float32

constexpr int kThreads = 256;
constexpr int kCols = 64;                 // output columns per block
constexpr int kSplit = kThreads / kCols;  // partial sums over the reduction axis
constexpr int kRows = 8;                  // capacity rows per pass
constexpr int kStage = 128;               // reduction-axis elements staged per step

// phase A: h[s, c, :] = silu(x[s, c] @ Wg[e]) * (x[s, c] @ Wu[e])
__global__ void __launch_bounds__(kThreads) f32_gate_up_kernel(
    const float* __restrict__ x, const float* __restrict__ w_gate,
    const float* __restrict__ w_up, const int* __restrict__ s2e,
    const int* __restrict__ active, float* __restrict__ h, int CAP, int d, int f) {
  const int s = blockIdx.y;
  if (!slot_live(s2e, active, s)) return;
  const size_t e = (size_t)s2e[s];
  const int col = threadIdx.x % kCols;
  const int part = threadIdx.x / kCols;
  const int fc = blockIdx.x * kCols + col;

  __shared__ float x_s[kRows][kStage];
  __shared__ float red_g[kSplit][kRows][kCols];
  __shared__ float red_u[kSplit][kRows][kCols];

  const float* wg = w_gate + e * d * f;
  const float* wu = w_up + e * d * f;
  const float* xs = x + (size_t)s * CAP * d;

  for (int r0 = 0; r0 < CAP; r0 += kRows) {
    const int nr = min(kRows, CAP - r0);
    float ag[kRows], au[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ag[r] = au[r] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kStage) {
      const int nd = min(kStage, d - d0);
      __syncthreads();  // previous stage fully consumed
      for (int i = threadIdx.x; i < kRows * kStage; i += kThreads) {
        const int r = i / kStage, dd = i % kStage;
        x_s[r][dd] = (r < nr && dd < nd) ? xs[(size_t)(r0 + r) * d + d0 + dd] : 0.f;
      }
      __syncthreads();
      if (fc < f) {
#pragma unroll 4
        for (int dd = part; dd < nd; dd += kSplit) {
          const size_t wi = (size_t)(d0 + dd) * f + fc;
          const float g = wg[wi];
          const float u = wu[wi];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            ag[r] += x_s[r][dd] * g;
            au[r] += x_s[r][dd] * u;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      red_g[part][r][col] = ag[r];
      red_u[part][r][col] = au[r];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const int fcc = blockIdx.x * kCols + c;
      if (r < nr && fcc < f) {
        float g = 0.f, u = 0.f;
#pragma unroll
        for (int k = 0; k < kSplit; ++k) {
          g += red_g[k][r][c];
          u += red_u[k][r][c];
        }
        const float silu = g / (1.f + expf(-g));
        h[((size_t)s * CAP + r0 + r) * f + fcc] = silu * u;
      }
    }
  }
}

// phase B: out[s, c, :] = h[s, c] @ Wd[e], over all of f
__global__ void __launch_bounds__(kThreads) f32_down_kernel(
    const float* __restrict__ h, const float* __restrict__ w_down, const int* __restrict__ s2e,
    const int* __restrict__ active, float* __restrict__ out, int CAP, int d, int f) {
  const int s = blockIdx.y;
  const int col = threadIdx.x % kCols;
  const int part = threadIdx.x / kCols;
  const int dc = blockIdx.x * kCols + col;
  float* os = out + (size_t)s * CAP * d;

  if (!slot_live(s2e, active, s)) {
    for (int i = threadIdx.x; i < CAP * kCols; i += kThreads) {
      const int r = i / kCols, c = blockIdx.x * kCols + i % kCols;
      if (c < d) os[(size_t)r * d + c] = 0.f;
    }
    return;
  }
  const size_t e = (size_t)s2e[s];

  __shared__ float h_s[kRows][kStage];
  __shared__ float red[kSplit][kRows][kCols];

  const float* wd = w_down + e * f * d;
  const float* hs = h + (size_t)s * CAP * f;

  for (int r0 = 0; r0 < CAP; r0 += kRows) {
    const int nr = min(kRows, CAP - r0);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int f0 = 0; f0 < f; f0 += kStage) {
      const int nf = min(kStage, f - f0);
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * kStage; i += kThreads) {
        const int r = i / kStage, ff = i % kStage;
        h_s[r][ff] = (r < nr && ff < nf) ? hs[(size_t)(r0 + r) * f + f0 + ff] : 0.f;
      }
      __syncthreads();
      if (dc < d) {
#pragma unroll 4
        for (int ff = part; ff < nf; ff += kSplit) {
          const float w = wd[(size_t)(f0 + ff) * d + dc];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] += h_s[r][ff] * w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) red[part][r][col] = acc[r];
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const int dcc = blockIdx.x * kCols + c;
      if (r < nr && dcc < d) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < kSplit; ++k) v += red[k][r][c];
        os[(size_t)(r0 + r) * d + dcc] = v;
      }
    }
  }
}

int launch_f32(const void* x, const void* wg, const void* wu, const void* wd, const int* s2e,
               const int* active, void* h, void* out, int S, int CAP, int d, int f,
               cudaStream_t st) {
  const dim3 grid_a((f + kCols - 1) / kCols, S);
  f32_gate_up_kernel<<<grid_a, kThreads, 0, st>>>((const float*)x, (const float*)wg,
                                                   (const float*)wu, s2e, active, (float*)h,
                                                   CAP, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((d + kCols - 1) / kCols, S);
  f32_down_kernel<<<grid_b, kThreads, 0, st>>>((const float*)h, (const float*)wd, s2e, active,
                                                (float*)out, CAP, d, f);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- bf16

constexpr int kBox = 64;                       // a TMA box: 64 columns x 64 rows of bf16
constexpr int kBoxBytes = kBox * kBox * 2;     // 8 KB, 128-byte rows, 128-byte swizzle
constexpr int kRowBytes = kBox * 2;            // one token row of a box: 64 values
// The weights' (A, MN-major) descriptor: LBO steps from one 64-column block
// to the next (unused: a box is one block), SBO from 8 reduction rows to
// the next (1024 bytes); the token rows' (B, K-major) SBO steps 8 rows.
constexpr uint32_t kLboA = 1024;
constexpr int kQueue = 16;  // item ids in flight from producer to consumers: more than the ring's stages

// A block: R x C consumer warpgroups and one producer warp (one thread of
// it issues the loads).  Warpgroup
// (r, c) owns token rows [r * N, (r + 1) * N) of the item's row block and
// weight boxes 2c and 2c + 1 of every ring stage.
template <int N, int R, int C>
struct Cfg {
  static_assert(N % 8 == 0 && N >= 8 && N <= 128, "wgmma n: a multiple of 8, at most 128 here");
  static constexpr int kConsumers = 128 * R * C;
  static constexpr int kThreads = kConsumers + 32;  // and a producer warp
  static constexpr int kTokBytes = N * kRowBytes;              // one warpgroup's token box
  static constexpr int kStageBytes = 2 * C * kBoxBytes + R * kTokBytes;
  static_assert(kStageBytes % 1024 == 0, "stages stay 1024-aligned for the 128-byte swizzle");
};

struct Params {
  const int* s2e;
  const int* active;
  bf16* h;             // [S, CAP, f]
  bf16* out;           // [S, CAP, d]
  unsigned* counters;  // [2, S * n_rb]: phase-A tiles done, phase-B items started
  int S, CAP, d, f;
  int n_rb;            // row blocks of R * N rows a slot
  int tiles_a;         // phase-A items a row block: 64 * C columns of h each
  int tiles_b;         // phase-B items a row block: 128 * C columns of out each
  int stages;          // ring depth
};

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma
// that it cannot see writing them
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] . B[16 x N]: A (the weights) MN-major, B (the
// token rows) K-major, both from shared memory; f32 accumulators
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tn<8>(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tn<16>(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tn<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tn<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tn<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The work list, the same in every block and in the Python model
// (ops.py:work_items): the live slots in order, each in n_rb row blocks
// ("units"); first every unit's tiles_a phase-A items, then every unit's
// tiles_b phase-B items.  The blocks take items in this order from one
// counter, or block b items b, b + G, ... (the producer's next()).
struct Item {
  bool a;
  int s, rb, ct, unit;
};

__device__ __forceinline__ Item item_at(const Params& p, const int* live, int items_a, int it) {
  Item t;
  t.a = it < items_a;
  const int j = t.a ? it : it - items_a;
  const int tiles = t.a ? p.tiles_a : p.tiles_b;
  const int q = j / tiles;
  t.ct = j % tiles;
  t.s = live[q / p.n_rb];
  t.rb = q % p.n_rb;
  t.unit = t.s * p.n_rb + t.rb;
  return t;
}

// first output column of weight box b (0 .. 2C - 1) of an item, and its width
template <int C>
__device__ __forceinline__ int box_col(const Params& p, const Item& t, int b) {
  return t.a ? t.ct * 64 * C + 64 * (b / 2) : t.ct * 128 * C + 64 * b;
}

// The producer: one thread keeps the ring full, item after item.
template <int N, int R, int C>
__device__ __forceinline__ void produce(const Params& p, const int* live, int items_a, int items,
                                        int* queue, unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* map_wg, const CUtensorMap* map_wu,
                                        const CUtensorMap* map_wd, const CUtensorMap* map_x,
                                        const CUtensorMap* map_h) {
  using K = Cfg<N, R, C>;
  unsigned* done_a = p.counters;
  unsigned* started_b = p.counters + p.S * p.n_rb;
  // the weights stream through L2 once: evict them first, so the token
  // rows and h, which every column tile of a slot reads, stay
  uint64_t stream_once, keep;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(stream_once));
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep));
  unsigned* next_item = p.counters + 2 * p.S * p.n_rb;
  unsigned* blocks_out = next_item + 1;
  int stage = 0, seq = 0;
  uint32_t phase = 0;
  // The next item: with two column warpgroups (33+ rows: long items), the
  // next of the list for whichever block asks first, claimed while the
  // current item's last stage waits for room (the atomic's latency hides
  // behind that wait), so the blocks end within one item of each other;
  // with one (decode), items b, b + G, ... in lockstep, so the column tiles
  // of a slot stream each weight row together (2-3% faster there than
  // claiming, which is 2-3% faster at 64 and 128 rows).  The consumers
  // learn it through the queue, published by its first stage's barrier.
  auto next = [&]() { return C > 1 ? (int)atomicAdd(next_item, 1u) : blockIdx.x + seq * gridDim.x; };
  int it = next();
  while (true) {
    mbar_wait(smem_u32(empty + stage), phase ^ 1);
    queue[seq % kQueue] = it < items ? it : -1;
    if (it >= items) {  // the list is spent: tell the consumers; the last
      // block out resets the counter for the next launch
      if (C > 1 && atomicAdd(blocks_out, 1u) == gridDim.x - 1) {
        atomicExch(next_item, 0u);
        atomicExch(blocks_out, 0u);
      }
      mbar_arrive(smem_u32(full + stage));
      return;
    }
    ++seq;
    const Item t = item_at(p, live, items_a, it);
    const int e = p.s2e[t.s];
    const int n_out = t.a ? p.f : p.d;
    const int nk = ((t.a ? p.d : p.f) + kBox - 1) / kBox;
    if (!t.a) {  // h of this unit: every phase-A tile written
      long long t0 = 0;
      while (true) {
        unsigned v;
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(done_a + t.unit) : "memory");
        if (v >= (unsigned)p.tiles_a) break;
        spin_check(t0);
      }
      asm volatile("fence.proxy.async;\n" ::: "memory");  // h's stores, then TMA's reads of h
      if (atomicAdd(started_b + t.unit, 1u) == (unsigned)p.tiles_b - 1) {
        atomicExch(done_a + t.unit, 0u);
        atomicExch(started_b + t.unit, 0u);
      }
    }
    uint32_t bytes = R * K::kTokBytes;
#pragma unroll
    for (int b = 0; b < 2 * C; ++b)
      if (box_col<C>(p, t, b) < n_out) bytes += kBoxBytes;
    const CUtensorMap* tok = t.a ? map_x : map_h;
    const int row0 = t.rb * R * N;
    int claimed = 0;
    for (int kt = 0; kt < nk; ++kt) {
      if (kt == nk - 1) claimed = next();
      if (kt > 0) mbar_wait(smem_u32(empty + stage), phase ^ 1);
      const uint32_t bar = smem_u32(full + stage);
      const uint32_t st = smem_u32(ring + stage * K::kStageBytes);
      mbar_expect_tx(bar, bytes);
#pragma unroll
      for (int b = 0; b < 2 * C; ++b) {
        const int col = box_col<C>(p, t, b);
        if (col < n_out)
          tma_load(st + b * kBoxBytes, t.a ? (b % 2 ? map_wu : map_wg) : map_wd, bar, col,
                   kt * kBox, e, stream_once);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        tma_load(st + 2 * C * kBoxBytes + r * K::kTokBytes, tok, bar, kt * kBox, row0 + r * N, t.s,
                 keep);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    it = claimed;
  }
}

// The consumers: R x C warpgroups run wgmma on each stage as it lands, then
// write the item's tile of h (with silu * mul) or of out.
template <int N, int R, int C>
__device__ __forceinline__ void consume(const Params& p, const int* live, int items_a,
                                        const int* queue, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty) {
  using K = Cfg<N, R, C>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned* done_a = p.counters;
  const int wg = warp / 4, wr = wg / C, wc = wg % C;
  const int t128 = tid % 128, w4 = t128 / 32;
  // zeros for the slots that do no work (read no weights)
  for (int s = blockIdx.x; s < p.S; s += gridDim.x) {
    if (p.active[s] != 0 && p.s2e[s] >= 0) continue;
    uint4* o = reinterpret_cast<uint4*>(p.out + (size_t)s * p.CAP * p.d);
    const int n16 = p.CAP * p.d / 8;
    for (int i = tid; i < n16; i += K::kConsumers) o[i] = make_uint4(0, 0, 0, 0);
  }

  float acc0[N / 2], acc1[N / 2];
  int stage = 0, seq = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(smem_u32(full + stage), phase);
    const int it = queue[seq++ % kQueue];
    if (it < 0) return;
    const Item t = item_at(p, live, items_a, it);
    const int nk = ((t.a ? p.d : p.f) + kBox - 1) / kBox;
    const int col0 = box_col<C>(p, t, 2 * wc), col1 = box_col<C>(p, t, 2 * wc + 1);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc0[i] = acc1[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      if (kt > 0) mbar_wait(smem_u32(full + stage), phase);
      const uint32_t st = smem_u32(ring + stage * K::kStageBytes);
      const uint32_t w0 = st + (2 * wc) * kBoxBytes, w1 = w0 + kBoxBytes;
      const uint32_t xb = st + 2 * C * kBoxBytes + wr * K::kTokBytes;
      // every warpgroup runs both products on every stage, with no branch
      // around them (a branch serialises wgmma); a box past the output's
      // edge was not loaded, and its product is never stored
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) {
        // weights: 16 reduction rows of 128 bytes from row 16 kk; tokens:
        // 16 reduction values (32 bytes) of every row from value 16 kk
        const uint64_t db = desc_sw128(xb + kk * 32, 16, 1024);
        wgmma_tn<N>(acc0, desc_sw128(w0 + kk * 16 * kRowBytes, kLboA, 1024), db);
        wgmma_tn<N>(acc1, desc_sw128(w1 + kk * 16 * kRowBytes, kLboA, 1024), db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc0);
      fence_regs(acc1);
      if (lane == 0) mbar_arrive(smem_u32(empty + stage));
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // accumulator i: output column (m) 16 w4 + lane / 4 (+ 8 for i % 4 >= 2),
    // token row (n) 8 (i / 4) + 2 (lane % 4) (+ 1 for odd i); offsets inside
    // a slot fit 32 bits (the wrapper checks CAP * max(d, f))
    const int row_base = t.rb * R * N + wr * N + 2 * (lane & 3);
    const int m_base = 16 * w4 + (lane >> 2);
    if (t.a) {
      bf16* hs = p.h + (size_t)t.s * p.CAP * p.f;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int row = row_base + 8 * (i >> 2) + (i & 1);
        const int col = col0 + m_base + 8 * ((i >> 1) & 1);
        if (row < p.CAP && col < p.f) {
          const float g = acc0[i];
          hs[row * p.f + col] = __float2bfloat16_rn(g / (1.f + expf(-g)) * acc1[i]);
        }
      }
      asm volatile("fence.proxy.async;\n" ::: "memory");  // for the TMA reads of h
      asm volatile("bar.sync 1, %0;\n" ::"r"(K::kConsumers) : "memory");
      if (tid == 0) {
        __threadfence();
        atomicAdd(done_a + t.unit, 1u);
      }
    } else {
      bf16* os = p.out + (size_t)t.s * p.CAP * p.d;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int row = row_base + 8 * (i >> 2) + (i & 1);
        const int m = m_base + 8 * ((i >> 1) & 1);
        if (row < p.CAP) {
          if (col0 + m < p.d) os[row * p.d + col0 + m] = __float2bfloat16_rn(acc0[i]);
          if (col1 + m < p.d) os[row * p.d + col1 + m] = __float2bfloat16_rn(acc1[i]);
        }
      }
    }
  }
}

// Both phases in one launch over a persistent grid (<= one block an SM, all
// resident).  Phase A: h[s] = bf16(silu(x[s] Wg[e]) * (x[s] Wu[e])), 64 * C
// columns an item; phase B: out[s] = bf16(h[s] Wd[e]), 128 * C columns an
// item; e = slot_to_expert[s].  A phase-B item waits until its unit's
// tiles_a phase-A items are done (a counter, release/acquire); the last of
// its tiles_b items resets both counters, so each launch starts from zero.
// Every item a B item waits on was taken earlier by a running block, whose
// producer issued all its loads before it took another: no deadlock.
template <int N, int R, int C>
__global__ void __launch_bounds__(Cfg<N, R, C>::kThreads, 1)
    expert_ffn_wgmma(const __grid_constant__ CUtensorMap map_wg,
                     const __grid_constant__ CUtensorMap map_wu,
                     const __grid_constant__ CUtensorMap map_wd,
                     const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_h, const Params p) {
  using K = Cfg<N, R, C>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * K::kStageBytes);
  uint64_t* empty = full + p.stages;
  int* live = reinterpret_cast<int*>(empty + p.stages);  // [S]
  int* warp_live = live + p.S;                           // [kThreads / 32]
  int* queue = warp_live + 9;                            // [kQueue] item ids

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == K::kConsumers) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(smem_u32(full + i), 1);
      mbar_init(smem_u32(empty + i), 4 * R * C);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (const CUtensorMap* m : {&map_wg, &map_wu, &map_wd, &map_x, &map_h})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)m) : "memory");
  }
  // the live slots, in order: every thread tests a slot, warps count theirs
  int n_live = 0;
  for (int s0 = 0; s0 < p.S; s0 += K::kThreads) {
    const int s = s0 + tid;
    const int a = s < p.S ? p.active[s] : 0, e = s < p.S ? p.s2e[s] : -1;
    const unsigned m = __ballot_sync(0xffffffffu, a != 0 && e >= 0);
    if (lane == 0) warp_live[warp] = __popc(m);
    __syncthreads();
    int pos = n_live;
    for (int w = 0; w < K::kThreads / 32; ++w) {
      if (w == warp) pos = n_live;
      n_live += warp_live[w];
    }
    if (a != 0 && e >= 0) live[pos + __popc(m & ((1u << lane) - 1))] = s;
    __syncthreads();
  }
  const int units = n_live * p.n_rb;
  const int items_a = units * p.tiles_a;
  const int items = items_a + units * p.tiles_b;
  if (tid >= K::kConsumers) {
    if (tid == K::kConsumers)
      produce<N, R, C>(p, live, items_a, items, queue, ring, full, empty, &map_wg, &map_wu, &map_wd,
                       &map_x, &map_h);
  } else {
    consume<N, R, C>(p, live, items_a, queue, ring, full, empty);
  }
}

// ------------------------------------------------------------------- host

template <int N, int R, int C>
cudaError_t launch_wgmma(int device, const CUtensorMap* maps, const Params& p, int grid, int smem,
                         cudaStream_t st) {
  static bool ready[repro::kMaxDevices] = {};  // under tma_mutex
  auto kern = expert_ffn_wgmma<N, R, C>;
  cudaError_t err = repro::allow_smem(kern, device, ready);
  if (err != cudaSuccess) return err;
  kern<<<grid, Cfg<N, R, C>::kThreads, smem, st>>>(maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return cudaGetLastError();
}

}  // namespace

// The bf16 path: one launch.  The tile (n_rows = N, row_wgs = R, col_wgs =
// C), ring depth, shared-memory bytes and grid come from the wrapper's plan
// (ops.py:bf16_plan); counters is its zeroed [2, S * n_rb] int32 scratch.
REPRO_EXPORT int expert_ffn_bf16(const void* x, const void* w_gate, const void* w_up,
                                 const void* w_down, const int* s2e, const int* active, void* h,
                                 void* out, void* counters, int S, int CAP, int d, int f, int E,
                                 int n_rows, int row_wgs, int col_wgs, int n_rb, int stages,
                                 int smem, int grid, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (S == 0 || CAP == 0) return 0;
  if (d % 8 || f % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];
  {
    std::lock_guard<std::mutex> lock(repro::tma_mutex());
    using repro::tensor_map;
    if (!tensor_map(&maps[0], w_gate, f, d, E, kBox, 1) || !tensor_map(&maps[1], w_up, f, d, E, kBox, 1) ||
        !tensor_map(&maps[2], w_down, d, f, E, kBox, 1) || !tensor_map(&maps[3], x, d, CAP, S, n_rows, 1) ||
        !tensor_map(&maps[4], h, f, CAP, S, n_rows, 1))
      return (int)cudaErrorInvalidValue;
  }
  Params p{s2e, active, (bf16*)h, (bf16*)out, (unsigned*)counters, S, CAP, d, f, n_rb,
           (f + 64 * col_wgs - 1) / (64 * col_wgs), (d + 128 * col_wgs - 1) / (128 * col_wgs), stages};
  cudaStream_t st = (cudaStream_t)stream;
  std::lock_guard<std::mutex> lock(repro::tma_mutex());
#define REPRO_K3(NN, RR, CC) \
  if (n_rows == NN && row_wgs == RR && col_wgs == CC) return (int)launch_wgmma<NN, RR, CC>(device, maps, p, grid, smem, st)
  REPRO_K3(8, 1, 1);
  REPRO_K3(16, 1, 1);
  REPRO_K3(32, 1, 1);
  REPRO_K3(64, 1, 2);
  REPRO_K3(128, 1, 2);
  REPRO_K3(128, 2, 1);
#undef REPRO_K3
  return (int)cudaErrorInvalidValue;
}

REPRO_EXPORT int expert_ffn(const void* x, const void* w_gate, const void* w_up,
                            const void* w_down, const int* s2e, const int* active, void* h,
                            void* out, int S, int CAP, int d, int f, int dtype, int device,
                            void* stream) {
  REPRO_SET_DEVICE(device);
  if (S == 0 || CAP == 0) return 0;
  if (dtype != REPRO_F32) return (int)cudaErrorInvalidValue;
  return launch_f32(x, w_gate, w_up, w_down, s2e, active, h, out, S, CAP, d, f, (cudaStream_t)stream);
}
