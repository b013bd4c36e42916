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
// Rounding: phase A rounds h to x.dtype, as the TPU kernel does; phase B
// accumulates h @ Wd in f32 over all of f inside one block and rounds once.
// The TPU kernel instead rounds its output block to x.dtype after every
// d_ff tile (11 tiles of 128 at f = 1408), so the two differ within bf16
// tolerance, not bitwise.  No sum crosses blocks, so results do not change
// from run to run.
//
// Bound on the H100: bytes.  Each activated expert streams 3 * d * f
// weights (17.3 MB in bf16 at dsv2-lite) for CAP rows: 2 * CAP FLOP per
// weight byte, 8 at decode (CAP 4) and 128 at a 64-token prefill chunk, both
// below the ~295 FLOP/B where the tensor cores would bind.  So the design
// streams every weight byte from device memory once per launch, whatever
// CAP is, with enough bytes in flight to keep the memory busy.
//
// Design (bf16), replacing the first version's plain-FMA kernels, which
// streamed each weight once per 8 rows (8 times at a 64-token prefill
// chunk) and loaded 2 bytes a thread (0.37 ms at decode and 5.2 ms at a
// 64-token prefill chunk on the H100, against 0.20 and 0.45 now): two
// launches of one GEMM template, phase A (x @ Wg and x @ Wu, silu * mul, h
// rounded to bf16 into a [S, CAP, f] scratch) and phase B (h @ Wd).  A
// block owns one slot and a tile of output columns, and ALL of the slot's
// CAP rows (up to 256): the loop over the reduction axis is the outer and
// only loop, so each weight tile is read once and used for every row.  A
// CAP above 256 (a prefill chunk of more than 256 tokens; the engine's is
// 64) runs as launches over blocks of 256 rows, each streaming the weights
// once.
//   * Weight tiles (64 reduction rows x the block's columns) and the
//     matching slice of the slot's token rows arrive through a ring in
//     shared memory, fed by 16-byte cp.async copies (cache-global: the
//     weights are a stream).  Rows are padded by 16 bytes so ldmatrix is
//     conflict-free.  The ring has 2 stages: what keeps bytes in flight is
//     the number of resident blocks (5 an SM at decode, each with a stage
//     in flight while it computes on the other), and on the H100 3, 4 and
//     6 stages, which fit fewer blocks, were slower.
//   * Products run on the tensor cores, mma.sync.m16n8k16 bf16 with f32
//     accumulators, "swap AB": the weights sit on the MMA's 16-row side
//     (out^T = W^T . x^T, weight fragments by ldmatrix.trans) and the token
//     rows on its 8-wide side, so CAP pads to a multiple of 8, not 16 or 64.
//     This mapping serves prefill too: at CAP 64 each weight fragment feeds
//     8 MMAs, the same operand reuse as putting the rows on M, and the
//     kernel stays bound by bytes either way.
//   * The launcher picks the tile from CAP: NT in {1, 2, 4, 8} n-tiles of 8
//     rows per warp; 4 warps over 64 columns for up to 16 rows (decode), 8
//     warps over 128 columns up to 128 rows (prefill: twice the warps share
//     each stage's token slice); 1-4 warp sets over the rows beyond (up to
//     256 rows a launch).  Blocks of inactive slots exit
//     before any load (phase B writes their zeros).
//   * Grid (column tiles, slots): at decode (64 slots, ~30 active) that is
//     ~660 live blocks for phase A and ~960 for phase B on 132 SMs.
// The wrapper checks what the 16-byte copies need (d and f multiples of 8,
// 16-byte-aligned tensors).
//
// float32 stays on CUDA cores in full f32 (no TF32): the first version's
// kernels, two launches of plain FMAs over row groups of 8.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

constexpr int kPad = 8;  // bf16 padding per shared row: 16 bytes, so ldmatrix is conflict-free

// A block's tile: WarpsN warps over 16 * WarpsN output columns, TileK
// reduction rows per ring stage, Ring stages, up to MaxRowWarps warp sets
// over the rows (512 threads at most).
template <int WarpsN, int TileK, int Ring>
struct Tile {
  static constexpr int kWarpsN = WarpsN;
  static constexpr int kTileN = 16 * WarpsN;
  static constexpr int kTileK = TileK;
  static constexpr int kRing = Ring;
  static constexpr int kLdW = kTileN + kPad;  // shared row stride of a weight tile
  static constexpr int kLdX = TileK + kPad;   // shared row stride of the token slice
  static constexpr int kMaxRowWarps = 16 / WarpsN;
  static constexpr int kThreads = 32 * WarpsN * kMaxRowWarps;
  // bf16 elements of one ring stage: kW weight tiles, then the token slice
  __host__ __device__ static constexpr int stage_elems(int kW, int rows) {
    return kW * TileK * kLdW + rows * kLdX;
  }
};
// Measured on the H100 at dsv2-lite's widths: 64 columns at decode (CAP 4),
// 128 at a 64-token prefill chunk (twice the warps share each stage's
// token slice); stages of 64 rows; 2 stages, because a smaller ring fits
// more blocks on an SM, and resident blocks keep more bytes in flight than
// a deeper ring does (3, 4 and 6 stages, and stages of 32 rows, were
// slower at both shapes).
using DecodeTile = Tile<4, 64, 2>;
using PrefillTile = Tile<8, 64, 2>;
constexpr int kMaxCap = DecodeTile::kMaxRowWarps * 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One phase for one slot and a tile of output columns: out[r, n] over nr
// rows r of the slot, reducing over K.  GateUp: W0 = Wg, W1 = Wu and
// out = bf16(silu(x W0) * (x W1)); otherwise out = bf16(x W0).  Slot s's
// rows start at x + s * CAP * K and out + s * CAP * N (the launcher offsets
// x and out to a block of rows), the weights are [E, K, N].  blockDim.x =
// 32 * WarpsN * (row warp sets); each warp set holds NT * 8 rows.
template <int NT, bool GateUp, class Tl>
__global__ void __launch_bounds__(Tl::kThreads) expert_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w0, const bf16* __restrict__ w1,
    const int* __restrict__ s2e, const int* __restrict__ active, bf16* __restrict__ out,
    int CAP, int nr, int K, int N) {
  static_assert(NT == 1 || NT % 2 == 0, "row n-tiles are loaded in pairs");
  constexpr int kW = GateUp ? 2 : 1;
  const int s = blockIdx.y;
  const int n0 = blockIdx.x * Tl::kTileN;
  const int tid = threadIdx.x;
  bf16* os = out + (size_t)s * CAP * N;
  if (!slot_live(s2e, active, s)) {
    if (!GateUp)  // phase B writes the inactive slot's zeros; phase A's h is never read
      for (int i = tid; i < nr * Tl::kTileN; i += blockDim.x) {
        const int r = i / Tl::kTileN, c = n0 + i % Tl::kTileN;
        if (c < N) os[(size_t)r * N + c] = __float2bfloat16_rn(0.f);
      }
    return;
  }
  const int rows = (blockDim.x / (32 * Tl::kWarpsN)) * NT * 8;  // nr padded, held in the ring
  const int n_stage = Tl::stage_elems(kW, rows);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const size_t e = (size_t)s2e[s];
  const bf16* wa = w0 + e * K * N;
  const bf16* wb = GateUp ? w1 + e * K * N : wa;
  const bf16* xs = x + (size_t)s * CAP * K;
  const int nk = (K + Tl::kTileK - 1) / Tl::kTileK;

  // stage <- weight rows [k0, k0 + TileK) x columns [n0, n0 + TileN), and
  // the token slice [rows, k0 : k0 + TileK); out-of-range chunks are
  // zero-filled
  auto load_stage = [&](int stage, int kt) {
    bf16* st = ring + stage * n_stage;
    const int k0 = kt * Tl::kTileK;
    constexpr int kChunksW = Tl::kTileK * (Tl::kTileN / 8);
#pragma unroll
    for (int m = 0; m < kW; ++m) {
      const bf16* w = m == 0 ? wa : wb;
      for (int i = tid; i < kChunksW; i += blockDim.x) {
        const int r = i / (Tl::kTileN / 8), c = (i % (Tl::kTileN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(st + (m * Tl::kTileK + r) * Tl::kLdW + c,
                   ok ? w + (size_t)(k0 + r) * N + n0 + c : w, ok);
      }
    }
    bf16* xt = st + kW * Tl::kTileK * Tl::kLdW;
    for (int i = tid; i < rows * (Tl::kTileK / 8); i += blockDim.x) {
      const int r = i / (Tl::kTileK / 8), c = (i % (Tl::kTileK / 8)) * 8;
      const bool ok = r < nr && k0 + c < K;
      cp_async16(xt + r * Tl::kLdX + c, ok ? xs + (size_t)r * K + k0 + c : xs, ok);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wn = warp % Tl::kWarpsN;  // this warp's 16 columns
  const int wr = warp / Tl::kWarpsN;  // this warp's NT * 8 rows
  float acc[kW][NT][4];
#pragma unroll
  for (int m = 0; m < kW; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

  // ldmatrix addresses: lane l gives row (l & 7) of 8x8 matrix (l >> 3).
  // Weight fragment (ldmatrix.trans of the [k][n] tile): matrices
  // (k 0-7, n 0-7), (k 0-7, n 8-15), (k 8-15, n 0-7), (k 8-15, n 8-15).
  const int a_off =
      (((lane >> 4) << 3) + (lane & 7)) * Tl::kLdW + wn * 16 + ((lane >> 3) & 1) * 8;
  // Row fragments of n-tiles j, j + 1: (j, k 0-7), (j, k 8-15), (j+1, k 0-7), (j+1, k 8-15).
  const int l = NT == 1 ? (lane & 15) : lane;
  const int b_off = (wr * NT * 8 + ((l >> 4) << 3) + (l & 7)) * Tl::kLdX + ((l >> 3) & 1) * 8;

#pragma unroll
  for (int i = 0; i < Tl::kRing - 1; ++i) {
    if (i < nk) load_stage(i, i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<Tl::kRing - 2>();  // stage kt has landed (for this thread) ...
    __syncthreads();             // ... for every thread, and stage kt - 1 is consumed
    const int next = kt + Tl::kRing - 1;
    if (next < nk) load_stage(next % Tl::kRing, next);
    cp_async_commit();
    const bf16* st = ring + (kt % Tl::kRing) * n_stage;
    const bf16* xt = st + kW * Tl::kTileK * Tl::kLdW;
#pragma unroll
    for (int kk = 0; kk < Tl::kTileK; kk += 16) {
      uint32_t a[kW][4];
#pragma unroll
      for (int m = 0; m < kW; ++m)
        ldsm_x4_trans(a[m], st + (m * Tl::kTileK + kk) * Tl::kLdW + a_off);
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldsm_x2(b, xt + b_off + kk);
#pragma unroll
        for (int m = 0; m < kW; ++m) mma_bf16(acc[m][0], a[m], b[0], b[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldsm_x4(b, xt + b_off + j * 8 * Tl::kLdX + kk);
#pragma unroll
          for (int m = 0; m < kW; ++m) {
            mma_bf16(acc[m][j], a[m], b[0], b[1]);
            mma_bf16(acc[m][j + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (i): column n0 + wn*16 + lane/4 (+8 for i >= 2), row
  // wr*NT*8 + j*8 + 2*(lane%4) (+1 for odd i)
  const int col0 = n0 + wn * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wr * NT * 8 + j * 8 + 2 * (lane & 3) + (i & 1);
      const int c = col0 + (i >> 1) * 8;
      if (r < nr && c < N) {
        float v = acc[0][j][i];
        if constexpr (GateUp) v = v / (1.f + expf(-v)) * acc[kW - 1][j][i];
        os[(size_t)r * N + c] = __float2bfloat16_rn(v);
      }
    }
}

template <int NT, bool GateUp, class Tl>
cudaError_t launch_mma(int row_warps, const bf16* x, const bf16* w0, const bf16* w1,
                       const int* s2e, const int* active, bf16* out, int S, int CAP, int r0,
                       int nr, int K, int N, cudaStream_t st) {
  constexpr int kW = GateUp ? 2 : 1;
  const int rows = row_warps * NT * 8;
  const int smem = Tl::kRing * Tl::stage_elems(kW, rows) * (int)sizeof(bf16);
  // allow this instance's largest ring on the current device: set at every
  // launch (a cheap host call), so every device and host thread has it
  const int most =
      Tl::kRing * Tl::stage_elems(kW, Tl::kMaxRowWarps * NT * 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(expert_mma_kernel<NT, GateUp, Tl>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Tl::kTileN - 1) / Tl::kTileN, S);
  expert_mma_kernel<NT, GateUp, Tl><<<grid, 32 * Tl::kWarpsN * row_warps, smem, st>>>(
      x + (size_t)r0 * K, w0, w1, s2e, active, out + (size_t)r0 * N, CAP, nr, K, N);
  return cudaGetLastError();
}

template <int NT, class Tl>
int launch_bf16_nt(int row_warps, const void* x, const void* wg, const void* wu,
                   const void* wd, const int* s2e, const int* active, void* h, void* out,
                   int S, int CAP, int r0, int nr, int d, int f, cudaStream_t st) {
  cudaError_t err = launch_mma<NT, true, Tl>(row_warps, (const bf16*)x, (const bf16*)wg,
                                             (const bf16*)wu, s2e, active, (bf16*)h, S, CAP,
                                             r0, nr, d, f, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_mma<NT, false, Tl>(row_warps, (const bf16*)h, (const bf16*)wd, nullptr,
                                        s2e, active, (bf16*)out, S, CAP, r0, nr, f, d, st);
}

// Rows [r0, r0 + nr) of every slot, nr <= kMaxCap.  The tile from nr:
// n-tiles of 8 rows per warp (1, 2, 4 or 8), the block shape (DecodeTile up
// to 16 rows, PrefillTile up to 128, DecodeTile with up to 4 warp sets
// beyond), and warp sets over the rows, so the block holds all nr rows.
int launch_bf16_rows(const void* x, const void* wg, const void* wu, const void* wd,
                     const int* s2e, const int* active, void* h, void* out, int S, int CAP,
                     int r0, int nr, int d, int f, cudaStream_t st) {
  const int tiles = (nr + 7) / 8;
  const int nt = tiles <= 1 ? 1 : tiles <= 2 ? 2 : tiles <= 4 ? 4 : 8;
  const int row_warps = (tiles + nt - 1) / nt;
#define REPRO_K3(NT, TL) \
  launch_bf16_nt<NT, TL>(row_warps, x, wg, wu, wd, s2e, active, h, out, S, CAP, r0, nr, d, f, st)
  if (nt == 1) return REPRO_K3(1, DecodeTile);
  if (nt == 2) return REPRO_K3(2, DecodeTile);
  if (nt == 4) return REPRO_K3(4, PrefillTile);
  if (row_warps <= PrefillTile::kMaxRowWarps) return REPRO_K3(8, PrefillTile);
  return REPRO_K3(8, DecodeTile);
#undef REPRO_K3
}

// Up to kMaxCap rows a block holds all of a slot's rows, so each active
// slot's weights stream once.  A larger CAP (a prefill chunk of more than
// 256 tokens) runs in blocks of kMaxCap rows, each streaming the weights
// once more.
int launch_bf16(const void* x, const void* wg, const void* wu, const void* wd, const int* s2e,
                const int* active, void* h, void* out, int S, int CAP, int d, int f,
                cudaStream_t st) {
  if (d % 8 || f % 8) return (int)cudaErrorInvalidValue;
  for (int r0 = 0; r0 < CAP; r0 += kMaxCap) {
    const int err = launch_bf16_rows(x, wg, wu, wd, s2e, active, h, out, S, CAP, r0,
                                     CAP - r0 < kMaxCap ? CAP - r0 : kMaxCap, d, f, st);
    if (err) return err;
  }
  return 0;
}

}  // namespace

REPRO_EXPORT int expert_ffn(const void* x, const void* w_gate, const void* w_up,
                            const void* w_down, const int* s2e, const int* active, void* h,
                            void* out, int S, int CAP, int d, int f, int dtype, int device,
                            void* stream) {
  REPRO_SET_DEVICE(device);
  if (S == 0 || CAP == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == REPRO_BF16)
    return launch_bf16(x, w_gate, w_up, w_down, s2e, active, h, out, S, CAP, d, f, st);
  if (dtype == REPRO_F32)
    return launch_f32(x, w_gate, w_up, w_down, s2e, active, h, out, S, CAP, d, f, st);
  return (int)cudaErrorInvalidValue;
}
