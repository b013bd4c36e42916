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
// accumulates h @ Wd in f32 over all of f and rounds once.  The TPU kernel
// instead rounds its output block to x.dtype after every d_ff tile (11 tiles
// of 128 at f = 1408), so the two differ within bf16 tolerance, not bitwise.
//
// Bound on the H100: bytes at decode.  Each activated expert streams
// 3 * d * f weights (17.3 MB in bf16 at dsv2-lite) for CAP = 4 rows, about
// 4 FLOP per weight byte against the ~295 where compute would bind.  Prefill
// chunks (CAP = 64) sit nearer the ridge.
//
// Design: two launches.  Phase A: grid (f tiles of 64, slots); a block of
// 256 threads = 64 f-columns x 4 partial sums over d; x rows are staged in
// shared memory 8 rows x 128 d at a time, each thread streams its weight
// column coalesced across the warp and keeps 8 row accumulators for gate and
// up, the 4 partials are reduced through shared memory, and silu(g) * u is
// rounded into a [S, CAP, f] scratch.  Phase B: grid (d tiles of 64, slots),
// the same shape over f with Wd.  Blocks of inactive slots exit at once
// (phase B writes their zero tile).  Plain FMAs, no tensor cores: wgmma and
// TMA pipelines are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 64;                 // output columns per block
constexpr int kSplit = kThreads / kCols;  // partial sums over the reduction axis
constexpr int kRows = 8;                  // capacity rows per pass
constexpr int kStage = 128;               // reduction-axis elements staged per step

__device__ __forceinline__ bool slot_live(const int* s2e, const int* active, int s) {
  return active[s] != 0 && s2e[s] >= 0;
}

// phase A: h[s, c, :] = silu(x[s, c] @ Wg[e]) * (x[s, c] @ Wu[e]), in x's dtype
template <typename T>
__global__ void __launch_bounds__(kThreads) expert_gate_up_kernel(
    const T* __restrict__ x, const T* __restrict__ w_gate, const T* __restrict__ w_up,
    const int* __restrict__ s2e, const int* __restrict__ active, T* __restrict__ h,
    int CAP, int d, int f) {
  using repro::from_f;
  using repro::to_f;
  const int s = blockIdx.y;
  if (!slot_live(s2e, active, s)) return;
  const size_t e = (size_t)s2e[s];
  const int col = threadIdx.x % kCols;
  const int part = threadIdx.x / kCols;
  const int fc = blockIdx.x * kCols + col;

  __shared__ float x_s[kRows][kStage];
  __shared__ float red_g[kSplit][kRows][kCols];
  __shared__ float red_u[kSplit][kRows][kCols];

  const T* wg = w_gate + e * d * f;
  const T* wu = w_up + e * d * f;
  const T* xs = x + (size_t)s * CAP * d;

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
        x_s[r][dd] = (r < nr && dd < nd) ? to_f(xs[(size_t)(r0 + r) * d + d0 + dd]) : 0.f;
      }
      __syncthreads();
      if (fc < f) {
#pragma unroll 4
        for (int dd = part; dd < nd; dd += kSplit) {
          const size_t wi = (size_t)(d0 + dd) * f + fc;
          const float g = to_f(wg[wi]);
          const float u = to_f(wu[wi]);
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
        h[((size_t)s * CAP + r0 + r) * f + fcc] = from_f<T>(silu * u);
      }
    }
  }
}

// phase B: out[s, c, :] = h[s, c] @ Wd[e], f32 over all of f, rounded once
template <typename T>
__global__ void __launch_bounds__(kThreads) expert_down_kernel(
    const T* __restrict__ h, const T* __restrict__ w_down, const int* __restrict__ s2e,
    const int* __restrict__ active, T* __restrict__ out, int CAP, int d, int f) {
  using repro::from_f;
  using repro::to_f;
  const int s = blockIdx.y;
  const int col = threadIdx.x % kCols;
  const int part = threadIdx.x / kCols;
  const int dc = blockIdx.x * kCols + col;
  T* os = out + (size_t)s * CAP * d;

  if (!slot_live(s2e, active, s)) {
    for (int i = threadIdx.x; i < CAP * kCols; i += kThreads) {
      const int r = i / kCols, c = blockIdx.x * kCols + i % kCols;
      if (c < d) os[(size_t)r * d + c] = from_f<T>(0.f);
    }
    return;
  }
  const size_t e = (size_t)s2e[s];

  __shared__ float h_s[kRows][kStage];
  __shared__ float red[kSplit][kRows][kCols];

  const T* wd = w_down + e * f * d;
  const T* hs = h + (size_t)s * CAP * f;

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
        h_s[r][ff] = (r < nr && ff < nf) ? to_f(hs[(size_t)(r0 + r) * f + f0 + ff]) : 0.f;
      }
      __syncthreads();
      if (dc < d) {
#pragma unroll 4
        for (int ff = part; ff < nf; ff += kSplit) {
          const float w = to_f(wd[(size_t)(f0 + ff) * d + dc]);
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
        os[(size_t)(r0 + r) * d + dcc] = from_f<T>(v);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, const int* s2e,
           const int* active, void* h, void* out, int S, int CAP, int d, int f,
           cudaStream_t st) {
  const dim3 grid_a((f + kCols - 1) / kCols, S);
  expert_gate_up_kernel<T><<<grid_a, kThreads, 0, st>>>(
      (const T*)x, (const T*)wg, (const T*)wu, s2e, active, (T*)h, CAP, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((d + kCols - 1) / kCols, S);
  expert_down_kernel<T><<<grid_b, kThreads, 0, st>>>((const T*)h, (const T*)wd, s2e, active,
                                                     (T*)out, CAP, d, f);
  return (int)cudaGetLastError();
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
    return launch<__nv_bfloat16>(x, w_gate, w_up, w_down, s2e, active, h, out, S, CAP, d, f, st);
  if (dtype == REPRO_F32)
    return launch<float>(x, w_gate, w_up, w_down, s2e, active, h, out, S, CAP, d, f, st);
  return (int)cudaErrorInvalidValue;
}
