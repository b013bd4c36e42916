// Hopper's asynchronous copies, shared by K1, K4, K5 (decode_attention.cu)
// and K3 (expert_ffn.cu): mbarrier waits and arrivals, a TMA box load, and the
// host's cache of tensor maps.
//
// A source that includes this header links with -lcuda
// (cuTensorMapEncodeTiled is a driver API call; kernels/cuda.py LINK_FLAGS).
#pragma once

#include <cuda.h>

#include <functional>
#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace repro {

constexpr long long kSpinCycles = 1LL << 35;  // ~17 s: a wait that long is a fault, not a wait

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void spin_check(long long& t0) {
  if (t0 == 0) t0 = clock64();
  else if (clock64() - t0 > kSpinCycles) __trap();
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    spin_check(t0);
  }
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing its bytes of the barrier's transaction count, with an
// L2 cache policy
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

// an L2 policy for bytes that one load reads once: evict them first
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// ------------------------------------------------------------------- host

// Tensor maps, cached: an encoding depends only on its key (address, shape,
// box), so a cached map is never stale.  Callers hold tma_mutex().
struct MapKey {
  const void* ptr;
  uint64_t inner, mid, outer;
  uint32_t box_mid, box_outer, elem;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && mid == o.mid && outer == o.outer &&
           box_mid == o.box_mid && box_outer == o.box_outer && elem == o.elem;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (uint64_t v : {k.inner, k.mid, k.outer, (uint64_t)k.box_mid, (uint64_t)k.box_outer, (uint64_t)k.elem})
      h = h * 1000003u ^ std::hash<uint64_t>()(v);
    return h;
  }
};

inline std::mutex& tma_mutex() {
  static std::mutex mu;
  return mu;
}

// A bf16 (elem 2) or uint8 (elem 1) [outer, mid, inner] array, boxes of 128
// bytes (inner) x box_mid (mid) x box_outer (outer): 128-byte rows of
// shared memory with the 128-byte swizzle (16-byte piece j of row r lands
// at piece j ^ (r % 8) of a 1024-byte-aligned destination), or where a row
// of the array holds 64 bytes, 64-byte rows with the 64-byte swizzle (piece
// j of row r at j ^ ((r / 2) % 4)).
inline bool tensor_map(CUtensorMap* out, const void* ptr, uint64_t inner, uint64_t mid, uint64_t outer,
                       uint32_t box_mid, uint32_t box_outer, uint32_t elem = 2) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{ptr, inner, mid, outer, box_mid, box_outer, elem};
  auto hit = maps.find(key);
  if (hit != maps.end()) {
    *out = hit->second;
    return true;
  }
  const bool wide = elem == 2 || inner * elem >= 128;
  cuuint64_t dims[3] = {inner, mid, outer};
  cuuint64_t strides[2] = {inner * elem, inner * mid * elem};
  cuuint32_t box[3] = {(wide ? 128u : 64u) / elem, box_mid, box_outer};
  cuuint32_t elem_strides[3] = {1, 1, 1};
  if (cuTensorMapEncodeTiled(out, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                             const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             wide ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (maps.size() > 4096) maps.clear();
  maps.emplace(key, *out);
  return true;
}

constexpr int kMaxDevices = 64;

// Lets `kern` take the most dynamic shared memory a block can (past the
// default 48 KB: 227 KB less its static shared memory), once a device;
// `ready` is the kernel's own flags.  Callers hold tma_mutex().
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kern, int device, bool (&ready)[kMaxDevices]) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448 - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  return cudaSuccess;
}

}  // namespace repro
