// K2: Activated-Expert-Balanced Scheduling (Janus Algorithm 1), one launch.
//
// Replaces the TPU kernels src/repro/kernels/aebs/kernel.py::
// _collect_and_greedy_kernel (K2a) and ::_rewrite_kernel (K2b), both
// launched by aebs_pallas.
//
// What it computes: the activated-expert bitmap over the [T, k] routed
// expert ids (ids < 0 are padding and activate nothing); then two greedy
// passes in ascending expert order -- single-replica experts go to their
// host, replicated experts to their least-loaded host with ties to the
// lowest replica index -- giving act_rep [E] (the chosen global slot, -1 for
// idle experts) and load [n_e]; finally slot_ids = act_rep[eids], keeping -1.
//
// Bound on the H100: neither bytes nor operations -- a few KB of int32
// tables -- but latency: the launch, the rounds of dependent reads and
// barriers, and the chain in which each replicated expert's choice reads
// the loads the previous choice left.
//
// Design.  The TPU kernels ran both passes as one serial loop over all E
// experts and gathered with a one-hot matmul; here:
//  - one round of global reads: each thread loads its items (16-byte
//    vectors where aligned) into registers, while block 0 copies the replica
//    tables (hosts, counts, slot_of) whole into shared memory, every load of
//    a batch issued before its stores; nothing after the first barrier reads
//    global memory;
//  - the bitmap by idempotent stores into shared memory;
//  - pass 1 in parallel: single-replica experts take their host, loads are
//    counted with shared atomics; meanwhile warp 0 compacts the activated
//    replicated experts into an ascending list with ballots;
//  - pass 2, one warp walks only that list.  With 8 <= n_e <= 32 lane g is
//    instance g: it keeps ld[g] in a register, and a step is one
//    __reduce_min_sync over the key (((load << b) | r) << gb) | g, r being
//    g's replica index in the expert's row (hosts inverted in shared
//    memory) -- the first minimum, with the winner in the low bits; b, gb =
//    ceil(log2 R), ceil(log2 n_e); load <= E <= 512, so the key is exact --
//    then a predicated add and slot store on the winning lane; a lane loads
//    its entries for 8 steps at once, so the chain waits on memory once
//    per 8 steps.  Otherwise the loads stay in shared memory, lane r
//    reads host r's, and the key is (load << b) | r, one reduction per 32
//    replicas: beyond 32 instances a lane cannot be an instance, and below
//    8 the inverted table costs more than the short chain saves (PERF.md
//    §6);
//  - outputs in parallel, act_rep written once, and the rewrite in the same
//    launch from the items each thread still holds in registers.
// Above 12288 items (8192 in registers, the rest read twice; the wrapper's
// CLUSTER_ITEMS) the launch is a thread block cluster of 8 blocks: each
// block collects its own range of items into its own bitmap,
// block 0 ORs them through distributed shared memory and runs the passes,
// and every block rewrites its items from block 0's act_rep.  Every MoE
// device could run the same launch redundantly, Janus's sync-free trick.
#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kHeld = 8;  // 4-item vectors a thread keeps in registers
constexpr int kMaxCluster = 8;
constexpr int kMaxExperts = 2 * kThreads;
constexpr int kBatch = 4;  // table entries a thread loads before it stores them
constexpr int kSteps = 8;  // chain steps whose entries a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

// The chain with the loads in lane registers and the hosts inverted into
// key bits, or with the loads in shared memory (the wrapper agrees).
__host__ __device__ constexpr bool keys_in_registers(int n_e) { return n_e >= 8 && n_e <= 32; }

struct Args {
  const int* eids;     // [n_items] logical expert ids, < 0 = padding
  int n_items;
  const int* hosts;    // [E, R] instance ids, -1 padded
  const int* counts;   // [E] replica counts
  const int* slot_of;  // [E, n_e] global slot of e on g, -1
  int E, R, n_e;
  int* slot_ids;       // out [n_items]
  int* act_rep;        // out [E]
  int* load;           // out [n_e]
};

__device__ __forceinline__ int4 load_items(const int* p, int i0, int n, bool vec) {
  if (vec && i0 + 4 <= n) return __ldg(reinterpret_cast<const int4*>(p + i0));
  return make_int4(i0 < n ? p[i0] : -1, i0 + 1 < n ? p[i0 + 1] : -1,
                   i0 + 2 < n ? p[i0 + 2] : -1, i0 + 3 < n ? p[i0 + 3] : -1);
}

__device__ __forceinline__ void store_items(int* p, int i0, int n, bool vec, int4 v) {
  if (vec && i0 + 4 <= n) {
    *reinterpret_cast<int4*>(p + i0) = v;
    return;
  }
  if (i0 < n) p[i0] = v.x;
  if (i0 + 1 < n) p[i0 + 1] = v.y;
  if (i0 + 2 < n) p[i0 + 2] = v.z;
  if (i0 + 3 < n) p[i0 + 3] = v.w;
}

__device__ __forceinline__ void mark(int* act, int e, int E) {
  if ((unsigned)e < (unsigned)E) act[e] = 1;
}

__device__ __forceinline__ void mark4(int* act, int4 v, int E) {
  mark(act, v.x, E);
  mark(act, v.y, E);
  mark(act, v.z, E);
  mark(act, v.w, E);
}

__device__ __forceinline__ int slot_for(const int* rep, int e, int E) {
  return (unsigned)e < (unsigned)E ? rep[e] : -1;
}

__device__ __forceinline__ int4 rewrite4(const int* rep, int4 v, int E) {
  return make_int4(slot_for(rep, v.x, E), slot_for(rep, v.y, E), slot_for(rep, v.z, E),
                   slot_for(rep, v.w, E));
}

template <bool kCluster>
__device__ __forceinline__ void sync_all() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Pass 2 with the loads in registers (keys_in_registers): lane g holds ld[g] and,
// for each step's expert e, kbits[e, g] = (r << gb) | g (r the replica
// index of instance g in e's row of hosts; -1 where g hosts no replica of e)
// and slot_of[e, g].  A step is one __reduce_min_sync over the key
// (load << (b + gb)) | kbits -- the first minimum, with the winning instance
// in the low bits; an invalid entry's key is all ones -- and a predicated
// add and slot store on the winning lane: nothing on the chain waits on
// memory or another lane's register.  Each lane loads its entries for
// kSteps steps at once, so the chain stalls on memory once per kSteps
// steps.
__device__ __forceinline__ void chain_in_registers(const short* kbits, const int* slot,
                                                   const int* list, int M, int* rep, int* ld,
                                                   int R, int n_e) {
  const int t = threadIdx.x;
  const int gb = n_e > 1 ? 32 - __clz(n_e - 1) : 0;
  const int sh = gb + (R > 1 ? 32 - __clz(R - 1) : 0);
  const unsigned gmask = (1u << gb) - 1u;
  const bool mine = t < n_e;
  int my_ld = mine ? ld[t] : 0;
  for (int i0 = 0; i0 < M; i0 += kSteps) {
    int e[kSteps], s[kSteps];
    unsigned k[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) e[j] = i0 + j < M ? list[i0 + j] : 0;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const bool live = mine && i0 + j < M;
      k[j] = live ? (unsigned)(int)kbits[e[j] * n_e + t] : UINT_MAX;
      s[j] = live ? slot[e[j] * n_e + t] : -1;
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (i0 + j >= M) break;
      const unsigned best = __reduce_min_sync(kFull, ((unsigned)my_ld << sh) | k[j]);
      const bool win = best != UINT_MAX && (best & gmask) == (unsigned)t;  // none: malformed
      my_ld += win;
      if (win) rep[e[j]] = s[j];
    }
  }
  if (mine) ld[t] = my_ld;
}

// Pass 2 with the loads in shared memory (any n_e): lane r reads the load of
// host r, one __reduce_min_sync over (load << b) | r per 32 replicas, and the
// winning lane writes load + 1 and the slot.
__device__ __forceinline__ void chain_in_shared(const int* host, const int* slot, const int* list,
                                                int M, int* rep, int* ld, int R, int n_e) {
  const int t = threadIdx.x;
  const int b = R > 1 ? 32 - __clz(R - 1) : 0;
  const unsigned rmask = (1u << b) - 1u;
  int e = M > 0 ? list[0] : 0;
  int g = M > 0 && t < R ? host[e * R + t] : -1;
  for (int i = 0; i < M; ++i) {
    const int en = i + 1 < M ? list[i + 1] : 0;
    const int gn = i + 1 < M && t < R ? host[en * R + t] : -1;
    unsigned best = __reduce_min_sync(kFull, g >= 0 ? ((unsigned)ld[g] << b) | t : UINT_MAX);
    for (int r = t + 32; r - t < R; r += 32) {  // rows of more than 32 replicas
      const int gr = r < R ? host[e * R + r] : -1;
      best = min(best, __reduce_min_sync(kFull, gr >= 0 ? ((unsigned)ld[gr] << b) | r : UINT_MAX));
    }
    if (best != UINT_MAX) {  // else a count without hosts: malformed table
      const int r = (int)(best & rmask);
      if (t == (r & 31)) {
        const int gw = r < 32 ? g : host[e * R + r];
        ld[gw] = (int)(best >> b) + 1;
        rep[e] = slot[e * n_e + gw];
      }
    }
    __syncwarp();
    e = en;
    g = gn;
  }
}

// Both greedy passes in block 0, from shared memory; leaves rep [E] (the
// chosen global slot) and ld [n_e] final.  Ends with a block barrier.
__device__ __forceinline__ void greedy(const int* act, const int* cnt, const int* host,
                                       const int* slot, const short* kbits, int* list,
                                       int* rep, int* ld, int E, int R, int n_e) {
  const int t = threadIdx.x;
  // pass 1: activated single-replica experts to their host, in parallel
  for (int e = t; e < E; e += kThreads) {
    int s = -1;
    const int g = host[e * R];
    if (act[e] && cnt[e] == 1 && g >= 0) {
      s = slot[e * n_e + g];
      atomicAdd(&ld[g], 1);
    }
    rep[e] = s;  // replicated experts are overwritten by pass 2
  }
  // warp 0: the activated replicated experts, ascending, E / 32 ballots
  int M = 0;
  if (t < 32) {
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + t;
      const bool f = e < E && act[e] && cnt[e] >= 2;
      const unsigned m = __ballot_sync(kFull, f);
      if (f) list[M + __popc(m & ((1u << t) - 1u))] = e;
      M += __popc(m);
    }
  }
  __syncthreads();  // pass 2 starts once every single's load is counted
  if (t < 32) {
    // pass 2, one warp: each listed expert to its least-loaded host
    if (keys_in_registers(n_e)) {
      chain_in_registers(kbits, slot, list, M, rep, ld, R, n_e);
    } else {
      chain_in_shared(host, slot, list, M, rep, ld, R, n_e);
    }
  }
  __syncthreads();
}

template <bool kCluster>
__global__ void __launch_bounds__(kThreads) aebs_schedule_kernel(Args a) {
  extern __shared__ int sm[];
  const int E = a.E, R = a.R, n_e = a.n_e;
  int* act = sm;             // [E] activation bitmap, one int an expert
  int* rep = act + E;        // [E] chosen slot per expert
  int* cnt = rep + E;        // [E] replica counts          (block 0 only)
  int* list = cnt + E;       // [E] listed experts           (block 0 only)
  int* host = list + E;      // [E * R] instance ids         (block 0 only)
  int* slot = host + E * R;  // [E * n_e] slot_of            (block 0 only)
  int* ld = slot + E * n_e;  // [n_e] loads                  (block 0 only)
  // [E * n_e] the chain's key bits, (r << gb) | g, -1    (block 0; keys_in_registers)
  short* kbits = reinterpret_cast<short*>(ld + n_e);

  const int t = threadIdx.x;
  int rank = 0, nb = 1;
  if constexpr (kCluster) {
    rank = (int)cg::this_cluster().block_rank();
    nb = (int)cg::this_cluster().num_blocks();
  }
  // this block's items, in 4-item units
  const int n_units = (a.n_items + 3) >> 2;
  const int per = (n_units + nb - 1) / nb;
  const int u0 = rank * per, u1 = min(n_units, u0 + per);
  const bool vec_in = ((uintptr_t)a.eids & 15) == 0;
  const bool vec_out = ((uintptr_t)a.slot_ids & 15) == 0;

  // ---- one round of global reads (held in flight across the barrier)
  int4 held[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int u = u0 + t + j * kThreads;
    held[j] = u < u1 ? load_items(a.eids, 4 * u, a.n_items, vec_in) : make_int4(-1, -1, -1, -1);
  }
  for (int e = t; e < E; e += kThreads) act[e] = 0;
  if (rank == 0) {
    // the tables are copied whole, no read depending on another, and each
    // batch's loads are issued before its stores, so the tables and the
    // items are in flight together (one batch up to 1024 entries a table)
    int c[kMaxExperts / kThreads];
#pragma unroll
    for (int j = 0; j < kMaxExperts / kThreads; ++j)
      c[j] = t + j * kThreads < E ? __ldg(a.counts + t + j * kThreads) : 0;
    const int nh = E * R, ns = E * n_e;
    for (int i0 = t; i0 < max(nh, ns); i0 += kBatch * kThreads) {
      int hv[kBatch], sv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads;
        hv[j] = i < nh ? __ldg(a.hosts + i) : 0;
        sv[j] = i < ns ? __ldg(a.slot_of + i) : 0;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads;
        if (i < nh) host[i] = hv[j];
        if (i < ns) slot[i] = sv[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxExperts / kThreads; ++j)
      if (t + j * kThreads < E) cnt[t + j * kThreads] = c[j];
    for (int g = t; g < n_e; g += kThreads) ld[g] = 0;
    if (keys_in_registers(n_e))
      for (int i = t; i < (E * n_e + 1) / 2; i += kThreads) reinterpret_cast<int*>(kbits)[i] = -1;
  }
  __syncthreads();
  if (rank == 0 && keys_in_registers(n_e)) {  // hosts inverted into the chain's key bits
    const int gb = n_e > 1 ? 32 - __clz(n_e - 1) : 0;
    for (int i = t; i < E * R; i += kThreads) {
      const int g = host[i];
      if (g >= 0) kbits[(i / R) * n_e + g] = (short)(((i % R) << gb) | g);
    }
  }

  // ---- the bitmap of this block's items
#pragma unroll
  for (int j = 0; j < kHeld; ++j) mark4(act, held[j], E);
  for (int u = u0 + t + kHeld * kThreads; u < u1; u += kThreads)  // beyond the registers
    mark4(act, load_items(a.eids, 4 * u, a.n_items, vec_in), E);
  sync_all<kCluster>();

  if (rank == 0) {
    if constexpr (kCluster) {
      // OR the other blocks' bitmaps through distributed shared memory
      cg::cluster_group cluster = cg::this_cluster();
      for (int e = t; e < E; e += kThreads) {
        int v = act[e];
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r)
          if (r < nb) v |= cluster.map_shared_rank(act, r)[e];
        act[e] = v;
      }
      __syncthreads();
    }
    greedy(act, cnt, host, slot, kbits, list, rep, ld, E, R, n_e);
    for (int g = t; g < n_e; g += kThreads) a.load[g] = ld[g];
    for (int e = t; e < E; e += kThreads) a.act_rep[e] = rep[e];
  }

  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // block 0's rep is final
    if (rank != 0) {
      const int* rep0 = cluster.map_shared_rank(rep, 0);
      for (int e = t; e < E; e += kThreads) rep[e] = rep0[e];
    }
    cluster.sync();  // block 0 stays until the others have copied its rep
  }

  // ---- the rewrite of this block's items
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int u = u0 + t + j * kThreads;
    if (u < u1) store_items(a.slot_ids, 4 * u, a.n_items, vec_out, rewrite4(rep, held[j], E));
  }
  for (int u = u0 + t + kHeld * kThreads; u < u1; u += kThreads) {
    const int4 v = load_items(a.eids, 4 * u, a.n_items, vec_in);
    store_items(a.slot_ids, 4 * u, a.n_items, vec_out, rewrite4(rep, v, E));
  }
}

template <bool kCluster>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(aebs_schedule_kernel<kCluster>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t smem_bytes(int E, int R, int n_e) {  // the wrapper's MAX_SMEM check agrees
  const size_t kbits = keys_in_registers(n_e) ? ((size_t)E * n_e + 1) / 2 : 0;  // ints of 16-bit keys
  return ((size_t)(4 * E + E * R + E * n_e + n_e) + kbits) * sizeof(int);
}

}  // namespace

// blocks: the cluster's size, 1 to 8 (1 launches a plain block); the
// wrapper picks it from n_items.
REPRO_EXPORT int aebs_schedule(const int* eids, int n_items, const int* hosts, const int* counts,
                               const int* slot_of, int E, int R, int n_e, int blocks,
                               int* slot_ids, int* act_rep, int* load, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (blocks < 1 || blocks > kMaxCluster || E < 1 || E > kMaxExperts || R < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(E, R, n_e);
  const Args a{eids, n_items, hosts, counts, slot_of, E, R, n_e, slot_ids, act_rep, load};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (blocks == 1) {
    if ((err = allow_smem<false>(smem)) != cudaSuccess) return (int)err;
    aebs_schedule_kernel<false><<<1, kThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  if ((err = allow_smem<true>(smem)) != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, aebs_schedule_kernel<true>, a)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}
