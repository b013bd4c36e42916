// K2: Activated-Expert-Balanced Scheduling (Janus Algorithm 1).
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
// Bound on the H100: neither bytes nor FLOPs -- a few KB of int32 tables --
// but latency: each replicated expert's choice reads the load the previous
// choice left, a chain of dependent steps.
//
// Design: K2a is one block.  All threads build the bitmap in shared memory
// with parallel stores (idempotent, so no atomics) and stage the replica
// tables into shared memory.  The first pass needs no order: a
// single-replica expert goes to its one host whatever the loads are, so the
// threads take those experts in parallel and count the loads with shared
// atomics.  Only the second pass -- the replicated experts, a handful -- is
// the dependent chain, and one thread runs it in ascending expert order out
// of shared memory.  (The TPU kernel ran both passes as one serial loop over
// all E experts; on the H100 that chain alone measured ~23 us at E = 64.)
// K2b is a parallel gather over the items; the TPU's one-hot matmul (a
// workaround for dynamic gathers there) is not needed.  Every MoE device
// could run the same launch redundantly, which is Janus's sync-free trick.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) aebs_collect_greedy_kernel(
    const int* __restrict__ eids, int n_items,
    const int* __restrict__ hosts,    // [E, R] instance ids, -1 padded
    const int* __restrict__ counts,   // [E] replica counts
    const int* __restrict__ slot_of,  // [E, n_e] global slot of e on g, -1
    int E, int R, int n_e,
    int* __restrict__ act_rep,        // out [E]
    int* __restrict__ load) {         // out [n_e]
  extern __shared__ int sm[];
  int* act = sm;              // [E] activation bitmap
  int* cnt = act + E;         // [E]
  int* host = cnt + E;        // [E * R]
  int* ld = host + E * R;     // [n_e]

  for (int e = threadIdx.x; e < E; e += kThreads) {
    act[e] = 0;
    cnt[e] = counts[e];
  }
  for (int i = threadIdx.x; i < E * R; i += kThreads) host[i] = hosts[i];
  for (int g = threadIdx.x; g < n_e; g += kThreads) ld[g] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n_items; i += kThreads) {
    const int e = eids[i];
    if (e >= 0 && e < E) act[e] = 1;
  }
  __syncthreads();

  // pass 1, in parallel: activated single-replica experts to their host
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int rep = -1;
    const int g = host[e * R];
    if (act[e] && cnt[e] == 1 && g >= 0) {
      rep = slot_of[e * n_e + g];
      atomicAdd(&ld[g], 1);
    }
    act_rep[e] = rep;  // replicated experts are overwritten by pass 2
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  // pass 2, one thread: replicated experts to the least-loaded host
  for (int e = 0; e < E; ++e) {
    if (!act[e] || cnt[e] < 2) continue;
    int best_g = -1;
    int best = INT_MAX;
    for (int r = 0; r < R; ++r) {
      const int g = host[e * R + r];
      if (g >= 0 && ld[g] < best) {  // strict: the first minimum wins
        best = ld[g];
        best_g = g;
      }
    }
    if (best_g < 0) continue;  // a count without hosts: malformed table
    act_rep[e] = slot_of[e * n_e + best_g];
    ld[best_g] += 1;
  }
  for (int g = 0; g < n_e; ++g) load[g] = ld[g];
}

__global__ void aebs_rewrite_kernel(const int* __restrict__ eids, int n_items,
                                    const int* __restrict__ act_rep, int E,
                                    int* __restrict__ slot_ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_items) {
    const int e = eids[i];
    slot_ids[i] = (e >= 0 && e < E) ? act_rep[e] : -1;
  }
}

}  // namespace

REPRO_EXPORT size_t aebs_collect_greedy_smem(int E, int R, int n_e) {
  return (size_t)(2 * E + E * R + n_e) * sizeof(int);
}

REPRO_EXPORT int aebs_collect_greedy(const int* eids, int n_items, const int* hosts,
                                     const int* counts, const int* slot_of, int E, int R,
                                     int n_e, int* act_rep, int* load, int device,
                                     void* stream) {
  REPRO_SET_DEVICE(device);
  const size_t smem = aebs_collect_greedy_smem(E, R, n_e);
  aebs_collect_greedy_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      eids, n_items, hosts, counts, slot_of, E, R, n_e, act_rep, load);
  return (int)cudaGetLastError();
}

REPRO_EXPORT int aebs_rewrite(const int* eids, int n_items, const int* act_rep, int E,
                              int* slot_ids, int device, void* stream) {
  REPRO_SET_DEVICE(device);
  if (n_items == 0) return 0;
  const int blocks = (n_items + kThreads - 1) / kThreads;
  aebs_rewrite_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(eids, n_items, act_rep, E,
                                                                      slot_ids);
  return (int)cudaGetLastError();
}
