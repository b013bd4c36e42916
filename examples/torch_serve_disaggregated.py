"""Disaggregated serving on the PyTorch/CUDA port — the Janus architecture
live (``examples/serve_disaggregated.py`` on ``repro_torch``).

A. **Three-pool engine (pool mode)** — ``ServingEngine(executor="disagg")``
   serves a continuous-batching request stream with chunked prompt prefill
   on a 2-device prefill pool, attention stages on a 2-device attention pool
   and expert stages on a 4-device MoE pool, admission pipelined; every
   decode layer hands its activations from the attention pool to the MoE
   pool and back (case-1 / case-2 chosen per step by the two-phase model).
   Mid-run one ``reconfigure`` call rescales 2P2A4E → 1P3A4E: the prefill
   pool shrinks, the attention pool grows, the MoE pool and its expert
   weights stay, the in-flight KV caches are kept.  On one card every pool
   aliases the device (as ``repro_torch.launch.serve --executor disagg``);
   on the CPU they alias the host.

B. **SPMD deployment (full model)** — a ``(data, model)`` mesh over a
   ``torch.distributed`` group whose model axis is the MoE pool; the
   scheduled expert-parallel decode step (``launch.steps.build_serve_step``:
   AEBS over the mesh's replica layout, each rank's pinned expert slots)
   serves a token stream.  On the card it is a 1 x 1 mesh over a one-rank
   NCCL group; with ``--device cpu`` a 2 x 4 mesh over 8 ranks of a gloo
   group, each a spawned process.

Run:  PYTHONPATH=src python examples/torch_serve_disaggregated.py [--device cpu]
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import InputShape, get_config
from repro_torch.core.aebs import ReplicaLayout
from repro_torch.launch import steps
from repro_torch.launch.mesh import close_group, make_host_mesh, open_group
from repro_torch.models import model as model_mod
from repro_torch.models.common import resolve_device
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import WorkloadSpec, sample_requests
from repro_torch.serving.trace import poisson_arrivals

SPMD_B, SPMD_S, SPMD_STEPS = 4, 32, 8
CPU_MESH = (2, 4)


def pool_mode_demo(device):
    print("=== A. three-pool engine: 2 prefill + 2 attention + 4 MoE devices ===")
    cfg = get_config("dsv2-lite-reduced")
    params = model_mod.init_params(cfg, 0, device=device)
    layout = ReplicaLayout.round_robin(cfg.num_experts, 4, 2)

    eng = ServingEngine(
        cfg, params, max_batch=6, cache_len=64, layout=layout,
        scheduler="aebs", capacity_tokens=64,
        executor="disagg", n_attn=2, n_prefill=2, prefill_chunk=8, device=device,
    )
    pools = eng.disagg.pools
    print(f"  pools: prefill={[str(d) for d in pools.prefill_devices]} "
          f"attn={[str(d) for d in pools.attn_devices]} "
          f"moe={[str(d) for d in pools.moe_devices]} (admission={eng.admission})")
    spec = WorkloadSpec(mean_input=12, mean_output=12, vocab_size=cfg.vocab_size,
                        max_input=32, max_output=16, seed=0)
    reqs = sample_requests(spec, poisson_arrivals(100.0, 0.12, seed=0)[:12], with_prompts=True)

    t0 = time.perf_counter()
    m = eng.run(reqs[:6])
    print(f"  phase 1 (2P2A4E): served 6 requests in {time.perf_counter()-t0:.1f}s wall "
          f"({m.get('prefill_chunks', 0)} prompt chunks streamed, "
          f"decode stall {m['decode_stall_time']:.3f}s)")

    # one call, three independent pools: prefill shrinks, attention grows,
    # MoE (and its expert weights) untouched
    relower = eng.reconfigure(n_attn=3, n_prefill=1)
    print(f"  reconfigure 2P2A4E → 1P3A4E: re-lowered pools {relower} "
          "(KV caches re-sharded in place, expert weights untouched)")

    t0 = time.perf_counter()
    m = eng.run(reqs[6:])
    print(f"  phase 2 (1P3A4E): served 6 more in {time.perf_counter()-t0:.1f}s wall")
    print(f"  telemetry: regimes={m['regime_counts']} "
          f"bytes/step={m['transfer_bytes_per_step']:.0f} "
          f"a_max mean={m['amax_mean']:.2f} max={m['amax_max']}")
    print(f"  completed={m['completed']} tokens={m['tokens']} "
          f"ttft_mean={m['ttft_mean']*1e3:.1f}ms "
          f"tpot_mean={m['tpot_mean']*1e3:.1f}ms truncated={m['truncated']}")
    return m


def spmd_decode(mesh, device):
    """The scheduled expert-parallel decode step on ``mesh``: prefill a
    batch, pin each rank's expert slots, decode ``SPMD_STEPS`` tokens.
    Returns ``(tokens of sequence 0, wall ms)``."""
    cfg = get_config("qwen2-moe-a2.7b-reduced")
    params = model_mod.init_params(cfg, 0, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (SPMD_B, SPMD_S), generator=gen, device=device, dtype=torch.int32)
    _, caches = model_mod.prefill(params, tokens, cfg, cache_len=SPMD_S + 16)
    step, _ = steps.build_serve_step(cfg, mesh, InputShape("decode", SPMD_S + 16, SPMD_B, "decode"))
    pinned = steps.materialize_slot_params(params, cfg, step.info["moe_ctx"]["slot_to_expert"])
    t = tokens[:, -1:]
    toks = []
    t0 = time.perf_counter()
    for i in range(SPMD_STEPS):
        nxt, caches = step(pinned, t, torch.tensor(SPMD_S + i, dtype=torch.int32), caches)
        t = nxt.full_tensor()[:, None]
        toks.append(int(t[0, 0]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return toks, (time.perf_counter() - t0) * 1e3


def _spmd_rank(rank, world, store_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    open_group("gloo", world, rank, dist.FileStore(store_path, world))
    try:
        toks, wall = spmd_decode(make_host_mesh(*CPU_MESH, device_type="cpu"), torch.device("cpu"))
        if rank == 0:
            print(f"  decoded {SPMD_STEPS} tokens/seq on {world} devices in {wall:.0f} ms", flush=True)
            print(f"  sample continuation (seq 0): {toks}", flush=True)
    finally:
        close_group()


def spmd_mode_demo(device):
    if device.type == "cpu":
        import torch.multiprocessing as mp

        world = CPU_MESH[0] * CPU_MESH[1]
        print(f"=== B. SPMD deployment (full reduced model, {CPU_MESH[0]}×{CPU_MESH[1]} mesh, gloo) ===", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_spmd_rank, args=(world, os.path.join(tmp, "store")), nprocs=world,
                               start_method="spawn")
        return
    print("=== B. SPMD deployment (full reduced model, 1×1 mesh, nccl) ===")
    open_group("nccl")
    try:
        toks, wall = spmd_decode(make_host_mesh(1, 1, "cuda"), device)
    finally:
        close_group()
    print(f"  decoded {SPMD_STEPS} tokens/seq on 1 device in {wall:.0f} ms")
    print(f"  sample continuation (seq 0): {toks}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    pool_mode_demo(device)
    spmd_mode_demo(device)


if __name__ == "__main__":
    main()
