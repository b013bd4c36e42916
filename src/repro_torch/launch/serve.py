"""Serving launcher: run the continuous-batching engine on a ``-reduced``
config with the Janus scheduled-MoE path (``repro.launch.serve``, flag for
flag, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --rate 20 --duration 2 --scheduler aebs

runs on the card (``--device cuda``, the default); ``--device cpu`` runs the
plain PyTorch versions of the kernels on the host.  Weights are drawn in
torch from ``--seed`` on that device, so they (and the token streams) differ
from the reference's, which draws them from JAX's PRNG; the requests, the
routing trace and the replica layout are the reference's for the same seed.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--rate", type=float, default=20.0, help="requests/s")
    ap.add_argument("--duration", type=float, default=2.0, help="seconds of arrivals")
    ap.add_argument("--scheduler", default="aebs", choices=["aebs", "random", "token_hash", "none"])
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--n-instances", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0, help="expert slots per instance")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--executor", default="mono", choices=["mono", "disagg"],
        help="disagg = two-pool execution (attention and MoE pools; on one "
        "card every pool aliases the device)",
    )
    ap.add_argument("--n-attn", type=int, default=2, help="attention pool size (disagg)")
    ap.add_argument(
        "--n-prefill", type=int, default=0,
        help="prefill pool size (third sub-cluster; >0 switches admission to "
        "the pipelined chunked-prefill path unless --admission overrides)",
    )
    ap.add_argument(
        "--admission", default=None, choices=["blocking", "pipelined"],
        help="blocking = whole-prompt prefill inline; pipelined = chunked "
        "prefill on the prefill pool, streamed KV hand-off",
    )
    ap.add_argument("--prefill-chunk", type=int, default=64, help="prefill chunk size (tokens)")
    ap.add_argument(
        "--kv-page-size", type=int, default=None, metavar="ROWS",
        help="enable the paged KV cache with fixed-size pages of ROWS tokens "
        "(must divide --cache-len); default keeps contiguous per-slot slabs",
    )
    ap.add_argument(
        "--kv-num-pages", type=int, default=None,
        help="page-pool size (incl. the reserved null page); default backs "
        "every slot fully — shrink it to overcommit KV memory",
    )
    ap.add_argument(
        "--prefix-cache", action="store_true",
        help="page-granular prefix cache: prompts sharing a chunk-aligned "
        "token prefix reuse its KV pages by block-table splicing; requires "
        "--kv-page-size",
    )
    ap.add_argument(
        "--prefix-cache-pages", type=int, default=None, metavar="N",
        help="page budget the prefix index may pin; LRU leaf eviction beyond "
        "it (default: unbounded — pages free when the last holder drops)",
    )
    ap.add_argument(
        "--prefill-batch", type=int, default=1, metavar="B",
        help="fuse up to B pending prompts into one padded-and-masked prefill "
        "chunk call per device (default 1)",
    )
    ap.add_argument(
        "--workload", default="chat", choices=["chat", "shared-prefix"],
        help="request-length preset: chat (ShareGPT-like) or shared-prefix "
        "(every prompt opens with the same system prompt)",
    )
    ap.add_argument("--ping-pong", action="store_true", help="m=2 micro-batch overlap (disagg)")
    ap.add_argument(
        "--fault-plan", default=None, metavar="PATH",
        help="JSON fault-injection plan (see repro_torch.serving.faults.FaultPlan): "
        "device losses, exchange timeouts and prefill-chunk failures are "
        "injected at the scheduled decode steps and recovered live",
    )
    ap.add_argument(
        "--request-deadline", type=float, default=None,
        help="admission deadline in seconds after arrival; requests that wait "
        "longer while the engine is saturated are rejected",
    )
    ap.add_argument(
        "--trace", default=None, metavar="PATH",
        help="replay a multi-tenant workload file (TraceSpec JSON: duration, "
        "seed, tenants with request class / arrival process / priority / "
        "SLOs); replaces --rate/--duration/--workload",
    )
    ap.add_argument(
        "--sched", default="fifo", choices=["fifo", "priority"],
        help="request admission scheduler: fifo = strict arrival order; "
        "priority = higher Request.priority first, preempting lower-priority "
        "active slots via KV spill/restore (requires --kv-page-size)",
    )
    ap.add_argument(
        "--slo-ttft", type=float, default=None, metavar="S",
        help="default TTFT SLO (s, arrival to first token) stamped on every "
        "request that does not carry one from the trace file",
    )
    ap.add_argument(
        "--slo-tpot", type=float, default=None, metavar="S",
        help="default TPOT SLO (s, p99 inter-token gap), same stamping rule",
    )
    ap.add_argument(
        "--draft", default=None, metavar="ARCH",
        help="enable speculative decode with ARCH (reduced config) as the "
        "draft model; pass the target --arch itself for self-drafting.  "
        "Output streams stay those of plain greedy decode whatever the draft",
    )
    ap.add_argument(
        "--spec-k", type=int, default=0, metavar="K",
        help="draft tokens proposed per verify step (default 2 when --draft "
        "is set); each step emits 1..K+1 tokens",
    )
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Serve the requests the flags describe, print the metrics as the
    reference does, and return them."""
    args = parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.amax import make_routing_trace
    from repro_torch.core.placement import build_layout
    from repro_torch.models import model as model_mod
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import WorkloadSpec, sample_requests, shared_prefix_spec
    from repro_torch.serving.trace import TraceSpec, poisson_arrivals

    cfg = get_config(args.arch + "-reduced")
    params = model_mod.init_params(cfg, args.seed, device=args.device)
    draft_config = None
    if args.draft is not None:
        draft_config = cfg if args.draft == args.arch else get_config(args.draft + "-reduced")
    layout = None
    if cfg.has_moe and args.scheduler != "none":
        C = args.slots or (cfg.num_experts // args.n_instances + 1)
        trace = make_routing_trace(2048, cfg.num_experts, cfg.top_k, skew=0.8, seed=args.seed)
        layout = build_layout(trace, cfg.num_experts, args.n_instances, C)
    if args.trace is not None:
        with open(args.trace) as fh:
            tspec = TraceSpec.from_json(fh.read())
        reqs = tspec.build(vocab_size=cfg.vocab_size, with_prompts=True)
    else:
        if args.workload == "shared-prefix":
            spec = shared_prefix_spec(vocab_size=cfg.vocab_size)
        else:
            spec = WorkloadSpec(
                mean_input=8, mean_output=24, vocab_size=cfg.vocab_size, max_input=48, max_output=64
            )
        reqs = sample_requests(spec, poisson_arrivals(args.rate, args.duration, args.seed), with_prompts=True)
    for r in reqs:
        if args.slo_ttft is not None and r.ttft_slo is None:
            r.ttft_slo = args.slo_ttft
        if args.slo_tpot is not None and r.tpot_slo is None:
            r.tpot_slo = args.slo_tpot
    if args.request_deadline is not None:
        for r in reqs:
            if r.deadline is None:
                r.deadline = r.arrival + args.request_deadline
    fault_plan = None
    if args.fault_plan is not None:
        from repro_torch.serving.faults import FaultPlan

        with open(args.fault_plan) as fh:
            fault_plan = FaultPlan.from_json(fh.read())
    eng = ServingEngine(
        cfg,
        params,
        max_batch=args.max_batch,
        cache_len=args.cache_len,
        layout=layout,
        scheduler=args.scheduler,
        executor=args.executor,
        n_attn=args.n_attn,
        n_prefill=args.n_prefill,
        admission=args.admission,
        prefill_chunk=args.prefill_chunk,
        ping_pong=args.ping_pong,
        fault_plan=fault_plan,
        kv_page_size=args.kv_page_size,
        kv_num_pages=args.kv_num_pages,
        prefix_cache=args.prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages,
        prefill_batch=args.prefill_batch,
        sched=args.sched,
        draft_config=draft_config,
        spec_k=args.spec_k,
        device=args.device,
    )
    print(
        f"serving {len(reqs)} requests on {cfg.name} "
        f"(scheduler={args.scheduler}, executor={args.executor}, "
        f"admission={eng.admission}, sched={args.sched}, "
        f"n_prefill={args.n_prefill}, device={eng.device}"
        + (f", trace={args.trace}" if args.trace else "")
        + (f", fault_plan={args.fault_plan}" if fault_plan else "")
        + ")"
    )
    m = eng.run(reqs)
    for k, v in m.items():
        print(f"  {k:20s} {v:.4f}" if isinstance(v, float) else f"  {k:20s} {v}")
    if fault_plan is not None and eng.degraded_reason:
        print(f"  degraded to mono executor: {eng.degraded_reason}")
    return m


if __name__ == "__main__":
    main()
