"""Quickstart on the PyTorch/CUDA port: the Janus pipeline end to end
(``examples/quickstart.py`` on ``repro_torch``).

1. Build a replica layout from a routing trace (placement, Alg. 3).
2. Schedule a decode batch with AEBS vs baselines (Alg. 1) — see a_max drop.
3. Ask the SLO scaler for the cheapest (n_a, n_e) deployment (Alg. 2).
4. Serve a few requests through the continuous-batching engine (on the card:
   AEBS in K2, the grouped expert FFN in K3, decode attention in K4).

Steps 1-3 are host numpy and print what the reference's example prints.
Step 4 draws its weights in torch from seed 0, so its streams differ from
the reference's.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.aebs import aebs_numpy
from repro_torch.core.amax import MonteCarloAmax, amax_bound, make_routing_trace
from repro_torch.core.baselines import random_numpy, token_hash_numpy
from repro_torch.core.placement import build_layout
from repro_torch.core.scaling import PerfModel, SLOScaler
from repro_torch.models import model as model_mod
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import WorkloadSpec, sample_requests
from repro_torch.serving.trace import poisson_arrivals


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    print("=== 1. expert placement from a routing trace ===")
    cfg = get_config("dsv2-lite")
    E, k, n_e, C = cfg.num_experts, cfg.top_k, 8, 12
    trace = make_routing_trace(8192, E, k, skew=1.0, seed=0)
    layout = build_layout(trace, E, n_e, C)
    print(f"  {E} experts → {n_e} instances × {C} slots; "
          f"replicas per expert: min={layout.replica_counts.min()} max={layout.replica_counts.max()}")

    print("=== 2. AEBS vs baselines (batch of 256 tokens) ===")
    rng = np.random.default_rng(1)
    batch = trace[rng.integers(0, len(trace), 256)]
    a_aebs = aebs_numpy(batch, layout)[1].max()
    a_rand = random_numpy(batch, layout, rng)[1].max()
    a_tok = token_hash_numpy(batch, layout)[1].max()
    bound = amax_bound(n_e, 256, E, k, C)
    print(f"  a_max:  AEBS={a_aebs}  random={a_rand}  token-hash={a_tok}  (Eq.5 bound={bound})")

    print("=== 3. SLO-aware scaling ===")
    mc = MonteCarloAmax(trace, E, trials=6)
    pm = PerfModel(cfg, amax_estimator=mc, slots_per_instance=C, s_ctx=512)
    sc = SLOScaler(pm, n_max=16)
    for demand in (1000.0, 8000.0):
        best = sc.scale(demand, slo=0.2)
        print(f"  demand={demand:7.0f} tok/s → {best.n_a}A{best.n_e}E  "
              f"B*={best.batch:.0f}  TPOT={best.tpot*1000:.1f}ms  TPG={best.tpg:.0f} tok/s/gpu")

    print("=== 4. serve a small MoE with the scheduled path ===")
    rcfg = get_config("qwen2-moe-a2.7b-reduced")
    params = model_mod.init_params(rcfg, 0, device=args.device)
    rtrace = make_routing_trace(1024, rcfg.num_experts, rcfg.top_k, skew=0.8, seed=0)
    rlayout = build_layout(rtrace, rcfg.num_experts, 2, 3)
    spec = WorkloadSpec(mean_input=8, mean_output=16, vocab_size=rcfg.vocab_size,
                        max_input=24, max_output=32)
    reqs = sample_requests(spec, poisson_arrivals(40.0, 0.25, seed=2), with_prompts=True)
    eng = ServingEngine(rcfg, params, max_batch=4, cache_len=96, layout=rlayout, scheduler="aebs",
                        device=args.device)
    m = eng.run(reqs)
    print(f"  served {m['completed']} requests, {m['tokens']} tokens, "
          f"TPOT mean={m['tpot_mean']*1000:.0f}ms p99={m['tpot_p99']*1000:.0f}ms")
    return m


if __name__ == "__main__":
    main()
