"""Fig. 11 on the PyTorch/CUDA port: a 24-hour diurnal trace driven through
the Janus autoscaler vs SGLang / MegaScale-Infer / xDeepServe scaling
policies (``examples/autoscale_trace.py`` on ``repro_torch``).

The simulator is host numpy over the performance model at the H100's
data-sheet constants, so every figure is analytic and equals the
reference's.  ``--device`` is accepted for symmetry with the other
examples and checked, but nothing here runs on it.

Run:  PYTHONPATH=src python examples/torch_autoscale_trace.py [--device cpu]
      [--hours 24] [--n-max 32]   (the reference's settings; the whole day takes minutes)
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.amax import MonteCarloAmax, make_routing_trace
from repro_torch.core.comm import H100
from repro_torch.core.scaling import PerfModel
from repro_torch.models.common import resolve_device
from repro_torch.serving.simulator import ClusterSimulator
from repro_torch.serving.trace import diurnal_rate_profile


def sparkline(vals, width=72):
    blocks = "▁▂▃▄▅▆▇█"
    vals = np.asarray(vals, float)
    if len(vals) > width:
        idx = np.linspace(0, len(vals) - 1, width).astype(int)
        vals = vals[idx]
    lo, hi = vals.min(), vals.max()
    span = (hi - lo) or 1.0
    return "".join(blocks[int((v - lo) / span * (len(blocks) - 1))] for v in vals)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="the device the deployment is modeled for (default: the card)")
    ap.add_argument("--hours", type=float, default=24.0, help="length of the diurnal trace")
    ap.add_argument("--n-max", type=int, default=32, help="most devices a policy may deploy")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # the card unless the CPU is asked for: no silent fallback

    cfg = get_config("dsv2-lite")
    trace = make_routing_trace(4096, cfg.num_experts, cfg.top_k, skew=1.0, seed=0)
    mc = MonteCarloAmax(trace, cfg.num_experts, trials=6)
    pm = PerfModel(cfg, hw=H100, amax_estimator=mc, slots_per_instance=12, s_ctx=512)
    sim = ClusterSimulator(pm, slo=0.2, n_max=args.n_max)

    t, rates = diurnal_rate_profile(
        hours=args.hours, step_minutes=15.0, mean_rate=30.0, burst_peak_over_mean=7.5, seed=0
    )
    print("demand  (req/s):", sparkline(rates))
    res = sim.compare(t, rates, tokens_per_req=256.0)
    for name, r in res.items():
        gpus = [rec.total_gpus for rec in r.records]
        print(f"{name:11s} gpus:", sparkline(gpus))
    print()
    print(f"{'system':12s} {'gpu-hours':>10s} {'slo-attain':>10s} {'gpu range':>10s}")
    for name, r in res.items():
        gpus = [rec.total_gpus for rec in r.records]
        print(f"{name:12s} {r.gpu_hours:10.0f} {r.slo_attainment*100:9.0f}% {min(gpus):>4d}-{max(gpus)}")
    base = res["janus"].gpu_hours
    for name in ("sglang", "megascale", "xdeepserve"):
        print(f"janus saves {100*(1-base/res[name].gpu_hours):.0f}% GPU-hours vs {name}")
    return res


if __name__ == "__main__":
    main()
