#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero; nothing is caught):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
     source, all at once), with ptxas' register / shared-memory lines;
  3. kernels: each kernel at the serving path's shapes against its plain
     PyTorch version on the same inputs (stated tolerance), timed with CUDA
     events beside its plain version, a PyTorch library yardstick where one
     exists, and the least time the card could take (bytes or FLOPs bound);
  4. reduced parity: dsv2-lite-reduced through the plain versions on the CPU
     and through the kernels on the card, same seeded weights and requests;
  5. full-width serving: dsv2-lite (27 layers, d 2048, 64 experts top-6 + 2
     shared, vocab 102400) with random bf16 weights drawn on the card from a
     seed, AEBS over a 4 x 17-slot replica layout, paged KV, 12 requests;
     launch counts are zeroed just before and read just after;
  6. a ``{"kernels": [...]}`` line, then the card line, then the result line.

Without a CUDA card, or outside the repository, it exits non-zero before
printing any result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

TOL = {"bf16": 3e-2, "f32_layer": 1e-4}  # tests/_torch_parity.py's table
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense tensor-core peak
SCALAR_OPS = 67e12  # fp32 / int32 outside the tensor cores


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def numel(tree):
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(numel(v) for v in tree)
    return tree.numel()


def bound(nbytes, ops, ops_rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.amax import make_routing_trace
    from repro_torch.core.placement import build_layout
    from repro_torch.kernels import cuda
    from repro_torch.kernels.aebs.ops import aebs_collect_greedy, aebs_rewrite
    from repro_torch.kernels.decode_attention.ops import (
        paged_decode_attention,
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.expert_ffn.ops import expert_ffn_grouped, expert_ffn_grouped_ref
    from repro_torch.core.aebs import aebs_assign, rewrite_slots
    from repro_torch.models import model as model_mod
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request, WorkloadSpec, sample_requests

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32 (parity phase)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    # ---- 1. device -------------------------------------------------------
    log({"phase": "device", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "device_name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    # ---- 2. build --------------------------------------------------------
    build_s = cuda.build_all()
    for name in cuda.SOURCES:
        for line in cuda.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas[{name}] {line.strip()}")
    log({"phase": "build", "seconds": round(build_s, 3), "built": sorted(cuda.BUILD_LOG),
         "card": card})

    def time_ms(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    rows = {}

    def record(name, source, replaces, err, tol, ms, plain_ms, bnd, library_ms):
        ok = err <= tol
        rows[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms,
        }
        log({"phase": "kernel", "card": card, "tolerance": tol, "ok": ok, **rows[name]})
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)

    # ---- 3a. K1 paged decode attention ----------------------------------
    B, nh, nkv, hd, ps, nblk = 8, 16, 16, 128, 16, 32
    P, L = B * nblk + 1, 4  # full backing + null page; 4 layers' pools exceed L2
    bf = torch.bfloat16
    k_pool = torch.randn((L, P, ps, nkv, hd), generator=gen, device=dev).to(bf)
    v_pool = torch.randn((L, P, ps, nkv, hd), generator=gen, device=dev).to(bf)
    q = torch.randn((B, nh, hd), generator=gen, device=dev).to(bf)
    lens_np = rng.integers(1, nblk * ps + 1, size=B).astype(np.int32)
    bt_np = np.zeros((B, nblk), np.int32)
    perm = rng.permutation(P - 1) + 1
    used = 0
    for b in range(B):
        nb = -(-int(lens_np[b]) // ps)
        bt_np[b, :nb] = perm[used: used + nb]
        used += nb
    bt = torch.from_numpy(bt_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    got = paged_decode_attention(q, k_pool[0], v_pool[0], bt, lens)
    want = paged_decode_attention_ref(q, k_pool[0], v_pool[0], bt, lens)
    err = float((got.float() - want.float()).abs().max())
    it = {"i": 0}

    def k1():
        it["i"] += 1
        paged_decode_attention(q, k_pool[it["i"] % L], v_pool[it["i"] % L], bt, lens)

    def k1_plain():
        it["i"] += 1
        paged_decode_attention_ref(q, k_pool[it["i"] % L], v_pool[it["i"] % L], bt, lens)

    S = nblk * ps
    kd = [k_pool[l][bt.long()].reshape(B, S, nkv, hd).transpose(1, 2).contiguous() for l in range(L)]
    vd = [v_pool[l][bt.long()].reshape(B, S, nkv, hd).transpose(1, 2).contiguous() for l in range(L)]
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]

    def k1_library():
        it["i"] += 1
        F.scaled_dot_product_attention(q4, kd[it["i"] % L], vd[it["i"] % L], attn_mask=mask)

    live = int(lens_np.sum())
    k1_bytes = 2 * live * nkv * hd * 2 + 2 * B * nh * hd * 2 + B * nblk * 4 + B * 4
    k1_ops = 4 * nh * hd * live
    record("paged_decode_attention", "src/repro_torch/csrc/paged_decode_attention.cu",
           "src/repro/kernels/decode_attention/kernel.py:177", err, TOL["bf16"],
           time_ms(k1, 200), time_ms(k1_plain, 50), bound(k1_bytes, k1_ops, BF16_FLOPS),
           time_ms(k1_library, 200))
    del k_pool, v_pool, kd, vd

    # ---- 3b. K2 AEBS ----------------------------------------------------
    cfg = get_config("dsv2-lite")
    E, K = cfg.num_experts, cfg.top_k
    layout = build_layout(make_routing_trace(2048, E, K, skew=0.8, seed=0), E, 4, 17)
    tables = layout.device_tables(dev)
    n_e, R = layout.num_instances, layout.expert_hosts.shape[1]
    log({"phase": "layout", "slots": layout.total_slots,
         "replicated_experts": int((layout.replica_counts > 1).sum()), "max_replicas": R})
    eids = torch.from_numpy(make_routing_trace(8, E, K, skew=0.8, seed=1)).to(dev)
    load, act_rep = aebs_collect_greedy(eids, tables, n_e)
    slot_ids = aebs_rewrite(eids, act_rep)
    want_slots, want_load, want_rep = aebs_assign(eids, tables, n_e)
    err_a = float(max((load - want_load).abs().max(), (act_rep - want_rep).abs().max()))
    err_b = float((slot_ids - rewrite_slots(eids, act_rep)).abs().max())
    if not torch.equal(slot_ids, want_slots):
        raise AssertionError("aebs: slot ids differ from the plain aebs_assign")
    nit = eids.numel()
    a_bytes = 4 * (nit + E * R + E + E * n_e + E + n_e)
    record("aebs_collect_greedy", "src/repro_torch/csrc/aebs.cu",
           "src/repro/kernels/aebs/kernel.py:30", err_a, 0.0,
           time_ms(lambda: aebs_collect_greedy(eids, tables, n_e), 500),
           time_ms(lambda: aebs_assign(eids, tables, n_e), 20),
           bound(a_bytes, nit + 2 * E * R, SCALAR_OPS), None)
    record("aebs_rewrite", "src/repro_torch/csrc/aebs.cu",
           "src/repro/kernels/aebs/kernel.py:87", err_b, 0.0,
           time_ms(lambda: aebs_rewrite(eids, act_rep), 500),
           time_ms(lambda: rewrite_slots(eids, act_rep), 500),
           bound(4 * (2 * nit + E), nit, SCALAR_OPS), None)

    # ---- 3c. K3 grouped expert FFN (decode: 8 tokens, CAP 4) -------------
    d, f = cfg.d_model, cfg.d_ff_expert
    CAP = 4  # default_capacity(8, 6, 68, 1.25)
    wg = (torch.randn((E, d, f), generator=gen, device=dev) * d**-0.5).to(bf)
    wu = (torch.randn((E, d, f), generator=gen, device=dev) * d**-0.5).to(bf)
    wd = (torch.randn((E, f, d), generator=gen, device=dev) * f**-0.5).to(bf)
    counts = torch.bincount(eids.reshape(-1).long(), minlength=E)
    x = torch.randn((E, CAP, d), generator=gen, device=dev).to(bf)
    x = torch.where(torch.arange(CAP, device=dev)[None, :, None] < counts[:, None, None], x, 0)
    s2e = torch.arange(E, dtype=torch.int32, device=dev)
    active = counts > 0
    got = expert_ffn_grouped(x, wg, wu, wd, s2e, active)
    want = expert_ffn_grouped_ref(x, wg, wu, wd, s2e, active)
    err = float((got.float() - want.float()).abs().max())
    idx = torch.nonzero(active)[:, 0]
    n_act = int(idx.numel())
    wg_a, wu_a, wd_a, x_a = wg[idx], wu[idx], wd[idx], x[idx]

    def k3_library():
        h = F.silu(torch.bmm(x_a, wg_a)) * torch.bmm(x_a, wu_a)
        torch.bmm(h, wd_a)

    k3_bytes = n_act * 3 * d * f * 2 + n_act * CAP * d * 2 + E * CAP * d * 2 + 2 * E * 4
    k3_ops = n_act * CAP * 2 * 3 * d * f
    record("expert_ffn", "src/repro_torch/csrc/expert_ffn.cu",
           "src/repro/kernels/expert_ffn/kernel.py:40", err, TOL["bf16"],
           time_ms(lambda: expert_ffn_grouped(x, wg, wu, wd, s2e, active), 50),
           time_ms(lambda: expert_ffn_grouped_ref(x, wg, wu, wd, s2e, active), 5),
           bound(k3_bytes, k3_ops, BF16_FLOPS), time_ms(k3_library, 50))
    log({"phase": "kernel_detail", "kernel": "expert_ffn", "active_experts": n_act, "card": card})
    # the prefill shape (one 64-token chunk, drop-free capacity 64, all experts)
    xp = torch.randn((E, 64, d), generator=gen, device=dev).to(bf)
    allp = torch.ones(E, dtype=torch.bool, device=dev)
    ms_p = time_ms(lambda: expert_ffn_grouped(xp, wg, wu, wd, s2e, allp), 5)
    log({"phase": "kernel_detail", "kernel": "expert_ffn", "shape": "prefill CAP=64, 64 active",
         "ms": ms_p, "bound_ms": bound(3 * E * d * f * 2 + 2 * E * 64 * d * 2,
                                       E * 64 * 6 * d * f, BF16_FLOPS)[0], "card": card})
    del wg, wu, wd, wg_a, wu_a, wd_a, x, xp, got, want
    torch.cuda.empty_cache()

    # ---- 4. reduced parity: plain versions on the CPU vs kernels on the card
    rcfg = dataclasses.replace(get_config("dsv2-lite-reduced"), dtype="float32")
    p_cpu = model_mod.init_params(rcfg, seed=0, device="cpu")

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v) for v in tree]
        return tree.to(dev)

    p_gpu = to_dev(p_cpu)
    rlayout = build_layout(make_routing_trace(512, rcfg.num_experts, rcfg.top_k, 0.8, 0),
                           rcfg.num_experts, 2, 3)
    spec = WorkloadSpec(mean_input=8, mean_output=10, vocab_size=rcfg.vocab_size, max_input=24,
                        max_output=16, seed=1)
    streams = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = ServingEngine(rcfg, params, max_batch=4, cache_len=64, kv_page_size=16,
                            prefill_chunk=16, layout=rlayout, scheduler="aebs", device=where)
        cuda.reset_launch_counts()
        eng.run(sample_requests(spec, np.zeros(6), with_prompts=True), max_steps=500)
        streams[where] = {r.rid: r.tokens_out for r in eng.completed}
        if where == "cuda" and min(cuda.LAUNCHES.values()) == 0:
            raise AssertionError(f"reduced run on the card skipped a kernel: {cuda.LAUNCHES}")
    prompt = torch.from_numpy(np.arange(13, dtype=np.int64)[None] % rcfg.vocab_size)
    logits = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        c = model_mod.init_decode_caches(rcfg, 1, 64, device=where)
        ex = {"moe_ctx": {"capacity": 13}}
        logits[where], _ = model_mod.prefill_chunk(params, prompt.to(where), c, 0, rcfg, extra=ex)
    lerr = float((logits["cuda"].cpu() - logits["cpu"]).abs().max())
    same = streams["cpu"] == streams["cuda"]
    log({"phase": "reduced_parity", "dtype": "float32", "prefill_logit_max_abs_err": lerr,
         "tolerance": TOL["f32_layer"], "streams_equal": same, "streams_cpu": streams["cpu"],
         "streams_cuda": streams["cuda"], "card": card})
    if lerr > TOL["f32_layer"] or not same:
        raise AssertionError("reduced parity: the card disagrees with the CPU plain versions")
    del p_gpu

    # ---- 5. full-width serving ------------------------------------------
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = numel(params)
    log({"phase": "init", "params": n_params, "seconds": time.perf_counter() - t0,
         "weights_gb": torch.cuda.memory_allocated() / 1e9, "card": card})

    rng = np.random.default_rng(2)
    reqs = []
    for i in range(12):
        n_in = int(rng.integers(16, 49))
        reqs.append(Request(rid=i, arrival=0.0, input_len=n_in, output_len=int(rng.integers(16, 33)),
                            prompt=rng.integers(0, cfg.vocab_size, size=n_in, dtype=np.int32),
                            token_times=[]))
    kw = dict(max_batch=8, cache_len=512, kv_page_size=16, prefill_chunk=64, layout=layout,
              scheduler="aebs", device=dev)
    warm = ServingEngine(cfg, params, **kw)  # first-call costs (cuBLAS handles, allocator)
    warm.run([Request(rid=99, arrival=0.0, input_len=8, output_len=3,
                      prompt=np.arange(8, dtype=np.int32), token_times=[])])
    del warm

    step_ms = []
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
    decode_step = model_mod.decode_step

    def checked_decode_step(*args, **kwargs):
        t = time.perf_counter()
        logits, caches = decode_step(*args, **kwargs)
        nonfinite.add_((~torch.isfinite(logits)).sum())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return logits, caches

    engine = ServingEngine(cfg, params, **kw)
    model_mod.decode_step = checked_decode_step
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    m = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    model_mod.decode_step = decode_step
    steps = engine.steps_done
    n_layers = cfg.num_layers
    log({"phase": "serve", "card": card, "model": cfg.name, "requests": len(reqs),
         "completed": m["completed"], "tokens": m["tokens"], "decode_steps": steps,
         "wall_s": wall, "tokens_per_s": m["throughput_tok_s"],
         "decode_step_ms_mean": float(np.mean(step_ms)),
         "decode_step_ms_p50": float(np.median(step_ms)),
         "tpot_ms_mean": m["tpot_mean"] * 1e3, "tpot_ms_p99": m["tpot_p99"] * 1e3,
         "ttft_ms_mean": m["ttft_mean"] * 1e3, "ttft_ms_p99": m["ttft_p99"] * 1e3,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "kv_pages": m["kv_pages"],
         "launches": launches})
    if m["completed"] != len(reqs) or m["truncated"]:
        raise AssertionError(f"serving: {m['completed']} of {len(reqs)} requests completed")
    if any(r.generated != r.output_len for r in engine.completed):
        raise AssertionError("serving: a request stopped short of its output length")
    if int(nonfinite) != 0:
        raise AssertionError(f"serving: {int(nonfinite)} non-finite logits")
    for name, n in launches.items():
        if n < n_layers * steps:
            raise AssertionError(f"{name}: {n} launches < {n_layers} layers x {steps} decode steps")
        rows[name]["launches"] = n

    # ---- 5b. where the time goes: device time of each decode step and
    # prefill chunk of a short run (8 requests, 16 in, 16 out), profiled one
    # call at a time with CUDA activity only (kernels, no double counting)
    from torch.profiler import ProfilerActivity, profile

    prefill_chunk = model_mod.prefill_chunk
    device_ms = {"decode": [], "prefill": []}
    kernel_ms = {"decode": {}, "prefill": {}}

    def profiled(fn, kind):
        def call(*args, **kwargs):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            total = 0.0
            for e in prof.key_averages():
                t = e.self_device_time_total / 1e3
                kernel_ms[kind][e.key] = kernel_ms[kind].get(e.key, 0.0) + t
                total += t
            device_ms[kind].append(total)
            return out
        return call

    short = [Request(rid=100 + i, arrival=0.0, input_len=16, output_len=16,
                     prompt=rng.integers(0, cfg.vocab_size, size=16, dtype=np.int32),
                     token_times=[]) for i in range(8)]
    engine = ServingEngine(cfg, params, **kw)
    model_mod.decode_step = profiled(decode_step, "decode")
    model_mod.prefill_chunk = profiled(prefill_chunk, "prefill")
    engine.run(short)
    model_mod.decode_step, model_mod.prefill_chunk = decode_step, prefill_chunk
    busy = float(np.mean(device_ms["decode"]))
    log({"phase": "profile", "card": card, "decode_steps": len(device_ms["decode"]),
         "device_ms_per_decode_step": busy,
         "step_ms_unprofiled": float(np.mean(step_ms)),
         "device_idle_share_decode": 1.0 - busy / float(np.mean(step_ms)),
         "device_ms_per_prefill_chunk": float(np.mean(device_ms["prefill"])),
         "ttft_ms_unprofiled": m["ttft_mean"] * 1e3})
    for kind in ("decode", "prefill"):
        n = len(device_ms[kind])
        top = sorted(kernel_ms[kind].items(), key=lambda kv: -kv[1])[:10]
        log({"phase": "profile_top", "kind": kind, "card": card,
             "ms_per_call": [[k[:80], v / n] for k, v in top]})

    # ---- 6. results ------------------------------------------------------
    log({"kernels": [rows[n] for n in cuda.LAUNCHES]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
