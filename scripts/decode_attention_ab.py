#!/usr/bin/env python3
"""Time the port's decode-attention, AEBS and expert-FFN kernels of several
checkouts on one card, in turns, on the same inputs.

    python3 scripts/decode_attention_ab.py --src OLD/src --src src --src src --src OLD/src
    python3 scripts/decode_attention_ab.py --only aebs --src OLD/src --src src

Each ``--src`` (a checkout's ``src`` directory) runs in a process of its own,
in the order given, because two checkouts share module names.  A process
builds that checkout's kernels, checks each kernel it has against its plain
version, and prints one JSON line: the card, the checkout, and per kernel
and shape the ms per call, twice: ``ms`` over back-to-back calls (CUDA
events; where the wrapper's host time is longer than the kernel, as at the
serving shape, it is what this measures) and ``device_ms`` over a CUDA
graph of the same calls (the device alone).  Kernels:
K1 ``paged_decode_attention`` at the serving shape (8 slots, 16 heads of
128, pages of 16, random lengths 1-512, four layers' pools rotated), at
4 x 32768 rows, all valid, and at every other K1 shape of PERF.md's kernel
table (8 x 512 at 3, 4 and 7 query heads a KV head, head_dim 256 and
dsv2's 128 heads; gemma2-2b's global layers, 8 x 8192 with softcap 50;
whisper-tiny's 8 x 448 and pixtral-12b's 8 x 2048), the block table a
random permutation of the pool's pages, with the host microseconds a
wrapper call takes (the median of 50 rounds of 20 calls); K4 ``decode_attention`` and K5 ``decode_attention_int8``
at the serving shape (six layers' caches rotated), at 8 and 1 x 32768 rows,
all valid, and at the same other shapes; K2 ``aebs_schedule``
(the whole schedule, however many launches the checkout makes of it) at the
serving shape (8 tokens' top-6 of 64 experts over a 4 x 17-slot replica
layout), at the paper's Fig. 15 grid (``benchmarks/fig15_overhead.py``:
64 experts, top-6, 12 slots an instance, n_e 8 and 16, B 64 to 4096), and
at n_e 16 with B 1365, 1366, 2048, 2049 and 3072, around one block's 8192
ids in registers and the port's cluster threshold (12288 ids = 2048 x 6);
beside
them the launch floor, an empty kernel (``scripts/launch_floor.cu``, built
into ``build/`` with the checkout's nvcc flags) in the same harness; K3
``expert_ffn_grouped`` at the decode shape (64 slots x CAP 4 x 2048 x 1408,
the experts that 8 tokens' top-6 activate), at a 64-token prefill
chunk's (CAP 64, all 64 experts) and at a batched prefill call's (two
prompts' 64-token chunks, CAP 128), as ``chip_smoke.py``'s phase 3d, and
at phase 3e's shapes of the other MoE configs (qwen2-moe, scaled-ds-1,
scaled-ds-2, phi3.5-moe, dsv2: 8 tokens' decode over ``serving_layout``'s
capacity and a 64-token chunk, CAP 64, every expert); beside each, the
host microseconds a wrapper call spends enqueueing and the same function
as three ``bmm`` calls and silu * mul on the active experts' pre-gathered
weights (``bmm``, timed the same two ways).  A group builds only its own
sources; ``build_s`` gives K3's build alone (``expert_ffn``) and the rest.
``--only`` keeps one group of kernels (``k1``: K1's shapes alone).
``--k1-body tc|attend`` runs every K1 call on that body of
``csrc/decode_attention.cu`` whatever ``ops.k1_body`` would pick (a
checkout with both), so the two can be timed in turns on the same shapes:

    for b in attend tc tc attend; do
      python3 scripts/decode_attention_ab.py --only k1 --k1-body $b --src src; done

``--body tc|attend`` does the same for every K4 and K5 call (``ops.decode_body``;
``--only k45`` keeps K4's and K5's shapes alone).  K4 and K5 also run at
gemma2-2b's local layers (a wrapped 8 x 4096 rolling buffer, every row
live, softcap 50), at 4 x 32768 rows of 32 query heads over 8, and at G = 1
over one slot of 16 heads at 512 to 16384 rows and whisper-tiny's 2 x 448,
all rows live; every K4 and K5 shape has its host microseconds too.

Needs one CUDA card; exits non-zero without one.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

TOL = 3e-2  # bf16, tests/_torch_parity.py


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()


def launch_floor(cuda):
    """The empty kernel's launcher, built with the checkout's nvcc flags."""
    source = Path(__file__).resolve().with_name("launch_floor.cu")
    key = hashlib.sha256(source.read_bytes() + " ".join(cuda.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = Path(__file__).resolve().parents[1] / "build" / f"liblaunch_floor-{key}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(tmp), str(source)], check=True)
        os.replace(tmp, out)
    fn = ctypes.CDLL(str(out)).launch_floor
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    return fn


def child(src, only, k1_body=None, body=None):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_ab: torch sees no CUDA device")
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels import cuda
    from repro_torch.kernels.decode_attention import ops

    if k1_body:
        ops.k1_body = lambda *_: k1_body
    if body:
        ops.decode_body = lambda *_: body
    groups = {"attention": ("decode_attention",), "k1": ("decode_attention",), "k45": ("decode_attention",),
              "aebs": ("aebs",), "ffn": ("expert_ffn",)}
    build_s = {"expert_ffn": cuda.build_all(("expert_ffn",))} if only in (None, "ffn") else {}
    build_s["rest"] = cuda.build_all(groups[only] if only else cuda.SOURCES)
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)

    def time_ms(fn, n, iters):
        """ms per call of back-to-back calls (CUDA events; the wrapper's host
        time included where it is longer than the kernel's)."""
        state = {"i": 0}

        def call():
            state["i"] += 1
            fn(state["i"] % n)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            call()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def device_ms(fn, n, reps=10):
        """ms per call on the device alone: a CUDA graph of ``reps`` rounds
        over the ``n`` inputs, replayed (no host time between launches)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(n):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                for i in range(n):
                    fn(i)
        graph.replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / (5 * reps * n)

    dev_out = {}

    def measure(key, fn, n, iters):
        out[key] = time_ms(fn, n, iters)
        dev_out[key] = device_ms(fn, n)

    def check(name, got, want):
        err = float((got.float() - want.float()).abs().max())
        if err > TOL:
            raise AssertionError(f"{src}: {name} disagrees with its plain version ({err})")

    out = {}
    floor = launch_floor(cuda)

    def floor_call(_):
        if floor(torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("launch_floor: the empty kernel did not launch")

    measure("launch_floor", floor_call, 1, 500)

    def host_us(fn, n=20, reps=50):
        """Host microseconds a call spends enqueueing: the median over
        ``reps`` rounds of ``n`` calls, the device idle before each round."""
        per = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            per.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
        return float(np.median(per))

    host = {}
    B, nh, nkv, hd, ps, nblk = 8, 16, 16, 128, 16, 32
    q_all = torch.randn((B, nh, hd), generator=gen, device=dev).to(bf)
    lens_np = rng.integers(1, nblk * ps + 1, size=B).astype(np.int32)

    def k1_shape(shape, q, nkv_c, lens_case, nblk_c, L, iters, cap=0.0):
        """K1 over ``L`` layers' pools rotated, the block table a random
        permutation of the pool's pages."""
        Bc, _, hd_c = q.shape
        P = Bc * nblk_c + 1
        k_pool = torch.randn((L, P, ps, nkv_c, hd_c), generator=gen, device=dev).to(bf)
        v_pool = torch.randn((L, P, ps, nkv_c, hd_c), generator=gen, device=dev).to(bf)
        bt_np = np.zeros((Bc, nblk_c), np.int32)
        perm = rng.permutation(P - 1) + 1
        used = 0
        for b in range(Bc):
            nb = -(-int(lens_case[b]) // ps)
            bt_np[b, :nb] = perm[used: used + nb]
            used += nb
        bt = torch.from_numpy(bt_np).to(dev)
        ln = torch.from_numpy(np.asarray(lens_case, np.int32)).to(dev)
        check(f"paged_decode_attention/{shape}", ops.paged_decode_attention(q, k_pool[0], v_pool[0], bt, ln, cap),
              ops.paged_decode_attention_ref(q, k_pool[0], v_pool[0], bt, ln, cap))
        call = lambda l: ops.paged_decode_attention(q, k_pool[l % L], v_pool[l % L], bt, ln, cap)  # noqa: E731
        measure(f"paged_decode_attention/{shape}", call, L, iters)
        host[f"paged_decode_attention/{shape}"] = host_us(call)
        del k_pool, v_pool
        torch.cuda.empty_cache()

    def k45_shape(shape, q, nkv_c, S, lens_case, L, iters, cap=0.0):
        """K4 and K5 over ``L`` layers' contiguous caches rotated."""
        from repro_torch.models.attention import quantize_kv

        Bc, _, hd_c = q.shape
        ln = torch.from_numpy(np.asarray(lens_case, np.int32)).to(dev)
        kc = torch.randn((L, Bc, S, nkv_c, hd_c), generator=gen, device=dev).to(bf)
        vc = torch.randn((L, Bc, S, nkv_c, hd_c), generator=gen, device=dev).to(bf)
        check("decode_attention", ops.decode_attention(q, kc[0], vc[0], ln, cap),
              ops.decode_attention_ref(q, kc[0], vc[0], ln, cap))
        def k4(l):
            return ops.decode_attention(q, kc[l % L], vc[l % L], ln, cap)

        measure(f"decode_attention/{shape}", k4, L, iters)
        host[f"decode_attention/{shape}"] = host_us(k4)
        quant = [quantize_kv(kc[l]) + quantize_kv(vc[l]) for l in range(L)]
        del kc, vc
        k8, ks, v8, vs = quant[0]
        check("decode_attention_int8", ops.decode_attention_int8(q, k8, v8, ks, vs, ln, cap),
              ops.decode_attention_int8_ref(q, k8, v8, ks, vs, ln, cap))

        def k5(l):
            kq, kscale, vq, vscale = quant[l % L]
            return ops.decode_attention_int8(q, kq, vq, kscale, vscale, ln, cap)

        measure(f"decode_attention_int8/{shape}", k5, L, iters)
        host[f"decode_attention_int8/{shape}"] = host_us(k5)
        del quant, k8, ks, v8, vs
        torch.cuda.empty_cache()

    if only in (None, "attention", "k1", "k45"):
        k1 = only != "k45"
        if k1:
            k1_shape("serving", q_all, nkv, lens_np, nblk, 4, 200)
            k1_shape("32k_b4", q_all[:4], nkv, np.full(4, 32768, np.int32), 32768 // ps, 1, 20)
        for shape, S, lens_case, L, iters in (
            ("serving", nblk * ps, lens_np, 6, 200),
            ("32k", 32768, np.full(B, 32768, np.int32), 1, 20),
            ("32k_b1", 32768, np.full(1, 32768, np.int32), 1, 50),
        ) if only != "k1" else ():
            k45_shape(shape, q_all[:len(lens_case)], nkv, S, lens_case, L, iters)
        # the K1 rows of PERF.md's kernel table: phase 3e's configs at 8 x 512,
        # gemma2-2b's global layers (8 x 8192, softcap 50), whisper-tiny's
        # decoder (8 x 448) and pixtral-12b's (8 x 2048), random lengths;
        # K4 and K5 at the same shapes
        for shape, nh_c, nkv_c, hd_c, S, cap, L, iters in (
            ("phi4_g3", 24, 8, 128, 512, 0.0, 4, 100),
            ("scaled_ds_g4", 32, 8, 128, 512, 0.0, 4, 100),
            ("yi_g7", 56, 8, 128, 512, 0.0, 4, 100),
            ("gemma7b_hd256", 16, 16, 256, 512, 0.0, 4, 100),
            ("dsv2_128h", 128, 128, 128, 512, 0.0, 4, 100),
            ("gemma2_global_8k", 8, 4, 256, 8192, 50.0, 2, 50),
            ("whisper_448", 6, 6, 64, 448, 0.0, 4, 100),
            ("pixtral_2k", 32, 8, 128, 2048, 0.0, 2, 50),
        ):
            lens_c = np.random.default_rng(S + nh_c).integers(1, S + 1, size=B).astype(np.int32)
            q = torch.randn((B, nh_c, hd_c), generator=gen, device=dev).to(bf)
            if k1:
                k1_shape(shape, q, nkv_c, lens_c, S // ps, L, iters, cap)
            if only != "k1":
                k45_shape(shape, q, nkv_c, S, lens_c, L, iters, cap)
        if only != "k1":
            # K4 and K5 alone: gemma2-2b's local layers (a wrapped rolling
            # buffer, every row live) and decode_32k at 32 heads over 8
            k45_shape("gemma2_local_4k", torch.randn((B, 8, 256), generator=gen, device=dev).to(bf), 4, 4096,
                      np.full(B, 4096, np.int32), 2, 50, 50.0)
            k45_shape("32k_b4_g4", torch.randn((4, 32, hd), generator=gen, device=dev).to(bf), 8, 32768,
                      np.full(4, 32768, np.int32), 1, 20)
            # G = 1 over few (slot, KV head) pairs, where ops.decode_body's
            # choice turns on the cache's rows: one slot of dsv2-lite's 16
            # heads of 128 at 512 to 16384 rows, and whisper-tiny's 2 x 448
            for S in (512, 2048, 4096, 8192, 16384):
                k45_shape(f"g1_b1_{S}", q_all[:1], nkv, S, np.full(1, S, np.int32), 4 if S <= 4096 else 2, 100)
            k45_shape("whisper_b2_448", torch.randn((2, 6, 64), generator=gen, device=dev).to(bf), 6, 448,
                      np.full(2, 448, np.int32), 4, 100)

    from repro_torch.core.aebs import aebs_assign
    from repro_torch.core.amax import make_routing_trace
    from repro_torch.core.placement import build_layout
    from repro_torch.kernels.aebs import ops as aebs
    from repro_torch.kernels.expert_ffn import ops as ffn

    E, top_k, d, f = 64, 6, 2048, 1408

    def aebs_shape(key, eids, layout, iters):
        tables, n_e = layout.device_tables(dev), layout.num_instances
        want = aebs_assign(eids, tables, n_e)
        for got, w in zip(aebs.aebs_schedule(eids, tables, n_e), want):
            if not torch.equal(got, w):
                raise AssertionError(f"{src}: aebs_schedule {key} differs from the plain aebs_assign")
        measure(f"aebs_schedule/{key}", lambda _: aebs.aebs_schedule(eids, tables, n_e), 1, iters)

    if only in (None, "aebs"):
        layout = build_layout(make_routing_trace(2048, E, top_k, skew=0.8, seed=0), E, 4, 17)
        aebs_shape("serving", torch.from_numpy(make_routing_trace(8, E, top_k, skew=0.8, seed=1)).to(dev),
                   layout, 500)
        trace = make_routing_trace(8192, E, top_k, skew=1.0, seed=0)
        for n_e, bs in ((8, (64, 256, 1024, 4096)), (16, (64, 256, 1024, 1365, 1366, 2048, 2049, 3072, 4096))):
            layout = build_layout(trace, E, n_e, 12)
            for b in bs:
                aebs_shape(f"fig15_ne{n_e}_B{b}", torch.from_numpy(trace[:b]).to(dev), layout, 200)

    def ffn_shape(key, x, w3, s2e, active, iters):
        wg, wu, wd = w3
        check("expert_ffn", ffn.expert_ffn_grouped(x, wg, wu, wd, s2e, active),
              ffn.expert_ffn_grouped_ref(x, wg, wu, wd, s2e, active))
        call = lambda _: ffn.expert_ffn_grouped(x, wg, wu, wd, s2e, active)  # noqa: E731
        measure(f"expert_ffn/{key}", call, 1, iters)
        host[f"expert_ffn/{key}"] = host_us(call)
        idx = torch.nonzero(active & (s2e >= 0))[:, 0]
        e_idx = s2e[idx].long()
        xa, ga, ua, da = x[idx], wg[e_idx], wu[e_idx], wd[e_idx]

        def lib(_):
            torch.bmm(F.silu(torch.bmm(xa, ga)) * torch.bmm(xa, ua), da)

        measure(f"bmm/{key}", lib, 1, iters)

    def ffn_weights(E3, d3, f3):
        return ((torch.randn((E3, d3, f3), generator=gen, device=dev) * d3**-0.5).to(bf),
                (torch.randn((E3, d3, f3), generator=gen, device=dev) * d3**-0.5).to(bf),
                (torch.randn((E3, f3, d3), generator=gen, device=dev) * f3**-0.5).to(bf))

    if only in (None, "ffn"):
        import torch.nn.functional as F

        from repro_torch.configs import get_config
        from repro_torch.launch.steps import serving_layout
        from repro_torch.models.moe import default_capacity

        w3 = ffn_weights(E, d, f)
        s2e = torch.arange(E, dtype=torch.int32, device=dev)
        eids = torch.from_numpy(make_routing_trace(8, E, top_k, skew=0.8, seed=1)).to(dev)
        counts = torch.bincount(eids.reshape(-1).long(), minlength=E)
        every = torch.ones(E, dtype=torch.bool, device=dev)
        for shape, CAP, active, iters in (("decode", 4, counts > 0, 50), ("prefill", 64, every, 20),
                                          ("batched_prefill", 128, every, 20)):
            x = torch.randn((E, CAP, d), generator=gen, device=dev).to(bf)
            ffn_shape(shape, x, w3, s2e, active, iters)
        del w3
        for name in ("qwen2-moe-a2.7b", "scaled-ds-1", "scaled-ds-2", "phi3.5-moe-42b-a6.6b", "dsv2"):
            cfg = get_config(name)
            E3, k3, d3, f3 = cfg.num_experts, cfg.top_k, cfg.d_model, cfg.d_ff_expert
            w3 = ffn_weights(E3, d3, f3)
            s2e3 = torch.arange(E3, dtype=torch.int32, device=dev)
            cap = default_capacity(8, k3, serving_layout(cfg, 4).total_slots, cfg.capacity_factor)
            counts = torch.bincount(torch.from_numpy(make_routing_trace(8, E3, k3, skew=0.8, seed=1)).to(dev)
                                    .reshape(-1).long(), minlength=E3)
            x = torch.randn((E3, cap, d3), generator=gen, device=dev).to(bf)
            x = torch.where(torch.arange(cap, device=dev)[None, :, None] < counts[:, None, None], x, 0)
            ffn_shape(f"{name}/decode", x, w3, s2e3, counts > 0, 30)
            x = torch.randn((E3, 64, d3), generator=gen, device=dev).to(bf)
            ffn_shape(f"{name}/prefill", x, w3, s2e3, torch.ones(E3, dtype=torch.bool, device=dev), 10)
            del w3, x
            torch.cuda.empty_cache()
    print(json.dumps({"card": card_line(), "src": src, "k1_body": k1_body, "body": body, "build_s": build_s, "ms": out,
                      "device_ms": dev_out, "host_us": host}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", help="a checkout's src directory (repeat, in turn order)")
    ap.add_argument("--only", choices=("attention", "k1", "k45", "aebs", "ffn"), help="one group of kernels")
    ap.add_argument("--k1-body", choices=("tc", "attend"), help="run K1 on this body of csrc/decode_attention.cu")
    ap.add_argument("--body", choices=("tc", "attend"), help="run K4 and K5 on this body of csrc/decode_attention.cu")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.only, args.k1_body, args.body)
        return 0
    if not args.src:
        ap.error("give at least one --src")
    only = (["--only", args.only] if args.only else []) + (["--k1-body", args.k1_body] if args.k1_body else [])
    only += ["--body", args.body] if args.body else []
    for src in args.src:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", src, *only], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
