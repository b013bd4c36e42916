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
128, pages of 16, random lengths 1-512, four layers' pools rotated) and at
4 x 32768 rows, all valid, the block table a random permutation of the
pool's pages; K4 ``decode_attention`` and K5 ``decode_attention_int8``,
where the checkout has them, at the serving shape (six layers' caches
rotated) and at 8 and 1 x 32768 rows, all valid; K2 ``aebs_schedule``
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
prompts' 64-token chunks, CAP 128).  The inputs are those of
``chip_smoke.py``'s phase 3.  ``--only`` keeps one group of kernels.  Needs
one CUDA card; exits non-zero without one.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
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


def child(src, only):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_ab: torch sees no CUDA device")
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels import cuda
    from repro_torch.kernels.decode_attention import ops

    build_s = cuda.build_all()
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

    B, nh, nkv, hd, ps, nblk = 8, 16, 16, 128, 16, 32
    q_all = torch.randn((B, nh, hd), generator=gen, device=dev).to(bf)
    lens_np = rng.integers(1, nblk * ps + 1, size=B).astype(np.int32)
    for shape, nblk_c, lens_case, L, iters in (
        ("serving", nblk, lens_np, 4, 200),
        ("32k_b4", 32768 // ps, np.full(4, 32768, np.int32), 1, 20),
    ) if only in (None, "attention") else ():
        Bc = len(lens_case)
        q = q_all[:Bc]
        P = Bc * nblk_c + 1
        k_pool = torch.randn((L, P, ps, nkv, hd), generator=gen, device=dev).to(bf)
        v_pool = torch.randn((L, P, ps, nkv, hd), generator=gen, device=dev).to(bf)
        bt_np = np.zeros((Bc, nblk_c), np.int32)
        perm = rng.permutation(P - 1) + 1
        used = 0
        for b in range(Bc):
            nb = -(-int(lens_case[b]) // ps)
            bt_np[b, :nb] = perm[used: used + nb]
            used += nb
        bt = torch.from_numpy(bt_np).to(dev)
        ln = torch.from_numpy(lens_case).to(dev)
        check("paged_decode_attention", ops.paged_decode_attention(q, k_pool[0], v_pool[0], bt, ln),
              ops.paged_decode_attention_ref(q, k_pool[0], v_pool[0], bt, ln))
        measure(f"paged_decode_attention/{shape}",
                lambda l: ops.paged_decode_attention(q, k_pool[l], v_pool[l], bt, ln), L, iters)
        del k_pool, v_pool
        torch.cuda.empty_cache()

    if hasattr(ops, "decode_attention") and only in (None, "attention"):
        from repro_torch.models.attention import quantize_kv

        for shape, S, lens_case, L, iters in (
            ("serving", nblk * ps, lens_np, 6, 200),
            ("32k", 32768, np.full(B, 32768, np.int32), 1, 20),
            ("32k_b1", 32768, np.full(1, 32768, np.int32), 1, 50),
        ):
            ln = torch.from_numpy(lens_case).to(dev)
            Bc = len(lens_case)
            q = q_all[:Bc]
            kc = torch.randn((L, Bc, S, nkv, hd), generator=gen, device=dev).to(bf)
            vc = torch.randn((L, Bc, S, nkv, hd), generator=gen, device=dev).to(bf)
            check("decode_attention", ops.decode_attention(q, kc[0], vc[0], ln),
                  ops.decode_attention_ref(q, kc[0], vc[0], ln))
            measure(f"decode_attention/{shape}",
                    lambda l: ops.decode_attention(q, kc[l], vc[l], ln), L, iters)
            quant = [quantize_kv(kc[l]) + quantize_kv(vc[l]) for l in range(L)]
            del kc, vc
            k8, ks, v8, vs = quant[0]
            check("decode_attention_int8", ops.decode_attention_int8(q, k8, v8, ks, vs, ln),
                  ops.decode_attention_int8_ref(q, k8, v8, ks, vs, ln))
            measure(f"decode_attention_int8/{shape}",
                    lambda l: ops.decode_attention_int8(
                        q, quant[l][0], quant[l][2], quant[l][1], quant[l][3], ln), L, iters)
            del quant, k8, ks, v8, vs
            torch.cuda.empty_cache()

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

    if only in (None, "ffn"):
        wg = (torch.randn((E, d, f), generator=gen, device=dev) * d**-0.5).to(bf)
        wu = (torch.randn((E, d, f), generator=gen, device=dev) * d**-0.5).to(bf)
        wd = (torch.randn((E, f, d), generator=gen, device=dev) * f**-0.5).to(bf)
        s2e = torch.arange(E, dtype=torch.int32, device=dev)
        eids = torch.from_numpy(make_routing_trace(8, E, top_k, skew=0.8, seed=1)).to(dev)
        counts = torch.bincount(eids.reshape(-1).long(), minlength=E)
        every = torch.ones(E, dtype=torch.bool, device=dev)
        for shape, CAP, active, iters in (("decode", 4, counts > 0, 50), ("prefill", 64, every, 20),
                                          ("batched_prefill", 128, every, 20)):
            x = torch.randn((E, CAP, d), generator=gen, device=dev).to(bf)
            check("expert_ffn", ffn.expert_ffn_grouped(x, wg, wu, wd, s2e, active),
                  ffn.expert_ffn_grouped_ref(x, wg, wu, wd, s2e, active))
            measure(f"expert_ffn/{shape}",
                    lambda _: ffn.expert_ffn_grouped(x, wg, wu, wd, s2e, active), 1, iters)
    print(json.dumps({"card": card_line(), "src": src, "build_s": build_s, "ms": out,
                      "device_ms": dev_out}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", help="a checkout's src directory (repeat, in turn order)")
    ap.add_argument("--only", choices=("attention", "aebs", "ffn"), help="one group of kernels")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.only)
        return 0
    if not args.src:
        ap.error("give at least one --src")
    only = ["--only", args.only] if args.only else []
    for src in args.src:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", src, *only], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
