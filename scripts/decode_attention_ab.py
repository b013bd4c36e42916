#!/usr/bin/env python3
"""Time the port's decode-attention kernels of several checkouts on one card,
in turns, on the same inputs.

    python3 scripts/decode_attention_ab.py --src OLD/src --src src --src src --src OLD/src

Each ``--src`` (a checkout's ``src`` directory) runs in a process of its own,
in the order given, because two checkouts share module names.  A process
builds that checkout's kernels, checks each kernel it has against its plain
version, and prints one JSON line: the card, the checkout, and per kernel
and shape the ms per call (CUDA events over back-to-back calls).  Kernels:
K1 ``paged_decode_attention`` at the serving shape (8 slots, 16 heads of
128, pages of 16, random lengths 1-512, four layers' pools rotated); K4
``decode_attention`` and K5 ``decode_attention_int8``, where the checkout
has them, at that shape (six layers' caches rotated) and at 8 x 32768 rows,
all valid.  The inputs are those of ``chip_smoke.py``'s phase 3.  Needs one
CUDA card; exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys

TOL = 3e-2  # bf16, tests/_torch_parity.py


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()


def child(src):
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

    def check(name, got, want):
        err = float((got.float() - want.float()).abs().max())
        if err > TOL:
            raise AssertionError(f"{src}: {name} disagrees with its plain version ({err})")

    out = {}
    B, nh, nkv, hd, ps, nblk = 8, 16, 16, 128, 16, 32
    P, L = B * nblk + 1, 4
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
    check("paged_decode_attention", ops.paged_decode_attention(q, k_pool[0], v_pool[0], bt, lens),
          ops.paged_decode_attention_ref(q, k_pool[0], v_pool[0], bt, lens))
    out["paged_decode_attention/serving"] = time_ms(
        lambda l: ops.paged_decode_attention(q, k_pool[l], v_pool[l], bt, lens), L, 200)
    del k_pool, v_pool

    if hasattr(ops, "decode_attention"):
        from repro_torch.models.attention import quantize_kv

        for shape, S, lens_case, L, iters in (
            ("serving", nblk * ps, lens_np, 6, 200),
            ("32k", 32768, np.full(B, 32768, np.int32), 1, 20),
        ):
            ln = torch.from_numpy(lens_case).to(dev)
            kc = torch.randn((L, B, S, nkv, hd), generator=gen, device=dev).to(bf)
            vc = torch.randn((L, B, S, nkv, hd), generator=gen, device=dev).to(bf)
            check("decode_attention", ops.decode_attention(q, kc[0], vc[0], ln),
                  ops.decode_attention_ref(q, kc[0], vc[0], ln))
            out[f"decode_attention/{shape}"] = time_ms(
                lambda l: ops.decode_attention(q, kc[l], vc[l], ln), L, iters)
            quant = [quantize_kv(kc[l]) + quantize_kv(vc[l]) for l in range(L)]
            del kc, vc
            k8, ks, v8, vs = quant[0]
            check("decode_attention_int8", ops.decode_attention_int8(q, k8, v8, ks, vs, ln),
                  ops.decode_attention_int8_ref(q, k8, v8, ks, vs, ln))
            out[f"decode_attention_int8/{shape}"] = time_ms(
                lambda l: ops.decode_attention_int8(
                    q, quant[l][0], quant[l][2], quant[l][1], quant[l][3], ln), L, iters)
            del quant, k8, ks, v8, vs
            torch.cuda.empty_cache()
    print(json.dumps({"card": card_line(), "src": src, "build_s": build_s, "ms": out}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", help="a checkout's src directory (repeat, in turn order)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    if not args.src:
        ap.error("give at least one --src")
    for src in args.src:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", src], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
