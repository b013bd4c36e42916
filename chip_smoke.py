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
     K1 also at a 32k context at batch 4, K4 and K5 at batch 8 and 1 (each
     with the split-KV plan its wrapper chose), every attention case held
     within one bf16 rounding of its f32 oracle; K3 also at a 64-token
     prefill chunk's shape, and checked at a 320-token one (two launches of
     rows);
  4. reduced parity: dsv2-lite-reduced in float32 through the plain versions
     on the CPU and through the kernels on the card, same seeded weights and
     requests, for four KV layouts: paged (K1), contiguous (K4), int8
     contiguous (K5) and int8 paged (gather path, no attention kernel);
  5. full-width serving: dsv2-lite (27 layers, d 2048, 64 experts top-6 + 2
     shared, vocab 102400) with random bf16 weights drawn once on the card
     from a seed, AEBS over a 4 x 17-slot replica layout, 12 requests, served
     three times: paged KV (K1), contiguous KV (K4), int8 contiguous KV (K5);
     launch counts are zeroed just before each run and read just after it;
     then a profiled short run of each layout (device time per step);
  6. a ``{"kernels": [...]}`` line, then the card line, then the result line.

Without a CUDA card, or outside the repository, it exits non-zero before
printing any result.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

TOL = {"bf16": 3e-2, "f32_layer": 1e-4}  # tests/_torch_parity.py's table
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense tensor-core peak
INT8_OPS = 1979e12  # dense tensor-core peak
SCALAR_OPS = 67e12  # fp32 / int32 outside the tensor cores
# one bf16 rounding of an f32 result: an ulp is at most 2^-7 of the value,
# and f32 summation-order noise is kept under 2^-12 of the largest output
ROUNDING_REL, ROUNDING_FLOOR = 2.0**-7, 2.0**-12


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


def rounding_excess(got, want):
    """Largest ``|got - want|`` over what one bf16 rounding of the same f32
    result allows, ``ROUNDING_REL |want| + ROUNDING_FLOOR max|want|``: at most
    1 when both sides compute in f32 and round once.  Unlike TOL["bf16"] it
    scales with the output, which is ~0.01 at S = 32768."""
    g, w = got.float(), want.float()
    allow = ROUNDING_REL * w.abs() + ROUNDING_FLOOR * w.abs().max()
    return float(((g - w).abs() / allow.clamp(min=1e-30)).max())


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
        decode_attention,
        decode_attention_int8,
        decode_attention_int8_ref,
        decode_attention_ref,
        paged_decode_attention,
        paged_decode_attention_ref,
        split_plan,
    )
    from repro_torch.kernels.expert_ffn.ops import expert_ffn_grouped, expert_ffn_grouped_ref
    from repro_torch.core.aebs import aebs_assign, rewrite_slots
    from repro_torch.models import model as model_mod
    from repro_torch.models.attention import quantize_kv
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
    for name in cuda.SOURCES:  # ptxas' lines, summed up per source
        lines = cuda.BUILD_LOG.get(name, "").splitlines()
        regs = [int(w.split()[1]) for ln in lines for w in [ln[ln.find("Used "):]]
                if "Used " in ln and "registers" in ln]
        spills = [ln.strip() for ln in lines if re.search(r"\b[1-9]\d* bytes spill", ln)]
        log({"phase": "ptxas", "source": name, "kernels": len(regs),
             "max_registers": max(regs, default=None), "smem_lines": sorted(
                 {ln.split("registers,")[-1].strip() for ln in lines if "smem" in ln})[:4],
             "spills": spills})
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

    def record(name, source, replaces, err, tol, ms, plain_ms, bnd, library_ms, shape=None,
               excess=None, **detail):
        """Log one kernel measurement (with any ``detail`` of the launch) and
        raise if the kernel disagrees with its plain version, or where
        ``excess`` (:func:`rounding_excess` against its f32 oracle) is given,
        if that passes 1; the serving path's shape (no ``shape``) is the
        kernel's row of the final line."""
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms,
        }
        if shape is None:
            rows[name] = row
        ok = err <= tol and (excess is None or excess <= 1.0)
        if excess is not None:
            detail = {"rounding_excess": excess, **detail}
        log({"phase": "kernel" if shape is None else "kernel_detail", "card": card,
             "shape": shape or "serving", "tolerance": tol, "ok": ok, **row, **detail})
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"({err} > {tol}, or rounding excess {excess} > 1)")

    def cycled(fn, n):
        """A call of ``fn(i)`` that moves to the next of ``n`` inputs each time
        (several layers' caches, so that one call does not find the last
        call's rows in L2)."""
        state = {"i": 0}

        def call():
            state["i"] += 1
            fn(state["i"] % n)
        return call

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)

    # ---- 3a. K1 paged decode attention ----------------------------------
    # the serving path's shape (four layers' pools rotated, which exceed L2)
    # and decode_32k's context (src/repro/configs/base.py:278) at the 4
    # slots one card holds of it in bf16 beside dsv2-lite's weights, every
    # row valid; the block table is a random permutation of the pool's pages
    B, nh, nkv, hd, ps, nblk = 8, 16, 16, 128, 16, 32
    bf = torch.bfloat16
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def paged_case(nblk, lens_np, L, iters, plain_iters, shape):
        Bc = len(lens_np)
        P = Bc * nblk + 1  # full backing + null page
        k_pool = torch.randn((L, P, ps, nkv, hd), generator=gen, device=dev).to(bf)
        v_pool = torch.randn((L, P, ps, nkv, hd), generator=gen, device=dev).to(bf)
        q = q_all[:Bc]
        bt_np = np.zeros((Bc, nblk), np.int32)
        perm = rng.permutation(P - 1) + 1
        used = 0
        for b in range(Bc):
            nb = -(-int(lens_np[b]) // ps)
            bt_np[b, :nb] = perm[used: used + nb]
            used += nb
        bt = torch.from_numpy(bt_np).to(dev)
        lens = torch.from_numpy(lens_np).to(dev)
        got = paged_decode_attention(q, k_pool[0], v_pool[0], bt, lens)
        want = paged_decode_attention_ref(q, k_pool[0], v_pool[0], bt, lens)  # f32, rounded once
        err, excess = float((got.float() - want.float()).abs().max()), rounding_excess(got, want)
        del got, want
        S = nblk * ps
        kd = [k_pool[l][bt.long()].reshape(Bc, S, nkv, hd).transpose(1, 2).contiguous() for l in range(L)]
        vd = [v_pool[l][bt.long()].reshape(Bc, S, nkv, hd).transpose(1, 2).contiguous() for l in range(L)]
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None].long())[:, None, None, :]
        q4 = q[:, :, None, :]
        lib_ms = time_ms(cycled(lambda l: F.scaled_dot_product_attention(
            q4, kd[l], vd[l], attn_mask=mask), L), iters)
        del kd, vd
        live = int(lens_np.sum())
        k1_bytes = 2 * live * nkv * hd * 2 + 2 * Bc * nh * hd * 2 + Bc * nblk * 4 + Bc * 4
        n_split, split_rows = split_plan(Bc, nkv, S, n_sms, ps)
        record("paged_decode_attention", "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:177", err, TOL["bf16"],
               time_ms(cycled(lambda l: paged_decode_attention(q, k_pool[l], v_pool[l], bt, lens), L), iters),
               time_ms(cycled(lambda l: paged_decode_attention_ref(q, k_pool[l], v_pool[l], bt, lens), L),
                       plain_iters),
               bound(k1_bytes, 4 * nh * hd * live, BF16_FLOPS), lib_ms, shape, excess,
               n_split=n_split, pages_per_split=split_rows // ps)
        del k_pool, v_pool
        torch.cuda.empty_cache()

    q_all = torch.randn((B, nh, hd), generator=gen, device=dev).to(bf)
    lens_np = rng.integers(1, nblk * ps + 1, size=B).astype(np.int32)
    paged_case(nblk, lens_np, 4, 200, 50, None)
    paged_case(2048, np.full(4, 32768, np.int32), 1, 20, 3,
               "decode_32k: B 4, S 32768, pages of 16, all rows valid")

    # ---- 3b. K4 / K5 decode attention over a contiguous (int8) cache ------
    # the serving path's shape (the K1 case's lengths, six layers' caches
    # rotated) and decode_32k's context at batch 8 (the int8 slots of 32k
    # one card holds beside the weights), every row valid, and at batch 1,
    # where 16 (slot, head) pairs leave most SMs to the split
    def contiguous_case(S, lens_np, L, iters, plain_iters, shape):
        lens = torch.from_numpy(lens_np).to(dev)
        Bc = len(lens_np)
        q = q_all[:Bc]
        q4 = q[:, :, None, :]
        live = int(lens_np.sum())
        io_bytes = 2 * Bc * nh * hd * 2 + Bc * 4  # q in, output out, lengths
        ops = 4 * nh * hd * live  # q.k and p.v over the live rows
        kc = torch.randn((L, Bc, S, nkv, hd), generator=gen, device=dev).to(bf)
        vc = torch.randn((L, Bc, S, nkv, hd), generator=gen, device=dev).to(bf)
        got, want = decode_attention(q, kc[0], vc[0], lens), decode_attention_ref(q, kc[0], vc[0], lens)
        err, excess = float((got.float() - want.float()).abs().max()), rounding_excess(got, want)
        kd = [kc[l].transpose(1, 2).contiguous() for l in range(L)]
        vd = [vc[l].transpose(1, 2).contiguous() for l in range(L)]
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None].long())[:, None, None, :]
        lib_ms = time_ms(cycled(lambda l: F.scaled_dot_product_attention(
            q4, kd[l], vd[l], attn_mask=mask), L), iters)
        del kd, vd
        n_split, split_rows = split_plan(Bc, nkv, S, n_sms)
        record("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:28", err, TOL["bf16"],
               time_ms(cycled(lambda l: decode_attention(q, kc[l], vc[l], lens), L), iters),
               time_ms(cycled(lambda l: decode_attention_ref(q, kc[l], vc[l], lens), L), plain_iters),
               bound(2 * live * nkv * hd * 2 + io_bytes, ops, BF16_FLOPS), lib_ms, shape,
               excess, n_split=n_split, rows_per_split=split_rows)
        quant = [quantize_kv(kc[l]) + quantize_kv(vc[l]) for l in range(L)]  # (k, ks, v, vs)
        del kc, vc
        torch.cuda.empty_cache()
        k8, ks, v8, vs = quant[0]
        got = decode_attention_int8(q, k8, v8, ks, vs, lens)
        err = float((got.float() - decode_attention_int8_ref(q, k8, v8, ks, vs, lens).float()).abs().max())
        # K5 keeps the dequantised rows in f32 (its plain version rounds them
        # to q's dtype first), so its one-rounding oracle attends over them
        want = decode_attention_ref(q, k8.float() * ks[..., None], v8.float() * vs[..., None], lens)
        excess = rounding_excess(got, want)
        del got, want
        # no single PyTorch call dequantises and attends: library_ms is null
        record("decode_attention_int8", "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention/kernel.py:75", err, TOL["bf16"],
               time_ms(cycled(lambda l: decode_attention_int8(
                   q, quant[l][0], quant[l][2], quant[l][1], quant[l][3], lens), L), iters),
               time_ms(cycled(lambda l: decode_attention_int8_ref(
                   q, quant[l][0], quant[l][2], quant[l][1], quant[l][3], lens), L), plain_iters),
               bound(2 * live * nkv * (hd + 4) + io_bytes, ops + 2 * live * nkv * hd, INT8_OPS),
               None, shape, excess, n_split=n_split, rows_per_split=split_rows)
        del quant, k8, ks, v8, vs
        torch.cuda.empty_cache()

    contiguous_case(nblk * ps, lens_np, 6, 200, 50, None)
    contiguous_case(32768, np.full(B, 32768, np.int32), 1, 20, 3, "decode_32k: B 8, S 32768, all rows valid")
    contiguous_case(32768, np.full(1, 32768, np.int32), 1, 50, 5, "decode_32k: B 1, S 32768, all rows valid")

    # ---- 3c. K2 AEBS ----------------------------------------------------
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

    # ---- 3d. K3 grouped expert FFN (decode: 8 tokens, CAP 4) -------------
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
    # the prefill shape: one 64-token chunk, drop-free capacity 64, all experts
    CAPP = 64
    xp = torch.randn((E, CAPP, d), generator=gen, device=dev).to(bf)
    allp = torch.ones(E, dtype=torch.bool, device=dev)
    err = float((expert_ffn_grouped(xp, wg, wu, wd, s2e, allp).float()
                 - expert_ffn_grouped_ref(xp, wg, wu, wd, s2e, allp).float()).abs().max())

    def k3_library_prefill():
        h = F.silu(torch.bmm(xp, wg)) * torch.bmm(xp, wu)
        torch.bmm(h, wd)

    record("expert_ffn", "src/repro_torch/csrc/expert_ffn.cu",
           "src/repro/kernels/expert_ffn/kernel.py:40", err, TOL["bf16"],
           time_ms(lambda: expert_ffn_grouped(xp, wg, wu, wd, s2e, allp), 20),
           time_ms(lambda: expert_ffn_grouped_ref(xp, wg, wu, wd, s2e, allp), 3),
           bound(3 * E * d * f * 2 + 2 * E * CAPP * d * 2 + 2 * E * 4, E * CAPP * 6 * d * f,
                 BF16_FLOPS),
           time_ms(k3_library_prefill, 20), f"prefill: CAP {CAPP}, {E} active")
    # a 320-token chunk: more rows than a block holds (256), so the bf16
    # kernel runs over two blocks of rows
    CAPL, SL = 320, 8
    xl = torch.randn((SL, CAPL, d), generator=gen, device=dev).to(bf)
    s2el = torch.arange(0, 2 * SL, 2, dtype=torch.int32, device=dev)
    s2el[1] = s2el[0]  # two slots share one expert
    actl = torch.ones(SL, dtype=torch.bool, device=dev)
    err = float((expert_ffn_grouped(xl, wg, wu, wd, s2el, actl).float()
                 - expert_ffn_grouped_ref(xl, wg, wu, wd, s2el, actl).float()).abs().max())
    log({"phase": "kernel_check", "kernel": "expert_ffn", "shape": f"CAP {CAPL}, {SL} slots",
         "max_abs_err": err, "tolerance": TOL["bf16"], "ok": err <= TOL["bf16"], "card": card})
    if err > TOL["bf16"]:
        raise AssertionError(f"expert_ffn at CAP {CAPL}: kernel disagrees ({err} > {TOL['bf16']})")
    del wg, wu, wd, wg_a, wu_a, wd_a, x, xp, xl, got, want
    torch.cuda.empty_cache()

    # ---- 4. reduced parity: plain versions on the CPU vs kernels on the card
    attn_kernels = ("paged_decode_attention", "decode_attention", "decode_attention_int8")
    moe_kernels = ("aebs_collect_greedy", "aebs_rewrite", "expert_ffn")
    # (KV layout, kv_quant, kv_page_size, the attention kernel it runs on the card)
    layouts = (("paged", False, 16, "paged_decode_attention"),
               ("contiguous", False, None, "decode_attention"),
               ("int8_contiguous", True, None, "decode_attention_int8"),
               ("int8_paged", True, 16, None))  # gather + dequantise, as the reference

    def check_launches(what, launches, attn_kernel, at_least):
        """The run launched each kernel of its path at least ``at_least``
        times and no other attention kernel."""
        path = moe_kernels + ((attn_kernel,) if attn_kernel else ())
        short = {n: launches[n] for n in path if launches[n] < at_least}
        stray = {n: launches[n] for n in attn_kernels if n not in path and launches[n]}
        if short or stray:
            raise AssertionError(f"{what}: kernels launched below {at_least} times {short} "
                                 f"or off the path {stray}")

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
    for name, kv_quant, page, attn_kernel in layouts:
        lcfg = dataclasses.replace(rcfg, kv_quant=kv_quant)
        streams = {}
        for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            eng = ServingEngine(lcfg, params, max_batch=4, cache_len=64, kv_page_size=page,
                                prefill_chunk=16, layout=rlayout, scheduler="aebs", device=where)
            cuda.reset_launch_counts()
            eng.run(sample_requests(spec, np.zeros(6), with_prompts=True), max_steps=500)
            launches = dict(cuda.LAUNCHES)
            streams[where] = {r.rid: r.tokens_out for r in eng.completed}
        check_launches(f"reduced {name} run on the card", launches, attn_kernel, 1)
        same = streams["cpu"] == streams["cuda"] and len(streams["cpu"]) == 6
        log({"phase": "reduced_parity", "layout": name, "dtype": "float32",
             "kv_dtype": "int8" if kv_quant else "float32", "streams_equal": same,
             "launches": launches, "streams_cpu": streams["cpu"], "streams_cuda": streams["cuda"],
             "card": card})
        if not same:
            raise AssertionError(f"reduced parity ({name}): the card disagrees with the CPU plain versions")
    prompt = torch.from_numpy(np.arange(13, dtype=np.int64)[None] % rcfg.vocab_size)
    logits = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        c = model_mod.init_decode_caches(rcfg, 1, 64, device=where)
        ex = {"moe_ctx": {"capacity": 13}}
        logits[where], _ = model_mod.prefill_chunk(params, prompt.to(where), c, 0, rcfg, extra=ex)
    lerr = float((logits["cuda"].cpu() - logits["cpu"]).abs().max())
    log({"phase": "reduced_parity", "dtype": "float32", "prefill_logit_max_abs_err": lerr,
         "tolerance": TOL["f32_layer"], "card": card})
    if lerr > TOL["f32_layer"]:
        raise AssertionError("reduced parity: prefill logits on the card disagree with the CPU")
    del p_gpu

    # ---- 5. full-width serving ------------------------------------------
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = numel(params)
    log({"phase": "init", "params": n_params, "seconds": time.perf_counter() - t0,
         "weights_gb": torch.cuda.memory_allocated() / 1e9, "card": card})

    def make_requests(seed, n, lo, hi, out_lo, out_hi, rid0=0):
        """Requests arriving at once; the same seed gives the same requests."""
        r = np.random.default_rng(seed)
        reqs = []
        for i in range(n):
            n_in = int(r.integers(lo, hi + 1))
            reqs.append(Request(rid=rid0 + i, arrival=0.0, input_len=n_in,
                                output_len=int(r.integers(out_lo, out_hi + 1)),
                                prompt=r.integers(0, cfg.vocab_size, size=n_in, dtype=np.int32),
                                token_times=[]))
        return reqs

    kw = dict(max_batch=8, cache_len=512, prefill_chunk=64, layout=layout, scheduler="aebs",
              device=dev)
    warm = ServingEngine(cfg, params, kv_page_size=16, **kw)  # first-call costs (cuBLAS, allocator)
    warm.run([Request(rid=99, arrival=0.0, input_len=8, output_len=3,
                      prompt=np.arange(8, dtype=np.int32), token_times=[])])
    del warm

    decode_step = model_mod.decode_step
    prefill_chunk = model_mod.prefill_chunk
    n_layers = cfg.num_layers
    serve_layouts = [lay for lay in layouts if lay[3] is not None]  # the three with a kernel
    served = {}
    for name, kv_quant, page, attn_kernel in serve_layouts:
        run_cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
        reqs = make_requests(2, 12, 16, 48, 16, 32)
        step_ms = []
        nonfinite = torch.zeros((), dtype=torch.int64, device=dev)

        def checked_decode_step(*args, **kwargs):
            t = time.perf_counter()
            logits, caches = decode_step(*args, **kwargs)
            nonfinite.add_((~torch.isfinite(logits)).sum())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return logits, caches

        engine = ServingEngine(run_cfg, params, kv_page_size=page, **kw)
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
        log({"phase": "serve", "layout": name, "card": card, "model": cfg.name,
             "kv_dtype": str(engine.caches["kv_k"].dtype), "requests": len(reqs),
             "completed": m["completed"], "tokens": m["tokens"], "decode_steps": steps,
             "wall_s": wall, "tokens_per_s": m["throughput_tok_s"],
             "decode_step_ms_mean": float(np.mean(step_ms)),
             "decode_step_ms_p50": float(np.median(step_ms)),
             "tpot_ms_mean": m["tpot_mean"] * 1e3, "tpot_ms_p99": m["tpot_p99"] * 1e3,
             "ttft_ms_mean": m["ttft_mean"] * 1e3, "ttft_ms_p99": m["ttft_p99"] * 1e3,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "kv_pages": m.get("kv_pages"), "launches": launches})
        if m["completed"] != len(reqs) or m["truncated"]:
            raise AssertionError(f"serving ({name}): {m['completed']} of {len(reqs)} requests completed")
        if any(r.generated != r.output_len for r in engine.completed):
            raise AssertionError(f"serving ({name}): a request stopped short of its output length")
        if int(nonfinite) != 0:
            raise AssertionError(f"serving ({name}): {int(nonfinite)} non-finite logits")
        check_launches(f"serving ({name}): {n_layers} layers x {steps} decode steps", launches,
                       attn_kernel, n_layers * steps)
        # each kernel's row counts the launches of the first run whose path has it
        for kname in (attn_kernel,) + moe_kernels:
            if rows[kname]["launches"] is None:
                rows[kname]["launches"] = launches[kname]
        served[name] = {"step_ms": float(np.mean(step_ms)), "ttft_ms": m["ttft_mean"] * 1e3}
        del engine
        torch.cuda.empty_cache()

    # ---- 5b. where the time goes: device time of each decode step and
    # prefill chunk of a short run (8 requests, 16 in, 16 out) per layout,
    # profiled one call at a time with CUDA activity only (kernels, no double
    # counting)
    from torch.profiler import ProfilerActivity, profile

    for name, kv_quant, page, _ in serve_layouts:
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

        engine = ServingEngine(dataclasses.replace(cfg, kv_quant=kv_quant), params,
                               kv_page_size=page, **kw)
        model_mod.decode_step = profiled(decode_step, "decode")
        model_mod.prefill_chunk = profiled(prefill_chunk, "prefill")
        engine.run(make_requests(3, 8, 16, 16, 16, 16, rid0=100))
        model_mod.decode_step, model_mod.prefill_chunk = decode_step, prefill_chunk
        del engine
        busy = float(np.mean(device_ms["decode"]))
        log({"phase": "profile", "layout": name, "card": card,
             "decode_steps": len(device_ms["decode"]),
             "device_ms_per_decode_step": busy,
             "step_ms_unprofiled": served[name]["step_ms"],
             "device_idle_share_decode": 1.0 - busy / served[name]["step_ms"],
             "device_ms_per_prefill_chunk": float(np.mean(device_ms["prefill"])),
             "ttft_ms_unprofiled": served[name]["ttft_ms"]})
        for kind in ("decode", "prefill"):
            n = len(device_ms[kind])
            top = sorted(kernel_ms[kind].items(), key=lambda kv: -kv[1])[:10]
            log({"phase": "profile_top", "layout": name, "kind": kind, "card": card,
                 "ms_per_call": [[k[:96], v / n] for k, v in top]})

    # ---- 6. results ------------------------------------------------------
    log({"kernels": [rows[n] for n in cuda.LAUNCHES]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
