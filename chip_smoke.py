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
     prefill chunk's shape and at a batched prefill call's (2 x 64 tokens,
     CAP 128), and checked at a whole-prompt call's (CAP 48) and a
     320-token chunk's (two launches of rows); K2 (one launch: bitmap, both greedy passes and the rewrite) at
     the serving shape and the paper's Fig. 15 grid, integers exact, each
     also timed on the device alone from a CUDA graph; and each kernel at
     the disaggregated executor's shapes of phase 5: K4 and K5 over a 4-row
     attention shard (K4 also over a 2-row one, phase 5c after its resize),
     K1 over a 2-row ping-pong shard with its own block table, K3 over each
     MoE instance's 17 slots through its row of ``slot_to_expert``;
  4. reduced parity: dsv2-lite-reduced in float32 through the plain versions
     on the CPU and through the kernels on the card, same seeded weights and
     requests, for four KV layouts: paged (K1), contiguous (K4), int8
     contiguous (K5) and int8 paged (gather path, no attention kernel); then
     the disaggregated executor (2 attention shards, 2 MoE instances x 3
     slots, capacity 64) for contiguous KV, paged KV with ping-pong and int8
     contiguous KV: streams CPU = card = the card's mono streams, and
     ``amax_log`` CPU = card; then disagg with a prefill pool, pipelined
     admission and 2-prompt batched prefill under modeled clocks, with one
     ``AutoScaler.actuate`` between two halves of the requests (contiguous
     KV): streams, ``amax_log`` and the decision CPU = card; then fault
     recovery in tests/test_faults.py's deployment: one plan that loses a
     prefill, an attention and a MoE device and times an exchange out twice,
     and an n_attn=1 attention loss over paged KV that degrades to mono:
     streams CPU = card = the fault-free run's, fault stats (without their
     wall-clock latencies) and ``amax_log`` CPU = card, launches exact;
  5. full-width serving: dsv2-lite (27 layers, d 2048, 64 experts top-6 + 2
     shared, vocab 102400) with random bf16 weights drawn once on the card
     from a seed, AEBS over a 4 x 17-slot replica layout, 12 requests, served
     three times: paged KV (K1), contiguous KV (K4), int8 contiguous KV (K5);
     launch counts are zeroed just before each run and read just after it,
     and K2 must have launched once per scheduled MoE layer call; then the
     same 12 requests through the disaggregated executor (2 attention
     shards, 4 MoE instances), contiguous KV (K4) and paged KV with
     ping-pong (K1), with its exchange telemetry and exact launch counts
     (K2 = instances x micro-batches x MoE layers x decode steps, K3 = as
     many plus MoE layers x prefill chunks, the attention kernel = shards x
     layers x decode steps); whether each stream equals its mono stream is
     reported, not gated (split-KV plans differ by batch in bf16);
     then (5c) the disagg deployment with a prefill pool of one device,
     pipelined admission and 2-prompt batched prefill serving the 12
     requests in two halves, an ``AutoScaler`` over the H100 performance
     model actuating a resize of the prefill, attention and MoE pools
     between them (launch counts exact in each half, K2/K3 held at the new
     layout's shapes, the streams held to an undisturbed blocking run, a
     flip allowed only on a bf16 near-tie); then (5d) fault recovery at
     full width: the 5c deployment (1P 2A 4E, contiguous KV, pipelined
     admission, the wall clock) loses its prefill device, times an exchange
     out twice, loses attention device 1 and MoE instance 0 and ends at 0P
     1A 3E, and an n_attn=1 deployment over paged KV loses its attention
     device and degrades to mono, replaying every slot through K1; each held
     to an undisturbed run of its deployment (a flip only on a bf16
     near-tie), with recovery latencies, replayed tokens, fault stall and
     peak memory logged and launches exact over every served, retried and
     replayed step; then a profiled short run of each mono layout, each
     disagg run and each pool size the fault runs pass through (device time
     per step, idle share);
  6. a ``{"kernels": [...]}`` line, then the card line, then the result line.

Without a CUDA card, or outside the repository, it exits non-zero before
printing any result.
"""

import dataclasses
import gc
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


def first_flips(streams, ref_streams, margins, ref_margins):
    """Where each stream first parts from its reference stream, with the
    top-2 logit margin of that token in both runs (None where not recorded)."""
    flips = {}
    for rid, want in ref_streams.items():
        got = streams.get(rid, [])
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None if len(got) == len(want) else min(len(got), len(want)))
        if j is not None:
            flips[rid] = {"token": j, "margin": margins.get((rid, j)), "margin_undisturbed": ref_margins.get((rid, j))}
    return flips


def wide_flips(flips, near_tie):
    """The flips that are not on a near-tie (margin above ``near_tie`` in both
    runs, or unrecorded)."""
    return {rid: f for rid, f in flips.items()
            if min(x for x in (f["margin"], f["margin_undisturbed"], float("inf")) if x is not None) > near_tie}


class StepTally:
    """Every decode step an engine runs while the tally is open (served,
    retried after a fault, or replayed by a recovery) with the executor and
    pools it ran at and, for a step a fault hook interrupted, the (layer,
    micro-batch) it stopped before; so the launches of a run with faults are
    held exactly; also the prefill calls (the queued path's and the
    replay's).  Wraps the engine's executor, its replay and the mono
    ``decode_step`` and prefill calls of ``model_mod``; ``close`` restores
    the module."""

    PREFILL = ("prefill_chunk", "prefill_chunk_batched", "prefill")

    def __init__(self, engine, model_mod):
        self.steps = []  # (kind, executor, rows per micro-batch, MoE instances, stopped at)
        self.prefill_calls = 0
        self._model, self._mono = model_mod, model_mod.decode_step
        self._prefill = {n: getattr(model_mod, n) for n in self.PREFILL}
        self._at, self._replaying = None, False
        ex = engine.disagg
        hook = ex.fault_hook

        def traced_hook(site, li, m):
            self._at = (li, m)
            if hook is not None:
                hook(site, li, m)

        def disagg_step(*args, **kwargs):
            # the executor through the engine, so that a degrade frees it
            ex = engine.disagg
            shards = [sum(s.mb == m for s in ex.shards) for m in range(ex.n_micro)]
            n_moe, done = ex.n_moe, False
            self._at = None
            try:
                out = type(ex).decode_step(ex, *args, **kwargs)
                done = True
            finally:
                self.steps.append((self._kind(done), "disagg", shards, n_moe, None if done else self._at))
            return out

        def mono_step(*args, **kwargs):
            out = self._mono(*args, **kwargs)
            self.steps.append((self._kind(True), "mono", [1], 1, None))
            return out

        replay = engine._replay_slot

        def replay_slot(slot):
            self._replaying = True
            try:
                replay(slot)
            finally:
                self._replaying = False

        def counted(fn):
            def call(*args, **kwargs):
                self.prefill_calls += 1
                return fn(*args, **kwargs)
            return call

        ex.fault_hook, ex.decode_step = traced_hook, disagg_step
        engine._replay_slot = replay_slot
        model_mod.decode_step = mono_step
        for n, fn in self._prefill.items():
            setattr(model_mod, n, counted(fn))

    def _kind(self, done):
        return "replay" if self._replaying else ("served" if done else "retried")

    def close(self):
        self._model.decode_step = self._mono
        for n, fn in self._prefill.items():
            setattr(self._model, n, fn)

    def counts(self):
        """Steps by (kind, executor)."""
        out = {}
        for kind, where, *_ in self.steps:
            out[f"{kind}_{where}"] = out.get(f"{kind}_{where}", 0) + 1
        return out

    def expected(self, kinds, attn_kernel):
        """The exact launches of the tallied steps and prefill calls: a
        disagg step launches the attention kernel once per shard and layer
        and K2 and K3 once per instance, micro-batch and MoE layer, as far as
        it got (a hook stops it before the exchange of (layer, micro-batch):
        that layer's attention ran for micro-batches up to it, its MoE stage
        for those before it); a mono step launches each once per layer (K2, K3
        per MoE layer); a prefill call K3 once per MoE layer."""
        n_moe_layers = sum(k == "moe" for k in kinds)
        attn = k2 = 0
        for _, where, shards, n_moe, at in self.steps:
            if where == "mono":
                attn, k2 = attn + len(kinds), k2 + n_moe_layers
            elif at is None:
                attn, k2 = attn + sum(shards) * len(kinds), k2 + n_moe * len(shards) * n_moe_layers
            else:
                li, m = at
                moe_before = sum(k == "moe" for k in kinds[:li])
                attn += sum(shards) * li + sum(shards[: m + 1])
                k2 += n_moe * (len(shards) * moe_before + m)
        return {attn_kernel: attn, "aebs_schedule": k2, "expert_ffn": k2 + self.prefill_calls * n_moe_layers}


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
    from repro_torch.core.aebs import ReplicaLayout
    from repro_torch.core.placement import build_layout, layout_for_survivors
    from repro_torch.kernels import cuda
    from repro_torch.kernels.aebs.ops import CLUSTER_ITEMS, aebs_schedule, cluster_blocks
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
    from repro_torch.core.aebs import aebs_assign
    from repro_torch.core.amax import MonteCarloAmax
    from repro_torch.core.comm import H100
    from repro_torch.core.scaling import PerfModel
    from repro_torch.serving.controller import AutoScaler
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.attention import quantize_kv
    from repro_torch.serving.disagg import DisaggExecutor
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import DEVICE_LOSS, EXCHANGE_TIMEOUT, FaultPlan, FaultSpec, RetryPolicy
    from repro_torch.serving.kv_cache import PagedKVCache
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

    def check(kernel, shape, err, tol, excess=None, **detail):
        """Log one kernel-vs-plain check that is not timed, and raise if the
        kernel disagrees with its plain version (or, where ``excess`` is
        given, passes one bf16 rounding of its f32 oracle)."""
        ok = err <= tol and (excess is None or excess <= 1.0)
        log({"phase": "kernel_check", "kernel": kernel, "shape": shape, "max_abs_err": err,
             "tolerance": tol, "rounding_excess": excess, "ok": ok, "card": card, **detail})
        if not ok:
            raise AssertionError(f"{kernel} at {shape}: kernel disagrees with its plain version "
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

    # the disaggregated executor's attention shards (phase 5: 8 rows over 2
    # attention devices, cache_len 512): K4 and K5 over a 4-row shard's own
    # cache, K1 over a 2-row ping-pong shard's own pools through the
    # shard-local block table its PagedKVCache builds, each with the split
    # plan its wrapper chose at that batch
    S_serve = nblk * ps
    q_sh, lens_sh = q_all[:4], torch.from_numpy(lens_np[:4]).to(dev)
    kc = torch.randn((4, S_serve, nkv, hd), generator=gen, device=dev).to(bf)
    vc = torch.randn((4, S_serve, nkv, hd), generator=gen, device=dev).to(bf)
    n_split, split_rows = split_plan(4, nkv, S_serve, n_sms)
    got, want = decode_attention(q_sh, kc, vc, lens_sh), decode_attention_ref(q_sh, kc, vc, lens_sh)
    check("decode_attention", f"disagg shard: 4 rows, S {S_serve}", float((got.float() - want.float()).abs().max()),
          TOL["bf16"], rounding_excess(got, want), n_split=n_split, rows_per_split=split_rows)
    n_split2, split_rows2 = split_plan(2, nkv, S_serve, n_sms)
    got, want = (decode_attention(q_sh[:2], kc[:2], vc[:2], lens_sh[:2]),
                 decode_attention_ref(q_sh[:2], kc[:2], vc[:2], lens_sh[:2]))
    check("decode_attention", f"disagg shard after the resize to 4 shards: 2 rows, S {S_serve}",
          float((got.float() - want.float()).abs().max()), TOL["bf16"], rounding_excess(got, want),
          n_split=n_split2, rows_per_split=split_rows2)
    (k8, ks), (v8, vs) = quantize_kv(kc), quantize_kv(vc)
    got = decode_attention_int8(q_sh, k8, v8, ks, vs, lens_sh)
    err = float((got.float() - decode_attention_int8_ref(q_sh, k8, v8, ks, vs, lens_sh).float()).abs().max())
    want = decode_attention_ref(q_sh, k8.float() * ks[..., None], v8.float() * vs[..., None], lens_sh)
    check("decode_attention_int8", f"disagg shard: 4 rows, S {S_serve}", err, TOL["bf16"],
          rounding_excess(got, want), n_split=n_split, rows_per_split=split_rows)
    pager = PagedKVCache(2, S_serve, ps)
    for r in range(2):
        pager.ensure(r, int(lens_np[r]) - 1)
    bt, lens_sh = pager.table_device(dev), lens_sh[:2]
    kp = torch.randn((pager.num_pages, ps, nkv, hd), generator=gen, device=dev).to(bf)
    vp = torch.randn((pager.num_pages, ps, nkv, hd), generator=gen, device=dev).to(bf)
    n_split, split_rows = split_plan(2, nkv, S_serve, n_sms, ps)
    got = paged_decode_attention(q_all[:2], kp, vp, bt, lens_sh)
    want = paged_decode_attention_ref(q_all[:2], kp, vp, bt, lens_sh)
    check("paged_decode_attention", f"disagg ping-pong shard: 2 rows, S {S_serve}, its own pages",
          float((got.float() - want.float()).abs().max()), TOL["bf16"], rounding_excess(got, want),
          n_split=n_split, pages_per_split=split_rows // ps)
    del kc, vc, k8, ks, v8, vs, kp, vp, got, want
    torch.cuda.empty_cache()

    # ---- 3c. K2 AEBS: bitmap, both greedy passes and the rewrite in one
    # launch; the serving shape (8 tokens' top-6 over 4 x 17 slots), then the
    # paper's Fig. 15 grid (benchmarks/fig15_overhead.py:20-36: 64 experts,
    # top-6, 12 slots an instance, n_e 8 and 16, B 64 to 4096) and n_e 16
    # at B 2048, 2049 and 3072, around the cluster threshold (one block up to
    # CLUSTER_ITEMS = 12288 ids), each held exactly against aebs_assign and
    # timed host-inclusive and, from a CUDA graph, on the device alone
    def graph_ms(fn, reps=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / (5 * reps)

    def aebs_case(eids, lay, iters, plain_iters, shape):
        tables, n_e = lay.device_tables(dev), lay.num_instances
        R = lay.expert_hosts.shape[1]
        got, want = aebs_schedule(eids, tables, n_e), aebs_assign(eids, tables, n_e)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        nit = eids.numel()
        call = lambda: aebs_schedule(eids, tables, n_e)  # noqa: E731
        record("aebs_schedule", "src/repro_torch/csrc/aebs.cu",
               "src/repro/kernels/aebs/kernel.py:30, src/repro/kernels/aebs/kernel.py:87", err, 0.0,
               time_ms(call, iters), time_ms(lambda: aebs_assign(eids, tables, n_e), plain_iters),
               bound(4 * (2 * nit + E * R + E + E * n_e + E + n_e), 2 * nit + 2 * E * R, SCALAR_OPS),
               None, shape, device_ms=graph_ms(call), blocks=cluster_blocks(nit),
               replicated_experts=int((lay.replica_counts > 1).sum()), max_replicas=R)

    cfg = get_config("dsv2-lite")
    E, K = cfg.num_experts, cfg.top_k
    layout = build_layout(make_routing_trace(2048, E, K, skew=0.8, seed=0), E, 4, 17)
    eids = torch.from_numpy(make_routing_trace(8, E, K, skew=0.8, seed=1)).to(dev)
    aebs_case(eids, layout, 500, 20, None)
    trace15 = make_routing_trace(8192, E, K, skew=1.0, seed=0)
    for n15 in (8, 16):
        lay15 = build_layout(trace15, E, n15, 12)
        for b15 in (64, 256, 1024, 4096):
            aebs_case(torch.from_numpy(trace15[:b15]).to(dev), lay15, 200, 5,
                      f"fig15: n_e {n15}, B {b15} (paper: < 90 us at B 4096)")
    for b15 in (2048, 2049, 3072):
        aebs_case(torch.from_numpy(trace15[:b15]).to(dev), lay15, 200, 5,
                  f"n_e 16, B {b15}: {6 * b15} ids, by the cluster threshold ({CLUSTER_ITEMS})")

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
    # the disaggregated executor's MoE instances (phase 5: the layout's 4 x
    # 17 slots): each runs K3 over its own slots at CAP 4 on the tokens AEBS
    # sends it, reading the logical weights through its row of slot_to_expert
    slot_ids = aebs_schedule(eids, layout.device_tables(dev), layout.num_instances)[0].reshape(-1).long()
    C = layout.capacity
    for g in range(layout.num_instances):
        s2e_g = torch.as_tensor(layout.slot_to_expert[g], dtype=torch.int32, device=dev)
        local = slot_ids[(slot_ids >= g * C) & (slot_ids < (g + 1) * C)] - g * C
        counts_g = torch.bincount(local, minlength=C)
        xg = torch.randn((C, CAP, d), generator=gen, device=dev).to(bf)
        xg = torch.where(torch.arange(CAP, device=dev)[None, :, None] < counts_g[:, None, None], xg, 0)
        act_g = (counts_g > 0) & (s2e_g >= 0)
        err = float((expert_ffn_grouped(xg, wg, wu, wd, s2e_g, act_g).float()
                     - expert_ffn_grouped_ref(xg, wg, wu, wd, s2e_g, act_g).float()).abs().max())
        check("expert_ffn", f"disagg instance {g}: {C} slots, CAP {CAP}, slot_to_expert row {g}", err,
              TOL["bf16"], active_slots=int(act_g.sum()), slot_to_expert=layout.slot_to_expert[g].tolist())
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
    # batched prefill (phase 5c): two prompts' 64-token chunks in one call,
    # drop-free capacity 2 x 64 = 128 over all experts; timed, as the 64-token
    # chunk is.  Then a whole-prompt call's shape: one 48-token prompt, CAP 48
    CAPB = 128
    xb = torch.randn((E, CAPB, d), generator=gen, device=dev).to(bf)
    err = float((expert_ffn_grouped(xb, wg, wu, wd, s2e, allp).float()
                 - expert_ffn_grouped_ref(xb, wg, wu, wd, s2e, allp).float()).abs().max())

    def k3_library_batched():
        h = F.silu(torch.bmm(xb, wg)) * torch.bmm(xb, wu)
        torch.bmm(h, wd)

    record("expert_ffn", "src/repro_torch/csrc/expert_ffn.cu",
           "src/repro/kernels/expert_ffn/kernel.py:40", err, TOL["bf16"],
           time_ms(lambda: expert_ffn_grouped(xb, wg, wu, wd, s2e, allp), 20),
           time_ms(lambda: expert_ffn_grouped_ref(xb, wg, wu, wd, s2e, allp), 3),
           bound(3 * E * d * f * 2 + 2 * E * CAPB * d * 2 + 2 * E * 4, E * CAPB * 6 * d * f,
                 BF16_FLOPS),
           time_ms(k3_library_batched, 20), f"batched prefill: 2 x 64 tokens, CAP {CAPB}, {E} active")
    xw = torch.randn((E, 48, d), generator=gen, device=dev).to(bf)
    err = float((expert_ffn_grouped(xw, wg, wu, wd, s2e, allp).float()
                 - expert_ffn_grouped_ref(xw, wg, wu, wd, s2e, allp).float()).abs().max())
    check("expert_ffn", f"whole-prompt prefill: 48 tokens, CAP 48, {E} active", err, TOL["bf16"])
    # every drop-free capacity a prefill call of phases 5-5d gives: a chunk
    # (or its tail) on the 16-token grid of 5d (a), whose replay's run_sync
    # keeps that grid, a prompt of up to 64 tokens in one call, and 5c's
    # batched pairs of chunks (up to 2 x 64 rows)
    err = 0.0
    for cap in range(1, 129):
        xc = torch.randn((E, cap, d), generator=gen, device=dev).to(bf)
        err = max(err, float((expert_ffn_grouped(xc, wg, wu, wd, s2e, allp).float()
                              - expert_ffn_grouped_ref(xc, wg, wu, wd, s2e, allp).float()).abs().max()))
    check("expert_ffn", f"prefill calls: CAP 1 to 128, {E} active", err, TOL["bf16"])
    # (b)'s mono decode after the degrade: 8 tokens at capacity 8 over the
    # experts AEBS's single-replica slots collapse to
    x8 = torch.randn((E, 8, d), generator=gen, device=dev).to(bf)
    x8 = torch.where(torch.arange(8, device=dev)[None, :, None] < counts[:, None, None], x8, 0)
    err = float((expert_ffn_grouped(x8, wg, wu, wd, s2e, active).float()
                 - expert_ffn_grouped_ref(x8, wg, wu, wd, s2e, active).float()).abs().max())
    check("expert_ffn", f"mono decode after a degrade: 8 tokens, CAP 8, {n_act} active", err, TOL["bf16"])
    del xb, xw, xc, x8
    # a 320-token chunk: more rows than a block holds (256), so the bf16
    # kernel runs over two blocks of rows
    CAPL, SL = 320, 8
    xl = torch.randn((SL, CAPL, d), generator=gen, device=dev).to(bf)
    s2el = torch.arange(0, 2 * SL, 2, dtype=torch.int32, device=dev)
    s2el[1] = s2el[0]  # two slots share one expert
    actl = torch.ones(SL, dtype=torch.bool, device=dev)
    err = float((expert_ffn_grouped(xl, wg, wu, wd, s2el, actl).float()
                 - expert_ffn_grouped_ref(xl, wg, wu, wd, s2el, actl).float()).abs().max())
    check("expert_ffn", f"CAP {CAPL}, {SL} slots", err, TOL["bf16"])
    del wg, wu, wd, wg_a, wu_a, wd_a, x, xp, xl, xg, got, want
    torch.cuda.empty_cache()

    # ---- 4. reduced parity: plain versions on the CPU vs kernels on the card
    attn_kernels = ("paged_decode_attention", "decode_attention", "decode_attention_int8")
    moe_kernels = ("aebs_schedule", "expert_ffn")
    # (KV layout, kv_quant, kv_page_size, the attention kernel it runs on the card)
    layouts = (("paged", False, 16, "paged_decode_attention"),
               ("contiguous", False, None, "decode_attention"),
               ("int8_contiguous", True, None, "decode_attention_int8"),
               ("int8_paged", True, 16, None))  # gather + dequantise, as the reference

    scheduled = {"calls": 0}  # MoE layer calls that schedule with AEBS
    moe_layer = moe_mod.moe_layer

    def counted_moe_layer(*args, **kwargs):
        if kwargs.get("scheduler") is not None and kwargs.get("layout_tables") is not None:
            scheduled["calls"] += 1
        return moe_layer(*args, **kwargs)

    moe_mod.moe_layer = counted_moe_layer

    def check_launches(what, launches, attn_kernel, at_least):
        """The run launched each kernel of its path at least ``at_least``
        times, K2 exactly once per scheduled MoE layer call, and no other
        attention kernel."""
        path = moe_kernels + ((attn_kernel,) if attn_kernel else ())
        short = {n: launches[n] for n in path if launches[n] < at_least}
        stray = {n: launches[n] for n in attn_kernels if n not in path and launches[n]}
        if short or stray or launches["aebs_schedule"] != scheduled["calls"]:
            raise AssertionError(f"{what}: kernels launched below {at_least} times {short}, "
                                 f"off the path {stray}, or K2 {launches['aebs_schedule']} times "
                                 f"in {scheduled['calls']} scheduled MoE layer calls")

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
    mono_streams = {}  # the card's mono streams per KV layout
    for name, kv_quant, page, attn_kernel in layouts:
        lcfg = dataclasses.replace(rcfg, kv_quant=kv_quant)
        streams = {}
        for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            eng = ServingEngine(lcfg, params, max_batch=4, cache_len=64, kv_page_size=page,
                                prefill_chunk=16, layout=rlayout, scheduler="aebs", device=where)
            cuda.reset_launch_counts()
            scheduled["calls"] = 0
            eng.run(sample_requests(spec, np.zeros(6), with_prompts=True), max_steps=500)
            launches = dict(cuda.LAUNCHES)
            streams[where] = {r.rid: r.tokens_out for r in eng.completed}
        check_launches(f"reduced {name} run on the card", launches, attn_kernel, 1)
        mono_streams[name] = streams["cuda"]
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

    # the disaggregated executor: 2 attention shards, rlayout's 2 instances,
    # capacity 64.  Every instance schedules each MoE layer call of a
    # micro-batch once, through the executor's scheduler, which is wrapped so
    # that K2's launches are counted against its calls exactly
    def counted_scheduler(fn):
        def call(*args):
            scheduled["calls"] += 1
            return fn(*args)
        return call

    def check_disagg_launches(what, launches, attn_kernel, ex, steps, prefill_calls):
        """Exactly: K2 once per instance, micro-batch, MoE layer and decode
        step (and once per call of the executor's scheduler), K3 as often
        plus once per MoE layer of each prefill call (a chunk, or a batched
        call of several prompts' chunks; prefill runs the mono model, experts
        as buckets, unscheduled), the attention kernel once per shard, layer
        and step (prefill attends densely); no other attention kernel."""
        kinds = ex.cfg.layer_kinds()
        n_moe_layers = sum(k == "moe" for k in kinds)
        per_decode = ex.n_moe * ex.n_micro * n_moe_layers * steps
        exact = {"aebs_schedule": per_decode,
                 "expert_ffn": per_decode + prefill_calls * n_moe_layers,
                 attn_kernel: len(ex.shards) * len(kinds) * steps}
        wrong = {n: launches[n] for n, want in exact.items() if launches[n] != want}
        stray = {n: launches[n] for n in attn_kernels if n != attn_kernel and launches[n]}
        if wrong or stray or scheduled["calls"] != exact["aebs_schedule"]:
            raise AssertionError(f"{what}: launches {wrong} not the exact {exact}, off the path "
                                 f"{stray}, or {scheduled['calls']} scheduler calls")
        return {"launches_exact": exact, "prefill_calls": prefill_calls}

    # (KV layout, kv_quant, kv_page_size, attention kernel, ping_pong)
    disagg_layouts = (("contiguous", False, None, "decode_attention", False),
                      ("paged", False, 16, "paged_decode_attention", True),
                      ("int8_contiguous", True, None, "decode_attention_int8", False))
    for name, kv_quant, page, attn_kernel, pp in disagg_layouts:
        lcfg = dataclasses.replace(rcfg, kv_quant=kv_quant)
        streams, amax = {}, {}
        for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            eng = ServingEngine(lcfg, params, max_batch=4, cache_len=64, kv_page_size=page,
                                prefill_chunk=16, layout=rlayout, scheduler="aebs", capacity_tokens=64,
                                executor="disagg", n_attn=2, ping_pong=pp, device=where)
            eng.disagg.scheduler = counted_scheduler(eng.disagg.scheduler)
            cuda.reset_launch_counts()
            scheduled["calls"] = 0
            eng.run(sample_requests(spec, np.zeros(6), with_prompts=True), max_steps=500)
            launches = dict(cuda.LAUNCHES)
            streams[where] = {r.rid: r.tokens_out for r in eng.completed}
            amax[where] = eng.amax_log
        checked = check_disagg_launches(f"reduced disagg {name} run on the card", launches,
                                        attn_kernel, eng.disagg, eng.steps_done,
                                        eng.prefill_worker.chunks_done)
        same = streams["cpu"] == streams["cuda"] and len(streams["cpu"]) == 6
        like_mono = streams["cuda"] == mono_streams[name]
        log({"phase": "reduced_parity_disagg", "layout": name, "ping_pong": pp, "dtype": "float32",
             "kv_dtype": "int8" if kv_quant else "float32", "n_attn": 2, "n_moe": rlayout.num_instances,
             "streams_equal": same, "streams_equal_mono": like_mono,
             "amax_log_equal": amax["cpu"] == amax["cuda"], "amax_log": amax["cuda"],
             "decode_steps": eng.steps_done, "launches": launches, **checked, "card": card})
        if not (same and like_mono and amax["cpu"] == amax["cuda"]):
            raise AssertionError(f"reduced disagg parity ({name}): streams CPU = card = mono "
                                 f"{same, like_mono}, amax_log CPU = card {amax['cpu'] == amax['cuda']}")

    def serve_counted(eng, reqs, what, attn_kernel, **run_kw):
        """Serve ``reqs`` with the launch counts zeroed just before and read
        just after, the prefill calls counted and timed; on the card, hold
        the launches exactly to the executor's pools as they stand."""
        steps0, chunks0 = eng.steps_done, eng.prefill_worker.chunks_done
        calls = {"n": 0, "s": 0.0}
        originals = model_mod.prefill_chunk, model_mod.prefill_chunk_batched

        def counted(fn):
            def call(*args, **kwargs):
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                if out[0].is_cuda:
                    torch.cuda.synchronize()
                calls["n"] += 1
                calls["s"] += time.perf_counter() - t
                return out
            return call

        model_mod.prefill_chunk, model_mod.prefill_chunk_batched = (counted(f) for f in originals)
        cuda.reset_launch_counts()
        scheduled["calls"] = 0
        t0 = time.perf_counter()
        try:
            m = eng.run(reqs, **run_kw)
        finally:
            model_mod.prefill_chunk, model_mod.prefill_chunk_batched = originals
        wall = time.perf_counter() - t0
        launches = dict(cuda.LAUNCHES)
        info = {"decode_steps": eng.steps_done - steps0, "prefill_calls": calls["n"],
                "prefill_s": calls["s"], "prefill_chunks": eng.prefill_worker.chunks_done - chunks0,
                "wall_s": wall, "launches": launches}
        if eng.device.type == "cuda":
            info.update(check_disagg_launches(what, launches, attn_kernel, eng.disagg,
                                              info["decode_steps"], calls["n"]))
        return m, info

    def pools_of(eng):
        ex = eng.disagg
        return {"n_p": len(ex.pools.prefill_devices), "n_a": len(ex.pools.attn_devices), "n_e": ex.n_moe}

    # pipelined admission through a prefill pool with 2-prompt batched
    # prefill, and one actuate of the AutoScaler between two halves of the
    # workload (contiguous KV).  Modeled clocks make the schedule, and so
    # amax_log, the same on both sides.  The decision is the scaler's at a
    # decode demand of 1e5 tokens/s (the window that gives it) and a 1 ms
    # SLO on the H100 spec: 1 attention device, 2 MoE instances, and a second
    # prefill device, as the prompt demand is 1e5 x prompt/output tokens
    # against 1000 prompt tokens/s a device (the modeled prefill rate)
    step_time = lambda b: 0.01 + 0.002 * b  # noqa: E731
    prefill_time = lambda n: 0.001 * n  # noqa: E731
    rtrace = make_routing_trace(512, rcfg.num_experts, rcfg.top_k, 0.8, 1)
    streams, amax, decisions = {}, {}, {}
    for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = ServingEngine(rcfg, params, max_batch=4, cache_len=64, prefill_chunk=16, layout=rlayout,
                            scheduler="aebs", capacity_tokens=64, executor="disagg", n_attn=2,
                            n_prefill=1, prefill_batch=2, step_time_fn=step_time,
                            prefill_time_fn=prefill_time, device=where)
        eng.disagg.scheduler = counted_scheduler(eng.disagg.scheduler)
        reqs = sample_requests(spec, np.zeros(6), with_prompts=True)
        _, half1 = serve_counted(eng, reqs[:3], "reduced pipelined disagg, first half", "decode_attention",
                                 max_steps=500)
        window = sum(r.generated for r in reqs[:3]) / 1e5
        ctrl = AutoScaler(PerfModel(rcfg, hw=H100, slots_per_instance=3, s_ctx=64), slo=1e-3, n_max=4,
                          window=window, prefill_tok_rate=1000.0, n_prefill_max=2)
        for r in reqs[:3]:
            ctrl.observe(r.arrival, r.generated, input_tokens=r.input_len)
        before = pools_of(eng)
        ctrl.actuate(eng, now=window, trace=rtrace)
        decisions[where] = (before, pools_of(eng), eng.disagg.relower_log[-1])
        m, half2 = serve_counted(eng, reqs[3:], "reduced pipelined disagg, after the actuate",
                                 "decode_attention", max_steps=500)
        streams[where] = {r.rid: r.tokens_out for r in eng.completed}
        amax[where] = eng.amax_log
    before, after, relower = decisions["cuda"]
    same = streams["cpu"] == streams["cuda"] and len(streams["cpu"]) == 6
    like_mono = streams["cuda"] == mono_streams["contiguous"]
    log({"phase": "reduced_parity_pipelined", "layout": "contiguous", "dtype": "float32",
         "admission": eng.admission, "prefill_batch": 2, "pools_before": before, "pools_after": after,
         "relower": relower, "decision_cpu_equal": decisions["cpu"] == decisions["cuda"],
         "streams_equal": same, "streams_equal_mono": like_mono,
         "amax_log_equal": amax["cpu"] == amax["cuda"], "amax_log": amax["cuda"],
         "decode_stall_time": m["decode_stall_time"],
         "first_half": {k: v for k, v in half1.items() if k != "launches"},
         "second_half": {k: v for k, v in half2.items() if k != "launches"}, "card": card})
    if not (same and like_mono and amax["cpu"] == amax["cuda"] and decisions["cpu"] == decisions["cuda"]):
        raise AssertionError(f"reduced pipelined disagg parity: streams CPU = card = mono {same, like_mono}, "
                             f"amax_log CPU = card {amax['cpu'] == amax['cuda']}, decisions {decisions}")
    if after["n_p"] == before["n_p"] or (after["n_a"], after["n_e"]) == (before["n_a"], before["n_e"]):
        raise AssertionError(f"reduced actuate: {before} -> {after} moves the prefill pool and no decode "
                             "pool, or not the prefill pool")
    if m["decode_stall_time"] != 0.0:
        raise AssertionError("reduced pipelined admission charged the decode clock")

    # fault recovery in tests/test_faults.py's deployment: 4 slots, cache 64,
    # 2 attention shards, 2 x 3 round-robin MoE slots, 1 prefill device,
    # 4-token chunks, a modeled 2 ms step, 10 ms charged a recovery.  One plan
    # loses a device of every pool and times an exchange out twice (requeue,
    # retry, replay, re-plan); then the one attention device of an n_attn=1
    # deployment is lost under paged KV, which degrades to mono and replays
    # every slot through K1.  Each run's streams equal its fault-free run's;
    # streams, stats (without their wall-clock latencies) and amax_log are
    # equal on the CPU and the card; launches exact on the card
    flayout = ReplicaLayout.round_robin(rcfg.num_experts, 2, 3)
    fspec = WorkloadSpec(mean_input=6, mean_output=24, vocab_size=rcfg.vocab_size, max_input=16,
                         max_output=32, seed=3)
    fault_plans = {
        "all_pools": FaultPlan([FaultSpec(DEVICE_LOSS, pool="prefill", index=0, at_step=2),
                                FaultSpec(EXCHANGE_TIMEOUT, at_step=4, transient=True, fail_count=2),
                                FaultSpec(DEVICE_LOSS, pool="attn", index=1, at_step=6),
                                FaultSpec(DEVICE_LOSS, pool="moe", index=0, at_step=9)]),
        "degrade_paged": FaultPlan([FaultSpec(DEVICE_LOSS, pool="attn", index=0, at_step=5)]),
    }
    # (run, its plan or None, n_attn, kv_page_size, attention kernel, the fault-free run it is held to)
    fault_runs = (("fault_free", None, 2, None, "decode_attention", None),
                  ("all_pools", fault_plans["all_pools"], 2, None, "decode_attention", "fault_free"),
                  ("fault_free_1a_paged", None, 1, 16, "paged_decode_attention", "fault_free"),
                  ("degrade_paged", fault_plans["degrade_paged"], 1, 16, "paged_decode_attention",
                   "fault_free_1a_paged"))
    fault_streams = {}
    for name, plan, n_attn, page, attn_kernel, held_to in fault_runs:
        out = {}
        for where, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            eng = ServingEngine(rcfg, params, max_batch=4, cache_len=64, layout=flayout, scheduler="aebs",
                                capacity_tokens=64, executor="disagg", n_attn=n_attn, n_prefill=1,
                                prefill_chunk=4, kv_page_size=page, step_time_fn=lambda n: 2e-3,
                                fault_plan=plan, retry_policy=RetryPolicy(recovery_charge_s=0.01), device=where)
            eng.disagg.scheduler = counted_scheduler(eng.disagg.scheduler)
            tally = StepTally(eng, model_mod)
            cuda.reset_launch_counts()
            scheduled["calls"] = 0
            try:
                m = eng.run(sample_requests(fspec, np.linspace(0, 0.005, 5), with_prompts=True), max_steps=2000)
            finally:
                tally.close()
            launches = dict(cuda.LAUNCHES)
            stats = {k: v for k, v in m.get("faults", {}).items() if not k.startswith("recovery_latency")}
            out[where] = ({r.rid: r.tokens_out for r in eng.completed}, stats, eng.amax_log, eng.executor_name)
        want = tally.expected(rcfg.layer_kinds(), attn_kernel)
        wrong = {n: launches[n] for n in want if launches[n] != want[n]}
        stray = {n: launches[n] for n in attn_kernels if n != attn_kernel and launches[n]}
        fault_streams[name] = out["cuda"][0]
        same = out["cpu"] == out["cuda"] and len(out["cpu"][0]) == 5
        held = held_to is None or out["cuda"][0] == fault_streams[held_to]
        log({"phase": "reduced_parity_faults", "run": name, "dtype": "float32", "n_attn": n_attn,
             "kv_page_size": page, "plan": None if plan is None else json.loads(plan.to_json()),
             "cpu_equal_card": same, "streams_equal_fault_free": held, "held_to": held_to,
             "faults": out["cuda"][1], "executor_at_end": out["cuda"][3], "amax_log": out["cuda"][2],
             "steps": tally.counts(), "launches": launches, "launches_exact": want, "card": card})
        if not (same and held) or wrong or stray or scheduled["calls"] != want["aebs_schedule"]:
            raise AssertionError(f"reduced faults ({name}): streams, stats, amax_log CPU = card {same}, "
                                 f"= fault-free {held}; launches {wrong} not {want}, off the path {stray}, "
                                 f"or {scheduled['calls']} scheduler calls")
        f = out["cuda"][1]
        if name == "all_pools" and ((f["injected"], f["recoveries"], f["retries"], f["degraded"]) != (4, 3, 2, 0)
                                    or not f["requeued"] or not f["replayed_slots"]):
            raise AssertionError(f"reduced faults ({name}): stats {f} are not the plan's")
        if name == "degrade_paged" and (f["degraded"] != 1 or not f["replayed_slots"] or out["cuda"][3] != "mono"):
            raise AssertionError(f"reduced faults ({name}): did not degrade to mono and replay: {f}")
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
    prefill_chunk_batched = model_mod.prefill_chunk_batched
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
        scheduled["calls"] = 0
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
             "kv_pages": m.get("kv_pages"), "launches": launches,
             "scheduled_moe_calls": scheduled["calls"]})
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
        served[name] = {"step_ms": float(np.mean(step_ms)), "ttft_ms": m["ttft_mean"] * 1e3,
                        "streams": {r.rid: r.tokens_out for r in engine.completed}}
        del engine
        torch.cuda.empty_cache()

    # the same requests through the disaggregated executor: 2 attention
    # shards, the layout's 4 instances (every pool on this card), served
    # with contiguous KV (K4) and with paged KV and ping-pong (K1)
    disagg_step = DisaggExecutor.decode_step
    # (run, kv_page_size, attention kernel, ping_pong, the mono run it is compared with)
    disagg_runs = (("disagg_contiguous", None, "decode_attention", False, "contiguous"),
                   ("disagg_paged_pingpong", 16, "paged_decode_attention", True, "paged"))
    for name, page, attn_kernel, pp, mono_name in disagg_runs:
        reqs = make_requests(2, 12, 16, 48, 16, 32)
        step_ms = []
        nonfinite = torch.zeros((), dtype=torch.int64, device=dev)

        def checked_disagg_step(*args, **kwargs):
            t = time.perf_counter()
            logits, tel = disagg_step(*args, **kwargs)
            nonfinite.add_((~torch.isfinite(logits)).sum())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return logits, tel

        engine = ServingEngine(cfg, params, kv_page_size=page, executor="disagg", n_attn=2,
                               ping_pong=pp, **kw)
        engine.disagg.scheduler = counted_scheduler(engine.disagg.scheduler)
        DisaggExecutor.decode_step = checked_disagg_step
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        scheduled["calls"] = 0
        t0 = time.perf_counter()
        m = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda.LAUNCHES)
        DisaggExecutor.decode_step = disagg_step
        steps = engine.steps_done
        streams = {r.rid: r.tokens_out for r in engine.completed}
        log({"phase": "serve", "layout": name, "executor": "disagg", "card": card, "model": cfg.name,
             "n_attn": len(engine.disagg.pools.attn_devices), "n_moe": engine.disagg.n_moe,
             "ping_pong": pp, "kv_dtype": str(engine.disagg._kv[0][0]["k"].dtype),
             "requests": len(reqs), "completed": m["completed"], "tokens": m["tokens"],
             "decode_steps": steps, "wall_s": wall, "tokens_per_s": m["throughput_tok_s"],
             "decode_step_ms_mean": float(np.mean(step_ms)),
             "decode_step_ms_p50": float(np.median(step_ms)),
             "tpot_ms_mean": m["tpot_mean"] * 1e3, "tpot_ms_p99": m["tpot_p99"] * 1e3,
             "ttft_ms_mean": m["ttft_mean"] * 1e3, "ttft_ms_p99": m["ttft_p99"] * 1e3,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "kv_pages": m.get("kv_pages"), "regime_counts": m["regime_counts"],
             "transfer_bytes_per_step": m["transfer_bytes_per_step"],
             "amax_mean": m["amax_mean"], "amax_max": m["amax_max"], "launches": launches,
             "scheduler_calls": scheduled["calls"],
             "streams_equal_mono": streams == served[mono_name]["streams"],
             "tokens_equal_mono": sum(a == b for rid, s in streams.items()
                                      for a, b in zip(s, served[mono_name]["streams"][rid]))})
        if m["completed"] != len(reqs) or m["truncated"]:
            raise AssertionError(f"serving ({name}): {m['completed']} of {len(reqs)} requests completed")
        if any(r.generated != r.output_len for r in engine.completed):
            raise AssertionError(f"serving ({name}): a request stopped short of its output length")
        if int(nonfinite) != 0:
            raise AssertionError(f"serving ({name}): {int(nonfinite)} non-finite logits")
        check_disagg_launches(f"serving ({name}): {steps} decode steps", launches, attn_kernel,
                              engine.disagg, steps, m["prefill_chunks"])
        served[name] = {"step_ms": float(np.mean(step_ms)), "ttft_ms": m["ttft_mean"] * 1e3}
        del engine
        torch.cuda.empty_cache()

    # ---- 5c. the prefill pool and the AutoScaler at full width -----------
    # phase 5's disagg deployment (2 attention shards, the layout's 4 MoE
    # instances of 17 slots) with a prefill pool of one device (every pool on
    # this card), pipelined admission and 2-prompt batched prefill, serving
    # the 12 requests in two halves of 6.  Between them an AutoScaler over
    # the H100 performance model observes the first half (arrivals on the
    # run's clock) and actuates: the window is chosen for a decode demand of
    # 30,000 tokens/s, where a 6 ms TPOT SLO needs 4 attention devices and 5
    # MoE instances (a layout replanned from the routing trace), and the
    # prompt demand exceeds one prefill device's measured rate (a second
    # device).  Decode capacity 8 (the batch) drops nothing, so each stream
    # is the request's own; they are held to an undisturbed run (blocking
    # admission, no prefill pool, no resize, the same halves), a flip only on
    # a bf16 near-tie (top-2 logit margin <= 2 TOL["bf16"] in either run).

    D_TARGET, SLO, NEAR_TIE = 30000.0, 0.006, 2 * TOL["bf16"]
    serve_trace = make_routing_trace(2048, E, K, skew=0.8, seed=0)  # `layout` was planned from it
    as_kw = dict(kw, capacity_tokens=8, executor="disagg", n_attn=2)

    def halves():
        reqs = make_requests(2, 12, 16, 48, 16, 32)
        return reqs[:6], reqs[6:]

    def check_instances(lay, label):
        """K2 on the layout's tables and K3 on each instance's slots at CAP 8
        (the phase's decode capacity), against their plain versions."""
        tables, n_e, C = lay.device_tables(dev), lay.num_instances, lay.capacity
        got, want = aebs_schedule(eids, tables, n_e), aebs_assign(eids, tables, n_e)
        check("aebs_schedule", f"{label}: {n_e} x {C} slots", max(float((g - w).abs().max())
                                                                 for g, w in zip(got, want)), 0.0)
        slots = got[0].reshape(-1).long()
        for g in range(n_e):
            s2e_g = torch.as_tensor(lay.slot_to_expert[g], dtype=torch.int32, device=dev)
            counts_g = torch.bincount(slots[(slots >= g * C) & (slots < (g + 1) * C)] - g * C, minlength=C)
            xg = torch.randn((C, 8, d), generator=gen, device=dev).to(bf)
            xg = torch.where(torch.arange(8, device=dev)[None, :, None] < counts_g[:, None, None], xg, 0)
            act_g = (counts_g > 0) & (s2e_g >= 0)
            mp = params["layers"][0]["moe"]
            err = float((expert_ffn_grouped(xg, mp["w_gate"], mp["w_up"], mp["w_down"], s2e_g, act_g).float()
                         - expert_ffn_grouped_ref(xg, mp["w_gate"], mp["w_up"], mp["w_down"], s2e_g,
                                                  act_g).float()).abs().max())
            check("expert_ffn", f"{label}: instance {g}, {C} slots, CAP 8", err, TOL["bf16"],
                  active_slots=int(act_g.sum()))

    greedy = model_mod.greedy_token
    last_logits = {}

    def stash_greedy(logits):
        last_logits["t"] = logits
        return greedy(logits)

    def top2(row):
        v = row.float().topk(2).values
        return float(v[0] - v[1])

    def record_margins(engine):
        """Top-2 logit margin of every token ``engine`` emits, by (rid, index):
        index 0 from its prefill call's logits, then one per decode step."""
        margins = {}
        worker = engine.prefill_worker
        adv, adv_b, dec = worker._advance, worker._advance_batched, engine._decode_iteration

        def advance(entry, sink):
            ev = adv(entry, sink)
            if ev is not None:
                margins[(ev.req.rid, 0)] = top2(last_logits["t"][0])
            return ev

        def advance_batched(di, sink):
            rids = [e.req.rid for e in worker._current[di]]
            evs = adv_b(di, sink)
            for ev in evs:
                margins[(ev.req.rid, 0)] = top2(last_logits["t"][rids.index(ev.req.rid)])
            return evs

        def decode_iteration():
            at = {s: (engine.slots.slot_req[s].rid, len(engine.slots.slot_req[s].tokens_out))
                  for s in engine.slots.active_slots}
            dec()
            for s, key in at.items():
                margins[key] = top2(last_logits["t"][s])

        worker._advance, worker._advance_batched = advance, advance_batched
        engine._decode_iteration = decode_iteration
        return margins

    def sample_steps(engine):
        """Check every decode step's logits and time it on the host (its
        device time comes from phase 5b's profiled runs of both pool sizes)."""
        fn = engine.disagg.decode_step
        st = {"wall_ms": [], "nonfinite": 0}

        def call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            st["wall_ms"].append((time.perf_counter() - t) * 1e3)
            st["nonfinite"] += int((~torch.isfinite(out[0])).sum())
            return out

        engine.disagg.decode_step = call
        return st

    def half_metrics(reqs):
        """TTFT, TPOT and tokens/s of one half's requests, from their own
        arrivals (the second half arrives when the first has drained)."""
        ttft = [r.prefill_done - r.arrival for r in reqs]
        gaps = np.concatenate([r.decode_gaps() for r in reqs])
        span = max(r.finished for r in reqs) - min(r.arrival for r in reqs)
        return {"ttft_ms_mean": float(np.mean(ttft)) * 1e3, "ttft_ms_max": float(np.max(ttft)) * 1e3,
                "tpot_ms_mean": float(gaps.mean()) * 1e3,
                "tokens_per_s": sum(r.generated for r in reqs) / span}

    model_mod.greedy_token = stash_greedy
    check_instances(layout, "phase 5c before the resize")
    undisturbed = ServingEngine(cfg, params, **as_kw)
    ref_margins = record_margins(undisturbed)
    blocking = {}
    for when, half in zip(("before", "after"), halves()):
        for r in half:
            r.arrival = undisturbed.clock
        undisturbed.run(half)
        blocking[when] = half_metrics(half)
    ref_streams = {r.rid: r.tokens_out for r in undisturbed.completed}
    del undisturbed
    torch.cuda.empty_cache()

    engine = ServingEngine(cfg, params, n_prefill=1, admission="pipelined", prefill_batch=2, **as_kw)
    engine.disagg.scheduler = counted_scheduler(engine.disagg.scheduler)
    margins = record_margins(engine)
    steps_st = sample_steps(engine)
    first, second = halves()
    torch.cuda.reset_peak_memory_stats()
    _, c1 = serve_counted(engine, first, "phase 5c, first half (before the resize)", "decode_attention")
    wall_ms = {"before": float(np.mean(steps_st["wall_ms"]))}
    steps_st["wall_ms"].clear()
    rate = sum(r.input_len for r in first) / c1["prefill_s"]  # prompt tokens/s of the pool's device
    window = sum(r.generated for r in first) / D_TARGET
    pm = PerfModel(cfg, hw=H100, slots_per_instance=17, s_ctx=512,
                   layout_fn=lambda n: build_layout(serve_trace, E, n, 17),
                   amax_estimator=MonteCarloAmax(serve_trace, E, trials=4))
    ctrl = AutoScaler(pm, slo=SLO, n_max=6, window=window, prefill_tok_rate=rate, n_prefill_max=2)
    for r in first:
        ctrl.observe(r.arrival, r.generated, input_tokens=r.input_len)
    before = pools_of(engine)
    t0 = time.perf_counter()
    best = ctrl.actuate(engine, now=window, trace=serve_trace)
    actuate_s = time.perf_counter() - t0
    after = pools_of(engine)
    resized_layout = engine.layout
    check_instances(resized_layout, "phase 5c after the resize")
    for r in second:
        r.arrival = engine.clock
    m2, c2 = serve_counted(engine, second, "phase 5c, second half (after the resize)", "decode_attention")
    wall_ms["after"] = float(np.mean(steps_st["wall_ms"]))
    model_mod.greedy_token = greedy
    streams = {r.rid: r.tokens_out for r in engine.completed}
    flips = first_flips(streams, ref_streams, margins, ref_margins)
    predicted = {when: pm.tpot(8.0, p["n_a"], p["n_e"]).tpot * 1e3 for when, p in (("before", before),
                                                                                     ("after", after))}
    log({"phase": "serve_autoscaled", "executor": "disagg", "card": card, "model": cfg.name,
         "admission": engine.admission, "prefill_batch": 2, "requests": len(first) + len(second),
         "completed": m2["completed"], "tokens": m2["tokens"], "truncated": m2["truncated"],
         "decision": {"n_a": best.n_a, "n_e": best.n_e, "n_p": ctrl.events[-1].n_p, "tpot_ms": best.tpot * 1e3,
                      "batch": best.batch, "a_max": best.a_max, "feasible": best.feasible,
                      "demand_tok_s": ctrl.events[-1].demand, "slo_ms": SLO * 1e3},
         "prefill_tok_rate": rate, "window_s": window, "actuate_s": actuate_s,
         "pools_before": before, "pools_after": after, "relower": engine.disagg.relower_log[-1],
         "predicted_tpot_ms_at_batch_8": predicted, "host_wall_ms_per_step": wall_ms,
         "halves": {"before": half_metrics(first), "after": half_metrics(second)},
         "halves_undisturbed_blocking": blocking, "decode_stall_time": m2["decode_stall_time"], "prefill_chunks": m2["prefill_chunks"],
         "amax_mean": m2["amax_mean"], "amax_max": m2["amax_max"],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "first_half": {k: v for k, v in c1.items() if k != "launches"},
         "second_half": {k: v for k, v in c2.items() if k != "launches"},
         "streams_equal_undisturbed": not flips, "flips": flips,
         "tokens_equal_undisturbed": sum(a == b for rid, st in streams.items()
                                         for a, b in zip(st, ref_streams[rid]))})
    if m2["completed"] != 12 or m2["truncated"] or any(r.generated != r.output_len for r in engine.completed):
        raise AssertionError(f"phase 5c: {m2['completed']} of 12 requests completed in full")
    if steps_st["nonfinite"]:
        raise AssertionError(f"phase 5c: {steps_st['nonfinite']} non-finite logits")
    if m2["decode_stall_time"] != 0.0:
        raise AssertionError("phase 5c: pipelined admission charged the decode clock")
    if after["n_p"] == before["n_p"] or (after["n_a"], after["n_e"]) == (before["n_a"], before["n_e"]):
        raise AssertionError(f"phase 5c: the decision {before} -> {after} does not move the prefill pool "
                             "and a decode pool")
    wide = wide_flips(flips, NEAR_TIE)
    if wide:
        raise AssertionError(f"phase 5c: streams part from the undisturbed run off a near-tie: {wide}")
    del engine
    torch.cuda.empty_cache()

    # ---- 5d. fault recovery at full width --------------------------------
    # (a) phase 5c's first deployment (1 prefill device, 2 attention shards,
    # 4 MoE instances of 17 slots, decode capacity 8, contiguous KV: K4) with
    # pipelined, unbatched admission in 16-token chunks (every prompt takes
    # 2-3, so one is in flight on the prefill device) on the wall clock.  The
    # plan: the prefill device is lost at decode step 3 (its prompt in flight
    # restarts on the engine's device), an exchange times out twice at step 5
    # (two retries), attention device 1 at step 14 (its shard's active slots
    # replay on the one survivor, a prefilling one restarts) and MoE instance
    # 0 at step 24 (the layout is replanned onto 3 instances).  (b) n_attn=1
    # with paged KV (K1) and blocking admission: the one attention device is
    # lost at step 8, the engine degrades to mono and replays every slot
    # through K1.  Each is held to an undisturbed run of its deployment as
    # phase 5c is (a flip only on a bf16 near-tie) and its launches to the
    # steps it ran (StepTally): served, retried and replayed
    fault_kw = {"disagg": dict(as_kw, n_prefill=1, admission="pipelined", prefill_chunk=16),
                "degrade": dict(as_kw, n_attn=1, kv_page_size=16)}
    fw_plans = {"disagg": FaultPlan([FaultSpec(DEVICE_LOSS, pool="prefill", index=0, at_step=3),
                                     FaultSpec(EXCHANGE_TIMEOUT, at_step=5, transient=True, fail_count=2),
                                     FaultSpec(DEVICE_LOSS, pool="attn", index=1, at_step=14),
                                     FaultSpec(DEVICE_LOSS, pool="moe", index=0, at_step=24)]),
                "degrade": FaultPlan([FaultSpec(DEVICE_LOSS, pool="attn", index=0, at_step=8)])}
    fw_attn = {"disagg": "decode_attention", "degrade": "paged_decode_attention"}
    nonfinite = {"n": 0}

    def checked_greedy(logits):
        nonfinite["n"] += int((~torch.isfinite(logits)).sum())
        return stash_greedy(logits)

    model_mod.greedy_token = checked_greedy
    # (a) ends on the survivors' layout: K2 and K3 there, as at 5c's layouts
    check_instances(layout_for_survivors(E, 3), "phase 5d after the MoE loss")
    fault_logs = {}
    for run, run_kw in fault_kw.items():
        seen = {}
        for plan in (None, fw_plans[run]):
            what = f"phase 5d ({run}, {'faults' if plan else 'undisturbed'})"
            gc.collect()  # earlier engines' wrappers hold them in cycles
            torch.cuda.empty_cache()
            engine = ServingEngine(cfg, params, fault_plan=plan, **run_kw)
            engine.disagg.scheduler = counted_scheduler(engine.disagg.scheduler)
            run_margins = record_margins(engine)
            recovered = []
            recover = engine._recover

            def traced_recover(fault, recover=recover, engine=engine, recovered=recovered):
                recovered.append({"pool": fault.pool, "kind": fault.kind, "at_step": engine.steps_done,
                                  "active_slots": engine.slots.num_active})
                recover(fault)

            engine._recover = traced_recover
            tally = StepTally(engine, model_mod)
            torch.cuda.reset_peak_memory_stats()
            mem_start = torch.cuda.memory_allocated() / 1e9
            cuda.reset_launch_counts()
            scheduled["calls"] = 0
            nonfinite["n"] = 0
            t0 = time.perf_counter()
            try:
                m = engine.run(make_requests(2, 12, 16, 48, 16, 32))
            finally:
                tally.close()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(cuda.LAUNCHES)
            want = tally.expected(cfg.layer_kinds(), fw_attn[run])
            wrong = {n: launches[n] for n in want if launches[n] != want[n]}
            stray = {n: launches[n] for n in attn_kernels if n != fw_attn[run] and launches[n]}
            streams = {r.rid: r.tokens_out for r in engine.completed}
            steps = tally.counts()
            info = {"phase": "serve_faults", "run": run, "plan": None if plan is None else json.loads(plan.to_json()),
                    "card": card, "model": cfg.name, "requests": 12, "completed": m["completed"],
                    "tokens": m["tokens"], "decode_steps": engine.steps_done, "steps": steps,
                    "prefill_calls": tally.prefill_calls, "wall_s": wall, "tokens_per_s": m["throughput_tok_s"],
                    "tpot_ms_mean": m["tpot_mean"] * 1e3, "ttft_ms_mean": m["ttft_mean"] * 1e3,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "mem_at_start_gb": mem_start,
                    "executor_at_end": engine.executor_name,
                    "launches": launches, "launches_exact": want, "nonfinite_logits": nonfinite["n"]}
            if engine.disagg is not None:
                pools = engine.disagg.pools
                info["pools_at_end"] = {"n_p": len(pools.prefill_devices), "n_a": len(pools.attn_devices),
                                        "n_e": engine.disagg.n_moe, "prefill_worker_devices": [
                                            str(d) for d in engine.prefill_worker.devices]}
                info["experts_seated"] = len(set(engine.layout.slot_to_expert[engine.layout.slot_to_expert >= 0]
                                                 .tolist()))
            if plan is not None:
                f = m["faults"]
                lat = engine.faults.stats.recovery_latency_s
                flips = first_flips(streams, seen["streams"], run_margins, seen["margins"])
                info.update(faults=f, degraded_reason=m.get("degraded_reason"),
                            recoveries=[dict(r, latency_ms=t * 1e3) for r, t in zip(recovered, lat)],
                            replay_decode_steps=sum(v for k, v in steps.items() if k.startswith("replay")),
                            replayed_tokens=sum(v for k, v in steps.items() if k.startswith("replay"))
                            + f["replayed_slots"], fault_stall_s=f["fault_stall_s"],
                            streams_equal_undisturbed=not flips, flips=flips,
                            tokens_equal_undisturbed=sum(a == b for rid, st in streams.items()
                                                         for a, b in zip(st, seen["streams"][rid])))
            log(info)
            if m["completed"] != 12 or m["truncated"] or any(r.generated != r.output_len for r in engine.completed):
                raise AssertionError(f"{what}: {m['completed']} of 12 requests completed in full")
            if nonfinite["n"]:
                raise AssertionError(f"{what}: {nonfinite['n']} non-finite logits")
            if wrong or stray or scheduled["calls"] != want["aebs_schedule"]:
                raise AssertionError(f"{what}: launches {wrong} not the exact {want}, off the path {stray}, "
                                     f"or {scheduled['calls']} scheduler calls")
            if plan is None:
                seen = {"streams": streams, "margins": run_margins}
            elif wide_flips(flips, NEAR_TIE):
                raise AssertionError(f"{what}: streams part from the undisturbed run off a near-tie: {flips}")
            elif run == "disagg" and ((f["injected"], f["detected"], f["recoveries"], f["retries"], f["degraded"])
                                      != (4, 5, 3, 2, 0) or not f["requeued"] or not f["replayed_slots"]
                                      or info["pools_at_end"]["n_a"] != 1 or info["pools_at_end"]["n_e"] != 3
                                      or info["pools_at_end"]["n_p"] != 0 or engine.prefill_worker.devices != [dev]
                                      or info["experts_seated"] != E):
                raise AssertionError(f"{what}: recovery is not the plan's: {f}, {info.get('pools_at_end')}")
            elif run == "degrade" and (f["degraded"] != 1 or engine.executor_name != "mono"
                                       or f["replayed_slots"] != recovered[0]["active_slots"]
                                       or set(k for k in steps if k.startswith("replay")) != {"replay_mono"}):
                raise AssertionError(f"{what}: did not degrade to mono and replay every slot there: {f}, {steps}")
            fault_logs[(run, plan is not None)] = info
            del engine, tally, recover, traced_recover
    model_mod.greedy_token = greedy

    # ---- 5b. where the time goes: device time of each decode step and
    # prefill chunk of a short run (8 requests, 16 in, 16 out) per layout,
    # profiled one call at a time with CUDA activity only (kernels, no double
    # counting)
    from torch.profiler import ProfilerActivity, profile

    # (run, its config, engine options, the mono run it is set beside)
    profile_runs = [(name, dataclasses.replace(cfg, kv_quant=kv_quant), dict(kv_page_size=page), None)
                    for name, kv_quant, page, _ in serve_layouts]
    profile_runs += [(name, cfg, dict(kv_page_size=page, executor="disagg", n_attn=2, ping_pong=pp),
                      mono_name) for name, page, _, pp, mono_name in disagg_runs]
    # phase 5c's deployment at both pool sizes (the resize's layout after it)
    profile_runs += [("autoscaled_before", cfg, dict(as_kw, n_prefill=1, prefill_batch=2), None),
                     ("autoscaled_after", cfg, dict(as_kw, n_attn=after["n_a"], n_prefill=after["n_p"],
                                                    prefill_batch=2, layout=resized_layout), None)]
    # phase 5d's pools after each recovery (the host times of those runs mix
    # pool sizes, so these have none): 1A 4E after the attention loss, 1A 3E
    # on the survivors' layout after the MoE loss, and (b)'s 1A 4E paged
    # before its degrade and mono paged after it, all at decode capacity 8
    profile_runs += [("fault_1a4e", cfg, dict(as_kw, n_attn=1), None),
                     ("fault_1a3e", cfg, dict(as_kw, n_attn=1, layout=layout_for_survivors(E, 3)), None),
                     ("fault_1a4e_paged", cfg, dict(as_kw, n_attn=1, kv_page_size=16), None),
                     ("fault_mono_paged", cfg, dict(kw, capacity_tokens=8, kv_page_size=16), None)]
    served["autoscaled_before"] = {"step_ms": wall_ms["before"], "ttft_ms": half_metrics(first)["ttft_ms_mean"]}
    served["autoscaled_after"] = {"step_ms": wall_ms["after"], "ttft_ms": half_metrics(second)["ttft_ms_mean"]}
    profiled_ms = {}
    # device ops by kind, first match wins: the port's kernels, cuBLAS,
    # sorting, copies and fills; the rest is PyTorch's elementwise ops and
    # reductions
    profile_groups = (("K3", ("expert_mma_kernel", "f32_gate_up_kernel", "f32_down_kernel")),
                      ("K2", ("aebs_schedule_kernel",)),
                      ("attention", ("decode_attention_kernel", "merge_splits_kernel")),
                      ("gemm", ("nvjet", "gemm", "gemv", "cutlass", "xmma")),
                      ("sort_topk", ("sort", "Sort", "topk", "TopK")),
                      ("copy_fill", ("copy", "Memcpy", "Memset", "fill")))
    for name, run_cfg, engine_kw, mono_name in profile_runs:
        device_ms = {"decode": [], "prefill": []}
        device_ops = {"decode": [], "prefill": []}  # kernels, copies and fills on the card
        kernel_n = {"decode": {}, "prefill": {}}
        kernel_ms = {"decode": {}, "prefill": {}}

        def profiled(fn, kind):
            def call(*args, **kwargs):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                total, ops = 0.0, 0
                for e in prof.key_averages():
                    t = e.self_device_time_total / 1e3
                    kernel_ms[kind][e.key] = kernel_ms[kind].get(e.key, 0.0) + t
                    kernel_n[kind][e.key] = kernel_n[kind].get(e.key, 0) + e.count
                    total += t
                    ops += e.count
                device_ms[kind].append(total)
                device_ops[kind].append(ops)
                return out
            return call

        engine = ServingEngine(run_cfg, params, **{**kw, **engine_kw})
        if engine.disagg is not None:
            DisaggExecutor.decode_step = profiled(disagg_step, "decode")
        else:
            model_mod.decode_step = profiled(decode_step, "decode")
        model_mod.prefill_chunk = profiled(prefill_chunk, "prefill")
        model_mod.prefill_chunk_batched = profiled(prefill_chunk_batched, "prefill")
        engine.run(make_requests(3, 8, 16, 16, 16, 16, rid0=100))
        model_mod.decode_step, model_mod.prefill_chunk = decode_step, prefill_chunk
        model_mod.prefill_chunk_batched = prefill_chunk_batched
        DisaggExecutor.decode_step = disagg_step
        del engine
        busy = float(np.mean(device_ms["decode"]))
        profiled_ms[name] = busy
        beside = {}
        if mono_name is not None:
            beside = {"mono_layout": mono_name, "mono_device_ms_per_decode_step": profiled_ms[mono_name],
                      "mono_device_idle_share_decode": 1.0 - profiled_ms[mono_name] / served[mono_name]["step_ms"]}
        log({"phase": "profile", "layout": name, "executor": engine_kw.get("executor", "mono"),
             "card": card, "decode_steps": len(device_ms["decode"]),
             "device_ms_per_decode_step": busy,
             "device_ops_per_decode_step": float(np.mean(device_ops["decode"])),
             "step_ms_unprofiled": served[name]["step_ms"] if name in served else None,
             "device_idle_share_decode": 1.0 - busy / served[name]["step_ms"] if name in served else None,
             "device_ms_per_prefill_chunk": float(np.mean(device_ms["prefill"])),
             "ttft_ms_unprofiled": served[name]["ttft_ms"] if name in served else None, **beside})
        for kind in ("decode", "prefill"):
            n = len(device_ms[kind])
            top = sorted(kernel_ms[kind].items(), key=lambda kv: -kv[1])[:10]
            groups = {}  # [ms, ops] per call, by what the device op is
            for key, ms in kernel_ms[kind].items():
                g = next((g for g, words in profile_groups if any(w in key for w in words)), "other")
                acc = groups.setdefault(g, [0.0, 0.0])
                acc[0] += ms / n
                acc[1] += kernel_n[kind][key] / n
            log({"phase": "profile_top", "layout": name, "kind": kind, "card": card,
                 "ms_per_call": [[k[:96], v / n] for k, v in top], "by_group_ms_ops": groups})

    # phase 5c's pools before and after the resize: the performance model's
    # TPOT at batch 8 (H100 spec) beside the card's device time per step
    log({"phase": "autoscaled_model_vs_card", "card": card, "pools": {"before": before, "after": after},
         "predicted_tpot_ms_at_batch_8": predicted,
         "device_ms_per_decode_step": {w: profiled_ms[f"autoscaled_{w}"] for w in ("before", "after")},
         "host_wall_ms_per_step": wall_ms})
    # phase 5d: device ms per decode step at the pools before and after each
    # recovery, beside what the recoveries took
    log({"phase": "fault_recovery_summary", "card": card,
         "device_ms_per_decode_step": {
             "disagg": {"1P2A4E (start, after the prefill loss 0P2A4E)": profiled_ms["autoscaled_before"],
                        "1A4E (after the attention loss)": profiled_ms["fault_1a4e"],
                        "1A3E (after the MoE loss)": profiled_ms["fault_1a3e"]},
             "degrade": {"1A4E paged (start)": profiled_ms["fault_1a4e_paged"],
                         "mono paged (after the degrade)": profiled_ms["fault_mono_paged"]}},
         "recoveries": {run: fault_logs[(run, True)]["recoveries"] for run in fault_kw},
         "fault_stall_s": {run: fault_logs[(run, True)]["fault_stall_s"] for run in fault_kw},
         "replayed_tokens": {run: fault_logs[(run, True)]["replayed_tokens"] for run in fault_kw},
         "replay_decode_steps": {run: fault_logs[(run, True)]["replay_decode_steps"] for run in fault_kw},
         "peak_mem_gb": {f"{run}_{'faults' if hit else 'undisturbed'}": v["peak_mem_gb"]
                         for (run, hit), v in fault_logs.items()}})

    # ---- 6. results ------------------------------------------------------
    log({"kernels": [rows[n] for n in cuda.LAUNCHES]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
