"""Multi-pod dry run (``repro.launch.dryrun``): trace every (architecture x
input shape) step on the production meshes without a card, prove its
memory fits, and derive its roofline terms.

It runs as its own process: it opens the ``fake`` process group of 256
ranks (512 with ``--multi-pod``), builds the step over a 16 x 16 (2 x 16 x
16) ``DeviceMesh`` with fake tensors (``FakeTensorMode``: shapes, dtypes and
devices, no storage, no kernel launch), and runs it once under a FLOP
counter, :class:`~repro_torch.roofline.analysis.OpRecorder` (bytes and
collectives) and ``MemTracker``, after one unrecorded run that fills
DTensor's sharding-propagation caches (propagation computes global shapes
with fake ops, which the recorders would take for a rank's work).  ``peak_memory_per_device`` is the
tracker's peak over the step on the mesh's device, the step's arguments
included and counted once (the step updates params, optimizer state and
caches in place, where the reference donates them).  Fake tensors live on
the card's device type when torch is built with CUDA; a CPU-only torch
cannot index fake ``cuda`` tensors (its C++ indexing needs the CUDA
runtime), so there they are fake ``cpu`` tensors, with the same shapes
and counts.  The serve step schedules with ``aebs_schedule`` (K2's custom
op, whose fake implementation gives shapes) on either.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-moe-a2.7b \\
        --shape decode_32k [--multi-pod] [--out results/dryrun]

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # fan out everything

``DRYRUN_KV_QUANT=1`` runs the int8-KV variant of the config (``+int8kv``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch.configs import REGISTRY, SHAPES, get_config, shape_supported
from repro_torch.kernels.aebs.ops import aebs_schedule
from repro_torch.launch.mesh import make_production_mesh, mesh_name, open_group
from repro_torch.launch.steps import BUILDERS
from repro_torch.models.common import tree_leaves
from repro_torch.roofline import analysis


def fake_device_type() -> str:
    """``cuda`` on a CUDA build of torch, else ``cpu`` (see the module's
    docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str, mesh=None) -> dict:
    """Trace one combo and write its record; ``mesh`` (over an open fake
    group) replaces the production mesh."""
    import torch.distributed as dist
    from torch.distributed._tools.mem_tracker import MemTracker

    cfg = get_config(arch)
    if os.environ.get("DRYRUN_KV_QUANT"):
        cfg = dataclasses.replace(cfg, kv_quant=True)
        arch = arch + "+int8kv"
    shape = SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    if mesh is None:
        if not dist.is_initialized():
            open_group("fake", world_size=512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=fake_device_type())
    device_type = mesh.device_type
    name = mesh_name(mesh)
    chips = mesh.size()
    t0 = time.perf_counter()
    kw = {"scheduler": aebs_schedule} if shape.kind == "decode" else {}
    step, args = BUILDERS[shape.kind](cfg, mesh, shape, **kw)
    t_build = time.perf_counter() - t0
    rec, flops, mem = analysis.OpRecorder(), analysis.LocalFlopCounter(display=False), MemTracker()
    with step.fake_mode:
        # a first run fills DTensor's sharding-propagation caches: propagation
        # computes global shapes with fake ops, which the recorders would
        # take for the rank's own work
        step(*args)
        t_warm = time.perf_counter() - t0 - t_build
        mem.track_external(*tree_leaves(args))
        with mem, flops, rec:
            step(*args)
    t_run = time.perf_counter() - t0 - t_build - t_warm
    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device(device_type)
    peak_snap = mem.get_tracker_snapshot("peak")
    peak = peak_snap.get(dev, {}).get("Total", 0)
    terms = analysis.analyze(arch, shape_name, name, chips,
                             {"flops": flops.get_total_flops(), "bytes accessed": rec.bytes},
                             rec.collectives, peak, analysis.model_flops_estimate(cfg, shape))
    out = terms.to_dict()
    out.update(
        lower_s=round(t_build, 1),  # building the step and placing its fake arguments
        compile_s=round(t_run, 1),  # the traced step
        memory_analysis=json.dumps({str(d): s for d, s in peak_snap.items()}),
        hlo_collective_count=terms.collective_breakdown.get("count", 0),
        device=str(dev),
    )
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}__{name}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(
        f"[dryrun] {arch} × {shape_name} × {name}: "
        f"compile={t_run:.0f}s peak_mem/dev={terms.peak_memory_per_device/2**30:.2f}GiB "
        f"t_comp={terms.t_compute*1e3:.2f}ms t_mem={terms.t_memory*1e3:.2f}ms "
        f"t_coll={terms.t_collective*1e3:.2f}ms dominant={terms.dominant}"
    )
    print(out["memory_analysis"])
    print({"flops": terms.flops_per_device, "bytes accessed": terms.bytes_per_device})
    return out


PAPER_ARCHS = ("dsv2-lite", "dsv2", "scaled-ds-1", "scaled-ds-2")


def all_combos(include_paper: bool = False):
    archs = [a for a in REGISTRY if a not in PAPER_ARCHS]
    if include_paper:
        archs += list(PAPER_ARCHS)
    for arch in archs:
        for shape_name in SHAPES:
            if arch in PAPER_ARCHS and shape_name == "train_4k":
                continue  # the paper's models are serving-only in its evaluation
            ok, _ = shape_supported(get_config(arch), SHAPES[shape_name])
            if ok:
                yield arch, shape_name


def fan_out(out_dir: str, multi_pod_also: bool, jobs: int, include_paper: bool = False) -> int:
    """Run every combo as a subprocess (the fake group is per process)."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    tasks = []
    for arch, shape_name in all_combos(include_paper):
        for mp in ([False, True] if multi_pod_also else [False]):
            name = "2x16x16" if mp else "16x16"
            if os.path.exists(os.path.join(out_dir, f"{arch}__{shape_name}__{name}.json")):
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape_name,
                   "--out", out_dir] + (["--multi-pod"] if mp else [])
            tasks.append(cmd)
    print(f"[dryrun] {len(tasks)} combos to run, {jobs} parallel")
    running, failed = [], []
    while tasks or running:
        while tasks and len(running) < jobs:
            cmd = tasks.pop(0)
            running.append((cmd, subprocess.Popen(cmd, env=env)))
        time.sleep(2)
        still = []
        for cmd, p in running:
            if p.poll() is None:
                still.append((cmd, p))
            elif p.returncode != 0:
                failed.append(cmd)
                print("[dryrun] FAILED:", " ".join(cmd[3:]))
        running = still
    print(f"[dryrun] done, {len(failed)} failures")
    return len(failed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--paper-models", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    if args.all:
        sys.exit(fan_out(args.out, multi_pod_also=True, jobs=args.jobs, include_paper=args.paper_models))
    run_one(args.arch, args.shape, args.multi_pod, args.out)


if __name__ == "__main__":
    main()
