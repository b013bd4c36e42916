"""The roofline terms (``repro_torch.roofline.analysis``) against the
reference's (``repro.roofline.analysis``), and the dry run
(``repro_torch.launch.dryrun``) on a fake mesh.

The fake process group opens only in a subprocess (16 ranks, as the dry
run opens its 256 or 512)."""

import json
import os
import subprocess
import sys

import pytest

from repro.configs import get_config as ref_get_config
from repro.roofline import analysis as ref_analysis
from repro_torch.configs import REGISTRY, SHAPES, get_config
from repro_torch.roofline import analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_HW = dict(peak_flops=ref_analysis.PEAK_FLOPS, hbm_bw=ref_analysis.HBM_BW, link_bw=ref_analysis.LINK_BW)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_model_flops_equal_reference(arch):
    for suffix in ("", "-reduced"):
        for name, shape in SHAPES.items():
            got = analysis.model_flops_estimate(get_config(arch + suffix), shape)
            from repro.configs import SHAPES as REF_SHAPES

            assert got == ref_analysis.model_flops_estimate(ref_get_config(arch + suffix), REF_SHAPES[name])


@pytest.mark.parametrize("loop_scale", [1.0, 3.0])
def test_terms_equal_reference_with_its_constants(loop_scale):
    kw = dict(arch="yi-34b", shape="train_4k", mesh="16x16", chips=256, flops_per_device=3.1e15,
              bytes_per_device=2.2e12, collective_bytes_per_device=4.5e10,
              collective_breakdown={"all-reduce": 4.5e10, "count": 7}, peak_memory_per_device=3.3e10,
              model_flops=6.1e17, loop_scale=loop_scale)
    assert analysis.RooflineTerms(**kw, **REF_HW).to_dict() == ref_analysis.RooflineTerms(**kw).to_dict()
    h100 = analysis.RooflineTerms(**kw)
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == (989e12, 3.35e12, 50e9)


def test_collective_bytes_and_analyze():
    recs = [("all-reduce", 4096), ("all-gather", 8192), ("all-reduce", 100)]
    assert analysis.collective_bytes(recs) == {"all-gather": 8192, "all-reduce": 4196, "reduce-scatter": 0,
                                               "all-to-all": 0, "collective-permute": 0, "count": 3}
    t = analysis.analyze("a", "s", "4x4", 16, {"flops": 2e12, "bytes accessed": 3e9}, recs, 5e9, 1e13, **REF_HW)
    assert t.collective_bytes_per_device == 12388 and t.peak_memory_per_device == 5e9
    assert t.t_compute == 2e12 / ref_analysis.PEAK_FLOPS and t.dominant == "compute"


SUBPROCESS = r"""
import json, sys, torch
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import make_mesh, open_group
from repro_torch.roofline.analysis import OpRecorder, collective_bytes
open_group("fake", world_size=16)
mesh = make_mesh((4, 4), ("data", "model"), "cpu")
with FakeTensorMode():
    x = torch.empty(8, 128)
    rec = OpRecorder()
    with rec:
        y = funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, 1)))
        z = y * 2.0
        w = funcol.wait_tensor(funcol.all_gather_tensor(z, 0, (mesh, 0)))
print(json.dumps({"coll": collective_bytes(rec.collectives), "bytes": rec.bytes, "shape": list(w.shape)}))
for shape in ("train_4k", "decode_32k"):
    run_one("dsv2-lite-reduced", shape, False, sys.argv[1], mesh=mesh)
"""


@pytest.fixture(scope="module")
def fake_runs(tmp_path_factory):
    """One process over a fake group of 16 ranks (a 4 x 4 mesh): a known
    program under the recorder, then two dry runs."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", SUBPROCESS, str(out)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return run.stdout, out


def test_recorder_counts_a_known_program_on_the_fake_backend(fake_runs):
    """One all-reduce of f32 [8, 128] over ``model`` and one all-gather of
    it over ``data`` (result [32, 128]) on the fake 4 x 4 mesh: their result
    bytes by kind, and the bytes of the one aten op between them."""
    lines = [ln for ln in fake_runs[0].splitlines() if ln.startswith('{"coll"')]
    got = json.loads(lines[0])
    assert got["coll"] == {"all-gather": 32 * 128 * 4, "all-reduce": 8 * 128 * 4, "reduce-scatter": 0,
                           "all-to-all": 0, "collective-permute": 0, "count": 2}
    assert got["shape"] == [32, 128] and got["bytes"] == 2 * 8 * 128 * 4  # the multiply's input and output


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dry_run_writes_its_record(fake_runs, shape):
    """``dsv2-lite-reduced`` traced on the fake 4 x 4 mesh: the reference's
    record keys, a positive peak, FLOPs and collective bytes."""
    out, tmp_path = fake_runs
    assert f"[dryrun] dsv2-lite-reduced × {shape} × 4x4:" in out
    with open(tmp_path / f"dsv2-lite-reduced__{shape}__4x4.json") as f:
        rec = json.load(f)
    ref_keys = set(ref_analysis.RooflineTerms("a", "s", "m", 1, 0, 0, 0, {}, 0, 0).to_dict())
    assert ref_keys | {"lower_s", "compile_s", "memory_analysis", "hlo_collective_count"} <= set(rec)
    assert rec["chips"] == 16 and rec["mesh"] == "4x4" and rec["loop_scale"] == 1.0
    assert rec["peak_memory_per_device"] > 0 and rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_breakdown"]["count"] == rec["hlo_collective_count"] > 0
    assert rec["collective_bytes_per_device"] > 0


def test_repeat_scope_scales_both_recorders():
    """Inside ``analysis.repeat(n)`` the FLOP counter and the op recorder
    count each op ``n`` times; scopes nest by multiplying, and ``repeat(0)``
    counts nothing."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a, b = torch.empty(8, 16), torch.empty(16, 4)
        flops, rec = analysis.LocalFlopCounter(display=False), analysis.OpRecorder()
        with flops, rec:
            a @ b
            with analysis.repeat(3):
                a @ b
                with analysis.repeat(2):
                    a @ b
                with analysis.repeat(0):
                    a @ b
    one = 2 * 8 * 16 * 4
    assert flops.get_total_flops() == (1 + 3 + 6) * one
    assert rec.bytes == (1 + 3 + 6) * (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert analysis._REPEAT == [1]


SCAN = r"""
import json, sys
from repro_torch.configs import SHAPES, InputShape
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import make_mesh, open_group
from repro_torch.models import ssm
open_group("fake", world_size=16)
mesh = make_mesh((4, 4), ("data", "model"), "cpu")
S = int(sys.argv[2])
SHAPES["train_s"] = InputShape("train_s", S, 8, "train")
SHAPES["prefill_s"] = InputShape("prefill_s", S, 8, "prefill")
counted, hits, out = ssm._counts_only, [0], {}


def counting(t):
    hit = counted(t)
    hits[0] += hit
    return hit


for arch in ("falcon-mamba-7b-reduced", "zamba2-2.7b-reduced"):
    for shape in ("train_s", "prefill_s"):
        for mode in ("counted", "loop"):
            hits[0] = 0
            ssm._counts_only = counting if mode == "counted" else (lambda t: False)
            r = run_one(arch, shape, False, sys.argv[1], mesh=mesh)
            out[f"{arch}|{shape}|{mode}"] = dict(flops=r["flops_per_device"], bytes=r["bytes_per_device"],
                                                 peak=r["peak_memory_per_device"], hits=hits[0])
print("SCAN " + json.dumps(out))
"""
SCAN_LEN = 64


@pytest.fixture(scope="module")
def scan_runs(tmp_path_factory):
    """The Mamba configs' train and prefill steps traced on the fake 4 x 4
    mesh at ``SCAN_LEN`` tokens, once through the counted scan and once
    through the token loop."""
    out = tmp_path_factory.mktemp("dryrun_scan")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", SCAN, str(out), str(SCAN_LEN)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("SCAN ")][0]
    return json.loads(line[len("SCAN "):])


@pytest.mark.parametrize("shape", ["train_s", "prefill_s"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b-reduced", "zamba2-2.7b-reduced"])
def test_counted_scan_records_the_token_loop(scan_runs, arch, shape):
    """The dry run's counted Mamba scan (``models/ssm.py`` ``_CountedScan``:
    one step inside ``analysis.repeat``) against the token loop it stands
    for: FLOPs exactly, unfused bytes and the peak a rank within 2%."""
    got, want = scan_runs[f"{arch}|{shape}|counted"], scan_runs[f"{arch}|{shape}|loop"]
    assert got["hits"] > 0 and want["hits"] == 0
    assert got["flops"] == want["flops"] > 0
    assert abs(got["bytes"] / want["bytes"] - 1) <= 0.02
    assert abs(got["peak"] / want["peak"] - 1) <= 0.02
