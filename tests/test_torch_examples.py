"""The port's examples (``examples/torch_*.py``), each run as a user runs it
(its own process, ``--device cpu``, short flags, one torch thread), beside
the reference's (``examples/*.py``).

Each must exit 0 and print its reference's sections.  The lines that come
from host numpy code must equal the reference example's output exactly:
quickstart's placement, ``a_max`` and scaler lines (steps 1-3; step 4 serves
torch weights, other numbers than the reference's JAX draw), and every line
of autoscale_trace, run on both sides at a shortened trace (2 hours, at most
8 devices a policy: the reference's script, with those two settings
patched into the functions it calls).  The processes run at once, in a
module fixture."""

import dataclasses
import os
import subprocess
import sys

import pytest

from repro.configs import get_config as ref_get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOURS, N_MAX = 2, 8
TRAIN_FLAGS = ["--steps", "12", "--batch", "4", "--seq", "64", "--warmup", "1", "--ckpt-dir", ""]

# the reference's autoscale_trace.py at the shortened settings
SHORT_REFERENCE_AUTOSCALE = f"""
import runpy
import repro.serving.simulator as sim
import repro.serving.trace as trace

profile, Simulator = trace.diurnal_rate_profile, sim.ClusterSimulator
trace.diurnal_rate_profile = lambda **kw: profile(**dict(kw, hours={HOURS}))


class Short(Simulator):
    def __init__(self, pm, **kw):
        super().__init__(pm, **dict(kw, n_max={N_MAX}))


sim.ClusterSimulator = Short
runpy.run_path("examples/autoscale_trace.py", run_name="__main__")
"""

RUNS = {
    "torch_quickstart": ["examples/torch_quickstart.py", "--device", "cpu"],
    "quickstart": ["examples/quickstart.py"],
    "torch_autoscale_trace": ["examples/torch_autoscale_trace.py", "--device", "cpu", "--hours", str(HOURS),
                              "--n-max", str(N_MAX)],
    "autoscale_trace": ["-c", SHORT_REFERENCE_AUTOSCALE],
    "torch_serve_disaggregated": ["examples/torch_serve_disaggregated.py", "--device", "cpu"],
    "torch_train_moe": ["examples/torch_train_moe.py", "--device", "cpu", *TRAIN_FLAGS],
}

SECTIONS = {
    "torch_quickstart": ["=== 1. expert placement from a routing trace ===",
                         "=== 2. AEBS vs baselines (batch of 256 tokens) ===", "=== 3. SLO-aware scaling ===",
                         "=== 4. serve a small MoE with the scheduled path ==="],
    "torch_autoscale_trace": ["demand  (req/s):", "janus       gpus:", "system        gpu-hours",
                              "janus saves"],
    "torch_serve_disaggregated": ["=== A. three-pool engine: 2 prefill + 2 attention + 4 MoE devices ===",
                                  "  phase 1 (2P2A4E): served 6 requests", "  reconfigure 2P2A4E → 1P3A4E",
                                  "  phase 2 (1P3A4E): served 6 more", "  completed=12 ",
                                  "=== B. SPMD deployment (full reduced model, 2×4 mesh, gloo) ===",
                                  "  decoded 8 tokens/seq on 8 devices", "  sample continuation (seq 0):"],
    "torch_train_moe": ["training dsv2-100m:", "step     0  loss", "step    10  loss", "loss "],
}


@pytest.fixture(scope="module")
def runs():
    """Every example's ``(exit code, stdout, stderr)``, all started at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True) for name, argv in RUNS.items()}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[name] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_example_runs_and_prints_its_sections(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, stderr[-3000:]
    lines = stdout.splitlines()
    at = 0
    for want in SECTIONS[name]:  # in order
        hits = [i for i in range(at, len(lines)) if lines[i].startswith(want)]
        assert hits, f"{name}: no line {want!r} after line {at}:\n{stdout}"
        at = hits[0] + 1


def test_quickstart_host_lines_equal_reference(runs):
    """Steps 1-3 (placement, a_max of AEBS, random and token hash against
    the Eq. 5 bound, the SLO scaler's deployments) line for line, and step
    4's header; step 4 served every request on both sides."""
    (rc, got, err), (ref_rc, want, ref_err) = runs["torch_quickstart"], runs["quickstart"]
    assert rc == 0 and ref_rc == 0, (err[-2000:], ref_err[-2000:])
    got, want = got.splitlines(), want.splitlines()
    cut = want.index("=== 4. serve a small MoE with the scheduled path ===") + 1
    assert len(want) == cut + 1 and len(got) == cut + 1
    assert got[:cut] == want[:cut]
    assert got[-1].split(",")[0] == want[-1].split(",")[0]  # "  served N requests"


def test_autoscale_lines_equal_reference(runs):
    """Every line: the demand and GPU sparklines, the GPU-hours table and
    the savings, all host numpy over the H100 performance model."""
    (rc, got, err), (ref_rc, want, ref_err) = runs["torch_autoscale_trace"], runs["autoscale_trace"]
    assert rc == 0 and ref_rc == 0, (err[-2000:], ref_err[-2000:])
    assert got.splitlines() == want.splitlines() and len(want.splitlines()) == 14


def test_train_moe_header_and_loss(runs):
    """The ~100M config's parameter count and expert share as the
    reference's ``total_params``/``expert_param_fraction`` give them, and a
    last loss below the first (the example's own assert)."""
    rc, stdout, stderr = runs["torch_train_moe"]
    assert rc == 0, stderr[-3000:]
    ref = dataclasses.replace(ref_get_config("dsv2-lite"), name="dsv2-100m", num_layers=4, d_model=512, num_heads=8,
                              num_kv_heads=8, head_dim=64, vocab_size=32_000, num_experts=8, num_shared_experts=1,
                              top_k=2, d_ff_expert=1024)
    assert stdout.splitlines()[0] == (f"training dsv2-100m: {ref.total_params()/1e6:.0f}M params "
                                      f"({ref.expert_param_fraction()*100:.0f}% in experts), 12 steps × 4×64 tokens")
    first, last = (float(x) for x in stdout.splitlines()[-1].split()[1:4:2])
    assert last < first
