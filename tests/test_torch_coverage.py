"""The port covers the reference: every module of ``src/repro/`` has its
counterpart in ``src/repro_torch/``, every public function and class
defined there exists in the counterpart (and every public member of such a
class on the port's class), or stands below with its reason; every example
``examples/<name>.py`` has its port ``examples/torch_<name>.py``; and
neither the port, its examples nor ``chip_smoke.py`` imports ``jax`` or
``repro``.

The modules are read as source (``ast``), walked by file: ``serving/`` has
no ``__init__.py``, so ``pkgutil`` would skip it."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
EXAMPLES = ROOT / "examples"

# the Pallas kernels and their oracles have CUDA ports under csrc/ with the
# plain versions in kernels/*/ops.py; the architecture list is folded into
# configs/__init__.py
NO_COUNTERPART = {"configs/archs.py"}
NO_COUNTERPART_GLOBS = ("kernels/*/kernel.py", "kernels/*/ref.py")

NOT_PORTED = {
    ("kernels/expert_ffn/ops.py", "expert_ffn"):
        "renamed: the plain per-expert SwiGLU is expert_ffn_ref; the port's K3 is expert_ffn_grouped, "
        "which takes the identity slot map for this case",
    ("models/moe.py", "expert_ffn"):
        "renamed: kernels/expert_ffn/ops.py expert_ffn_einsum (the stacked-weight einsum SwiGLU)",
    ("launch/mesh.py", "use_mesh"):
        "JAX-only: enters a jax.sharding mesh context; the port passes DeviceMesh objects explicitly",
    ("models/attention.py", "paged_decode_backend"):
        "the reference's REPRO_PAGED_DECODE knob choosing between its TPU paged-decode paths; "
        "the port has one paged decode (K1)",
    ("models/common.py", "init_layernorm"): "called by no model in the reference",
    ("models/common.py", "layernorm"): "called by no model in the reference",
    ("models/common.py", "param_dtype"): "JAX-only: renamed ModelConfig.torch_dtype",
    ("models/common.py", "split_keys"): "JAX-only: splits a PRNG key; the port draws from a torch.Generator",
    ("models/moe.py", "stream_slot_ffn"):
        "a TPU knob: streams slot weights through the Pallas FFN; the port's K3 reads the logical "
        "weights slot-indirectly",
}

IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)|import_module\(\s*['\"](?:jax|repro)[.'\"]",
                    re.M)


def _modules():
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        if rel in NO_COUNTERPART or any(pathlib.PurePosixPath(rel).match(g) for g in NO_COUNTERPART_GLOBS):
            continue
        yield rel


def _public_defs(tree):
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _bound_names(body):
    """Names a module or class body binds: defs, classes, imports and
    assignments."""
    out = set()
    for n in body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in n.names}
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                out |= {x.id for x in ast.walk(t) if isinstance(x, ast.Name)}
    return out


def _classes(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


MODULES = list(_modules())


def test_every_reference_module_is_walked():
    """Each of the reference's packages is walked, ``serving/`` included."""
    tops = {m.split("/")[0] for m in MODULES}
    assert {"configs", "core", "kernels", "launch", "models", "roofline", "serving", "sharding",
            "training"} <= tops
    assert "serving/simulator.py" in MODULES and "core/baselines.py" in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_module_has_its_counterpart(rel):
    ref = ast.parse((REF / rel).read_text())
    port_path = PORT / rel
    assert port_path.exists(), f"src/repro_torch/{rel} is missing"
    port = ast.parse(port_path.read_text())
    bound = _bound_names(port.body)
    missing = sorted(n for n in _public_defs(ref) - bound if (rel, n) not in NOT_PORTED)
    assert not missing, f"{rel}: {missing}"
    port_classes = _classes(port)
    for name, cls in _classes(ref).items():
        if name.startswith("_") or name not in port_classes:
            continue
        members = {m for m in _bound_names(cls.body) if not m.startswith("_")}
        gone = sorted(members - _bound_names(port_classes[name].body))
        assert not gone, f"{rel}: {name}.{gone}"


def test_not_ported_names_are_really_absent():
    """Every stated reason names a definition the reference has and the port
    lacks, so the list cannot go stale."""
    for (rel, name), reason in NOT_PORTED.items():
        assert reason
        assert name in _public_defs(ast.parse((REF / rel).read_text())), (rel, name)
        assert name not in _bound_names(ast.parse((PORT / rel).read_text()).body), (rel, name)


REF_EXAMPLES = sorted(p.name for p in EXAMPLES.glob("*.py") if not p.name.startswith("torch_"))


def test_reference_examples_are_found():
    assert {"quickstart.py", "serve_disaggregated.py", "train_moe.py", "autoscale_trace.py"} <= set(REF_EXAMPLES)


@pytest.mark.parametrize("name", REF_EXAMPLES)
def test_example_has_its_port(name):
    assert (EXAMPLES / f"torch_{name}").exists(), f"examples/torch_{name} is missing"


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
                         + sorted(p.relative_to(ROOT).as_posix() for p in EXAMPLES.glob("torch_*.py"))
                         + ["chip_smoke.py"])
def test_port_imports_neither_jax_nor_the_reference(path):
    text = (ROOT / path).read_text()
    assert not IMPORT.search(text), f"{path}: {IMPORT.search(text).group(0)!r}"
