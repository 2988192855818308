"""The port's two analysis CLIs and the source rules behind the first.

* ``repro_torch.analysis.ast_rules`` gives the reference's findings (rule
  and line, and the binding named) on every snippet of
  ``tests/test_tools.py``, each carried over to the port (``src/repro`` ->
  ``src/repro_torch``, ``jnp.exp2`` -> ``torch.exp2``, ``PRNGKey(k)`` ->
  ``manual_seed(k)``); allowlist entries and pragmas act as there.
* ``torch_check_no_globals.py``: 0 on the port's tree, 1 on an injected
  violation, 2 on a missing tree.
* ``torch_lint_programs.py``: 2 without a baseline, ``--update`` creates
  it, the same programs pass against it, a doctored baseline (an injected
  drift) fails with 1 and an ``--override`` widens it again.
"""
import argparse
import importlib.util
import json
import re
import warnings
from pathlib import Path

import pytest

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.analysis import check_source as ref_check_source

from repro_torch.analysis import SOURCE_RULES, check_source

ROOT = Path(__file__).resolve().parents[1]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (path, source) of every snippet of tests/test_tools.py, as written there
REF_SNIPPETS = [
    ("src/repro/x.py", "a, b = [], {}\n"),
    ("src/repro/x.py", "a, b = [], 3\n"),
    ("src/repro/x.py", "a, *rest = (1, 2, 3)\n"),
    ("src/repro/x.py", "(a, b), c = ([], 1), {}\n"),
    ("src/repro/x.py", "X = {}\n\ndef f():\n    global X\n    X = {}\n"),
    ("src/repro/x.py", "X = (1, 2)\nY = 3\n"),
    ("src/repro/x.py", "__all__ = []\nz: dict\n"),
    ("src/repro/x.py", "CACHE = {}\n"),
    ("src/repro/x.py", "CACHE = {}  # lint: allow(module-mutable)\n"),
    ("src/repro/x.py", "CACHE = {}  # lint: allow(fixed-prngkey)\n"),
    ("src/repro/core/quantizer.py",
     "import jax.numpy as jnp\ns = jnp.exp2(f)\n"),
    ("src/repro/kernels/wire_pack/kernel.py",
     "import jax.numpy as jnp\ns = jnp.exp2(f)\n"),
    ("src/repro/train/loop.py", "import jax.numpy as jnp\ns = jnp.exp2(f)\n"),
    ("src/repro/core/quantizer.py", "m = 2.0 ** 24\np = pow(2, 5)\n"),
    ("src/repro/a.py", "import jax\nk = jax.random.PRNGKey(0)\n"),
    ("src/repro/a.py", "k = jax.random.PRNGKey(7)\n"),
    ("src/repro/a.py", "from repro.dist import set_axes\n"
                       "set_axes(('data',), 'model')\n"),
    ("src/repro/a.py", "def set_axes(*a, **k):\n    pass\n"),
]


def _to_port(path, text):
    text = (text.replace("import jax.numpy as jnp", "import torch")
            .replace("jnp.exp2", "torch.exp2")
            .replace("import jax\n", "import torch\n")
            .replace("jax.random.PRNGKey(", "torch.manual_seed(")
            .replace("from repro.dist", "from repro_torch.dist"))
    return path.replace("src/repro/", "src/repro_torch/"), text


def _findings(probs):
    """{(line, rule, the binding named)} of a list of findings."""
    out = set()
    for p in probs:
        m = re.match(r"[^:]+:(\d+): \[([\w-]+)\] (.*)", p)
        name = re.search(r"`([^`]+)`", m.group(3))
        out.add((int(m.group(1)), m.group(2),
                 name.group(1) if m.group(2) == "module-mutable" else ""))
    return out


@pytest.mark.parametrize("path,text", REF_SNIPPETS,
                         ids=[f"snippet{i}" for i in range(len(REF_SNIPPETS))])
def test_source_rules_give_the_reference_findings(path, text):
    ppath, ptext = _to_port(path, text)
    assert "jax" not in ptext
    assert _findings(check_source(ppath, ptext)) == _findings(
        ref_check_source(path, text))


def test_source_rules_retargeted():
    assert [r.name for r in SOURCE_RULES] == [
        "no-global", "module-mutable", "inexact-bit-arith", "fixed-prngkey",
        "deprecated-shim-call"]
    q = "src/repro_torch/core/quantizer.py"
    for call in ("torch.exp2(f)", "torch.log2(x)", "torch.pow(2.0, f)",
                 "x.pow(2)"):
        probs = check_source(q, f"y = {call}\n")
        assert len(probs) == 1 and "[inexact-bit-arith]" in probs[0], call
    # the bit-exact modules only; Python powers are exact
    assert check_source("src/repro_torch/optim/optimizers.py",
                        "y = torch.pow(b1, t)\n") == []
    assert check_source("src/repro_torch/kernels/qmatmul/ref.py",
                        "y = x.pow(2)\n") != []
    for seed in ("torch.manual_seed(0)", "gen.manual_seed(0)"):
        probs = check_source("src/repro_torch/a.py", f"{seed}\n")
        assert len(probs) == 1 and "[fixed-prngkey]" in probs[0]
    assert check_source("src/repro_torch/a.py",
                        "gen.manual_seed(seed)\n") == []
    # an immutable rebinding passes, a dict does not
    assert check_source("src/repro_torch/a.py",
                        "T = types.MappingProxyType({'a': 1})\n") == []
    assert check_source("src/repro_torch/a.py", "T = {'a': 1}\n") != []


def test_source_rules_allowlist_and_pragma():
    rel = "src/repro_torch/x.py"
    assert check_source(rel, "CACHE = {}\n") != []
    assert check_source(rel, "CACHE = {}\n",
                        allow=frozenset({f"{rel}::CACHE"})) == []
    assert check_source(rel, "CACHE = {}\n",
                        allow=frozenset({f"{rel}::*"})) == []


# --------------------------- torch_check_no_globals --------------------------

def test_check_no_globals_cli(tmp_path):
    tool = _load_tool("torch_check_no_globals")
    assert tool.main([]) == 0                       # the port's own tree
    src = tmp_path / "src" / "repro_torch"
    src.mkdir(parents=True)
    (src / "ok.py").write_text("X = (1,)\n")
    assert tool.main(["--src", str(src)]) == 0
    (src / "bad.py").write_text("a, b = [], {}\n")
    assert tool.main(["--src", str(src)]) == 1
    assert tool.main(["--src", str(tmp_path / "nope")]) == 2
    # the allowlist names one binding with its reason
    assert tool.ALLOWLIST == frozenset(
        {"src/repro_torch/kernels/_build.py::_LOADED"})


# ---------------------------- torch_lint_programs ----------------------------

def test_lint_programs_override_parsing():
    tool = _load_tool("torch_lint_programs")
    assert tool._parse_override("train:*.launches=0.5") == \
        ("train:*.launches", 0.5)
    with pytest.raises(argparse.ArgumentTypeError):
        tool._parse_override("no-equals-sign")


def test_lint_programs_gate_and_injected_drift(tmp_path):
    tool = _load_tool("torch_lint_programs")
    specs = tmp_path / "specs"
    specs.mkdir()
    (specs / "host_1x1.json").write_text(
        (ROOT / "examples" / "specs" / "host_1x1.json").read_text())
    (specs / "plan_x.json").write_text("{not json}")   # skipped, not parsed
    out = tmp_path / "report.json"
    baseline = tmp_path / "PROGRAMS.json"
    common = ["--specs-dir", str(specs), "--out", str(out), "--baseline",
              str(baseline)]
    empty = tmp_path / "none"
    empty.mkdir()
    assert tool.main(["--specs-dir", str(empty), "--out", str(out)]) == 2
    assert tool.main(common) == 2                   # no baseline yet
    assert tool.main(common + ["--update"]) == 0
    assert tool.main(common) == 0
    report = json.loads(out.read_text())
    assert set(report["programs"]) == {"train:host_1x1", "decode:host_1x1"}
    # the committed golden holds the same two programs
    golden = json.loads((ROOT / "src" / "repro_torch" / "analysis"
                         / "programs.json").read_text())
    for name, rep in report["programs"].items():
        assert rep["violations"] == []
        assert {k: v for k, v in rep.items() if k != "spec"} == {
            k: v for k, v in golden["programs"][name].items()
            if k != "spec"}
    # inject drift: the golden claims one more in-place buffer and one
    # kernel op fewer than the program has
    doctored = json.loads(baseline.read_text())
    prog = doctored["programs"]["train:host_1x1"]
    prog["aliased_buffers"] += 1
    prog["kernels"]["hgq_quantize_bwd"] -= 1
    baseline.write_text(json.dumps(doctored))
    assert tool.main(common) == 1
    assert tool.main(common + [
        "--override", "train:host_1x1.aliased_buffers=0.5",
        "--override", "train:host_1x1.kernels.*=0.5"]) == 0
