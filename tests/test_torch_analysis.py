"""``repro_torch.analysis``: the program rules, their census and the
traced facts they read.

* The spec-built train step updates params, both AdamW moments and the EF
  residual in place (``RunContext.init_training`` reads
  ``train_shardings``' donate tuple): no storage changes across a step,
  by the ``data_ptr`` of every leaf, on ``host_1x1.json`` and
  ``host_2x4_int8wire2d.json`` at SMOKE.
* Each program rule is flagged by its injected fault (as
  ``tests/test_analysis.py`` injects them into the reference's rules) and
  passes the clean program.
* The shipped specs' programs are clean at SMOKE and their census is the
  committed golden (``torch_lint_programs.py`` exits 0).
* The collectives of a SMOKE compressed 1D step (``--mesh 4x1``) and of
  the SMOKE 2D step agree, by summed elements per (primitive, axes,
  dtype), with the reference's record of the same exchange: the jaxpr
  of the JAX package's ``ef_wire_pmean`` / ``ef_wire_pmean_2d`` over the
  same tree, traced in a subprocess on 8 host devices.
* A float64 operation outside the deliberate modules is charged to where
  it comes from.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import analysis
from repro_torch.analysis import (ExplicitCollective, ProgramArtifacts,
                                  ProgramTrace, Violation, run_rules)
from repro_torch.api import RunSpec, build
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
SPECS = ROOT / "examples" / "specs"
CPU = "cpu"


# ------------------------------ donation -----------------------------------

def _storages(setup):
    return [t.data_ptr() for t in tree_leaves(
        (setup.params, setup.opt.mu, setup.opt.nu,
         None if setup.ef_state is None else setup.ef_state.residual))]


@pytest.mark.parametrize("name,batch", [("host_1x1", 2),
                                        ("host_2x4_int8wire2d", 4)])
def test_spec_built_step_updates_its_state_in_place(name, batch):
    spec = RunSpec.from_args(["--spec", str(SPECS / f"{name}.json"),
                              "--batch", str(batch), "--seq", "8"])
    setup = build(spec, device=CPU).init_training()
    before = _storages(setup)
    p0 = [t.clone() for t in tree_leaves(setup.params)]
    for s in range(2):
        setup.step(s)
    assert _storages(setup) == before
    assert any(not torch.equal(a, b)
               for a, b in zip(p0, tree_leaves(setup.params)))
    if setup.ef_state is not None:
        assert any(r.any() for r in tree_leaves(setup.ef_state.residual))


# ------------------------- rules on injected faults -------------------------

class _Run:
    def __init__(self):
        self.trace = ProgramTrace()


def _fake_art(explicit=(), kind="train", mesh=(2, 4), meta=None,
              state=(), f64=None, aliased=0, moved=0):
    """A ProgramArtifacts with hand-planted facts: the injection point for
    the violation tests (subclassing keeps the rule code on the
    production path)."""
    class Injected(ProgramArtifacts):
        def explicit_collectives(self):
            return list(explicit)

        def aliased_buffers(self):
            return aliased

        def moved_buffers(self):
            return moved

        def state(self, inputs=True, outputs=True):
            return [s for s in state if (inputs and s[0] != "returned")
                    or (outputs and s[0] == "returned")]

        def f64_ops(self):
            return dict(f64 or {})

        def kernel_ops(self):
            return {}
    return Injected(name=f"{kind}:injected", kind=kind, spec=RunSpec(),
                    spec_path="", mesh_shape=mesh, run=_Run(),
                    meta={"wire": True, "wire_payload": "int8",
                          "donated_leaves": 0, **(meta or {})})


def _ec(primitive, axes, dtype, dims):
    return ExplicitCollective(primitive=primitive, axes=axes, dtype=dtype,
                              dims=dims)


CLEAN_WIRE = [_ec("all_to_all", ("data",), "int8", (2, 8478)),
              _ec("pmax", ("data", "model"), "float32", (49,))]
PACKED = {"packed": True, "unpacked_param_bytes": 4000}
QKV = {"kv_bits": 8, "kv_cache_int_bytes": 1000}

# (rule, the injected program's facts)
FAULTS = [
    ("wire-dtype", dict(explicit=[
        _ec("all_to_all", ("data",), "float32", (2, 8478)),
        _ec("pmax", ("data", "model"), "float32", (49,))])),
    ("wire-present", dict(explicit=[_ec("pmax", ("data", "model"),
                                        "float32", (49,))])),
    # an f32 exchange larger than one value a quantization row
    ("wire-dtype", dict(explicit=CLEAN_WIRE + [
        _ec("pmax", ("data", "model"), "float32", (358,))],
        meta={"scale_rows": 357})),
    ("donation", dict(explicit=CLEAN_WIRE, meta={"donated_leaves": 10},
                      aliased=9)),
    ("no-f64", dict(explicit=CLEAN_WIRE,
                    state=[("params", "float64", 16)])),
    ("no-f64", dict(explicit=CLEAN_WIRE,
                    state=[("returned", "float64", 1)])),
    ("no-f64", dict(explicit=CLEAN_WIRE,
                    f64={"repro_torch.models.lm": 3,
                         "repro_torch.nn.basic": 10})),
    ("no-f64", dict(explicit=CLEAN_WIRE + [
        _ec("pmax", ("data",), "float64", (4,))])),
    ("decode-donation", dict(kind="decode", mesh=(1, 1), aliased=0)),
    ("decode-donation", dict(kind="decode", mesh=(1, 1), aliased=2,
                             moved=1)),
    ("packed-weights", dict(kind="decode", mesh=(1, 1), aliased=2,
                            meta=PACKED,
                            state=[("params", "float32", 100)])),
    ("packed-weights", dict(kind="decode", mesh=(1, 1), aliased=2,
                            meta=PACKED,
                            state=[("params", "int8", 100),
                                   ("params", "float32", 1000)])),
    ("quantized-kv", dict(kind="decode", mesh=(1, 1), aliased=2, meta=QKV,
                          state=[("caches", "int8", 999)])),
    ("quantized-kv", dict(kind="decode", mesh=(1, 1), aliased=2, meta=QKV,
                          state=[("caches", "int8", 1000),
                                 ("caches", "bfloat16", 4096)])),
]


@pytest.mark.parametrize("rule,facts", FAULTS,
                         ids=[f"{r}-{i}" for i, (r, _) in enumerate(FAULTS)])
def test_injected_fault_is_flagged(rule, facts):
    names = [v.rule for v in run_rules(_fake_art(**facts))]
    assert rule in names, names


@pytest.mark.parametrize("facts", [
    dict(explicit=CLEAN_WIRE, meta={"donated_leaves": 10}, aliased=10,
         f64={"repro_torch.nn.basic": 10, "repro_torch.core.fixedpoint": 1,
              "repro_torch.nn.recurrent": 2}),
    dict(kind="decode", mesh=(1, 1), aliased=2, meta={**PACKED, **QKV},
         state=[("params", "int8", 1000), ("params", "float32", 100),
                ("caches", "int8", 1000), ("returned", "float32", 8)]),
], ids=["train", "decode"])
def test_clean_program_passes(facts):
    assert run_rules(_fake_art(**facts)) == []


def test_amax_pmax_of_every_row_is_scalar_class():
    """qwen2-0.5b's full-width amax pmax: 357 float32 values, one a
    quantization row, over ``SCALAR_MAX`` and still scalar-class."""
    art = _fake_art(explicit=CLEAN_WIRE + [
        _ec("pmax", ("data", "model"), "float32", (357,))],
        meta={"scale_rows": 357})
    assert run_rules(art) == []
    art.meta["scale_rows"] = 0
    assert [v.rule for v in run_rules(art)] == ["wire-dtype"]


def test_violation_str_names_rule_and_program():
    v = Violation(rule="wire-dtype", program="train:x", message="boom")
    assert "wire-dtype" in str(v) and "train:x" in str(v)


def test_stray_f64_op_is_charged_to_its_origin():
    x = torch.ones(64)
    with ProgramTrace() as tr:
        (x.to(torch.float64) * 2).sum()
    assert tr.f64_outside() == {"<no module of the port>": 3}


# ------------------------- report + baseline diff --------------------------

def _report_with(kernels=5, f64=3, aliased=5):
    return {"report": "programs", "programs": {"train:x": {
        "kind": "train", "spec": "s.json", "mesh": [2, 4], "launches": 4,
        "explicit": {"all_to_all[data]": 1}, "collectives": {},
        "crossing": {}, "aliased_buffers": aliased,
        "kernels": {"hgq_quantize_bwd": kernels}, "f64_ops": f64,
        "violations": []}}}


def test_compare_kernel_ops_and_f64_are_lower_is_better():
    assert analysis.direction_for("train:x.kernels.qmatmul") == "lower"
    assert analysis.direction_for("train:x.f64_ops") == "lower"
    failures, _ = analysis.compare(_report_with(), _report_with(kernels=6))
    assert any("kernels.hgq_quantize_bwd" in f for f in failures)
    failures, _ = analysis.compare(_report_with(), _report_with(f64=4))
    assert any("f64_ops" in f for f in failures)
    failures, notes = analysis.compare(_report_with(), _report_with(f64=2))
    assert not failures and any("f64_ops" in n for n in notes)
    failures, _ = analysis.compare(_report_with(), _report_with(aliased=4))
    assert any("aliased_buffers" in f for f in failures)


# --------------------------- the shipped specs ------------------------------

def test_shipped_spec_programs_clean_and_at_the_golden(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "torch_lint_programs", ROOT / "torch_lint_programs.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "report.json"
    assert tool.main(["--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert set(report["programs"]) == {
        "train:host_1x1", "decode:host_1x1", "train:host_2x4_int8wire2d",
        "train:serving_asr_stream", "decode:serving_asr_stream",
        "train:serving_kv_plan", "decode:serving_kv_plan",
        "train:serving_packed", "decode:serving_packed"}
    for name, rep in report["programs"].items():
        assert rep["violations"] == [], (name, rep["violations"])
    two = report["programs"]["train:host_2x4_int8wire2d"]
    # the reference's census of the same program
    assert two["explicit"] == {"all_gather[data]": 1,
                               "all_gather[model]": 1,
                               "all_to_all[data]": 1,
                               "pmax[data,model]": 1}
    assert two["aliased_buffers"] == 4 * 35 and two["kernels"][
        "wire_quantize_sflat"] > 0
    assert report["programs"]["train:host_1x1"]["aliased_buffers"] == 105
    assert report["programs"]["decode:serving_kv_plan"]["kernels"][
        "kv_attention_rows"] > 0


# ------------------ collectives against the reference's ---------------------

_REF_RECORD = r'''
import json, os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
warnings.simplefilter("ignore", DeprecationWarning)
import jax, jax.numpy as jnp
from repro.analysis import explicit_collectives
from repro.configs import get
from repro.dist import collectives as jcoll
from repro.models import model_for
cfg = get("qwen2-0.5b", smoke=True)
params, _ = jax.eval_shape(lambda k: model_for(cfg).init(k, cfg),
                           jax.random.PRNGKey(1))
out = {}
for D, M in ((4, 1), (2, 4)):
    grads = jax.tree.map(lambda a: jnp.zeros((D,) + a.shape, a.dtype),
                         params)
    mesh = jax.make_mesh((D, M), ("data", "model"))
    if M > 1:
        res = jcoll.ef_wire2d_init(jax.tree.map(lambda a: a[0], grads), D, M)
        jaxpr = jax.jit(lambda g, r: jcoll.ef_wire_pmean_2d(
            g, r, mesh, "int8")).trace(grads, res).jaxpr
    else:
        jaxpr = jax.jit(lambda g: jcoll.ef_wire_pmean(
            g, mesh, "int8")).trace(grads).jaxpr
    rec = {}
    for c in explicit_collectives(jaxpr):
        k = "|".join((c.primitive, ",".join(c.axes), c.dtype))
        rec[k] = rec.get(k, 0) + c.numel
    out[f"{D}x{M}"] = rec
print(json.dumps(out))
'''


def _reference_records():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF_RECORD], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_collectives_agree_with_the_reference_record():
    ref = _reference_records()
    for argv, key in (
            (["--spec", str(SPECS / "host_1x1.json"), "--mesh", "4x1",
              "--grad-compression", "int8-wire"], "4x1"),
            (["--spec", str(SPECS / "host_2x4_int8wire2d.json")], "2x4")):
        spec = RunSpec.from_args(argv)
        art = analysis.train_artifacts(spec, device=CPU)
        ours = {"|".join((p, ",".join(a), d)): n for (p, a, d), n in
                analysis.summed_elements(art.explicit_collectives()).items()}
        assert ours == ref[key], (key, ours, ref[key])
        assert run_rules(art) == []
