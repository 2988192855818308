"""Port parity: ``repro_torch.api`` (``RunSpec``, ``build``,
``RunContext``) against ``repro.api``, on the CPU at SMOKE size with
fixed seeds.

The checks of ``tests/test_api.py`` and the api and spec checks of
``tests/test_streaming_asr.py``, ported: every shipped spec file loads
and re-serializes to its own bytes (the reference's bytes); CLI flags
give the spec file's value; validation errors carry the reference's
messages; compression layouts and KV widths resolve as the reference
resolves them; the seed threads into init and data; two contexts with
different compute dtypes coexist; an engine keeps the configuration it
was built under; ``make_engine`` refuses its removed keywords;
``emit_pareto_specs`` writes the reference's files byte for byte; meshes
the port does not build raise.

Parity with the reference's runs (one seeded JAX init carried across
with ``weights.from_jax``, the JAX pipeline's tokens handed to both):
- training: ``build(spec).init_training()`` steps equal a hand-wired
  ``make_train_step`` + ``Trainer`` bit for bit, and the steps of
  ``repro.api.build(spec)``'s state and train step (jitted without the
  1x1 mesh's shardings) with its ``quantize`` swapped for the kernel op
  (as ``tests/test_torch_lm_train.py`` does) within that file's stated
  tolerances: loss, total and ~EBOPs relative 1e-6 at step 0 and 1e-3
  at every step;
- serving: greedy tokens of ``build(spec).make_engine`` equal
  ``repro.api``'s for ``serving_packed.json``, ``serving_kv_plan.json``
  and ``serving_asr_stream.json``;
- bf16 compute: ``HDense`` under ``PrecisionSpec(compute_dtype=
  "bfloat16")`` gives the reference's output dtype and values within
  one bf16 rounding (relative 2^-8 of the largest output: both sides
  multiply bf16 operands and round the float32 sums to bf16, in other
  summation orders); with ``packed_matmul=False`` a packed kernel gives
  the reference's dequantize-then-matmul result within 1e-6 of the
  largest output (float32 sums in other orders).
"""
import contextlib
import dataclasses
import glob
import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.api imports repro.dist)
    import repro.api as japi
    import repro.core.hgq as jhgq
    import repro.nn.attention as jattn
    from repro.core.pareto import ParetoFront as JFront
    from repro.core.plan import LayerPlan as JLayerPlan
    from repro.core.plan import PrecisionPlan as JPlan
    from repro.kernels import hgq_quantize as j_hgq_quantize
    from repro.nn.basic import HDense as JHDense
    from repro.nn.common import HGQConfig as JHGQConfig
    from repro.core.hgq import QTensor as JQTensor
    from repro.serving import AudioRequest as JAudioRequest
    from repro.serving import Request as JRequest
    from repro.serving import resolve_kv_bits as j_resolve_kv_bits
    from repro.serving.packed import pack_tree as jpack_tree

import repro_torch.api as tapi
from repro_torch.api import (AudioSpec, CompressionSpec,
                             GRAD_COMPRESSION_KINDS, MeshSpec,
                             PrecisionSpec, RunSpec, ServingSpec, build,
                             emit_pareto_specs)
from repro_torch.core import hgq
from repro_torch.core.hgq import QTensor
from repro_torch.core.pareto import ParetoFront
from repro_torch.core.plan import LayerPlan, PrecisionPlan
from repro_torch.data import DataSpec, make_pipeline
from repro_torch.dist import LocalMesh
from repro_torch.dist import perf as tperf
from repro_torch.dist.axes import get_axes
from repro_torch.nn.basic import HDense
from repro_torch.serving import (AudioRequest, Request, StreamingEngine,
                                 generate_asr, resolve_kv_bits)
from repro_torch.serving.packed import pack_tree
from repro_torch.train import TrainConfig, Trainer, lm_loss
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax

ROOT = Path(__file__).resolve().parents[1]
SPEC_DIR = ROOT / "examples" / "specs"
CPU = "cpu"


def _ctx(spec):
    return build(spec, device=CPU)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ----------------------------- spec files ----------------------------------

SPEC_FILES = sorted(os.path.basename(p)
                    for p in glob.glob(str(SPEC_DIR / "*.json")))


def test_six_spec_files_ship():
    assert len(SPEC_FILES) >= 6 and "plan_mixed_w4w8.json" in SPEC_FILES


@pytest.mark.parametrize("path", SPEC_FILES)
def test_shipped_spec_files_roundtrip_to_their_bytes(path):
    """Each shipped file loads with the port's loader (``plan_*`` files
    are bare plans) and re-serializes to the bytes on disk, which are
    also the reference loader's bytes."""
    full = str(SPEC_DIR / path)
    plan = path.startswith("plan_")
    obj = (PrecisionPlan if plan else RunSpec).from_file(full)
    ref = (JPlan if plan else japi.RunSpec).from_file(full)
    with open(full) as f:
        text = f.read()
    assert obj.to_json() == text == ref.to_json()
    assert type(obj).from_json(obj.to_json()) == obj


def test_default_spec_roundtrip_and_bytes():
    s = RunSpec()
    assert RunSpec.from_json(s.to_json()) == s
    assert RunSpec.from_dict(s.to_dict()) == s
    assert s.to_json() == japi.RunSpec().to_json()
    assert json.loads(s.to_json())["plan"] is None


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=10 ** 6),
       st.integers(min_value=1, max_value=16),
       st.integers(min_value=1, max_value=16),
       st.integers(min_value=0, max_value=len(GRAD_COMPRESSION_KINDS) - 1),
       st.integers(min_value=0, max_value=2),
       st.integers(min_value=1, max_value=4096),
       st.floats(min_value=2.0 ** -20, max_value=1.0, width=32))
def test_spec_json_roundtrip_property(seed, d, m, comp_i, dtype_i, steps,
                                      lr):
    """A random spec round-trips exactly, and its JSON is the reference's
    for the same value (the reference re-serializes the port's bytes to
    themselves)."""
    s = RunSpec(
        arch="qwen2-0.5b", seed=seed, mesh=MeshSpec.host(d, m),
        precision=PrecisionSpec(
            compute_dtype=[None, "bfloat16", "float32"][dtype_i],
            packed_serving=bool(seed % 2),
            packed_matmul=[None, True, False][dtype_i]),
        compression=CompressionSpec(kind=GRAD_COMPRESSION_KINDS[comp_i]),
        train=dataclasses.replace(RunSpec().train, steps=steps,
                                  lr=float(lr)),
        data=dataclasses.replace(RunSpec().data, batch=d * 2, seed=seed),
        plan=PrecisionPlan(layers={"layers/mlp/up/kernel":
                                   LayerPlan(wire_bits=4, pack_bits=4)})
        if seed % 3 == 0 else None)
    s2 = RunSpec.from_json(s.to_json())
    assert s2 == s and s2.to_json() == s.to_json()
    assert japi.RunSpec.from_json(s.to_json()).to_json() == s.to_json()


ARGVS = [
    [],
    ["--spec", str(SPEC_DIR / "host_2x4_int8wire2d.json")],
    ["--mesh", "2x4", "--grad-compression", "int8-wire-2d"],
    ["--spec", str(SPEC_DIR / "host_2x4_int8wire2d.json"), "--steps", "7",
     "--seed", "3"],
    ["--spec", str(SPEC_DIR / "serving_kv_plan.json"), "--full", "--batch",
     "2", "--seq", "256", "--ckpt-dir", "/ckpt", "--ckpt-every", "2"],
    ["--arch", "llama3.2-3b", "--kv-cache", "int8", "--slots", "3",
     "--compute-dtype", "bfloat16", "--production-mesh"],
    ["--multi-pod", "--compute-dtype", "none", "--plan",
     str(SPEC_DIR / "plan_mixed_w4w8.json")],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_cli_flags_give_the_references_spec(argv):
    assert RunSpec.from_args(argv).to_json() == \
        japi.RunSpec.from_args(argv).to_json()


def test_cli_flags_equal_spec_file():
    """``--spec host_2x4_int8wire2d.json`` and the classic flags give one
    value; flags override the file's fields."""
    from_flags = RunSpec.from_args(
        ["--mesh", "2x4", "--grad-compression", "int8-wire-2d"])
    from_file = RunSpec.from_args(
        ["--spec", str(SPEC_DIR / "host_2x4_int8wire2d.json")])
    assert from_flags == from_file
    over = RunSpec.from_args(
        ["--spec", str(SPEC_DIR / "host_2x4_int8wire2d.json"),
         "--steps", "7", "--seed", "3"])
    assert over.train.steps == 7 and over.seed == 3 and over.data.seed == 3
    assert over.mesh == MeshSpec.host(2, 4)
    s = RunSpec.from_args(["--plan", str(SPEC_DIR / "plan_mixed_w4w8.json")])
    assert s.plan is not None and not s.plan.is_uniform_int8
    assert s.plan.entry_for("layers/mlp/down/kernel").wire_bits == 4
    assert s.plan.entry_for("embed/table").wire_bits == 8


def _bad_values(m):
    """Constructions the reference refuses, built with the module ``m``
    (``repro.api`` or ``repro_torch.api``)."""
    return [
        lambda: m.RunSpec.from_dict({"archh": "x"}),
        lambda: m.RunSpec.from_dict({"mesh": {"rows": 2}}),
        lambda: m.RunSpec.from_dict({"serving": {"slotss": 2}}),
        lambda: m.RunSpec.from_dict({"plan": {"default": {"bits": 3}}}),
        lambda: m.MeshSpec(kind="ring"),
        lambda: m.MeshSpec(data=0),
        lambda: m.MeshSpec(pods=2),
        lambda: m.PrecisionSpec(compute_dtype="fp8"),
        lambda: m.CompressionSpec(kind="topk"),
        lambda: m.CompressionSpec(fused=1),
        lambda: m.CompressionSpec(wire_layout="3d"),
        lambda: m.CompressionSpec(residual_layout="ring"),
        lambda: m.CompressionSpec(kind="int8-wire-2d", wire_layout="1d"),
        lambda: m.AudioSpec(chunk_frames=-1),
        lambda: m.AudioSpec(max_frames=-2),
        lambda: m.ServingSpec(slots=0),
        lambda: m.ServingSpec(ring_slack=-1),
        lambda: m.ServingSpec(kv_cache="int4"),
        lambda: m.ServingSpec(packed=1),
        lambda: m.ServingSpec(workloads=()),
        lambda: m.ServingSpec(workloads=("lm", "tts")),
        lambda: m.ServingSpec(workloads=("lm", "lm")),
        lambda: m.ServingSpec(audio=m.AudioSpec(chunk_frames=4)),
        lambda: m.ServingSpec(workloads=("asr",), audio={"chunkz": 3}),
        lambda: m.LayerPlan(wire_bits=3),
    ]


@pytest.mark.parametrize("i", range(len(_bad_values(japi))))
def test_validation_errors_carry_the_references_messages(i):
    with pytest.raises(ValueError) as ours:
        _bad_values(tapi)[i]()
    with pytest.raises(ValueError) as theirs:
        _bad_values(japi)[i]()
    assert str(ours.value) == str(theirs.value)


def test_serving_spec_workloads_and_packed_resolution():
    assert ServingSpec().workloads == ("lm",)
    assert ServingSpec(workloads=["lm", "asr"]).audio == AudioSpec()
    assert ServingSpec(workloads=("asr",),
                       audio={"chunk_frames": 3}).audio.chunk_frames == 3
    assert not ServingSpec().resolved_packed(PrecisionSpec())
    assert ServingSpec().resolved_packed(PrecisionSpec(packed_serving=True))
    assert not ServingSpec(packed=False).resolved_packed(
        PrecisionSpec(packed_serving=True))
    for ps, pm in ((False, None), (True, None), (True, False),
                   (False, True)):
        assert PrecisionSpec(packed_serving=ps, packed_matmul=pm) \
            .packed_kernels == japi.PrecisionSpec(
                packed_serving=ps, packed_matmul=pm).packed_kernels
    s = RunSpec.from_args(["--kv-cache", "int8", "--slots", "3"])
    assert s.serving.kv_cache == "int8" and s.serving.slots == 3


# ------------------------------ resolution ---------------------------------

def test_compression_layout_resolution_matches_reference():
    for kind in GRAD_COMPRESSION_KINDS:
        for wl in ("auto", "1d", "2d"):
            for rl in ("auto", "1d", "2d"):
                if kind == "int8-wire-2d" and wl == "1d":
                    continue
                c = CompressionSpec(kind=kind, wire_layout=wl,
                                    residual_layout=rl)
                j = japi.CompressionSpec(kind=kind, wire_layout=wl,
                                         residual_layout=rl)
                assert (c.is_wire, c.wire_kind) == (j.is_wire, j.wire_kind)
                for n_model in (1, 4):
                    assert c.resolved_wire_layout(n_model) == \
                        j.resolved_wire_layout(n_model)
                    assert c.resolved_residual_layout(n_model) == \
                        j.resolved_residual_layout(n_model)


def test_kv_cache_resolution_matches_reference():
    plans = [None, PrecisionPlan(),
             PrecisionPlan(layers={"layers/attn/wk/kernel":
                                   LayerPlan(kv_bits=4)}),
             PrecisionPlan(default=LayerPlan(kv_bits=5)),
             PrecisionPlan.from_file(str(SPEC_DIR / "plan_mixed_w4w8.json")),
             RunSpec.from_file(str(SPEC_DIR / "serving_kv_plan.json")).plan]
    for plan in plans:
        jplan = None if plan is None else JPlan.from_json(plan.to_json())
        for mode in ("fp", "int8", "plan"):
            assert resolve_kv_bits(mode, plan) == \
                j_resolve_kv_bits(mode, jplan)
    assert resolve_kv_bits("plan", plans[2]) == 4
    # a kv-only plan is wire/pack-uniform: build() resolves ctx.plan to
    # None, and make_engine reads the kv width of the plan as given
    ctx = _ctx(RunSpec(plan=plans[2], serving=ServingSpec(
        slots=2, kv_cache="plan")))
    assert ctx.plan is None
    p, q = ctx.init_state()
    assert ctx.make_engine(p, q, max_len=32).kv_bits == 4
    assert plans[2].kv_bits_for("layers/attn/wk/kernel/w") == 4
    assert plans[2].kv_bits_for("layers/attn/wq/kernel/w") == 8


def test_uniform_plan_resolves_to_none_and_summary():
    assert _ctx(RunSpec()).plan is None
    assert _ctx(RunSpec(plan=PrecisionPlan())).plan is None
    mixed = PrecisionPlan(layers={"x": LayerPlan(wire_bits=4)})
    ctx = _ctx(RunSpec(plan=mixed))
    assert ctx.plan is mixed
    assert ctx.plan_summary() == mixed.summary() == \
        JPlan(layers={"x": JLayerPlan(wire_bits=4)}).summary()
    assert _ctx(RunSpec()).plan_summary() is None
    golden = SPEC_DIR / "plan_mixed_w4w8.json"
    assert PrecisionPlan.from_file(str(golden)).summary() == \
        JPlan.from_file(str(golden)).summary()


def test_plan_save_and_sweep_plans(tmp_path):
    from repro.core.plan import sweep_plans as j_sweep_plans
    from repro_torch.core.plan import sweep_plans
    plan = PrecisionPlan.from_file(str(SPEC_DIR / "plan_mixed_w4w8.json"))
    plan.save(str(tmp_path / "p.json"))
    assert (tmp_path / "p.json").read_text() == \
        (SPEC_DIR / "plan_mixed_w4w8.json").read_text()
    front, jfront = ParetoFront("max"), JFront("max")
    for metric, ebops, step, pay in ((0.9, 100.0, 1, plan),
                                     (0.95, 300.0, 2, "ckpt"),
                                     (0.5, 50.0, 3, None)):
        front.offer(metric, ebops, step, pay)
        jfront.offer(metric, ebops, step,
                     JPlan.from_json(pay.to_json())
                     if isinstance(pay, PrecisionPlan) else pay)
    rows, jrows = sweep_plans(front), j_sweep_plans(jfront)
    assert [r[:3] for r in rows] == [r[:3] for r in jrows]
    assert [None if r[3] is None else r[3].to_json() for r in rows] == \
        [None if r[3] is None else r[3].to_json() for r in jrows]


def test_emit_pareto_specs_writes_the_references_files(tmp_path):
    base, jbase = RunSpec(), japi.RunSpec()
    front, jfront = ParetoFront("max"), JFront("max")
    for i, (metric, ebops, step) in enumerate(((0.9, 100.0, 10),
                                               (0.95, 300.0, 20),
                                               (0.5, 50.0, 30))):
        plan = PrecisionPlan(layers={"layers/mlp/up/kernel": LayerPlan(
            wire_bits=4 + i, pack_bits=4 + i)})
        pay = plan if i != 1 else "not a plan"
        front.offer(metric, ebops, step, pay)
        jfront.offer(metric, ebops, step,
                     JPlan.from_json(plan.to_json()) if i != 1 else pay)
    ours = emit_pareto_specs(front, base, str(tmp_path / "ours"))
    theirs = japi.emit_pareto_specs(jfront, jbase, str(tmp_path / "ref"))
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs] and len(ours) == 2
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "ref"))
    for n in names:
        assert (tmp_path / "ours" / n).read_bytes() == \
            (tmp_path / "ref" / n).read_bytes(), n
    assert RunSpec.from_file(ours[0]).plan is not None


def test_build_refuses_the_meshes_the_port_lacks():
    # the 2 x 4 data x model mesh is built (a LocalMesh of 8 ranks) and
    # trains over the 2D sliced exchange; only production meshes raise
    two = build(RunSpec.from_args(
        ["--spec", str(SPEC_DIR / "host_2x4_int8wire2d.json")]), device=CPU)
    assert isinstance(two.mesh, LocalMesh)
    assert two.mesh.axis_sizes == (2, 4) and two.n_data == 2
    assert two.n_model == 4 and two.axes.model_size == 4
    comp = two.grad_compression()
    assert comp.wire and comp.wire_layout == "2d"
    setup = two.init_training()
    res = tree_leaves(setup.ef_state.residual)
    assert all(r.shape[:2] == (2, 4) for r in res)
    sh, donate = two.train_shardings(setup.params, setup.qstate, setup.opt,
                                     setup.ef_state, comp)
    assert donate == (0, 2, 5)
    assert all(tuple(x.spec) == ("data", "model", None)
               for x in tree_leaves(sh[5].residual))
    assert tuple(sh[3]["tokens"].spec) == ("data", None)
    assert tuple(sh[4].spec) == ()
    assert any("model" in x.spec for x in tree_leaves(sh[0]))
    losses = [float(setup.step(s)["loss"]) for s in range(2)]
    assert all(np.isfinite(losses))
    assert any(r.any() for r in tree_leaves(setup.ef_state.residual))
    with pytest.raises(NotImplementedError, match="--chips N"):
        build(RunSpec(mesh=MeshSpec.production()), device=CPU)
    with pytest.raises(NotImplementedError, match="--chips N"):
        build(RunSpec(mesh=MeshSpec.production(multi_pod=True)),
              device=CPU)
    ctx = _ctx(RunSpec(mesh=MeshSpec.host(4, 1)))
    assert ctx.mesh.size == 4 and ctx.n_data == 4 and ctx.n_model == 1
    assert ctx.axes.data_size == 4 and ctx.axes.model_size == 1
    assert _ctx(RunSpec()).mesh is None


# ------------------------------- seeding -----------------------------------

def test_seed_threads_into_init_and_data():
    ctx0 = _ctx(RunSpec())
    ctx3 = _ctx(RunSpec.from_args(["--seed", "3"]))
    p0, _ = ctx0.init_state()
    p3, _ = ctx3.init_state()
    assert any(not torch.equal(a, b)
               for a, b in zip(tree_leaves(p0), tree_leaves(p3)))
    b0 = ctx0.make_pipeline()(0)["tokens"]
    b3 = ctx3.make_pipeline()(0)["tokens"]
    assert not torch.equal(b0, b3)
    p0b, _ = _ctx(RunSpec()).init_state()
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(p0), tree_leaves(p0b)))


def test_asr_pipeline_shapes():
    spec = RunSpec.from_file(str(SPEC_DIR / "serving_asr_stream.json"))
    ctx = _ctx(spec)
    batch = ctx.make_pipeline()(0)
    assert batch["frame_embeds"].shape == (
        spec.data.batch, ctx.cfg.enc_seq, ctx.cfg.d_model)
    assert batch["tokens"].shape == (spec.data.batch, spec.data.seq)
    assert torch.equal(batch["tokens"], ctx.make_pipeline()(0)["tokens"])
    with pytest.raises(ValueError, match="d_model"):
        make_pipeline(DataSpec(kind="asr", batch=1, seq=4, vocab=8),
                      device=CPU)


# --------------------------- contexts coexist -------------------------------

def test_two_contexts_do_not_perturb_each_other():
    ctx_fp = _ctx(RunSpec())
    ctx_bf = _ctx(RunSpec(precision=PrecisionSpec(compute_dtype="bfloat16")))
    f = lambda x: tperf.cast_for_matmul(x).to(torch.float32) * 3.0
    fp, bf = ctx_fp.wrap(f), ctx_bf.wrap(f)
    x = torch.tensor([1.0, 1.0 + 2.0 ** -12, -0.3])
    y_fp1, y_bf1, y_fp2, y_bf2 = fp(x), bf(x), fp(x), bf(x)
    assert torch.equal(y_fp1, y_fp2) and torch.equal(y_bf1, y_bf2)
    # the bf16 context cast (1 + 2^-12 rounds away), the fp one did not
    assert float(y_fp1[1]) != float(y_bf1[1])
    with ctx_bf.activate():
        assert tperf.get_compute_dtype() == torch.bfloat16
        with ctx_fp.activate():
            assert tperf.get_compute_dtype() is None
        assert tperf.get_packed_matmul() is False
    assert tperf.get_compute_dtype() is None
    # unset, the packed routing is the kernel's
    assert tperf.get_packed_matmul() is True
    assert get_axes().data_size == 1


def test_two_contexts_training_isolated():
    """Steps of an fp32 and a bf16-compute spec interleave without either
    moving the other: the interleaved run equals an isolated one bit for
    bit, and bf16 compute is another computation."""
    spec = dataclasses.replace(
        RunSpec(), train=dataclasses.replace(RunSpec().train, steps=3),
        data=dataclasses.replace(RunSpec().data, batch=2, seq=8))
    sa = _ctx(spec).init_training()
    sb = _ctx(dataclasses.replace(spec, precision=PrecisionSpec(
        compute_dtype="bfloat16"))).init_training()
    ma0 = float(sa.step(0)["loss"])
    mb0 = float(sb.step(0)["loss"])
    sb.step(1)
    ma1 = {k: float(v) for k, v in sa.step(1).items()}
    iso = _ctx(spec).init_training()
    iso.step(0)
    ma1_iso = {k: float(v) for k, v in iso.step(1).items()}
    assert ma1 == ma1_iso
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((sa.params, sa.qstate, sa.opt)),
        tree_leaves((iso.params, iso.qstate, iso.opt))))
    assert ma0 != mb0


# ------------------------------ the engine ----------------------------------

def test_engine_snapshot_isolated_from_later_scopes():
    """An engine keeps decoding the same tokens while another context's
    scope is active: its snapshot, not the ambient scope, governs it."""
    spec = RunSpec(arch="qwen2-0.5b", serving=ServingSpec(slots=2))
    ctx = _ctx(spec)
    params, qstate = ctx.init_state()
    eng = ctx.make_engine(params, qstate, max_len=32)
    r1 = Request(prompt=[3, 1, 4, 1], max_new=5)
    eng.run([r1])
    ctx_bf = _ctx(dataclasses.replace(
        spec, precision=PrecisionSpec(compute_dtype="bfloat16")))
    with ctx_bf.activate():
        r2 = Request(prompt=[3, 1, 4, 1], max_new=5)
        eng.run([r2])
    assert r1.out == r2.out
    # and the other way round: an engine built under bf16 keeps it
    eng_bf = ctx_bf.make_engine(params, qstate, max_len=32)
    assert eng._compute_dtype is None
    assert eng_bf._compute_dtype == torch.bfloat16
    r3, r4 = (Request(prompt=[3, 1, 4, 1], max_new=5) for _ in range(2))
    eng_bf.run([r3])
    with ctx.activate():
        eng_bf.run([r4])
    assert r3.out == r4.out


def test_make_engine_removed_kwargs_rejected():
    ctx = _ctx(RunSpec(arch="qwen2-0.5b", serving=ServingSpec(slots=4)))
    params, qstate = ctx.init_state()
    for kw, field in (("batch_slots", "serving.slots"),
                      ("packed", "serving.packed"),
                      ("plan", "RunSpec.plan")):
        with pytest.raises(TypeError, match=field.replace(".", r"\.")):
            ctx.make_engine(params, qstate, max_len=32, **{kw: 2})
    eng = ctx.make_engine(params, qstate, max_len=32)
    assert eng.slots == 4 and eng.device == torch.device(CPU)


def test_spec_routing_builds_streaming_engine():
    """The golden ASR spec routes through ``make_engine`` to a
    ``StreamingEngine`` with the spec's audio chunk and plan KV width;
    streamed tokens equal ``generate_asr``'s."""
    spec = RunSpec.from_file(str(SPEC_DIR / "serving_asr_stream.json"))
    assert spec.serving.workloads == ("lm", "asr")
    ctx = _ctx(spec)
    params, qstate = ctx.init_state()
    eng = ctx.make_engine(params, qstate, max_len=32)
    assert isinstance(eng, StreamingEngine)
    assert eng.audio_chunk == spec.serving.audio.chunk_frames
    assert eng.kv_bits == 4 and eng.max_frames == ctx.cfg.enc_seq
    frames = _frames(ctx.cfg.d_model, ctx.cfg.enc_seq)
    req = AudioRequest(frames=frames, prompt=[1, 2], max_new=4)
    eng.run([req])
    ref = generate_asr(ctx.model, params, qstate, ctx.cfg, frames, [1, 2],
                       4, chunk=eng.audio_chunk, cache_len=32,
                       kv_bits=eng.kv_bits, device=CPU)
    assert req.out == ref[0].tolist()


# --------------------------- parity: training -------------------------------

TRAIN_STEPS = 3
TRAJ_LIMIT = 1e-3


def _train_spec():
    """``host_1x1.json`` at 3 steps, batch 2, seq 16."""
    return RunSpec.from_args(["--spec", str(SPEC_DIR / "host_1x1.json"),
                              "--steps", str(TRAIN_STEPS), "--batch", "2",
                              "--seq", "16"])


def test_init_training_equals_hand_wired_trainer():
    """``build(spec).init_training()`` steps == ``make_train_step`` +
    ``Trainer`` wired by hand from the same TrainConfig, init and data:
    params, qstate and AdamW state bit for bit."""
    from repro_torch.configs import get
    from repro_torch.models import TransformerLM
    spec = _train_spec()
    setup = _ctx(spec).init_training()
    for s in range(TRAIN_STEPS):
        setup.step(s)
    cfg = get(spec.arch, smoke=True)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(spec.seed)
    p, q = TransformerLM.init(gen, cfg, device=CPU)
    tr = Trainer(lambda p, q, b, mode: TransformerLM.forward(p, q, b, cfg,
                                                             mode),
                 lambda out, b: lm_loss(out, b["tokens"]),
                 TrainConfig(**dataclasses.asdict(spec.train)), p, q,
                 pipeline=make_pipeline(dataclasses.replace(
                     spec.data, vocab=cfg.vocab), device=CPU))
    tr.run(log=lambda *a: None)
    a = tree_leaves((setup.params, setup.qstate, setup.opt))
    b = tree_leaves((tr.params, tr.qstate, tr.opt))
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _kernel_op(x, f):
    """The JAX kernel op, a per-channel f of shape (1, ..., 1, N) handed
    over as (N,) (``tests/test_torch_lm_train.py``)."""
    if 1 < f.ndim and f.shape != x.shape and set(f.shape[:-1]) == {1}:
        return j_hgq_quantize(x, f.reshape(-1))
    return j_hgq_quantize(x, f)


def test_init_training_matches_reference_api(monkeypatch):
    monkeypatch.setattr(jhgq, "quantize", _kernel_op)
    monkeypatch.setattr(jattn, "quantize", _kernel_op)
    spec = _train_spec()
    jctx = japi.build(japi.RunSpec.from_json(spec.to_json()))
    jsetup = jctx.init_training()
    setup = _ctx(spec).init_training()
    setup.params, setup.qstate = from_jax(_np(jsetup.params),
                                          _np(jsetup.qstate), device=CPU)
    from repro_torch.optim import adamw_init
    setup.opt = adamw_init(setup.params)
    setup.pipeline = lambda s: {"tokens": torch.from_numpy(np.asarray(
        jsetup.pipeline(s)["tokens"]).astype(np.int64))}
    # the reference context's step, jitted without the 1x1 mesh's
    # shardings (the kernel op runs in interpret mode, which refuses the
    # mesh's explicit shardings; on one device they place nothing)
    jstep = jax.jit(jctx.make_train_step())
    jp, jq, jopt = jsetup.params, jsetup.qstate, jsetup.opt
    for s in range(TRAIN_STEPS):
        jp, jq, jopt, jm = jstep(jp, jq, jopt, jsetup.pipeline(s),
                                 jnp.int32(s))
        jm = {k: float(v) for k, v in jm.items()}
        tm = {k: float(v) for k, v in setup.step(s).items()}
        lim = 1e-6 if s == 0 else TRAJ_LIMIT
        for k in ("loss", "total", "ebops"):
            assert _rel(tm[k], jm[k]) < lim, (s, k, tm[k], jm[k])


# ---------------------------- parity: serving -------------------------------

def _frames(d, T, seed=9):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (T, d))).astype(np.float32)


def _serve_both(name, make_reqs, max_len=32, chunk=4):
    spec = RunSpec.from_file(str(SPEC_DIR / name))
    jctx = japi.build(japi.RunSpec.from_file(str(SPEC_DIR / name)))
    p, q = jctx.init_state()
    tp, tq = from_jax(_np(p), _np(q), device=CPU)
    ctx = _ctx(spec)
    treqs, jreqs = make_reqs(AudioRequest, Request), \
        make_reqs(JAudioRequest, JRequest)
    eng = ctx.make_engine(tp, tq, max_len=max_len, prefill_chunk=chunk)
    eng.run(treqs)
    jctx.make_engine(p, q, max_len=max_len, prefill_chunk=chunk).run(jreqs)
    assert all(r.done for r in treqs + jreqs)
    return eng, [r.out for r in treqs], [r.out for r in jreqs]


def _lm(Req, vocab, lens=(4, 8, 4), max_new=4, seed=7):
    rng = np.random.default_rng(seed)
    return [Req(prompt=[int(t) for t in rng.integers(1, vocab, n)],
                max_new=max_new) for n in lens]


@pytest.mark.parametrize("name", ["serving_packed.json",
                                  "serving_kv_plan.json"])
def test_make_engine_tokens_match_reference(name):
    spec = RunSpec.from_file(str(SPEC_DIR / name))
    vocab = _ctx(spec).cfg.vocab
    eng, ours, theirs = _serve_both(name, lambda A, R: _lm(R, vocab))
    assert eng.packed and eng.slots == spec.serving.slots
    assert eng.kv_bits == (4 if spec.serving.kv_cache == "plan" else None)
    assert ours == theirs


def test_asr_spec_engine_tokens_match_reference():
    spec = RunSpec.from_file(str(SPEC_DIR / "serving_asr_stream.json"))
    cfg = _ctx(spec).cfg

    def make(A, R):
        return [A(frames=_frames(cfg.d_model, cfg.enc_seq, seed=40),
                  prompt=[1, 2], max_new=4),
                _lm(R, cfg.vocab, lens=(2,), max_new=3)[0]]

    eng, ours, theirs = _serve_both("serving_asr_stream.json", make)
    assert isinstance(eng, StreamingEngine)
    assert ours == theirs


# ------------------------- parity: precision knobs --------------------------

def _dense(bias=True):
    """One HDense (32 -> 24, per-channel weights) from a seeded JAX init,
    its port twin, and an input."""
    jcfg = JHGQConfig()
    jp, jq = JHDense.init(jax.random.PRNGKey(3), 32, 24, jcfg, bias=bias,
                          out_q=False)
    tp, tq = from_jax(_np(jp), _np(jq), device=CPU)
    x = np.random.default_rng(4).standard_normal((5, 32)).astype(np.float32)
    return jp, jq, tp, tq, x


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_bf16_compute_hdense_matches_reference(x_dtype):
    jp, jq, tp, tq, x = _dense()
    spec = RunSpec(precision=PrecisionSpec(compute_dtype="bfloat16"))
    jctx = japi.build(japi.RunSpec.from_json(spec.to_json()))
    ctx = _ctx(spec)
    jx = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    with jctx.activate():
        jy, _ = JHDense.apply(jp, jq, JQTensor(jx, None), mode="eval",
                              aux=jhgq.Aux.zero())
    with ctx.activate():
        ty, _ = HDense.apply(tp, tq, QTensor(tx, None), mode=hgq.EVAL,
                             aux=hgq.Aux.zero(CPU))
    assert str(ty.q.dtype).split(".")[-1] == str(jy.q.dtype) == x_dtype
    a = ty.q.float().numpy()
    b = np.asarray(jy.q.astype(jnp.float32))
    assert np.abs(a - b).max() <= 2.0 ** -8 * np.abs(b).max()
    # the bf16 cast is real: float32 compute gives another result
    with _ctx(RunSpec()).activate():
        t32, _ = HDense.apply(tp, tq, QTensor(tx.float(), None),
                              mode=hgq.EVAL, aux=hgq.Aux.zero(CPU))
    assert not torch.equal(t32.q, ty.q.float())


def test_packed_matmul_off_dequantizes_as_reference():
    jp, jq, tp, tq, x = _dense()
    jpk, tpk = jpack_tree(jp), pack_tree(tp)
    spec = RunSpec(precision=PrecisionSpec(packed_serving=True,
                                           packed_matmul=False))
    jctx = japi.build(japi.RunSpec.from_json(spec.to_json()))
    ctx = _ctx(spec)
    assert not spec.precision.packed_kernels
    with jctx.activate():
        jy, _ = JHDense.apply(jpk, jq, JQTensor(jnp.asarray(x), None),
                              mode="eval", aux=jhgq.Aux.zero())
    with ctx.activate():
        ty, _ = HDense.apply(tpk, tq, QTensor(torch.from_numpy(x), None),
                             mode=hgq.EVAL, aux=hgq.Aux.zero(CPU))
    b = np.asarray(jy.q)
    assert np.abs(ty.q.numpy() - b).max() <= 1e-6 * np.abs(b).max()
    # off: x @ unpack_weight + the bias, exactly; on: the qmatmul route
    want = torch.from_numpy(x) @ tperf.unpack_weight(tpk["kernel"]) \
        + tp["bias"]["w"]
    assert torch.equal(ty.q, want)
    with ctx.activate(packed=True):
        on, _ = HDense.apply(tpk, tq, QTensor(torch.from_numpy(x), None),
                             mode=hgq.EVAL, aux=hgq.Aux.zero(CPU))
    assert torch.allclose(on.q, ty.q, rtol=0, atol=1e-5)


def test_unset_packed_routing_takes_the_kernel(monkeypatch):
    """With no scope a packed weight goes through ``qmatmul_any``; the
    plain route is taken only where a scope turns the routing off.  An
    engine keeps the routing in scope at its construction."""
    import repro_torch.models.lm as tlm
    import repro_torch.nn.basic as tbasic
    calls = [0]

    def counting(real):
        def f(*a, **k):
            calls[0] += 1
            return real(*a, **k)
        return f

    monkeypatch.setattr(tbasic, "qmatmul_any", counting(tbasic.qmatmul_any))
    monkeypatch.setattr(tlm, "qmatmul_any", counting(tlm.qmatmul_any))
    _, _, tp, tq, x = _dense()
    tpk = pack_tree(tp)

    def apply():
        return HDense.apply(tpk, tq, QTensor(torch.from_numpy(x), None),
                            mode=hgq.EVAL, aux=hgq.Aux.zero(CPU))[0].q

    unset = apply()
    assert calls[0] == 1
    with tperf.packed_matmul(True):
        assert torch.equal(apply(), unset)
    assert calls[0] == 2
    with tperf.packed_matmul(False):
        off = apply()
    assert calls[0] == 2 and off.shape == unset.shape

    spec = RunSpec(arch="qwen2-0.5b", serving=ServingSpec(slots=2))
    ctx = _ctx(spec)
    params, qstate = ctx.init_state()
    pp, qq = pack_tree(params), qstate
    cfg = ctx.cfg
    from repro_torch.models import TransformerLM
    from repro_torch.serving import Engine
    outs = {}
    for name, route in (("unset", None), ("off", False)):
        scope = (tperf.packed_matmul(route) if route is not None
                 else contextlib.nullcontext())
        with scope:
            eng = Engine(TransformerLM, pp, qq, cfg, batch_slots=2,
                         max_len=32, device=CPU)
        calls[0] = 0
        # run under the opposite routing: the snapshot governs
        with tperf.packed_matmul(route is not False):
            r = Request(prompt=[3, 1, 4, 1], max_new=3)
            eng.run([r])
        outs[name] = (calls[0], r.out)
    assert outs["unset"][0] > 0 and outs["off"][0] == 0
