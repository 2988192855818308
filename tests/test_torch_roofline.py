"""``repro_torch.launch.roofline``: the H100's constants, the terms, and
one count of work whatever implements the port's kernel ops.

* On the CPU each kernel op's formula counts what its plain body's ATen
  operations count (FLOPs), for a SMOKE packed decode tick (``qmatmul``,
  the KV store and ``kv_attention_rows``), the jet tagger's step and a
  SMOKE LM train step (the ``hgq_quantize`` forward and backward).
* The count of the SMOKE ``host_1x1.json`` train step equals the
  reference's ``analytic_flops_total`` exactly, and the reference's
  ``parse_dot_flops`` of the same step's compiled HLO within 2.5%: XLA
  leaves out 1.96% of the remat recompute (measured: 70189056 against
  71565312 FLOPs at batch 4, seq 32).
* ``chip_smoke.py`` keeps no peaks of its own: its bound is this
  module's, with the values every kernel row's bound was computed with.
"""
import importlib.util
import sys
import warnings
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import ProgramTrace
from repro_torch.api import RunSpec, build
from repro_torch.configs import ShapeSpec, get
from repro_torch.data import DataSpec, make_pipeline
from repro_torch.launch import roofline
from repro_torch.launch.analytic import analytic_flops_total
from repro_torch.models import JetTagger
from repro_torch.nn import HGQConfig
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train import losses as tlosses

ROOT = Path(__file__).resolve().parents[1]
SPECS = ROOT / "examples" / "specs"
CPU = "cpu"
REF_HLO_REL = 0.025


def test_constants_are_the_h100_sheet():
    assert roofline.PEAK_FLOPS["bfloat16"] == 989e12
    assert roofline.PEAK_FLOPS["tf32"] == 495e12
    assert roofline.PEAK_FLOPS["float32"] == 67e12
    assert roofline.PEAK_FLOPS["int8"] == 1979e12
    assert roofline.HBM_BW == 3.35e12 and roofline.HBM_BYTES == 80e9
    assert roofline.NVLINK_BW == 450e9 and not roofline.NVLINK_VERIFIED


def test_chip_smoke_bound_is_the_roofline_bound(monkeypatch):
    """The same values as the script's own constants before: 3.35e12 B/s,
    67e12 float32 and 989e12 bf16 operations a second."""
    spec = importlib.util.spec_from_file_location("chip_smoke_mod",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, cs)
    spec.loader.exec_module(cs)
    assert not [n for n in vars(cs) if n.startswith("PEAK_")]
    for nbytes, flops in ((1e9, 1e12), (1e6, 1e12), (3e9, 0.0)):
        old = max(nbytes / 3.35e12, flops / 67e12) * 1e3
        assert cs.bound(nbytes, flops)[0] == old
        old_bf = max(nbytes / 3.35e12, flops / 989e12) * 1e3
        assert cs.bound(nbytes, flops, cs.peak_rate("bfloat16"))[0] == old_bf
    assert cs.bound(1e9, 0.0)[1] == "bytes"
    assert cs.bound(1.0, 1e12)[1] == "operations"


def test_terms_and_mfu():
    t = roofline.RooflineTerms(
        flops=2e12, hbm_bytes=3.35e9, coll_bytes=None, coll_breakdown={},
        chips=1, flops_by_dtype={"float32": 1e12, "bfloat16": 1e12})
    assert t.t_compute == pytest.approx(1e12 / 67e12 + 1e12 / 989e12)
    assert t.t_memory == pytest.approx(1e-3)
    assert t.t_collective is None and t.bottleneck == "compute"
    d = t.as_dict()
    assert d["t_collective_s"] is None and d["chips"] == 1
    assert set(d["peak_flops_per_s"]) == {"float32", "bfloat16"}
    assert roofline.mfu(1e12, t) == pytest.approx(
        1e12 / (roofline.PEAK_FLOPS[t.dtype] * t.t_compute))
    c = roofline.RooflineTerms(flops=0.0, hbm_bytes=0.0, coll_bytes=9e9,
                               coll_breakdown={}, chips=2)
    assert c.t_collective == 9e9 / 450e9 and c.bottleneck == "collective"


def _both(run):
    """(FLOPs by formula, FLOPs of the plain bodies) of two runs of
    ``run``."""
    out = []
    for formulas in (True, False):
        with ProgramTrace(formulas=formulas) as tr:
            run()
        out.append(tr)
    return out


def test_decode_tick_formulas_equal_plain_bodies():
    spec = RunSpec.from_file(str(SPECS / "serving_kv_plan.json"))
    ctx = build(spec, device=CPU)
    params, qstate = ctx.init_state()
    eng = ctx.make_engine(params, qstate, max_len=32)
    form, plain = _both(lambda: eng.decode_program())
    assert {"qmatmul", "kv_attention_rows", "kv_quantize_store"} <= set(
        form.kernel_ops)
    assert form.flops == plain.flops > 0
    assert form.kernel_ops == plain.kernel_ops


def test_jet_step_formulas_equal_plain_bodies():
    g = torch.Generator().manual_seed(0)
    p, q = JetTagger.init(g, HGQConfig(weight_gran="per_parameter",
                                       act_gran="per_parameter"),
                          device=CPU)
    step = make_train_step(
        lambda p_, q_, b, mode: JetTagger.forward(p_, q_, b, mode),
        lambda o, b: tlosses.softmax_xent(o, b["y"]), TrainConfig())
    from repro_torch.optim import adamw_init
    opt = adamw_init(p)
    batch = make_pipeline(DataSpec(kind="jet", batch=64), device=CPU)(0)
    form, plain = _both(lambda: step(p, q, opt, batch, 0))
    assert form.kernel_ops["hgq_quantize_bwd"] > 0
    assert form.flops == plain.flops > 0


def test_lm_step_formulas_equal_plain_bodies():
    setup = build(RunSpec.from_args(
        ["--spec", str(SPECS / "host_1x1.json"), "--batch", "2", "--seq",
         "16"]), device=CPU).init_training()
    form, plain = _both(lambda: setup.step(0))
    assert form.kernel_ops["hgq_quantize_bwd"] > 0
    assert form.flops == plain.flops > 0
    assert roofline.program_flops(setup.step, 1) == form.flops


def test_count_against_the_reference_hlo():
    """The SMOKE ``host_1x1.json`` step (batch 4, seq 32): the port's count
    equals ``analytic_flops_total``; the reference's parse of its compiled
    HLO is within ``REF_HLO_REL`` of both."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.analysis import train_step_hlo
        from repro.api import RunSpec as JRunSpec
        from repro.launch.roofline import parse_dot_flops
    text = (SPECS / "host_1x1.json").read_text()
    setup = build(RunSpec.from_json(text), device=CPU).init_training()
    ours = roofline.program_flops(setup.step, 0)
    analytic = analytic_flops_total(get("qwen2-0.5b", smoke=True),
                                    ShapeSpec("t", 32, 4, "train"))
    ref = parse_dot_flops(train_step_hlo(JRunSpec.from_json(text)))
    assert ours == analytic
    assert abs(ref - ours) <= REF_HLO_REL * ours, (ref, ours)


def test_collective_bytes_of_a_record():
    from repro_torch.analysis import ExplicitCollective
    rec = [ExplicitCollective("all_to_all", ("data",), "int8", (2, 100)),
           ExplicitCollective("pmax", ("data",), "float32", (7,)),
           ExplicitCollective("all_to_all", ("data",), "int8", (2, 50))]
    assert roofline.collective_bytes(rec) == {"all_to_all": 300.0,
                                              "pmax": 28.0}
