"""Port parity: data-parallel quantization-aware training of the jet tagger
over the compressed gradient wire (``reduce="compressed"``), post-reduce
error feedback (``grad_tx``) and the EF state in checkpoints, against the
JAX package.

The JAX reference is its own compressed step (``train/loop.py``
``_make_compressed_step``) on one JAX device, with two swaps made in the
test and nothing on disk changed: ``repro.core.hgq.quantize`` becomes the
kernel op ``repro.kernels.hgq_quantize`` (Eq. 4's exact grid, as the port
lands on), and ``collectives.ef_wire_pmean`` becomes
``simulate_wire_pmean``, which the JAX package's own 8-device tests hold
equal to the shard_map collective bit for bit.  A stand-in mesh object
tells the step it has 4 data shards.  The port runs on a
``dist.LocalMesh(4)`` on the CPU.

Tolerance of the 20-step trajectory at batch 256 over 4 shards: loss
relative 1e-5 and ~EBOPs relative 1e-4 at every step (read: 2.4e-7 and
1.7e-6 at most).  The forward is exact on both sides,
the gradient sums differ in the last ulps (XLA and PyTorch sum in other
orders), and the wire quantizer turns an ulp that crosses a rounding
boundary into a whole grid step of one gradient element; AdamW then
normalizes that element's update.  Step 0 (before any update) agrees to
1e-6."""
import types
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.train imports repro.dist)
    import repro.core.hgq as jhgq
    from repro.core import plan as jplan
    from repro.data import jet_batch as j_jet_batch
    from repro.dist import EFState as JEFState
    from repro.dist import collectives as jcoll
    from repro.kernels import hgq_quantize as j_hgq_quantize
    from repro.models import JetTagger as JJet
    from repro.nn import HGQConfig as JCfg
    from repro import optim as joptim
    from repro.train import losses as jlosses
    from repro.train import loop as jloop

from repro_torch import optim as toptim
from repro_torch.core import plan as tplan
from repro_torch.core.hgq import ActState
from repro_torch.data import DataSpec, make_pipeline
from repro_torch.dist import (EFState, LocalMesh, ef_compress, ef_init,
                              ef_wire_init)
from repro_torch.models import JetTagger
from repro_torch.nn import HGQConfig
from repro_torch.train import TrainConfig, Trainer, checkpoint as tckpt
from repro_torch.train import losses as tlosses
from repro_torch.train import make_train_step
from repro_torch.train.loop import _merge_sliced_qstate
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax

QCFG = dict(weight_gran="per_parameter", act_gran="per_parameter",
            init_weight_f=2.0, init_act_f=2.0)
TCFG = dict(steps=20, lr=3e-3, beta0=1e-6, beta1=1e-3, gamma=2e-6)
N = 4


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fwd(p, q, b, mode):
    return JetTagger.forward(p, q, b, mode)


def _loss(o, b):
    return tlosses.softmax_xent(o, b["y"])


def _jet_pair():
    jp, jq = JJet.init(jax.random.PRNGKey(0), JCfg(**QCFG))
    tp, tq = from_jax(_np(jp), _np(jq), device="cpu")
    return (jp, jq), (tp, tq)


def _fake_mesh(n):
    """What JAX's step reads of a mesh: its axis names and device grid."""
    return types.SimpleNamespace(axis_names=("data",),
                                 devices=np.empty((n,), dtype=object))


@pytest.fixture
def jax_reference(monkeypatch):
    """The JAX step's exact-grid quantizer and the collective's simulator."""
    monkeypatch.setattr(jhgq, "quantize", j_hgq_quantize)
    monkeypatch.setattr(
        jcoll, "ef_wire_pmean",
        lambda e, mesh, kind="int8", widths=None, fused=True:
        jcoll.simulate_wire_pmean(e, kind, widths=widths))


def _tb(b):
    return {k: torch.tensor(np.asarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("mixed,fused", [(True, True), (False, False)])
def test_compressed_step_matches_jax(jax_reference, mixed, fused):
    """20 compressed steps at batch 256 over 4 shards from one init: loss
    (rel 1e-5), ~EBOPs (rel 1e-4) and beta against the JAX step at every
    step, step 0 within 1e-6; the final residuals of JAX's size."""
    (jp, jq), (tp, tq) = _jet_pair()
    jw = jplan.mixed_low_plan(jp, 4) if mixed else None
    tw = tplan.mixed_low_plan(tp, 4) if mixed else None
    if mixed:
        assert tw.to_json() == jw.to_json()
    batches = [j_jet_batch(0, s, 256) for s in range(20)]
    jstep = jax.jit(jloop.make_train_step(
        lambda p, q, b, mode: JJet.forward(p, q, b, mode),
        lambda o, b: jlosses.softmax_xent(o, b["y"]),
        jloop.TrainConfig(**TCFG), reduce="compressed", mesh=_fake_mesh(N),
        wire_layout="1d", wire_widths=jw, wire_fused=fused))
    jopt = joptim.adamw_init(jp)
    jef = JEFState(residual=jcoll.ef_wire_init(jp, N))
    tstep = make_train_step(_fwd, _loss, TrainConfig(**TCFG),
                            reduce="compressed", mesh=LocalMesh(N, "cpu"),
                            wire_widths=tw, wire_fused=fused)
    topt = toptim.adamw_init(tp)
    tef = EFState(residual=ef_wire_init(tp, N))
    gaps = []
    for s, b in enumerate(batches):
        jp, jq, jopt, jm, jef = jstep(jp, jq, jopt, b, jnp.int32(s), jef)
        tp, tq, topt, tm, tef = tstep(tp, tq, topt, _tb(b), s, tef)
        g = {k: _rel(tm[k], jm[k]) for k in ("loss", "ebops", "beta",
                                             "gnorm")}
        gaps.append(g)
        assert g["loss"] <= (1e-6 if s == 0 else 1e-5), (s, g)
        assert g["ebops"] <= (1e-6 if s == 0 else 1e-4), (s, g)
        assert g["beta"] <= 1e-6, (s, g)
    print(f"\ncompressed step (mixed={mixed}, fused={fused}) vs JAX, 20 "
          f"steps: loss max {max(g['loss'] for g in gaps):.3g}, ~EBOPs "
          f"{max(g['ebops'] for g in gaps):.3g}, gnorm "
          f"{max(g['gnorm'] for g in gaps):.3g}")
    assert int(topt.step) == 20 and float(tm["loss"]) < float(np.log(5.0))
    # the residuals are of JAX's size: each bounded by the residual's own
    # range on the JAX side (a grid step and a phase-2 remainder)
    for r, jr in zip(tree_leaves(tef.residual), jax.tree.leaves(jef.residual)):
        assert r.shape == tuple(jr.shape)
        bound = 2 * float(np.max(np.abs(np.asarray(jr)))) + 1e-30
        assert float(np.max(np.abs(r.numpy() - np.asarray(jr)))) <= bound


def _wire_run(p, q, batches, plan):
    step = make_train_step(_fwd, _loss,
                           TrainConfig(**dict(TCFG, steps=len(batches))),
                           reduce="compressed", mesh=LocalMesh(N, "cpu"),
                           wire_widths=plan)
    opt, out = toptim.adamw_init(p), []
    ef = EFState(residual=ef_wire_init(p, N))
    for s, b in enumerate(batches):
        p, q, opt, m, ef = step(p, q, opt, b, s, ef)
        out.append((float(m["loss"]), float(m["ebops"])))
    return out


def test_wire_faults_move_the_trajectory(monkeypatch):
    """The two faulty wires ``chip_smoke.py`` holds its card-vs-CPU limit
    (1e-4) against move 20 compressed steps at batch 1024 (4 shards,
    mixed plan) far beyond it on the CPU: a wire that drops the phase-2
    error feedback, and a wire grid one step finer than ``grid_scale``."""
    import repro_torch.dist.collectives as coll
    import repro_torch.kernels.wire_pack as wp
    g = torch.Generator().manual_seed(20241017)
    p, q = JetTagger.init(g, HGQConfig(**QCFG), device="cpu")
    plan = tplan.mixed_low_plan(p, 4)
    pipe = make_pipeline(DataSpec(kind="jet", batch=1024, seed=3),
                         device="cpu")
    batches = [pipe(s) for s in range(20)]
    sound = _wire_run(p, q, batches, plan)
    assert sound == _wire_run(p, q, batches, plan)   # repeatable

    def gap(run):
        return max(max(_rel(a[0], b[0]), _rel(a[1], b[1]))
                   for a, b in zip(run, sound))

    real_requant = coll._phase2_requantize

    def dropped(chunk_sum, n, kind):           # a zero remainder handed on
        q2, err = real_requant(chunk_sum, n, kind)
        return q2, torch.zeros_like(err)

    with monkeypatch.context() as mp:
        mp.setattr(coll, "_phase2_requantize", dropped)
        no_ef = gap(_wire_run(p, q, batches, plan))
    real = wp.grid_scale
    with monkeypatch.context() as mp:
        mp.setattr(wp, "grid_scale", lambda a, b=8: real(a, b) * 0.5)
        finer = gap(_wire_run(p, q, batches, plan))
    print(f"\nfaulty wires vs the sound one, 20 steps at batch 1024: no "
          f"phase-2 error feedback {no_ef:.3g}, grid one step finer "
          f"{finer:.3g}")
    assert no_ef > 1e-3 and finer > 1e-3


def test_merge_sliced_qstate_matches_jax():
    rng = np.random.default_rng(5)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    st = {"inp": (r(4, 16), r(4, 16)), "d0": {"out": (r(4), r(4))}}
    j = {"inp": jhgq.ActState(*map(jnp.asarray, st["inp"])),
         "d0": {"out": jhgq.ActState(*map(jnp.asarray, st["d0"]["out"]))}}
    t = {"inp": ActState(*map(torch.from_numpy, st["inp"])),
         "d0": {"out": ActState(*map(torch.from_numpy, st["d0"]["out"]))}}
    jm = jloop._merge_sliced_qstate(j)
    tm = _merge_sliced_qstate(t)
    for a, b in zip(tree_leaves(tm), jax.tree.leaves(jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert isinstance(tm["inp"], ActState)


def test_compressed_step_tracks_post_reduce():
    """reduce='compressed' over LocalMesh(4) trains to the same loss curve
    as the post-reduce int8 path (both carry one-grid-step EF noise),
    from an identical first step."""
    g = torch.Generator().manual_seed(0)
    p0, q0 = JetTagger.init(g, HGQConfig(weight_gran="per_parameter",
                                         act_gran="per_parameter",
                                         init_weight_f=2, init_act_f=2),
                            device="cpu")
    pipe = make_pipeline(DataSpec(kind="jet", batch=256), device="cpu")
    tc = TrainConfig(steps=20, lr=3e-3, beta0=1e-7, beta1=1e-6)
    step_c = make_train_step(_fwd, _loss, tc, reduce="compressed",
                             mesh=LocalMesh(N, "cpu"), wire_layout="1d")
    step_r = make_train_step(
        _fwd, _loss, tc, grad_tx=lambda g_, s: ef_compress(g_, s,
                                                            kind="int8"))
    pc, qc, oc = p0, q0, toptim.adamw_init(p0)
    ec = EFState(residual=ef_wire_init(p0, N))
    pr, qr, orr, er = p0, q0, toptim.adamw_init(p0), ef_init(p0)
    lc, lr_ = [], []
    for s in range(8):
        b = pipe(s)
        pc, qc, oc, mc, ec = step_c(pc, qc, oc, b, s, ec)
        pr, qr, orr, mr, er = step_r(pr, qr, orr, b, s, er)
        lc.append(float(mc["loss"]))
        lr_.append(float(mr["loss"]))
    assert abs(lc[0] - lr_[0]) < 1e-5, (lc[0], lr_[0])
    assert max(abs(a - b) for a, b in zip(lc, lr_)) < 0.05, (lc, lr_)
    assert lc[-1] < lc[0]


def test_compressed_single_device_is_post_reduce_path():
    """With one data rank (or no mesh) the compressed step is the
    post-reduce ef_compress step, bit for bit."""
    g = torch.Generator().manual_seed(1)
    p0, q0 = JetTagger.init(g, HGQConfig(**QCFG), device="cpu")
    pipe = make_pipeline(DataSpec(kind="jet", batch=64), device="cpu")
    tc = TrainConfig(**TCFG)
    ref = make_train_step(_fwd, _loss, tc,
                          grad_tx=lambda g_, s: ef_compress(g_, s,
                                                            kind="int8"))
    for mesh in (None, LocalMesh(1, "cpu")):
        step = make_train_step(_fwd, _loss, tc, reduce="compressed",
                               mesh=mesh)
        a = (p0, q0, toptim.adamw_init(p0), ef_init(p0))
        b = (p0, q0, toptim.adamw_init(p0), ef_init(p0))
        for s in range(3):
            pa, qa, oa, _, ea = step(a[0], a[1], a[2], pipe(s), s, a[3])
            pb, qb, ob, _, eb = ref(b[0], b[1], b[2], pipe(s), s, b[3])
            a, b = (pa, qa, oa, ea), (pb, qb, ob, eb)
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)


def test_compressed_rejects_grad_tx_and_2d():
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(_fwd, _loss, TrainConfig(), reduce="compressed",
                        mesh=LocalMesh(2, "cpu"),
                        grad_tx=lambda g, s: (g, s))
    with pytest.raises(NotImplementedError, match="2d"):
        make_train_step(_fwd, _loss, TrainConfig(), reduce="compressed",
                        mesh=LocalMesh(2, "cpu"), wire_layout="2d")
    with pytest.raises(ValueError, match="wire_layout"):
        make_train_step(_fwd, _loss, TrainConfig(), reduce="compressed",
                        wire_layout="3d")
    step = make_train_step(_fwd, _loss, TrainConfig(**TCFG),
                           reduce="compressed", mesh=LocalMesh(4, "cpu"))
    g = torch.Generator().manual_seed(0)
    p, q = JetTagger.init(g, HGQConfig(**QCFG), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        step(p, q, toptim.adamw_init(p),
             make_pipeline(DataSpec(kind="jet", batch=30), device="cpu")(0),
             0, EFState(residual=ef_wire_init(p, 4)))


# ---------------------- the Trainer with gradient_tx ------------------------

def _make_trainer(tmp=None, steps=40, grad_tx=None, tx_state=None):
    g = torch.Generator().manual_seed(0)
    p, q = JetTagger.init(g, HGQConfig(**QCFG), device="cpu")
    tc = TrainConfig(steps=steps, lr=3e-3, beta0=1e-7, beta1=1e-6,
                     log_every=1000, ckpt_dir=tmp or "")
    return Trainer(_fwd, _loss, tc, p, q,
                   pipeline=make_pipeline(DataSpec(kind="jet", batch=128),
                                          device="cpu"),
                   grad_tx=grad_tx, tx_state=tx_state)


def test_trainer_honors_grad_tx():
    """A coarse compressor changes the trajectory and threads a nonzero
    residual; kind='none' stays bit-exact with no transform."""
    tx = lambda g, s: ef_compress(g, s, kind="int8")
    tr_c = _make_trainer(steps=6, grad_tx=tx)
    tr_p = _make_trainer(steps=6)
    tr_c.run(steps=6, log=lambda *a: None)
    tr_p.run(steps=6, log=lambda *a: None)
    assert tr_c.tx_state is not None
    res_max = max(float(leaf.abs().max())
                  for leaf in tree_leaves(tr_c.tx_state.residual))
    assert res_max > 0.0, "residual never updated: grad_tx was ignored"
    diff = max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(tr_c.params),
                               tree_leaves(tr_p.params)))
    assert diff > 0.0, "int8 compression had no effect: grad_tx ignored"
    tr_n = _make_trainer(steps=6,
                         grad_tx=lambda g, s: ef_compress(g, s, kind="none"))
    tr_n.run(steps=6, log=lambda *a: None)
    for got, want in zip(tree_leaves(tr_n.params), tree_leaves(tr_p.params)):
        assert torch.equal(got, want)


def test_trainer_rejects_orphan_tx_state():
    g = torch.Generator().manual_seed(0)
    p, _ = JetTagger.init(g, HGQConfig(**QCFG), device="cpu")
    with pytest.raises(ValueError, match="grad_tx"):
        _make_trainer(steps=1, tx_state=ef_init(p))


def test_trainer_saves_and_resumes_ef_residual(tmp_path):
    """The EF residual is checkpointed whenever compression is on; resume
    round-trips it exactly and replays like the uninterrupted run."""
    tx = lambda g, s: ef_compress(g, s, kind="int8")
    tr_ref = _make_trainer(steps=12, grad_tx=tx)
    tr_ref.run(steps=12, log=lambda *a: None)
    d = str(tmp_path)
    tr1 = _make_trainer(d, steps=12, grad_tx=tx)
    tr1.run(steps=6, log=lambda *a: None)
    tr1.checkpoint(6)
    saved = [x.clone() for x in tree_leaves(tr1.tx_state.residual)]
    assert tckpt.has_tree(d, 6, "ef"), "EF residual not checkpointed"
    tr2 = _make_trainer(d, steps=12, grad_tx=tx)
    assert tr2.maybe_resume() and tr2.start_step == 6
    for got, want in zip(tree_leaves(tr2.tx_state.residual), saved):
        assert torch.equal(got, want)
    tr2.run(steps=12, log=lambda *a: None)
    for got, want in zip(tree_leaves(tr2.params), tree_leaves(tr_ref.params)):
        assert torch.equal(got, want)


def test_jax_compressed_run_continues_in_the_port(jax_reference, tmp_path):
    """A JAX compressed run's state (params, qstate, AdamW, the [4, ...]
    wire residual) carries into the port through ``from_jax`` and through
    a JAX checkpoint with an ``ef`` tree, and the port's next step matches
    JAX's next step."""
    from repro.train import checkpoint as jckpt
    (jp, jq), _ = _jet_pair()
    jstep = jax.jit(jloop.make_train_step(
        lambda p, q, b, mode: JJet.forward(p, q, b, mode),
        lambda o, b: jlosses.softmax_xent(o, b["y"]),
        jloop.TrainConfig(**TCFG), reduce="compressed", mesh=_fake_mesh(N),
        wire_layout="1d"))
    jopt = joptim.adamw_init(jp)
    jef = JEFState(residual=jcoll.ef_wire_init(jp, N))
    for s in range(3):
        jp, jq, jopt, _, jef = jstep(jp, jq, jopt, j_jet_batch(0, s, 128),
                                     jnp.int32(s), jef)
    tp, tq, topt, tef = from_jax(_np(jp), _np(jq), _np(jopt), _np(jef),
                                 device="cpu")
    assert isinstance(tef, EFState) and isinstance(topt, toptim.AdamWState)
    jckpt.save(str(tmp_path), 3, {"params": jp, "qstate": jq, "opt": jopt,
                                  "ef": jef})
    _, back = tckpt.restore(str(tmp_path), 3, {
        "params": tp, "qstate": tq, "opt": topt, "ef": tef})
    for a, b in zip(tree_leaves(back["ef"]), tree_leaves(tef)):
        assert torch.equal(a, b)
    b = j_jet_batch(0, 3, 128)
    jp, jq, jopt, jm, jef = jstep(jp, jq, jopt, b, jnp.int32(3), jef)
    tstep = make_train_step(_fwd, _loss, TrainConfig(**TCFG),
                            reduce="compressed", mesh=LocalMesh(N, "cpu"))
    tp, tq, topt, tm, tef = tstep(tp, tq, topt, _tb(b), 3, tef)
    assert _rel(tm["loss"], jm["loss"]) <= 1e-6
    assert _rel(tm["ebops"], jm["ebops"]) <= 1e-6
