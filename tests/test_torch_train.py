"""Port parity: quantization-aware training of the jet tagger in
``repro_torch`` against the JAX package.

The JAX reference here is its own train step with ``repro.core.hgq``'s
quantizer swapped for the JAX kernel op
``repro.kernels.hgq_quantize`` (monkeypatched in the test; nothing on
disk changes).  Both land on Eq. 4's exact grid, as the port does.  JAX's
own ``quantize`` returns ``x - (sg(d + a) - a)``, up to an ulp off the
grid, and products of grid values sit exactly on the next quantizer's
rounding ties, which those ulps decide: against that trajectory the
port's loss differs by 3e-3 at step 0 and by up to 8% within 20 steps,
against the kernel-op trajectory by at most 1.2e-7.

Limits: optimizers, clipping, schedules and losses rel 1e-6 (float32
pow / exp / log differ in the last ulp between XLA and PyTorch); the
jet tagger's logits and range states bit for bit (products and sums of
grid values are exact); ~EBOPs rel 1e-6; the 20-step trajectory at
batch 256, loss rel 1e-5 and ~EBOPs rel 1e-4 at every step (gradient
sums in another order move the weights by ulps).  Inputs are made with
numpy (or the JAX package's own generator) and handed to both sides."""
import os
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
    from repro.core import pareto as jpareto
    from repro.core import schedule as jsched
    from repro.data import jet_batch as j_jet_batch
    from repro.kernels import hgq_quantize as j_hgq_quantize
    from repro.models import JetTagger as JJet
    from repro.nn import HGQConfig as JCfg
    from repro import optim as joptim
    from repro.train import checkpoint as jckpt
    from repro.train import losses as jlosses
    from repro.train import loop as jloop

from repro_torch import optim as toptim
from repro_torch.core import pareto as tpareto
from repro_torch.core import schedule as tsched
from repro_torch.core.plan import PrecisionPlan
from repro_torch.data import DataSpec, jet_batch, make_pipeline
from repro_torch.dist import ef_compress, ef_init
from repro_torch.models import JetTagger
from repro_torch.nn import HGQConfig
from repro_torch.train import TrainConfig, Trainer, checkpoint as tckpt
from repro_torch.train import losses as tlosses
from repro_torch.train import make_train_step
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.weights import from_jax

RNG = np.random.default_rng(23)
QCFG = dict(weight_gran="per_parameter", act_gran="per_parameter",
            init_weight_f=2.0, init_act_f=2.0)
TCFG = dict(steps=20, lr=3e-3, beta0=1e-6, beta1=1e-3, gamma=2e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _close_trees(t_tree, j_tree, rtol, atol=0.0):
    jl = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                   for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_flatten_with_path(j_tree)[0]}
    tl = {"/".join(p): v.detach().numpy()
          for p, v in tree_flatten_with_path(t_tree)}
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _grad_tree():
    return {"a": {"w": RNG.normal(size=(3, 4)).astype(np.float32),
                  "f": RNG.normal(size=(3, 4)).astype(np.float32)},
            "b": RNG.normal(size=(5,)).astype(np.float32)}


# ----------------------- optimizers, schedules, losses ----------------------

@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_lion_sgd_match_jax(wd):
    params = _grad_tree()
    jp, tp = jax.tree.map(jnp.asarray, params), \
        jax.tree.map(torch.from_numpy, params)
    jst, tst = joptim.adamw_init(jp), toptim.adamw_init(tp)
    jl, tl = joptim.lion_init(jp), toptim.lion_init(tp)
    jlp, tlp = jp, tp
    for _ in range(4):
        g = _grad_tree()
        jp, jst = joptim.adamw_update(jax.tree.map(jnp.asarray, g), jst, jp,
                                      lr=jnp.float32(1e-2), weight_decay=wd)
        tp, tst = toptim.adamw_update(jax.tree.map(torch.from_numpy, g), tst,
                                      tp, lr=torch.tensor(1e-2),
                                      weight_decay=wd)
        jlp, jl = joptim.lion_update(jax.tree.map(jnp.asarray, g), jl, jlp,
                                     lr=1e-2, weight_decay=wd)
        tlp, tl = toptim.lion_update(jax.tree.map(torch.from_numpy, g), tl,
                                     tlp, lr=1e-2, weight_decay=wd)
    assert int(tst.step) == int(jst.step) == 4 and tst.step.dtype == \
        torch.int32
    for t, j in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu), (tlp, jlp),
                 (tl.mu, jl.mu)):
        _close_trees(t, j, rtol=1e-6, atol=1e-7)
    g = _grad_tree()
    _close_trees(toptim.sgd_update(jax.tree.map(torch.from_numpy, g), tp,
                                   lr=0.1),
                 joptim.sgd_update(jax.tree.map(jnp.asarray, g), jp, lr=0.1),
                 rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_in_place_gives_the_same_bits(dtype, wd):
    """``in_place`` writes the functional update's results over its
    inputs: params of either dtype, both moments and the step bit for bit
    over 4 steps, and the returned leaves are the given tensors."""
    to = lambda a: torch.from_numpy(a).to(dtype)
    params = _grad_tree()
    fp, ip = tree_map(to, params), tree_map(to, params)
    fst, ist = toptim.adamw_init(fp), toptim.adamw_init(ip)
    for _ in range(4):
        g = tree_map(to, _grad_tree())
        fp, fst = toptim.adamw_update(g, fst, fp, lr=torch.tensor(3e-2),
                                      weight_decay=wd)
        given = tree_leaves(ip) + tree_leaves(ist.mu) + tree_leaves(ist.nu)
        ip, ist = toptim.adamw_update(g, ist, ip, lr=torch.tensor(3e-2),
                                      weight_decay=wd, in_place=True)
        got = tree_leaves(ip) + tree_leaves(ist.mu) + tree_leaves(ist.nu)
        assert all(a is b for a, b in zip(given, got))
    assert int(fst.step) == int(ist.step) == 4
    for a, b in zip(tree_leaves((fp, fst.mu, fst.nu)),
                    tree_leaves((ip, ist.mu, ist.nu))):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_clip_by_global_norm_over_a_list():
    """The list form scales each entry where it lies in the list, the
    same bits as the tree form, and leaves the given tensors as they
    were."""
    g = jax.tree.map(torch.from_numpy, _grad_tree())
    raw = [t.clone() for t in tree_leaves(g)]
    want, wn = toptim.clip_by_global_norm(g, 0.5)
    leaves = tree_leaves(g)
    gn = toptim.clip_by_global_norm_(leaves, 0.5)
    assert torch.equal(gn, wn)
    assert all(torch.equal(a, b) for a, b in zip(leaves, tree_leaves(want)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g), raw))
    assert not any(torch.equal(a, b) for a, b in zip(leaves, raw))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm(max_norm):
    g = _grad_tree()
    jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                        max_norm)
    tg, tn = toptim.clip_by_global_norm(jax.tree.map(torch.from_numpy, g),
                                        max_norm)
    assert _rel(tn, jn) < 1e-6
    _close_trees(tg, jg, rtol=1e-6)


def test_schedules():
    pairs = [(jsched.constant(3e-3), tsched.constant(3e-3)),
             (jsched.log_ramp(1e-6, 1e-3, 100), tsched.log_ramp(1e-6, 1e-3,
                                                                100)),
             (jsched.linear_warmup_cosine(1e-3, 10, 100, 1e-5),
              tsched.linear_warmup_cosine(1e-3, 10, 100, 1e-5))]
    for step in (0, 1, 5, 10, 50, 99, 100, 150):
        for js, ts in pairs:
            t = ts(step)
            assert t.dtype == torch.float32 and t.ndim == 0
            assert _rel(t, js(jnp.int32(step))) < 1e-6
            assert float(ts(torch.tensor(step, dtype=torch.int32))) == \
                float(t)


def test_losses():
    logits = (RNG.normal(size=(64, 5)) * 3).astype(np.float32)
    labels = RNG.integers(0, 5, 64)
    lm_logits = RNG.normal(size=(2, 7, 11)).astype(np.float32)
    toks = RNG.integers(0, 11, (2, 7))
    pred = (RNG.normal(size=(200,)) * 20).astype(np.float32)
    tgt = (RNG.normal(size=(200,)) * 20).astype(np.float32)
    cases = [("softmax_xent", (logits, labels)), ("lm_loss", (lm_logits, toks)),
             ("mse", (pred, tgt)), ("accuracy", (logits, labels)),
             ("rms_resolution", (pred, tgt))]
    for name, args in cases:
        j = getattr(jlosses, name)(*map(jnp.asarray, args))
        t = getattr(tlosses, name)(*map(torch.from_numpy, args))
        assert _rel(t, j) < 1e-6, name


# ------------------------------ the jet tagger ------------------------------

@pytest.fixture
def kernel_quantizer(monkeypatch):
    """The JAX TRAIN quantizer swapped for its kernel op (exact grid)."""
    monkeypatch.setattr(jhgq, "quantize", j_hgq_quantize)


def _jet_pair(qcfg=QCFG):
    jp, jq = JJet.init(jax.random.PRNGKey(0), JCfg(**qcfg))
    tp, tq = from_jax(_np(jp), _np(jq), device="cpu")
    return (jp, jq), (tp, tq)


@pytest.mark.parametrize("mode", ["train", "calib", "eval"])
def test_jet_forward_loss_and_ebops_match_jax(mode, kernel_quantizer):
    (jp, jq), (tp, tq) = _jet_pair()
    b = j_jet_batch(0, 3, 128)
    jout, jnq, jaux = JJet.forward(jp, jq, b, mode=mode)
    tb = {k: torch.tensor(np.asarray(v)) for k, v in b.items()}
    tout, tnq, taux = JetTagger.forward(tp, tq, tb, mode=mode)
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    _close_trees(tnq, jnq, rtol=0)
    assert _rel(taux.ebops.detach(), jaux.ebops) < 1e-6
    assert _rel(taux.l1.detach(), jaux.l1) < 1e-6
    assert _rel(tlosses.softmax_xent(tout, tb["y"]).detach(),
                jlosses.softmax_xent(jout, b["y"])) < 1e-6


def _jax_losses(jp, jq, batches):
    """(loss, ~EBOPs) per step of the JAX train step as repro.core.hgq
    stands when it is traced."""
    jstep = jax.jit(jloop.make_train_step(
        lambda p, q, b, mode: JJet.forward(p, q, b, mode),
        lambda o, b: jlosses.softmax_xent(o, b["y"]),
        jloop.TrainConfig(**TCFG)))
    jopt, out = joptim.adamw_init(jp), []
    for s, b in enumerate(batches):
        jp, jq, jopt, jm = jstep(jp, jq, jopt, b, jnp.int32(s))
        out.append((float(jm["loss"]), float(jm["ebops"]), float(jm["beta"])))
    return out


def test_twenty_step_trajectory_matches_jax(monkeypatch):
    """20 steps at batch 256 from one init and one set of batches: against
    the JAX step with the kernel op, loss within 1e-5 and ~EBOPs within
    1e-4 (relative) at every step; against JAX's own surrogate quantizer
    the loss moves by more than 1e-3 (why that is not the reference)."""
    (jp, jq), (tp, tq) = _jet_pair()
    batches = [j_jet_batch(0, s, 256) for s in range(20)]
    surrogate = _jax_losses(jp, jq, batches)        # traced unpatched
    monkeypatch.setattr(jhgq, "quantize", j_hgq_quantize)
    exact = _jax_losses(jp, jq, batches)
    tstep = make_train_step(lambda p, q, b, mode: JetTagger.forward(p, q, b,
                                                                    mode),
                            lambda o, b: tlosses.softmax_xent(o, b["y"]),
                            TrainConfig(**TCFG))
    topt, port = toptim.adamw_init(tp), []
    for s, b in enumerate(batches):
        tb = {k: torch.tensor(np.asarray(v)) for k, v in b.items()}
        tp, tq, topt, tm = tstep(tp, tq, topt, tb, s)
        port.append((float(tm["loss"]), float(tm["ebops"]),
                     float(tm["beta"])))
    gaps = {name: [_rel(p[0], r[0]) for p, r in zip(port, ref)]
            for name, ref in (("kernel_op", exact), ("surrogate", surrogate))}
    ebops_gap = max(_rel(p[1], r[1]) for p, r in zip(port, exact))
    exact_gap, sur0, sur = (max(gaps["kernel_op"]), gaps["surrogate"][0],
                            max(gaps["surrogate"]))
    print(f"\nport vs JAX, 20 steps: loss rel gap max {exact_gap:.3g} and "
          f"~EBOPs {ebops_gap:.3g} against the kernel-op step; loss rel gap "
          f"{sur0:.3g} at step 0 and max {sur:.3g} against JAX's own "
          f"quantizer")
    for s, (p, r) in enumerate(zip(port, exact)):
        assert _rel(p[0], r[0]) <= 1e-5, (s, p, r)
        assert _rel(p[1], r[1]) <= 1e-4, (s, p, r)
        assert _rel(p[2], r[2]) <= 1e-6
    assert max(gaps["surrogate"]) > 1e-3
    assert port[-1][0] < float(np.log(5.0))         # it learned
    assert int(topt.step) == 20


def test_checkpoint_jax_to_port_and_back(tmp_path, kernel_quantizer):
    """A JAX checkpoint (params, qstate, AdamW state) loads into the port
    and the port's checkpoint of it loads back into JAX: the same files,
    the same keys, the same values."""
    (jp, jq), _ = _jet_pair()
    jstep = jax.jit(jloop.make_train_step(
        lambda p, q, b, mode: JJet.forward(p, q, b, mode),
        lambda o, b: jlosses.softmax_xent(o, b["y"]),
        jloop.TrainConfig(**TCFG)))
    jopt = joptim.adamw_init(jp)
    for s in range(2):
        jp, jq, jopt, _ = jstep(jp, jq, jopt, j_jet_batch(0, s, 64),
                                jnp.int32(s))
    jtrees = {"params": jp, "qstate": jq, "opt": jopt}
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(a, 2, jtrees)
    # templates: the port's own fresh trees of the same structure
    (tp0, tq0, topt0) = from_jax(_np(jp), _np(jq), _np(jopt), device="cpu")
    assert isinstance(topt0, toptim.AdamWState)
    tmpl = {"params": tree_map(torch.zeros_like, tp0),
            "qstate": tree_map(torch.zeros_like, tq0),
            "opt": toptim.adamw_init(tp0)}
    step, ttrees = tckpt.restore(a, 2, tmpl)
    assert step == 2 and isinstance(ttrees["opt"], toptim.AdamWState)
    for name in jtrees:
        _close_trees(ttrees[name], jtrees[name], rtol=0)
    assert ttrees["opt"].step.dtype == torch.int32
    tckpt.save(b, 2, ttrees)
    for name in jtrees:
        with np.load(os.path.join(a, "step_00000002", f"{name}.npz")) as fa, \
                np.load(os.path.join(b, "step_00000002", f"{name}.npz")) as fb:
            assert sorted(fa.files) == sorted(fb.files)
            for k in fa.files:
                assert fa[k].dtype == fb[k].dtype, k
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    step, back = jckpt.restore(b, 2, jtrees)
    assert step == 2
    for name in jtrees:
        for x, y in zip(jax.tree.leaves(back[name]),
                        jax.tree.leaves(jtrees[name])):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------- the port's Trainer alone -------------------------

def _trainer(ckpt_dir="", steps=20, **kw):
    g = torch.Generator().manual_seed(0)
    p, q = JetTagger.init(g, HGQConfig(**QCFG), device="cpu")
    tc = TrainConfig(**{**TCFG, "steps": steps, "log_every": 1000,
                        "ckpt_dir": ckpt_dir, **kw})
    return Trainer(lambda p_, q_, b, mode: JetTagger.forward(p_, q_, b, mode),
                   lambda o, b: tlosses.softmax_xent(o, b["y"]), tc, p, q,
                   pipeline=make_pipeline(DataSpec(kind="jet", batch=128),
                                          device="cpu"))


def _equal_params(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_resume_replays_identically(tmp_path):
    ref = _trainer()
    ref.run(steps=20, log=lambda *a: None)
    d = str(tmp_path)
    tr = _trainer(d)
    tr.run(steps=10, log=lambda *a: None)
    tr.checkpoint(10)
    tr2 = _trainer(d)
    assert tr2.maybe_resume() and tr2.start_step == 10
    tr2.run(steps=20, log=lambda *a: None)
    _equal_params(tr2.params, ref.params)
    _equal_params(tr2.opt.mu, ref.opt.mu)
    assert int(tr2.opt.step) == 20


def test_auto_checkpoint_labels_steps_applied(tmp_path):
    ref = _trainer(steps=6)
    ref.run(steps=6, log=lambda *a: None)
    tr = _trainer(str(tmp_path), steps=6, ckpt_every=2)
    tr.run(steps=5, log=lambda *a: None)          # auto-ckpt after 3 and 5
    tr2 = _trainer(str(tmp_path), steps=6, ckpt_every=2)
    assert tr2.maybe_resume() and tr2.start_step == 5
    tr2.run(steps=6, log=lambda *a: None)
    _equal_params(tr2.params, ref.params)


def test_eval_pareto_pins_and_gc(tmp_path):
    tr = _trainer(str(tmp_path), steps=12, eval_every=3, keep_ckpts=1,
                  ckpt_every=1000)
    evals = iter([(0.5, 900.0), (0.7, 800.0), (0.6, 950.0)])
    tr.eval_fn = lambda p, q: next(evals)
    res = tr.run(steps=10, log=lambda *a: None)
    assert res["pareto"] == [(0.7, 800.0, 7)]
    names = sorted(os.listdir(tmp_path))
    # 4 and 7 joined the front (pinned); keep_ckpts=1 GCs nothing pinned
    assert "step_00000004" in names and "step_00000007" in names
    assert os.path.exists(tmp_path / "step_00000007" / "PARETO")


def test_gradient_compression_is_not_ported():
    """Every layout of gradient compression is ported (the wire:
    tests/test_torch_train_dp.py, tests/test_torch_wire2d.py).  With no
    mesh, wire_layout="2d" is the post-reduce ef_compress path, as in the
    reference: one step equals the grad_tx step bit for bit."""
    g = torch.Generator().manual_seed(0)
    p, q = JetTagger.init(g, HGQConfig(**QCFG), device="cpu")
    fwd = lambda p_, q_, b, mode: JetTagger.forward(p_, q_, b, mode)
    loss = lambda o, b: tlosses.softmax_xent(o, b["y"])
    batch = make_pipeline(DataSpec(kind="jet", batch=64), device="cpu")(0)
    two_d = make_train_step(fwd, loss, TrainConfig(), reduce="compressed",
                            wire_layout="2d")
    ref = make_train_step(fwd, loss, TrainConfig(),
                          grad_tx=lambda g_, s: ef_compress(g_, s))
    a = two_d(p, q, toptim.adamw_init(p), batch, 0, ef_init(p))
    b = ref(p, q, toptim.adamw_init(p), batch, 0, ef_init(p))
    for x, y in zip(tree_leaves((a[0], a[4])), tree_leaves((b[0], b[4]))):
        assert torch.equal(x, y)
    tr = Trainer(None, None, TrainConfig(), {}, {},
                 grad_tx=lambda g, s: (g, s))
    assert tr.grad_tx is not None and tr.tx_state is not None


def test_pareto_front_matches_jax_and_round_trips():
    offers = [(0.9, 100, 1), (0.95, 200, 2), (0.89, 150, 3), (0.85, 50, 4),
              (0.95, 180, 5), (0.95, 180, 6)]
    jf, tf = jpareto.ParetoFront("max"), tpareto.ParetoFront("max")
    for o in offers:
        assert tf.offer(*o) == jf.offer(*o)
    assert tf.front() == jf.front()
    assert tf.to_json() == jf.to_json()
    assert tf.best(max_ebops=120).metric == 0.9
    tf.offer(0.99, 400, 7, PrecisionPlan())
    back = tpareto.ParetoFront.from_json(tf.to_json())
    assert back.front() == tf.front()
    assert back.points[-1].payload == PrecisionPlan()
    with pytest.raises(ValueError):
        tpareto.ParetoFront("mid")


def test_jet_pipeline_is_a_function_of_seed_and_step():
    a, b = jet_batch(3, 5, 512, device="cpu"), jet_batch(3, 5, 512,
                                                         device="cpu")
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
    c = jet_batch(3, 6, 512, device="cpu")
    assert not torch.equal(a["x"], c["x"])
    assert a["x"].shape == (512, 16) and a["y"].dtype == torch.int64
    # five clusters with unit noise around centres of spread 1.5
    big = jet_batch(0, 0, 20000, device="cpu")
    counts = torch.bincount(big["y"], minlength=5).numpy()
    assert counts.min() > 3600 and counts.max() < 4400
    centres = torch.stack([big["x"][big["y"] == k].mean(0) for k in range(5)])
    noise = big["x"] - centres[big["y"]]
    assert abs(float(noise.std()) - 1.0) < 0.02
    assert 1.0 < float(centres.std()) < 2.0
    # the asr kind needs the architecture's frame dims, as the reference's
    with pytest.raises(ValueError, match="d_model"):
        make_pipeline(DataSpec(kind="asr", batch=8), device="cpu")
    asr = make_pipeline(DataSpec(kind="asr", batch=2, seq=6, vocab=32),
                        device="cpu", d_model=8, enc_seq=12)(0)
    assert asr["frame_embeds"].shape == (2, 12, 8)
    assert asr["tokens"].shape == (2, 6)
    if not torch.cuda.is_available():       # the card is the default
        with pytest.raises(RuntimeError):
            make_pipeline(DataSpec(kind="jet", batch=8))


def test_jet_init_shapes_match_jax():
    (jp, jq), _ = _jet_pair()
    g = torch.Generator().manual_seed(0)
    tp, tq = JetTagger.init(g, HGQConfig(**QCFG), device="cpu")
    jshapes = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in path): tuple(np.shape(v))
               for path, v in jax.tree_util.tree_flatten_with_path(
                   {"p": jp, "q": jq})[0]}
    tshapes = {"/".join(path): tuple(v.shape)
               for path, v in tree_flatten_with_path({"p": tp, "q": tq})}
    assert tshapes == jshapes
    for d_in, d_out, name in ((16, 64, "d0"), (64, 32, "d1"), (32, 32, "d2"),
                              (32, 5, "d3")):
        w = tp[name]["kernel"]["w"]
        lim = (3.0 / d_in) ** 0.5
        assert float(w.abs().max()) <= lim and float(w.std()) > lim / 3
