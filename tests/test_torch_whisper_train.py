"""Port parity: HGQ training of the Whisper family (``models/whisper.py``)
against the JAX package, on whisper-large-v3 SMOKE (2 encoder and 2
decoder layers, d 64, 4 heads of 16, ``enc_seq`` 16, vocab 256) on an
``asr`` batch (frame embeddings ``[B, enc_seq, d]`` N(0, 1) x 0.3 and 7
tokens), the loss ``lm_loss + beta ~EBOPs + gamma L1`` as ``train/loop``
builds it.  One seeded port init is carried to the JAX side leaf for
leaf (the JAX tree's structure from ``jax.eval_shape`` of its own init);
the init leaves every bias at 0 and every LayerNorm at scale 1, bias 0,
which would hide a missing or swapped term, so they are redrawn from the
seed first, as ``tests/test_torch_whisper.py`` redraws them.  The JAX
side swaps both TRAIN quantizer entries for its kernel op
``repro.kernels.hgq_quantize`` (the exact Eq.-4 grid, as the port;
swapped inside the tests, nothing on disk changes).

The reference's model-level numbers come from one jitted call a file
(``_reference``): the reference's train step (``repro.train.loop.
make_train_step`` under the reference's ``RunContext``, with a
``grad_tx`` that hands its clipped gradient out unchanged) on the tree
without activation quantizers, and its TRAIN forward on the tree with
them.  Layer-level gradients are held to the reference run eagerly.

The reference's TRAIN forward returns the cross K/V range states under a
key of its own, ``dec_layers/xattn_kv``; the port returns them where the
init qstate keeps them, ``dec_layers/xattn/{wk,wv}``.  The tests move
the reference's back under ``xattn`` before comparing.  The reference's
second jitted step refuses its own first step's qstate; one test pins
that, and the port takes two steps with the qstate's leaf paths
unchanged.

Tolerances (relative to each leaf's largest entry unless stated):
- ``CrossAttention.kv`` then ``apply`` in TRAIN (no activation
  quantizers; the probabilities' grid kept): the output and the
  gradients in the encoder memory, the decoder stream and every weight
  and ``f`` of the block within XATTN_TOL = 1e-5 (read 2.3e-6,
  ``probs_f``).
- Model level without activation quantizers (every ``out_f``): the
  loss, ~EBOPs and the total relative LOSS_TOL = 1e-6 (read 8.5e-8), the
  gradient norm GNORM_TOL = 1e-5 (read 8.5e-8); every leaf's clipped
  gradient within GRAD_TOL = 1e-4 (read 1.3e-6), but the attention
  probabilities' f within PROBS_F_GRAD_TOL = 1e-3 (read 1.15e-4, the
  decoder's causal self-attention; the encoder's 2.1e-5): its gradient
  is the sum of ``g ln2 (p - p_q)`` over every probability, whose
  cancellation magnifies the ulps of ``exp`` and of the sum's order.
- With activation quantizers: the loss and the total relative
  ACT_LOSS_TOL = 1e-3 (read 8.5e-8; a value on an activation grid's
  rounding tie, which XLA's and PyTorch's ulps decide differently, moves
  it: RWKV reads 7.5e-5), every new range state within STATE_TOL = 1e-5
  (read 2.3e-7).
- One step through ``RunContext.init_training()`` against the
  reference's step on the same tree (without activation quantizers): the
  first moment within the gradient's bars (read 1.15e-4 for probs_f,
  1.3e-6 elsewhere), the second, the gradient squared, within twice them
  (read 1.35e-4); the new params within PARAM_TOL = 0.25 x lr (read
  4.7e-3 x lr): AdamW's first step moves an entry by lr g / (|g| +
  1e-8), lr whatever g where |g| is far above 1e-8, but an entry near
  that floor carries its gradient's relative gap into the step whole.
"""
import contextlib
import functools
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
    import repro.nn.attention as jattn
    from repro import api as japi
    from repro.kernels import hgq_quantize as j_hgq_quantize
    from repro.core.schedule import log_ramp as j_log_ramp
    from repro.models import model_for as jmodel_for
    from repro.optim import adamw_init as j_adamw_init
    from repro.core.hgq import Aux as JAux
    from repro.core.hgq import QTensor as JQ
    from repro.models import whisper as jwh
    from repro.train import losses as jlosses
    from repro.train import loop as jloop

from repro_torch.api import RunSpec, build
from repro_torch.core.hgq import QTensor
from repro_torch.core.schedule import log_ramp
from repro_torch.models import whisper as twh
from repro_torch.optim import adamw_init, clip_by_global_norm
from repro_torch.train import lm_loss
from repro_torch.train.loop import _value_and_grad
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_unflatten)

ARCH = "whisper-large-v3"
B, S = 2, 7
CPU = "cpu"
XATTN_TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 1e-4
PROBS_F_GRAD_TOL = 1e-3
STATE_TOL = 1e-5
PARAM_TOL = 0.25
GNORM_TOL = 1e-5
ACT_LOSS_TOL = 1e-3
_STATE = {}


def _kernel_op(x, f):
    """The JAX kernel op, a per-channel f of shape (1, ..., 1, N) handed
    over as (N,), the shape its backward reduces to."""
    if 1 < f.ndim and f.shape != x.shape and set(f.shape[:-1]) == {1}:
        return j_hgq_quantize(x, f.reshape(-1))
    return j_hgq_quantize(x, f)


@contextlib.contextmanager
def _kernel_quantizer():
    """Both JAX TRAIN quantizer entries swapped for the kernel op."""
    real = jhgq.quantize, jattn.quantize
    jhgq.quantize = jattn.quantize = _kernel_op
    try:
        yield
    finally:
        jhgq.quantize, jattn.quantize = real


def _without_act_quantizers(tree):
    """The tree without its activation quantizers (every ``out_f`` and
    ``attnout_f``)."""
    if isinstance(tree, dict):
        return {k: _without_act_quantizers(v) for k, v in tree.items()
                if k not in ("out_f", "attnout_f")}
    if isinstance(tree, list):
        return [_without_act_quantizers(v) for v in tree]
    return tree


def _to_jax(tree, struct):
    """The port's tree as a JAX tree of ``struct``'s structure (both
    flatten in sorted key order), shapes checked leaf by leaf."""
    leaves, treedef = jax.tree.flatten(struct)
    mine = tree_leaves(tree)
    assert len(mine) == len(leaves)
    for a, b in zip(mine, leaves):
        assert tuple(a.shape) == tuple(b.shape)
    return jax.tree.unflatten(treedef, [jnp.asarray(a.detach().numpy())
                                        for a in mine])


def _flat(tree):
    """{path: numpy leaf} of a port or a JAX tree."""
    if isinstance(jax.tree.leaves(tree)[0], jax.Array):
        return {"/".join(str(getattr(k, "key", getattr(k, "name",
                                                      getattr(k, "idx", k))))
                         for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {"/".join(p): v.detach().numpy()
            for p, v in tree_flatten_with_path(tree)}


def _gaps(got, want):
    """{path: |got - want| max over the leaf's largest |want|}."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    return {k: float(np.abs(g[k] - w[k]).max())
            / max(float(np.abs(w[k]).max()), 1e-30) for k in w}


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _gap(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()) \
        / max(float(np.abs(want).max()), 1e-30)


def _over(gaps, tol):
    """The leaves whose gap passes ``tol`` (``PROBS_F_GRAD_TOL`` for an
    attention probabilities' f)."""
    return {k: v for k, v in gaps.items()
            if v > (PROBS_F_GRAD_TOL if k.endswith("probs_f") else tol)}


def _worst(gaps, n=5):
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _spec():
    return RunSpec.from_args(["--arch", ARCH, "--steps", "5", "--batch",
                              str(B), "--seq", str(S)])


def _setup():
    """(port context, JAX context, port params and qstate, the JAX
    tree's structure, the batch) of one seeded port init."""
    if not _STATE:
        spec = _spec()
        ctx = build(spec, device=CPU)
        jctx = japi.build(japi.RunSpec.from_json(spec.to_json()))
        p, q = ctx.init_state()
        p = _redraw(p, np.random.default_rng(0))
        rng = np.random.default_rng(1)
        struct = jax.eval_shape(functools.partial(
            jmodel_for(jctx.cfg).init, cfg=jctx.cfg), jax.random.PRNGKey(0))
        cfg = ctx.cfg
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
                 "frame_embeds": (0.3 * rng.standard_normal(
                     (B, cfg.enc_seq, cfg.d_model))).astype(np.float32)}
        _STATE.update(ctx=ctx, jctx=jctx, p=p, q=q, struct=struct,
                      batch=batch)
    return _STATE


def _redraw(tree, rng):
    """The port's tree with its biases ~ N(0, 0.1), LayerNorm scales in
    [0.5, 1.5] and LayerNorm biases ~ N(0, 0.1) (``tests/
    test_torch_whisper.py``'s draws), every other leaf as it is."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "bias" and isinstance(v, dict):       # an HDense bias
            out[k] = {**v, "w": _draw(0.1 * rng.standard_normal(
                tuple(v["w"].shape)))}
        elif k == "bias":                             # a LayerNorm's
            out[k] = _draw(0.1 * rng.standard_normal(tuple(v.shape)))
        elif k == "scale":
            out[k] = _draw(rng.uniform(0.5, 1.5, tuple(v.shape)))
        else:
            out[k] = _redraw(v, rng)
    return out


def _draw(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _xattn_kv_under_xattn(qstate):
    """The reference's new qstate with its cross K/V range states
    (``dec_layers/xattn_kv/{wk,wv}``) moved back under
    ``dec_layers/xattn``, where its init qstate and the port keep them."""
    dec = dict(qstate["dec_layers"])
    dec["xattn"] = {**dec["xattn"], **dec.pop("xattn_kv")}
    return {**qstate, "dec_layers": dec}


def _loss_fn_j(out, b):
    return jlosses.lm_loss(out, b["tokens"])


def _reference():
    """The reference's numbers, once a file: its train step on the tree
    without activation quantizers (new params, qstate, AdamW state,
    metrics and the clipped gradient), and its TRAIN forward on the tree
    with them (the loss and the new range states)."""
    s = _setup()
    if "ref" in s:
        return s["ref"]
    jctx, cfg = s["jctx"], s["jctx"].cfg
    p = _to_jax(s["p"], s["struct"][0])
    q = _to_jax(s["q"], s["struct"][1])
    p0 = _without_act_quantizers(p)
    batch = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    tcfg = jctx.spec.train
    step = jctx.wrap(jloop.make_train_step(
        jctx.forward, _loss_fn_j, tcfg, grad_tx=lambda g, st: (g, g)))
    beta0 = j_log_ramp(tcfg.beta0, tcfg.beta1, tcfg.steps)(0)

    def both(p0, p, q, batch):
        out = step(p0, q, j_adamw_init(p0), batch, jnp.int32(0), None)
        lg, nq, aux = jctx.forward(p, q, batch, jhgq.TRAIN)
        loss = _loss_fn_j(lg, batch)
        total = loss + beta0 * aux.ebops + tcfg.gamma * aux.l1
        return out, (loss, total, nq)

    with _kernel_quantizer():
        out, act = jax.jit(both)(p0, p, q, batch)
    s["ref"] = {"step": out, "act": act, "p0": p0, "q": q,
                "tcfg": tcfg, "step_fn": step}
    return s["ref"]


# ------------------------------ CrossAttention ------------------------------

def _layer0_jax(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _layer0_port(tree):
    return tree_map(lambda t: t[0], tree)


def test_cross_attention_gradients_match_jax():
    """The cross K/V of the encoder memory, then the decoder stream's
    read over them: the gradient reaches the memory through k and v."""
    s = _setup()
    jctx, cfg = s["jctx"], s["ctx"].cfg
    rng = np.random.default_rng(2)
    mem = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    tp = _without_act_quantizers(_layer0_port(s["p"]["dec_layers"]["xattn"]))
    tq = _layer0_port(s["q"]["dec_layers"]["xattn"])
    jp_all = _to_jax(s["p"], s["struct"][0])
    jq_all = _to_jax(s["q"], s["struct"][1])
    jp = _without_act_quantizers(_layer0_jax(jp_all["dec_layers"]["xattn"]))
    jq = _layer0_jax(jq_all["dec_layers"]["xattn"])

    def jf(p, m, x):
        kh, vh, _ = jwh.CrossAttention.kv(p, jq, JQ(m, None), jctx.cfg,
                                          jhgq.TRAIN, JAux.zero())
        y, _ = jwh.CrossAttention.apply(p, jq, JQ(x, None), kh, vh,
                                        jctx.cfg, jhgq.TRAIN, JAux.zero())
        return y.q

    with _kernel_quantizer():
        want, vjp = jax.vjp(jf, jp, jnp.asarray(mem), jnp.asarray(x))
        jgp, jgm, jgx = vjp(jnp.asarray(ct))
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    tpl = tree_unflatten(tp, leaves)
    tm, tx = (torch.tensor(a, requires_grad=True) for a in (mem, x))
    kh, vh, _ = twh.CrossAttention.kv(tpl, tq, QTensor(tm, None), cfg,
                                      "train", None)
    got, _ = twh.CrossAttention.apply(tpl, tq, QTensor(tx, None), kh, vh,
                                      cfg, "train", None)
    (got.q * torch.from_numpy(ct)).sum().backward()
    err = {"out": _gap(got.q.detach(), want), "d_memory": _gap(tm.grad, jgm),
           "d_x": _gap(tx.grad, jgx)}
    grads = tree_unflatten(tp, [torch.zeros_like(t) if t.grad is None
                                else t.grad for t in leaves])
    err.update(_gaps(grads, jgp))
    assert float(np.abs(np.asarray(jgm)).max()) > 0
    assert max(err.values()) <= XATTN_TOL, _worst(err)


# -------------------------------- model level -------------------------------

def test_loss_and_gradients_match_jax():
    """Without activation quantizers: the loss, ~EBOPs, the Eq.-16 total
    and every leaf's clipped gradient."""
    s, ref = _setup(), _reference()
    jp, jq, jopt, jm, jgrads = ref["step"]
    ctx, tcfg = s["ctx"], ref["tcfg"]
    beta = log_ramp(tcfg.beta0, tcfg.beta1, tcfg.steps)(0)
    batch = {k: torch.from_numpy(v) for k, v in s["batch"].items()}
    total, _, ebops, base, grads = _value_and_grad(
        ctx.forward, lambda out, b: lm_loss(out, b["tokens"]), tcfg,
        _without_act_quantizers(s["p"]), s["q"], batch, beta)
    assert _rel(base, jm["loss"]) <= LOSS_TOL
    assert _rel(ebops, jm["ebops"]) <= LOSS_TOL
    assert _rel(total, jm["total"]) <= LOSS_TOL
    clipped, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
    assert _rel(gnorm, jm["gnorm"]) <= GNORM_TOL
    gaps = _gaps(clipped, jgrads)
    assert not _over(gaps, GRAD_TOL), _worst(gaps)
    # the bitwidths train: every kernel's f has a gradient (a zero bias,
    # on every grid, has none)
    flat = _flat(clipped)
    assert all(np.abs(v).max() > 0 for k, v in flat.items()
               if k.endswith("kernel/f"))


def test_loss_and_range_states_with_activation_quantizers():
    s, ref = _setup(), _reference()
    jloss, jtotal, jnq = ref["act"]
    tcfg = ref["tcfg"]
    beta = log_ramp(tcfg.beta0, tcfg.beta1, tcfg.steps)(0)
    batch = {k: torch.from_numpy(v) for k, v in s["batch"].items()}
    total, newq, _, base, _ = _value_and_grad(
        s["ctx"].forward, lambda out, b: lm_loss(out, b["tokens"]), tcfg,
        s["p"], s["q"], batch, beta)
    assert _rel(base, jloss) <= ACT_LOSS_TOL
    assert _rel(total, jtotal) <= ACT_LOSS_TOL
    gaps = _gaps(newq, _xattn_kv_under_xattn(jnq))
    assert gaps and max(gaps.values()) <= STATE_TOL, gaps


# ----------------------------- one whole step --------------------------------

def test_init_training_step_matches_reference_step():
    """``build(spec).init_training()``'s step from the same tree and
    batch: params and both AdamW moments."""
    s, ref = _setup(), _reference()
    jp, jq, jopt, jm, _ = ref["step"]
    setup = s["ctx"].init_training()
    setup.params = _without_act_quantizers(_clone(s["p"]))
    setup.qstate = _clone(s["q"])
    setup.opt = adamw_init(setup.params)
    setup.pipeline = lambda step: {k: torch.from_numpy(v)
                                   for k, v in s["batch"].items()}
    m = setup.step(0)
    assert _rel(m["loss"], jm["loss"]) <= LOSS_TOL
    # the second moment is the gradient squared: twice its relative gap
    for got, want, tol in ((setup.opt.mu, jopt.mu, GRAD_TOL),
                           (setup.opt.nu, jopt.nu, 2 * GRAD_TOL)):
        gaps = _gaps(got, want)
        assert not _over(gaps, tol), _worst(gaps)
    lr = ref["tcfg"].lr
    got, want = _flat(setup.params), _flat(jp)
    assert got.keys() == want.keys()
    moved = {k: float(np.abs(got[k] - want[k]).max()) / lr for k in want}
    assert max(moved.values()) <= PARAM_TOL, _worst(moved)


# --------------------------- the qstate's round trip -------------------------

def test_two_steps_keep_the_qstate_paths():
    """Two steps through ``RunContext.init_training()`` on the tree with
    its activation quantizers: after each the new qstate has the init
    qstate's leaf paths (the cross K/V range states under
    ``dec_layers/xattn``), and the losses are finite."""
    s = _setup()
    setup = s["ctx"].init_training()
    setup.params, setup.qstate = _clone(s["p"]), _clone(s["q"])
    setup.opt = adamw_init(setup.params)
    setup.pipeline = lambda step: {k: torch.from_numpy(v)
                                   for k, v in s["batch"].items()}
    paths = list(_flat(s["q"]))
    assert "dec_layers/xattn/wk/out/vmax" in paths
    for step in range(2):
        m = setup.step(step)
        assert np.isfinite(float(m["loss"]))
        assert list(_flat(setup.qstate)) == paths
    moved = _flat(setup.qstate)["dec_layers/xattn/wk/out/vmax"]
    assert np.abs(moved).min() > 0


def test_reference_second_step_refuses_its_own_qstate():
    """Reference behaviour: the reference's TRAIN forward returns the
    cross K/V range states under ``dec_layers/xattn_kv`` and drops them
    from ``xattn``, so its jitted step, given its own step 0's qstate,
    cannot trace step 1 (``CrossAttention.kv`` reads ``xattn/wk``)."""
    s, ref = _setup(), _reference()
    jp, jq, jopt, _, _ = ref["step"]
    assert "xattn_kv" in jq["dec_layers"]
    assert "wk" not in jq["dec_layers"]["xattn"]
    batch = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    with _kernel_quantizer(), pytest.raises(KeyError, match="wk"):
        jax.jit(ref["step_fn"])(jp, jq, jopt, batch, jnp.int32(1), None)
