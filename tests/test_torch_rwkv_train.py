"""Port parity: HGQ training of the RWKV-6 family (``nn/recurrent.py``'s
RWKV half and ``models/rwkv.py``) against the JAX package, on rwkv6-1.6b
SMOKE (2 layers, d 128, 2 heads of 64, vocab 256, WKV chunks of 8; 21
tokens: three chunks, the last padded), the loss ``lm_loss + beta ~EBOPs
+ gamma L1`` as ``train/loop`` builds it.  One seeded port init is
carried to the JAX side leaf for leaf (the JAX tree's structure from
``jax.eval_shape`` of its own init); the init's constants (``mu``,
``bonus_u``, ``decay_w0``, ``ln_scale``), which would hide a swapped row
or a missing term, are redrawn from the seed first, as
``tests/test_torch_rwkv.py`` redraws them.  Inputs are made with numpy.
The JAX side swaps both TRAIN quantizer entries for its kernel op
``repro.kernels.hgq_quantize`` (the exact Eq.-4 grid, as the port;
swapped inside the tests, nothing on disk changes).

The reference's model-level numbers come from one jitted call a file
(``_reference``): the reference's train step (``repro.train.loop.
make_train_step`` under the reference's ``RunContext``, with a
``grad_tx`` that hands its clipped gradient out unchanged) on the tree
without activation quantizers, and its TRAIN forward on the tree with
them.  Layer-level gradients are held to the reference run eagerly.

Tolerances (relative to each leaf's largest entry unless stated):
- ``_wkv_chunked`` at chunk 8 for S in {5, 16, 21} (one chunk, two
  chunks, three with the last padded) from a carried state: y, the final
  state and the gradients in r, k, v, w, u and the carried state within
  WKV_TOL = 1e-6 (read 3.8e-7, ``w``'s through ``log``, the left-to-right
  ``_cumsum`` and ``exp``): PyTorch's ``exp`` and ``log`` are not XLA's
  at the ulp, and the port sums the contractions in float64.
- Model level without activation quantizers (every ``out_f``): the
  loss, ~EBOPs and the total relative LOSS_TOL = 1e-6 (read 8.0e-8), the
  gradient norm GNORM_TOL = 1e-5 (read 2.2e-6); every leaf's clipped
  gradient within GRAD_TOL = 1e-4 (read 6.3e-6, ``layers/att/wv``).
- With activation quantizers: the loss and the total relative
  ACT_LOSS_TOL = 1e-3 (read 7.5e-5, the eager reference alike: a value
  on an activation grid's rounding tie, which XLA's and PyTorch's ulps
  decide differently, moves a few logits by up to 0.024), every new
  range state within STATE_TOL = 1e-5 (read 1.4e-7).
- One step through ``RunContext.init_training()`` against the
  reference's step on the same tree (without activation quantizers): the
  first moment within GRAD_TOL (read 6.3e-6), the second, the gradient
  squared, within twice that (read 1.1e-5); the new params within
  PARAM_TOL = 0.25 x lr (read 0.039 x lr, ``layers/att/wg``): AdamW's
  first step moves an entry by lr g / (|g| + 1e-8), lr whatever g where
  |g| is far above 1e-8, but an entry near that floor carries its
  gradient's relative gap into the step whole.
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
    from repro.nn import recurrent as jrec
    from repro.train import losses as jlosses
    from repro.train import loop as jloop

from repro_torch.api import RunSpec, build
from repro_torch.core.schedule import log_ramp
from repro_torch.nn import recurrent as trec
from repro_torch.optim import adamw_init, clip_by_global_norm
from repro_torch.train import lm_loss
from repro_torch.train.loop import _value_and_grad
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

ARCH = "rwkv6-1.6b"
B, S = 2, 21
CPU = "cpu"
WKV_TOL = 1e-6
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
        struct = jax.eval_shape(functools.partial(
            jmodel_for(jctx.cfg).init, cfg=jctx.cfg), jax.random.PRNGKey(0))
        toks = np.random.default_rng(0).integers(0, ctx.cfg.vocab, (B, S))
        _STATE.update(ctx=ctx, jctx=jctx, p=p, q=q, struct=struct,
                      batch={"tokens": toks})
    return _STATE


def _redraw(p, rng):
    """The port's tree with the constants of the init redrawn: ``mu`` in
    [0, 1], ``bonus_u`` ~ N(0, 0.5), ``decay_w0`` in [-6, -1],
    ``ln_scale`` in [0.5, 1.5] (``tests/test_torch_rwkv.py``'s draws)."""
    draw = {("att", "mu"): lambda s: rng.uniform(0.0, 1.0, s),
            ("att", "bonus_u"): lambda s: 0.5 * rng.standard_normal(s),
            ("att", "decay_w0"): lambda s: rng.uniform(-6.0, -1.0, s),
            ("att", "ln_scale"): lambda s: rng.uniform(0.5, 1.5, s),
            ("ffn", "mu"): lambda s: rng.uniform(0.0, 1.0, s)}
    layers = {k: dict(v) for k, v in p["layers"].items()}
    for (mix, name), fn in draw.items():
        t = layers[mix][name]
        layers[mix][name] = torch.from_numpy(
            fn(tuple(t.shape)).astype(np.float32))
    return {**p, "layers": {**p["layers"], **layers}}


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


# ------------------------------- _wkv_chunked -------------------------------

def _wkv_inputs(S_, seed, B_=2, H=2, N=64):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B_, S_, H, N)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6, -1, (B_, S_, H, N)))).astype(
        np.float32)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = rng.standard_normal((B_, H, N, N)).astype(np.float32)
    cts = (rng.standard_normal((B_, S_, H, N)).astype(np.float32),
           rng.standard_normal((B_, H, N, N)).astype(np.float32))
    return (r, k, v, w, u, s0), cts


@pytest.mark.parametrize("S_", [5, 16, 21])
def test_wkv_chunked_gradients_match_jax(S_):
    args, (cy, cs) = _wkv_inputs(S_, 40 + S_)
    (yj, sj), vjp = jax.vjp(lambda *a: jrec._wkv_chunked(*a, 8),
                            *map(jnp.asarray, args))
    jgrads = vjp((jnp.asarray(cy), jnp.asarray(cs)))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    yt, st = trec._wkv_chunked(*ts, 8)
    ((yt * torch.from_numpy(cy)).sum()
     + (st * torch.from_numpy(cs)).sum()).backward()
    err = {}
    for name, got, want in [("y", yt.detach(), yj), ("state", st.detach(),
                                                     sj)] + [
            (f"d{n}", t.grad, g) for n, t, g in zip(
                ("r", "k", "v", "w", "u", "state0"), ts, jgrads)]:
        want = np.asarray(want)
        err[name] = float(np.abs(got.numpy() - want).max()) \
            / float(np.abs(want).max())
    assert max(err.values()) <= WKV_TOL, err


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
    gaps = _gaps(newq, jnq)
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
    assert _flat(setup.qstate).keys() == _flat(s["q"]).keys()
