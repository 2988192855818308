"""Port parity: the paper's SVHN (Table II) and muon (Table III) models in
``repro_torch`` against the JAX package: ``HConv2D`` and ``_chan_bits``,
``SVHNNet`` and ``MuonTracker``, their 20-step trajectories, ``from_jax``
of their trees, and the ``svhn`` and ``muon`` data kinds.

The JAX side runs with ``repro.core.hgq.quantize`` swapped for the JAX
kernel op ``repro.kernels.hgq_quantize`` (monkeypatched in the test;
nothing on disk changes), which lands on Eq. 4's exact grid as the port
does (``tests/test_torch_train.py`` says why JAX's own quantizer is not
the reference).  Inputs are made with numpy (or the JAX package's own
generators) and handed to both sides.  The configurations are the
paper's (``benchmarks/paper_tables.py``): per-parameter weight f,
per-tensor activation f, initial f 6; the batches are cut to 16 (SVHN)
and 64 (muon).

Tolerances:
- layers and models, forward: values, range states and logits bit for
  bit (the inputs sit on grids, and products and sums of grid values are
  exact in float32 in any order); ~EBOPs and L1 relative 1e-6 (float32
  sums of bits in another order); losses relative 1e-6.
- ``HConv2D`` in TRAIN, a loss of the output weighted by normal noise:
  its value within 1e-6 of the sum of its terms' magnitudes, its
  gradients within 1e-5 of each leaf's largest entry (the conv's backward
  sums non-grid products in another order).
- 20-step trajectories: loss and ~EBOPs relative gaps at every step below
  ``TRAJ_LIMIT`` = 1e-4.  Read (``test_trajectories`` prints them): SVHN
  loss 1.2e-7 and ~EBOPs 2.1e-6, muon loss 1.8e-7 and ~EBOPs 8.4e-6 at
  most; JAX's own surrogate quantizer, an ulp off the grid, lands at
  2.3e-2 (SVHN) and 6.7e-4 (muon).  The gradients' sums differ in the
  last ulps, and a weight that an ulp moves across a rounding point flips
  a grid step; ~EBOPs follow the continuous f, which AdamW moves by the
  sign of a gradient that may sit near zero.
"""
import argparse
import json
import math
import sys
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
    from repro.core.hgq import Aux as JAux, QTensor as JQTensor
    from repro.data import muon_batch as j_muon_batch
    from repro.data import svhn_batch as j_svhn_batch
    from repro.kernels import hgq_quantize as j_hgq_quantize
    from repro.models import MuonTracker as JMuon, SVHNNet as JSVHN
    from repro.nn import HGQConfig as JCfg
    from repro.nn import basic as jbasic
    from repro import optim as joptim
    from repro.train import losses as jlosses
    from repro.train import loop as jloop

from repro_torch import optim as toptim
from repro_torch.core.hgq import Aux, QTensor
from repro_torch.data import (DataSpec, make_pipeline, muon_batch,
                              svhn_batch)
from repro_torch.data.synthetic import MUON_STRIPS, muon_strips, svhn_blob
from repro_torch.models import MuonTracker, SVHNNet
from repro_torch.nn import HConv2D, HGQConfig
from repro_torch.nn import basic as tbasic
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train import losses as tlosses
from repro_torch.tree import tree_flatten_with_path, tree_leaves
from repro_torch.weights import from_jax

QCFG = dict(weight_gran="per_parameter", act_gran="per_tensor",
            init_weight_f=6.0, init_act_f=6.0)
TRAJ_LIMIT = 1e-4
TRAJ_STEPS = 20


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {"/".join(p): v.detach().numpy()
            for p, v in tree_flatten_with_path(tree)}


def _equal_trees(t_tree, j_tree):
    jl, tl = _flat_jax(j_tree), _flat_port(t_tree)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)


def _kernel_op(x, f):
    """The JAX kernel op, a per-channel f of shape (1, ..., 1, N) handed
    over as (N,), the shape its backward reduces to (autodiff reshapes
    the gradient back)."""
    if 1 < f.ndim and f.shape != x.shape and set(f.shape[:-1]) == {1}:
        return j_hgq_quantize(x, f.reshape(-1))
    return j_hgq_quantize(x, f)


@pytest.fixture
def kernel_quantizer(monkeypatch):
    """The JAX TRAIN quantizer swapped for its kernel op (exact grid)."""
    monkeypatch.setattr(jhgq, "quantize", _kernel_op)


def _torch_batch(b):
    return {k: torch.tensor(np.asarray(v)) for k, v in b.items()}


# ------------------------------- HConv2D ------------------------------------

def _grid(rng, shape, f=4, k=40):
    """Values k / 2^f with |k| <= k: products and sums stay exact."""
    return (rng.integers(-k, k + 1, shape) / 2.0 ** f).astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("gran", ["per_parameter", "per_channel"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_hconv2d_matches_jax(mode, bias, gran, stride, kernel_quantizer):
    """Values, range state and ~EBOPs bit for bit at TRAIN and EVAL (input
    on a grid, per-channel input bits); in TRAIN the gradients of a loss
    over the output and ~EBOPs within 1e-5 of each leaf's largest."""
    rng = np.random.default_rng([7, stride, bias, len(gran)])
    cfg = dict(QCFG, weight_gran=gran)
    jp, jq = jbasic.HConv2D.init(jax.random.PRNGKey(stride), 3, 3, 5, 6,
                                 JCfg(**cfg), bias=bias)
    jp = jax.tree.map(lambda a: a + 0.25 * jnp.asarray(
        rng.standard_normal(a.shape), a.dtype) if a.ndim else a, jp)
    # a tied range state: the output quantizer in TRAIN sees it decay
    jq = jax.tree.map(lambda a: a + 1.5, jq)
    tp, tq = from_jax(_np(jp), _np(jq), device="cpu")
    x = _grid(rng, (3, 11, 9, 5))
    bits = np.abs(_grid(rng, (5,), f=2)) + 1.0
    gy = rng.standard_normal((3, 5, 4, 6) if stride == 2
                             else (3, 9, 7, 6)).astype(np.float32)

    def jloss(p):
        aux = JAux.zero()
        y, nq = jbasic.HConv2D.apply(p, jq, JQTensor(jnp.asarray(x),
                                                     jnp.asarray(bits)),
                                     mode=mode, aux=aux, act="relu",
                                     stride=stride)
        return jnp.sum(y.q * gy) + 1e-3 * aux.ebops, (y, nq, aux.ebops,
                                                      aux.l1)

    (jl, (jy, jnq, jeb, jl1)), jg = jax.value_and_grad(jloss,
                                                       has_aux=True)(jp)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    from repro_torch.tree import tree_unflatten
    tpg = tree_unflatten(tp, leaves)
    aux = Aux.zero()
    ty, tnq = HConv2D.apply(tpg, tq, QTensor(torch.tensor(x),
                                             torch.tensor(bits)),
                            mode=mode, aux=aux, act="relu", stride=stride)
    np.testing.assert_array_equal(ty.q.detach().numpy(), np.asarray(jy.q))
    np.testing.assert_array_equal(ty.bits.detach().numpy(),
                                  np.asarray(jy.bits))
    _equal_trees(tnq, jnq)
    assert _rel(aux.ebops.detach(), jeb) < 1e-6
    assert _rel(aux.l1.detach(), jl1) < 1e-6
    if mode != "train":
        return
    tl = torch.sum(ty.q * torch.tensor(gy)) + 1e-3 * aux.ebops
    # a float32 sum of terms of both signs: within 1e-6 of their magnitudes
    terms = float(np.abs(np.asarray(jy.q) * gy).sum()) + 1e-3 * float(jeb)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * terms
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    tg = tree_unflatten(tp, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(leaves, grads)])
    jgf, tgf = _flat_jax(jg), _flat_port(tg)
    assert sorted(jgf) == sorted(tgf)
    for k in jgf:
        scale = max(float(np.abs(jgf[k]).max()), 1e-30)
        assert float(np.abs(tgf[k] - jgf[k]).max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("shape", [(), (5,), (4, 3, 5), (7,), (2, 7)])
def test_chan_bits_matches_jax(shape):
    """Scalar bits stay, per-channel bits (any leading axes) collapse by
    max over all but the last, bits of another width collapse to one max;
    the gradient is split among ties as JAX splits it."""
    rng = np.random.default_rng(len(shape) * 10 + sum(shape))
    b = np.floor(rng.uniform(0, 4, shape)).astype(np.float32)
    w = rng.standard_normal(np.shape(jbasic._chan_bits(jnp.asarray(b), 5))
                            ).astype(np.float32)
    jf = lambda v: jnp.sum(jbasic._chan_bits(v, 5) * w)
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(b))
    tb = torch.tensor(b, requires_grad=True)
    tv = tbasic._chan_bits(tb, 5)
    assert tuple(tv.shape) == np.shape(jbasic._chan_bits(jnp.asarray(b), 5))
    (tv * torch.tensor(w)).sum().backward()
    assert float((tv * torch.tensor(w)).sum().detach()) == float(jv)
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("padding,stride", [("SAME", 1), ("SAME", 2)])
def test_conv2d_nhwc_same_padding_matches_jax(padding, stride):
    """XLA's SAME padding (the low side takes the smaller half) on odd and
    even sizes: bit for bit on grid values."""
    rng = np.random.default_rng(stride)
    x, w = _grid(rng, (2, 8, 7, 3)), _grid(rng, (3, 3, 3, 4))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tbasic.conv2d_nhwc(torch.tensor(x), torch.tensor(w), stride,
                             padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tbasic.conv2d_nhwc(torch.tensor(x), torch.tensor(w), 1, "FULL")


def test_conv_runs_in_full_float32_whatever_the_global_flag():
    """The layer's cuDNN settings are its own: full float32 (no TF32) and
    deterministic, set around the forward and the backward, and the
    caller's global flags are left as they were."""
    assert tbasic.CUDNN_FLAGS["allow_tf32"] is False
    assert tbasic.CUDNN_FLAGS["deterministic"] is True
    before = torch.backends.cudnn.allow_tf32
    x = torch.randn((1, 5, 5, 2), requires_grad=True)
    w = torch.randn((3, 3, 2, 2), requires_grad=True)
    tbasic.conv2d_nhwc(x, w).sum().backward()
    assert torch.backends.cudnn.allow_tf32 == before
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


# ------------------------------- the models ---------------------------------

def _svhn_pair(seed=0):
    jp, jq = JSVHN.init(jax.random.PRNGKey(seed), JCfg(**QCFG))
    return (jp, jq), from_jax(_np(jp), _np(jq), device="cpu")


def _muon_pair(seed=0):
    jp, jq = JMuon.init(jax.random.PRNGKey(seed), JCfg(**QCFG))
    return (jp, jq), from_jax(_np(jp), _np(jq), device="cpu")


MODELS = {
    "svhn": dict(pair=_svhn_pair, J=JSVHN, T=SVHNNet, batch=16,
                 data=lambda s, n: j_svhn_batch(0, s, n),
                 jloss=lambda o, b: jlosses.softmax_xent(o, b["y"]),
                 tloss=lambda o, b: tlosses.softmax_xent(o, b["y"]),
                 tcfg=dict(lr=2e-3, beta0=1e-7, beta1=1e-4, gamma=2e-6)),
    "muon": dict(pair=_muon_pair, J=JMuon, T=MuonTracker, batch=64,
                 data=lambda s, n: j_muon_batch(0, s, n),
                 jloss=lambda o, b: jlosses.mse(o, b["target"]) * 1e-3,
                 tloss=lambda o, b: tlosses.mse(o, b["target"]) * 1e-3,
                 tcfg=dict(lr=3e-3, beta0=3e-6, beta1=6e-4, gamma=2e-6)),
}


@pytest.mark.parametrize("mode", ["train", "calib", "eval"])
@pytest.mark.parametrize("model", ["svhn", "muon"])
def test_model_forward_loss_and_ebops_match_jax(model, mode,
                                                kernel_quantizer):
    m = MODELS[model]
    (jp, jq), (tp, tq) = m["pair"]()
    b = m["data"](3, m["batch"])
    jout, jnq, jaux = m["J"].forward(jp, jq, b, mode=mode)
    tb = _torch_batch(b)
    tout, tnq, taux = m["T"].forward(tp, tq, tb, mode=mode)
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    _equal_trees(tnq, jnq)
    assert _rel(taux.ebops.detach(), jaux.ebops) < 1e-6
    assert _rel(taux.l1.detach(), jaux.l1) < 1e-6
    assert _rel(m["tloss"](tout, tb).detach(), m["jloss"](jout, b)) < 1e-6


def _jax_losses(model, jp, jq, batches):
    """(loss, ~EBOPs, beta) per step of the JAX train step as
    repro.core.hgq stands when it is traced."""
    m = MODELS[model]
    jstep = jax.jit(jloop.make_train_step(
        lambda p, q, b, mode: m["J"].forward(p, q, b, mode), m["jloss"],
        jloop.TrainConfig(steps=TRAJ_STEPS, **m["tcfg"])))
    jopt, out = joptim.adamw_init(jp), []
    for s, b in enumerate(batches):
        jp, jq, jopt, jm = jstep(jp, jq, jopt, b, jnp.int32(s))
        out.append((float(jm["loss"]), float(jm["ebops"]), float(jm["beta"])))
    return out


@pytest.mark.parametrize("model", ["svhn", "muon"])
def test_trajectories(model, monkeypatch):
    """20 steps from one init and one set of batches: against the JAX step
    with the kernel op, loss and ~EBOPs within ``TRAJ_LIMIT`` (relative)
    at every step; JAX's own surrogate quantizer lands above it."""
    m = MODELS[model]
    (jp, jq), (tp, tq) = m["pair"]()
    batches = [m["data"](s, m["batch"]) for s in range(TRAJ_STEPS)]
    surrogate = _jax_losses(model, jp, jq, batches)     # traced unpatched
    monkeypatch.setattr(jhgq, "quantize", _kernel_op)
    exact = _jax_losses(model, jp, jq, batches)
    tstep = make_train_step(
        lambda p, q, b, mode: m["T"].forward(p, q, b, mode), m["tloss"],
        TrainConfig(steps=TRAJ_STEPS, **m["tcfg"]))
    topt, port = toptim.adamw_init(tp), []
    for s, b in enumerate(batches):
        tp, tq, topt, tm = tstep(tp, tq, topt, _torch_batch(b), s)
        port.append((float(tm["loss"]), float(tm["ebops"]),
                     float(tm["beta"])))
    gap = lambda ref, i: max(_rel(p[i], r[i]) for p, r in zip(port, ref))
    sur = max(gap(surrogate, 0), gap(surrogate, 1))
    print(f"\n{model} port vs JAX, {TRAJ_STEPS} steps: loss rel gap max "
          f"{gap(exact, 0):.3g}, ~EBOPs {gap(exact, 1):.3g} against the "
          f"kernel-op step; {sur:.3g} against JAX's own quantizer")
    for s, (p, r) in enumerate(zip(port, exact)):
        assert _rel(p[0], r[0]) <= TRAJ_LIMIT, (s, p, r)
        assert _rel(p[1], r[1]) <= TRAJ_LIMIT, (s, p, r)
        assert _rel(p[2], r[2]) <= 1e-6
    assert sur > TRAJ_LIMIT
    if model == "svhn":                             # it learned
        assert port[-1][0] < port[0][0]
    assert int(topt.step) == TRAJ_STEPS


@pytest.mark.parametrize("model", ["svhn", "muon"])
def test_from_jax_round_trip(model):
    """JAX's trees carry into the port unchanged (HWIO conv kernels
    included) and back to numpy bit for bit; the port's own init has the
    same keys and shapes, and per-parameter f on every weight and bias."""
    m = MODELS[model]
    (jp, jq), (tp, tq) = m["pair"](5)
    _equal_trees(tp, jp)
    _equal_trees(tq, jq)
    g = torch.Generator().manual_seed(0)
    op, oq = m["T"].init(g, HGQConfig(**QCFG), device="cpu")
    shapes = lambda flat: {k: np.shape(v) for k, v in flat.items()}
    assert shapes(_flat_port({"p": op, "q": oq})) == \
        shapes(_flat_jax({"p": jp, "q": jq}))
    for name, layer in op.items():
        if isinstance(layer, dict) and "kernel" in layer:
            for k in ("kernel", "bias"):
                assert layer[k]["f"].shape == layer[k]["w"].shape, name
                assert bool((layer[k]["f"] == 6.0).all())
    if model == "svhn":
        assert tuple(tp["c1"]["kernel"]["w"].shape) == (3, 3, 16, 16)
        w = op["c0"]["kernel"]["w"]
        lim = (3.0 / 27) ** 0.5                     # fan-in kh * kw * cin
        assert float(w.abs().max()) <= lim and float(w.std()) > lim / 3


# ------------------------------- the data -----------------------------------

def test_svhn_batch_is_a_function_of_seed_and_step():
    a, b = svhn_batch(3, 5, 64, device="cpu"), svhn_batch(3, 5, 64,
                                                          device="cpu")
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
    assert not torch.equal(a["x"], svhn_batch(3, 6, 64, device="cpu")["x"])
    assert a["x"].shape == (64, 32, 32, 3) and a["y"].dtype == torch.int64
    big = svhn_batch(0, 0, 2000, device="cpu")
    counts = torch.bincount(big["y"], minlength=10).numpy()
    assert counts.min() > 140 and counts.max() < 260
    # what is left after the blob is U(0, 1) on every pixel and channel
    rest = big["x"] - 2.0 * svhn_blob(big["y"])[..., None]
    assert float(rest.min()) >= -1e-6 and float(rest.max()) < 1.0 + 1e-6
    assert abs(float(rest.mean()) - 0.5) < 0.01
    assert abs(float(rest.var()) - 1.0 / 12) < 0.002
    # the reference's images carry the same blob on its own labels
    j = j_svhn_batch(0, 1, 256)
    jrest = np.asarray(j["x"]) - 2.0 * svhn_blob(
        torch.tensor(np.asarray(j["y"])).long()).numpy()[..., None]
    assert jrest.min() >= -1e-6 and jrest.max() < 1.0 + 1e-6


def test_muon_batch_is_a_function_of_seed_and_step():
    a, b = muon_batch(3, 5, 256, device="cpu"), muon_batch(3, 5, 256,
                                                           device="cpu")
    assert torch.equal(a["stations"], b["stations"])
    assert torch.equal(a["target"], b["target"])
    assert not torch.equal(a["target"],
                           muon_batch(3, 6, 256, device="cpu")["target"])
    big = muon_batch(0, 0, 8000, device="cpu")
    x, t = big["stations"], big["target"]
    assert x.shape == (8000, 3, 150) and t.shape == (8000,)
    assert set(torch.unique(x).tolist()) <= {0.0, 1.0}
    assert float(t.min()) >= -250.0 and float(t.max()) < 250.0
    assert abs(float(t.mean())) < 5.0 and abs(float(t.std()) - 500 / 12 ** .5
                                              ) < 3.0

    def track_hits(x, target):
        """Per (track, station, layer): the hits within one strip of the
        track's strip (cyclically), and the hits elsewhere."""
        strips = muon_strips(target / 1000.0)
        maps = x.reshape(-1, 3, 3, MUON_STRIPS)
        pos = torch.arange(MUON_STRIPS)
        d = (pos - strips[:, :, None, None]) % MUON_STRIPS
        near = (d <= 1) | (d == MUON_STRIPS - 1)
        return (maps * near).sum(-1), (maps * ~near).sum()

    near, far = track_hits(x, t)
    assert bool((near >= 1).all())                   # the track fired
    noise = float(far) / (x.numel() - 3 * near.numel())
    assert 0.004 < noise < 0.006
    # the jitter: -1, 0 and 1 equally often where no noise hit lies near
    strips = muon_strips(t / 1000.0)
    maps = x.reshape(-1, 3, 3, MUON_STRIPS)
    clean = near == 1
    fired = torch.argmax(maps, dim=-1)
    shift = (fired - strips[:, :, None] + 1) % MUON_STRIPS
    counts = torch.bincount(shift[clean], minlength=3).numpy()[:3]
    assert counts.min() > 0.3 * counts.sum()
    # the reference's hit maps follow the same strips from its own angles
    j = j_muon_batch(0, 1, 1024)
    jnear, _ = track_hits(torch.tensor(np.asarray(j["stations"])),
                          torch.tensor(np.asarray(j["target"])))
    assert bool((jnear >= 1).all())


def test_pipeline_serves_the_paper_kinds():
    for kind, key in (("svhn", "x"), ("muon", "stations")):
        pipe = make_pipeline(DataSpec(kind=kind, batch=4, seed=2),
                             device="cpu")
        ref = (svhn_batch if kind == "svhn" else muon_batch)(2, 7, 4,
                                                             device="cpu")
        assert torch.equal(pipe(7)[key], ref[key])
        if not torch.cuda.is_available():    # the card is the default
            with pytest.raises(RuntimeError):
                make_pipeline(DataSpec(kind=kind, batch=4))


# ------------------- the full configurations' JAX reference -----------------

PAPER = {
    "svhn": dict(batch=128, steps=120, lr=2e-3, beta0=1e-7, beta1=1e-4),
    "muon": dict(batch=1024, steps=500, lr=3e-3, beta0=3e-6, beta1=6e-4),
}


def jax_reference(model: str) -> dict:
    """The JAX package at the paper's configuration on the CPU, as
    ``benchmarks/paper_tables.py`` trains it (its own quantizer, init key
    0, data seed 0): the metric and ~EBOPs of a CALIB pass on the held-out
    batch of step 10^6, and the TRAIN ~EBOPs every 10 steps."""
    from repro.data import DataSpec as JDataSpec, make_pipeline as jpipe
    from repro.train import Trainer as JTrainer
    m, c = MODELS[model], PAPER[model]
    metric = (lambda o, b: jlosses.accuracy(o, b["y"])) if model == "svhn" \
        else (lambda o, b: jlosses.rms_resolution(o, b["target"]))
    jp, jq = m["J"].init(jax.random.PRNGKey(0), JCfg(**QCFG))
    pipe = jpipe(JDataSpec(kind=model, batch=c["batch"]))
    tc = jloop.TrainConfig(steps=c["steps"], lr=c["lr"], beta0=c["beta0"],
                           beta1=c["beta1"], log_every=10, eval_every=10 ** 9)
    tr = JTrainer(lambda p, q, b, mode: m["J"].forward(p, q, b, mode),
                  m["jloss"], tc, jp, jq, pipeline=pipe)
    tr.run(log=lambda *a: None)
    b = pipe(10 ** 6)
    out, _, aux = m["J"].forward(tr.params, tr.qstate, b, mode=jhgq.CALIB)
    return {"model": model, **c, "metric": float(metric(out, b)),
            "calib_ebops": float(aux.ebops),
            "train_ebops": {h["step"]: h["ebops"] for h in tr.history}}


def port_cpu_run(model: str, seed: int) -> dict:
    """The port at the paper's configuration on the CPU, init and data
    from ``seed`` (its own generators): the same readings as
    ``jax_reference``, for the spread the card's margins must allow."""
    from repro_torch.core import hgq as thgq
    from repro_torch.train import Trainer, accuracy, rms_resolution
    m, c = MODELS[model], PAPER[model]
    metric = (lambda o, b: accuracy(o, b["y"])) if model == "svhn" \
        else (lambda o, b: rms_resolution(o, b["target"]))
    p, q = m["T"].init(torch.Generator().manual_seed(seed),
                       HGQConfig(**QCFG), device="cpu")
    pipe = make_pipeline(DataSpec(kind=model, batch=c["batch"], seed=seed),
                         device="cpu")
    tc = TrainConfig(steps=c["steps"], lr=c["lr"], beta0=c["beta0"],
                     beta1=c["beta1"], log_every=10)
    tr = Trainer(lambda p_, q_, b, mode: m["T"].forward(p_, q_, b, mode),
                 m["tloss"], tc, p, q, pipeline=pipe)
    tr.run(log=lambda *a: None)
    b = pipe(10 ** 6)
    with torch.no_grad():
        out, _, aux = m["T"].forward(tr.params, tr.qstate, b,
                                     mode=thgq.CALIB)
    return {"model": model, "seed": seed, **c,
            "metric": float(metric(out, b)), "calib_ebops": float(aux.ebops),
            "train_ebops": {h["step"]: h["ebops"] for h in tr.history}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        description="Print the JAX package's metric at the paper's SVHN and "
                    "muon configurations (the reference chip_smoke.py holds "
                    "the port's card run to), and with --port the port's on "
                    "the CPU from seeds 0 and 1.")
    ap.add_argument("--reference", choices=("svhn", "muon", "both"),
                    default="both")
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    for name in (("svhn", "muon") if args.reference == "both"
                 else (args.reference,)):
        print(json.dumps(jax_reference(name)), flush=True)
        if args.port:
            for seed in (0, 1):
                print(json.dumps(port_cpu_run(name, seed)), flush=True)
    sys.exit(0)
