"""Port parity: HGQ training of the MoE family in ``repro_torch`` against
the JAX package, at granite-moe-3b-a800m SMOKE (2 layers, d 48, 5
experts of d_ff 16, top 2, vocab 256, per-channel weights: each expert
stack's f is [E, 1, N]), on trees carried across with
``weights.from_jax`` from one seeded JAX init; inputs are made with numpy
(or the JAX package's own generator) and handed to both sides.

The JAX side runs with its TRAIN quantizer entries
(``repro.core.hgq.quantize``, ``repro.nn.attention.quantize``) swapped
for its kernel op ``repro.kernels.hgq_quantize`` on Eq. 4's exact grid,
as ``tests/test_torch_lm_train.py`` does (monkeypatched in the test;
nothing on disk changes).  That op takes an expert stack's f per expert
here (one call an expert), since its own backward reduces only the
per-tensor, per-channel and per-parameter shapes.  The JAX side is
jitted (its eager per-op compiles take minutes).

Tolerances:
- ``layout_of``: the per-expert layouts exactly, every other broadcast
  refused.
- The dispatch backward: on inputs where every product is exact and a
  token's k slot gradients are 2^27, -2^27, 1 and 0 (ascending experts
  give 1, the reverse 0), ``dx`` equals JAX's ``jax.grad`` bit for bit
  (a dropped token's too); a descending-order sum does not.
- TRAIN ``forward`` of the 2-layer MoE LM: loss and ~EBOPs (the experts'
  share scaled by k/E) relative 1e-6, and the gradient of every leaf of
  the Eq.-16 total, each expert stack's f among them, within 1e-3 of the
  leaf's largest entry (XLA's and PyTorch's float32 matmuls, ``exp`` and
  sums differ in the last ulps, which the quantizers' residuals magnify
  in the f gradients, as in ``test_torch_lm_train.py``).
- One ``make_train_step`` step: loss, total and ~EBOPs relative 1e-6,
  gradient norm 1e-5; remat on and off, and ``donate`` on and off, give
  the same bits over two steps.
"""
import dataclasses
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
    from repro.configs import get as jget
    from repro.core.hgq import Aux as JAux
    from repro.core.hgq import QTensor as JQ
    from repro.data import lm_batch as j_lm_batch
    from repro.kernels import hgq_quantize as j_hgq_quantize
    from repro.models import model_for
    from repro.nn import moe as jmoe
    from repro import optim as joptim
    from repro.train import losses as jlosses
    from repro.train import loop as jloop

import repro_torch.kernels.hgq_quantize.ops as hops
from repro_torch import optim as toptim
from repro_torch.configs import get as tget
from repro_torch.core import hgq
from repro_torch.core.hgq import QTensor
from repro_torch.kernels.hgq_quantize import layout_of
from repro_torch.models import TransformerLM
from repro_torch.nn import moe as tmoe
from repro_torch.train import TrainConfig, lm_loss, make_train_step
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_unflatten)
from repro_torch.weights import from_jax

B, S = 2, 24
# the launcher's optimizer settings (src/repro/api/spec.py), a beta that
# gives ~EBOPs a share of the total like the loss's
TCFG = dict(steps=4, lr=1e-3, beta0=1e-8, beta1=1e-7)
BETA, GAMMA = 1e-7, 2e-6
GRAD_LIMIT = 1e-3


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {"/".join(p): v.detach().numpy()
            for p, v in tree_flatten_with_path(tree)}


def _kernel_op(x, f):
    """The JAX kernel op; a per-channel f of shape (1, ..., 1, N) handed
    over as (N,), and an expert stack's f ((E, 1, ..., 1, N) or (E, 1,
    ..., 1)) one expert at a time, the shapes its backward reduces to."""
    if 1 < f.ndim and f.shape != x.shape and set(f.shape[:-1]) == {1}:
        return j_hgq_quantize(x, f.reshape(-1))
    if 2 < f.ndim == x.ndim and f.shape != x.shape \
            and f.shape[0] == x.shape[0] > 1 and set(f.shape[1:-1]) == {1}:
        per = (lambda fe: fe.reshape(-1)) if f.shape[-1] == x.shape[-1] \
            else (lambda fe: fe.reshape(()))
        return jnp.stack([j_hgq_quantize(x[e], per(f[e]))
                          for e in range(x.shape[0])])
    return j_hgq_quantize(x, f)


@pytest.fixture
def kernel_quantizer(monkeypatch):
    """Both JAX TRAIN quantizer entries swapped for the kernel op."""
    monkeypatch.setattr(jhgq, "quantize", _kernel_op)
    monkeypatch.setattr(jattn, "quantize", _kernel_op)


_TREES = {}


def _trees():
    """(JAX cfg, port cfg, JAX params, JAX qstate), one seeded JAX init."""
    if not _TREES:
        jc = jget("granite-moe-3b-a800m", smoke=True)
        tc = tget("granite-moe-3b-a800m", smoke=True)
        p, q = jax.jit(functools.partial(model_for(jc).init, cfg=jc))(
            jax.random.PRNGKey(0))
        _TREES["smoke"] = (jc, tc, p, q)
    return _TREES["smoke"]


def _port_trees(p, q):
    return from_jax(jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, q),
                    device="cpu")


def _tokens(step, batch=B, seq=S):
    jc = _trees()[0]
    return np.array(j_lm_batch(0, step, batch, seq, jc.vocab)["tokens"])


# ---------------------------------- layouts ---------------------------------

@pytest.mark.parametrize("x_shape,f_shape,want", [
    ((40, 1536, 512), (40, 1, 512), "per_expert_channel"),
    ((40, 512, 1536), (40, 1, 1536), "per_expert_channel"),
    ((40, 1536, 512), (40, 1, 1), "per_expert_tensor"),
    ((5, 3, 4, 16), (5, 1, 1, 16), "per_expert_channel"),
    ((5, 3, 4, 16), (5, 1, 1, 1), "per_expert_tensor"),
    ((5, 1, 16), (5, 1, 1), "per_expert_tensor"),          # K = 1
    ((1, 48, 16), (1, 1, 16), "per_channel"),              # E = 1
    ((1, 48, 16), (1, 1, 1), "per_expert_tensor"),
    ((5, 1, 16), (5, 1, 16), "per_parameter"),
    # shapes no kernel takes
    ((5, 48, 16), (5, 48, 1), None), ((5, 48, 16), (1, 48, 16), None),
    ((5, 48, 16), (5, 16), None), ((5, 48, 16), (3, 1, 16), None),
    ((5, 48, 16), (5, 1, 8), None), ((5, 48, 16), (5, 1), None),
    ((5, 16), (5, 1), None), ((5, 3, 4, 16), (5, 3, 1, 16), None),
])
def test_layout_of_per_expert(x_shape, f_shape, want):
    assert layout_of(x_shape, f_shape) == want


# ------------------------- the dispatch backward's order --------------------

def _order_case():
    """A 4-of-8 MoE, 3 tokens a row, in which every product is exact and a
    token's k slot gradients in ascending expert order are 2^27, -2^27, 1
    and 0: router zeros (every probability 1/8, experts 0-3 by the
    lower-index-first rule, gates 1/4), linear experts that pass x's
    column 0, expert e's down row c_e = 2^25, -2^25, 2^-2, 0 in every
    column.  With d = 8 a slot's gradient in column 0 is 4 c_e; the
    capacity (C = 2) drops the third token's pairs."""
    cfg = dict(d_model=8, d_ff=4, n_experts=8, top_k=4, act="linear")
    gate = np.zeros((8, 8, 4), np.float32)
    gate[:, 0, 0] = 1.0
    down = np.zeros((8, 4, 8), np.float32)
    for e, c in enumerate((2.0 ** 25, -2.0 ** 25, 0.25, 0.0)):
        down[e, 0, :] = c
    p = {"router": {"kernel": {"w": np.zeros((8, 8), np.float32)}},
         "gate": {"w": gate}, "up": {"w": gate.copy()}, "down": {"w": down}}
    x = np.ones((2, 3, 8), np.float32)
    return cfg, p, x


def _port_dx(cfg, p, x):
    xt = torch.tensor(x, requires_grad=True)
    y, _ = tmoe.MoE.apply(jax.tree.map(torch.from_numpy, p),
                          {"router": {}}, QTensor(xt, None),
                          cfg=tmoe.MoEConfig(**cfg), mode=hgq.EVAL,
                          aux=None)
    return y.q, xt


def _descending(contrib):
    """Control: a token's k terms added in the reverse order."""
    y = torch.zeros(contrib.shape[:2] + contrib.shape[3:],
                    dtype=contrib.dtype)
    for j in reversed(range(contrib.shape[2])):
        y = y + contrib[:, :, j]
    return y


def test_dispatch_backward_order_is_jax_bit_for_bit(monkeypatch):
    cfg, p, x = _order_case()
    jm = jmoe.MoEConfig(**cfg)

    def jax_out(xj):
        y, _ = jmoe.MoE.apply(jax.tree.map(jnp.asarray, p), {"router": {}},
                              JQ(xj, None), cfg=jm, mode="eval",
                              aux=JAux.zero())
        return jnp.sum(y.q)

    dx_j = np.asarray(jax.grad(jax_out)(jnp.asarray(x)))
    y, xt = _port_dx(cfg, p, x)
    dx, = torch.autograd.grad(y.sum(), xt)
    np.testing.assert_array_equal(dx.numpy(), dx_j)
    # the order shows: the kept tokens' column 0 is 1 in ascending expert
    # order, the dropped token's +0.0
    assert (dx_j[:, :2, 0] == 1.0).all() and (dx_j[:, 2] == 0.0).all()
    y, xt = _port_dx(cfg, p, x)
    monkeypatch.setattr(tmoe, "_add_in_order", _descending)
    dx_desc, = torch.autograd.grad(y.sum(), xt)
    assert (dx_desc[:, :2, 0] == 0.0).all()
    assert not np.array_equal(dx_desc.numpy(), dx_j)


def test_dispatch_gather_forward_and_backward_match_the_plain_gather():
    """On random inputs the buffer equals the plain gather's, and the
    backward the accumulating ``index_put``'s within float32 rounding."""
    rng = np.random.default_rng(3)
    cfg = tmoe.MoEConfig(d_model=16, d_ff=8, n_experts=5, top_k=2)
    x = torch.tensor(rng.standard_normal((2, 24, 16)).astype(np.float32),
                     requires_grad=True)
    eidx = tmoe.route(torch.tensor(rng.standard_normal((2, 24, 5))
                                   .astype(np.float32)), 2)[1]
    E, C = 5, tmoe.capacity(24, cfg)
    dsp = tmoe.dispatch(eidx, E, C)
    ts = tmoe.token_slots(eidx, dsp, C)
    tok = (dsp.slot_token + 24 * torch.arange(2)[:, None, None]) \
        .permute(1, 0, 2).reshape(E, 2 * C)
    filled = dsp.filled.permute(1, 0, 2).reshape(E, 2 * C, 1)
    xe = tmoe._DispatchGather.apply(x, tok, filled,
                                    torch.where(ts.valid, ts.rows,
                                                E * 2 * C))
    bidx = torch.arange(2).repeat_interleave(C)
    plain = torch.where(filled, x[bidx.expand(E, -1), dsp.slot_token
                                  .permute(1, 0, 2).reshape(E, 2 * C)], 0.0)
    assert torch.equal(xe, plain)
    assert (~dsp.valid).any(), "no pair dropped"
    ct = torch.tensor(rng.standard_normal(xe.shape).astype(np.float32))
    got, = torch.autograd.grad(xe, x, ct)
    want, = torch.autograd.grad(plain, x, ct)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ------------------------ the MoE LM in TRAIN against JAX --------------------

def _jax_value_and_grad(batch):
    """(loss, ~EBOPs, L1, grads of the Eq.-16 total) of the JAX forward
    with the kernel op, jitted."""
    jc, _, p, q = _trees()
    M = model_for(jc)

    def total(p):
        out, _, aux = M.forward(p, q, batch, jc, mode="train")
        base = jlosses.lm_loss(out, batch["tokens"])
        return base + BETA * aux.ebops + GAMMA * aux.l1, (base, aux.ebops,
                                                          aux.l1)

    (_, (base, ebops, l1)), grads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(p)
    return float(base), float(ebops), float(l1), _flat_jax(grads)


def _port_value_and_grad(tp, tq, tc, toks):
    """The port's counterpart of ``_jax_value_and_grad``."""
    names = ["/".join(n) for n, _ in tree_flatten_with_path(tp)]
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    out, _, aux = TransformerLM.forward(tree_unflatten(tp, leaves), tq,
                                        {"tokens": torch.from_numpy(toks)},
                                        tc, mode=hgq.TRAIN)
    base = lm_loss(out, torch.from_numpy(toks))
    total = base + BETA * aux.ebops + GAMMA * aux.l1
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return (float(base.detach()), float(aux.ebops.detach()),
            float(aux.l1.detach()),
            {n: (np.zeros(tuple(t.shape), np.float32) if g is None
                 else g.numpy()) for n, t, g in zip(names, leaves, grads)})


def _expert_df_summed(real):
    """Control: an expert stack's f gradient summed over all experts (a
    per-channel reduction that crosses the experts' boundary)."""
    def grad_ref(g, x, f):
        df = real(g, x, f)
        if f.ndim == 3 and f.shape[0] > 1 and f.shape[1] == 1:
            return df.sum(0, keepdim=True).expand_as(df).clone()
        return df
    return grad_ref


def test_moe_lm_forward_train_matches_jax(kernel_quantizer, monkeypatch):
    """Loss, ~EBOPs, L1 and every gradient (read: 7.0e-5 of the leaf's
    largest entry at most, ``final_norm/out_f``; the stacks' f below
    1e-6); the stacks' f gradients summed over the experts miss the
    limit."""
    jc, tc, p, q = _trees()
    toks = _tokens(0)
    base_j, ebops_j, l1_j, grads_j = _jax_value_and_grad(
        {"tokens": jnp.asarray(toks)})
    tp, tq = _port_trees(p, q)
    base, ebops, l1, got = _port_value_and_grad(tp, tq, tc, toks)
    assert _rel(base, base_j) < 1e-6
    assert _rel(ebops, ebops_j) < 1e-6
    assert _rel(l1, l1_j) < 1e-6
    assert BETA * ebops_j > 0.1 * base_j        # ~EBOPs carry weight

    def gaps(got):
        assert sorted(got) == sorted(grads_j)
        return {k: float(np.abs(got[k] - grads_j[k]).max())
                / max(float(np.abs(grads_j[k]).max()), 1e-30) for k in got}

    assert max(gaps(got).values()) < GRAD_LIMIT, gaps(got)
    stacks = [f"layers/moe/{s}/f" for s in ("gate", "up", "down")]
    for k in stacks:
        assert grads_j[k].shape == (2, 5, 1, grads_j[k].shape[-1])
        assert np.abs(grads_j[k]).min(axis=-1).max() > 0, k
    monkeypatch.setattr(hops.ref, "hgq_quantize_grad_ref",
                        _expert_df_summed(hops.ref.hgq_quantize_grad_ref))
    faulty = gaps(_port_value_and_grad(tp, tq, tc, toks)[3])
    assert min(faulty[k] for k in stacks) > 10 * GRAD_LIMIT, faulty


def _port_run(cfg, steps, donate=False):
    jc, tc, p, q = _trees()
    tp, tq = _port_trees(p, q)
    step = make_train_step(
        lambda p, q, b, mode: TransformerLM.forward(p, q, b, cfg, mode),
        lambda o, b: lm_loss(o, b["tokens"]), TrainConfig(**TCFG),
        donate=donate)
    opt, out = toptim.adamw_init(tp), []
    for s in range(steps):
        tp, tq, opt, m = step(tp, tq, opt,
                              {"tokens": torch.from_numpy(_tokens(s))}, s)
        out.append({k: float(v) for k, v in m.items()})
    return out, (tp, tq, opt.mu, opt.nu)


def test_train_step_matches_jax(kernel_quantizer):
    jc, _, p, q = _trees()
    M = model_for(jc)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, q, b, mode: M.forward(p, q, b, jc, mode),
        lambda o, b: jlosses.lm_loss(o, b["tokens"]),
        jloop.TrainConfig(**TCFG)))
    _, _, _, mj = jstep(p, q, joptim.adamw_init(p),
                        {"tokens": jnp.asarray(_tokens(0))}, jnp.int32(0))
    mt, _ = _port_run(_trees()[1], 1)
    for k in ("loss", "total", "ebops"):
        assert _rel(mt[0][k], mj[k]) < 1e-6, k
    assert _rel(mt[0]["gnorm"], mj["gnorm"]) < 1e-5


@pytest.mark.parametrize("variant", ["remat_off", "donate"])
def test_remat_and_donate_give_the_same_bits(variant):
    tc = _trees()[1]
    ref, ref_state = _port_run(tc, 2)
    if variant == "remat_off":
        got, state = _port_run(dataclasses.replace(tc, remat=False), 2)
    else:
        got, state = _port_run(tc, 2, donate=True)
    assert got == ref
    for a, b in zip(ref_state, state):
        fa, fb = _flat_port(a), _flat_port(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
