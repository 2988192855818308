"""Port parity: the HGQ quantizer op ``repro_torch.kernels.hgq_quantize``
against the JAX package's kernel op (Pallas, interpret mode) and its
plain reference, and the port's training quantizer against JAX's.

The forward is compared bit for bit; ``df`` is a float32 sum, whose
order differs between the two packages, so it is held at rtol 1e-5 /
atol 1e-6 (the tolerance of ``tests/test_kernels.py`` for the kernel
against Algorithm 1); ``dx`` is ``g`` itself.  Inputs are made with
numpy from a seed and handed to both sides."""
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.nn imports repro.dist lazily)
    from repro.core import quantizer as jq
    from repro.kernels import hgq_quantize as j_hgq_quantize
    from repro.kernels.hgq_quantize.ref import hgq_quantize_ref as j_ref

from repro_torch.core import quantizer as tq
from repro_torch.kernels.hgq_quantize import (hgq_quantize,
                                              hgq_quantize_bwd,
                                              hgq_quantize_fwd,
                                              hgq_quantize_grad_ref,
                                              hgq_quantize_ref, layout_of)

# tests/test_kernels.py's QUANT_SHAPES, plus the (1, ..., 1, N) per-channel
# f that f_shape_for gives weights
QUANT_SHAPES = [((64, 256), ()), ((64, 256), (256,)), ((64, 256), (64, 256)),
                ((3, 5, 100), ()), ((3, 5, 100), (100,)), ((7,), (7,)),
                ((33, 130), (130,)), ((1, 128), (1, 128)), ((2, 2, 2, 64), ()),
                ((64, 256), (1, 256)), ((33, 130), (1, 130)),
                ((3, 5, 100), (1, 1, 100))]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to(torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same(j, t) -> None:
    jb, tb = _bits(j), _bits(t)
    assert jb.shape == tb.shape
    bad = np.flatnonzero(jb != tb)
    assert bad.size == 0, f"{bad.size} of {jb.size} differ"


def _inputs(shape, fshape, jdt, seed):
    rng = np.random.default_rng(seed)
    # x rounded to the working dtype once, so both sides read the same values
    x = np.asarray(jnp.asarray(rng.normal(size=shape).astype(np.float32) * 4,
                               jdt), np.float32)
    f = rng.uniform(-1, 8, size=fshape).astype(np.float32)
    g = np.asarray(jnp.asarray(rng.normal(size=shape).astype(np.float32),
                               jdt), np.float32)
    return x, f, g


@pytest.mark.parametrize("shape,fshape", QUANT_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_and_grads_match_jax(shape, fshape, dtype):
    jdt, tdt = DTYPES[dtype]
    x, f, g = _inputs(shape, fshape, jdt, seed=len(shape) * 1000 + sum(shape))
    xj, fj, gj = jnp.asarray(x, jdt), jnp.asarray(f), jnp.asarray(g, jdt)
    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    ft = torch.tensor(f).requires_grad_(True)
    out = hgq_quantize(xt, ft)
    assert out.dtype == tdt and out.shape == xt.shape
    _same(j_ref(xj, jnp.broadcast_to(fj, xj.shape)), out)
    _same(hgq_quantize_ref(xt.detach(), ft.detach()), out)
    if len(fshape) < 2 or fshape == shape:
        # the JAX op's own vjp; its backward cannot reduce to a (1, N) f
        jout, vjp = jax.vjp(j_hgq_quantize, xj, fj)
        _same(jout, out)
        _, df_j = vjp(gj)
    else:
        # there, Algorithm 1 itself (test_kernels.py pins the op to it)
        _same(j_hgq_quantize(xj, fj), out)
        _, vjp = jax.vjp(jq.quantize, xj, fj)
        _, df_j = vjp(gj)
    gt = torch.tensor(g).to(tdt)
    dx, df = torch.autograd.grad(out, (xt, ft), gt)
    assert torch.equal(dx, gt)
    assert df.dtype == torch.float32 and df.shape == ft.shape
    np.testing.assert_allclose(df.numpy(), np.asarray(df_j, np.float32),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        hgq_quantize_grad_ref(gt, xt.detach(), ft.detach()), df,
        rtol=0, atol=0)


@pytest.mark.parametrize("fkind", ["channel", "param"])
def test_training_quantizer_lands_on_the_grid(fkind):
    """The port's TRAIN quantizer equals Eq. 4 (JAX ``quantize_inference``)
    bit for bit; JAX's ``quantize`` (x - (sg(d + a) - a)) differs from it
    by a float32 residue on some elements, and the port differs from JAX's
    ``quantize`` only there, by at most that residue."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(512, 96)) * 4).astype(np.float32)
    if fkind == "channel":
        f = np.tile(np.float32([2.0, 3.7, 6.0]), 32)
    else:
        f = rng.uniform(-1, 8, size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = torch.from_numpy(f).requires_grad_(True)
    got = tq.quantize(xt, ft).detach().numpy()
    exact = np.asarray(jq.quantize_inference(jnp.asarray(x), jnp.asarray(f)))
    surrogate = np.asarray(jq.quantize(jnp.asarray(x), jnp.asarray(f)))
    _same(exact, torch.from_numpy(got))
    off = surrogate != exact
    print(f"\nJAX quantize off the Eq.-4 grid ({fkind} f): {off.mean():.2%} "
          f"of elements, by up to {np.abs(surrogate - exact).max():.3g}")
    assert 0 < off.mean() < 0.05, off.mean()          # the residue is real
    np.testing.assert_array_equal(got[~off], surrogate[~off])
    assert np.all(np.abs(got - surrogate) <= np.abs(surrogate - exact))
    # and its gradients are Algorithm 1's
    _, vjp = jax.vjp(jq.quantize, jnp.asarray(x), jnp.asarray(f))
    dx_j, df_j = vjp(jnp.ones_like(jnp.asarray(x)))
    dx, df = torch.autograd.grad(tq.quantize(xt, ft).sum(), (xt, ft))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(dx_j))
    np.testing.assert_allclose(df.numpy(), np.asarray(df_j), rtol=1e-5,
                               atol=1e-6)


def test_layouts():
    assert layout_of((1024, 16), ()) == "per_tensor"
    assert layout_of((), ()) == "per_tensor"
    assert layout_of((1024, 16), (16,)) == "per_channel"
    assert layout_of((896, 4864), (1, 4864)) == "per_channel"
    assert layout_of((3, 5, 100), (1, 1, 100)) == "per_channel"
    assert layout_of((16, 64), (16, 64)) == "per_parameter"
    assert layout_of((64,), (64,)) == "per_parameter"
    # an MoE layer's expert stacks [E, K, N], f per expert
    assert layout_of((3, 5, 100), (3, 1, 100)) == "per_expert_channel"
    assert layout_of((3, 5, 100), (3, 1, 1)) == "per_expert_tensor"
    for x_shape, f_shape in (((16, 64), (16, 1)), ((3, 5, 100), (3, 5, 1)),
                             ((3, 5, 100), (5, 100)), ((16, 64), (1,)),
                             ((64,), (1, 64))):
        assert layout_of(x_shape, f_shape) is None, (x_shape, f_shape)


def test_cpu_takes_the_plain_version_and_any_broadcast():
    """On the CPU the op takes the plain version (the kernels' counters
    stay put), also for f shapes no kernel takes; the kernel wrappers
    themselves refuse CPU tensors."""
    before = (hgq_quantize_fwd.launches, hgq_quantize_bwd.launches)
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.normal(size=(12, 10)) * 3).astype(np.float32))
    f = torch.from_numpy(rng.uniform(0, 6, size=(12, 1)).astype(np.float32))
    f.requires_grad_(True)
    out = hgq_quantize(x, f)
    torch.testing.assert_close(out, tq.quantize_inference(x, f.detach()),
                               rtol=0, atol=0)
    (df,) = torch.autograd.grad(out.sum(), (f,))
    assert df.shape == (12, 1)
    assert (hgq_quantize_fwd.launches, hgq_quantize_bwd.launches) == before
    with pytest.raises(ValueError):
        hgq_quantize_fwd(x, f.detach())
    with pytest.raises(ValueError):
        hgq_quantize_bwd(x, x, f.detach())


@pytest.mark.parametrize("lo", range(-126, 128, 32))
def test_reciprocal_grid_step_is_the_division(lo):
    """The backward's reductions (csrc/hgq_quantize.cu, ``Grid``) compute
    ``xq = floor(x * 2^fi + 1/2) * 2^-fi`` where the plain version divides
    by ``2^fi``: ``2^-fi`` is exact for every fi in -126..127 (``2^-127``
    is a subnormal), so the product rounds the same real number as the
    quotient, bit for bit, overflow to inf included."""
    rng = np.random.default_rng(lo + 200)
    mant = rng.normal(size=4096)
    x = torch.from_numpy((mant * 2.0 ** rng.integers(-150, 104, 4096))
                         .astype(np.float32))
    for fi in range(lo, min(lo + 32, 128)):
        f = torch.tensor(float(fi))
        s = torch.tensor(2.0 ** fi, dtype=torch.float32)
        rs = torch.tensor(2.0 ** -fi, dtype=torch.float32)
        assert float(rs) * float(s) == 1.0, fi          # 2^-fi is exact
        xq = torch.floor(x * s + 0.5) * rs
        assert torch.equal(xq.view(torch.int32),
                           hgq_quantize_ref(x, f).view(torch.int32)), fi


# groups of independent quantizers: the jet tagger's weights and biases
# (per parameter, one grouped launch a training step on the card), and
# mixed layouts and dtypes
GROUPS = {
    "jet_weights": [(s, s, "float32") for s in
                    ((16, 64), (64,), (64, 32), (32,), (32, 32), (32,),
                     (32, 5), (5,))],
    "mixed": [((64, 256), (), "float32"), ((33, 130), (130,), "bfloat16"),
              ((16, 64), (16, 64), "bfloat16"),
              ((3, 5, 100), (1, 1, 100), "float32"), ((7,), (7,), "float32"),
              ((2, 2, 2, 64), (), "bfloat16"),
              ((64, 256), (1, 256), "bfloat16")],
    "one": [((1, 128), (1, 128), "float32")],
}


@pytest.mark.parametrize("group", list(GROUPS))
def test_group_matches_jax_member_by_member(group):
    """``hgq_quantize_group`` (and its plain version) gives each member the
    JAX package's Eq. 4 bit for bit, and each member the value and the
    gradients of its own ``hgq_quantize``."""
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_group,
                                                  hgq_quantize_group_ref)
    xs, fs, gs, js = [], [], [], []
    for i, (shape, fshape, dtype) in enumerate(GROUPS[group]):
        jdt, tdt = DTYPES[dtype]
        x, f, g = _inputs(shape, fshape, jdt, seed=100 + i)
        xj = jnp.asarray(x, jdt)
        js.append(j_ref(xj, jnp.broadcast_to(jnp.asarray(f), xj.shape)))
        xs.append(torch.tensor(x).to(tdt).requires_grad_(True))
        fs.append(torch.tensor(f).requires_grad_(True))
        gs.append(torch.tensor(g).to(tdt))
    outs = hgq_quantize_group(xs, fs)
    plain = hgq_quantize_group_ref([x.detach() for x in xs],
                                   [f.detach() for f in fs])
    grads = torch.autograd.grad(outs, xs + fs, gs)
    for i, (x, f, g) in enumerate(zip(xs, fs, gs)):
        assert outs[i].dtype == x.dtype and outs[i].shape == x.shape
        _same(js[i], outs[i])
        _same(js[i], plain[i])
        one = hgq_quantize(x, f)
        assert torch.equal(one, outs[i])
        dx, df = torch.autograd.grad(one, (x, f), g)
        assert torch.equal(grads[i], dx) and torch.equal(grads[i], g)
        assert torch.equal(grads[len(xs) + i].view(torch.int32),
                           df.view(torch.int32))


def test_quant_weights_is_quant_weight_in_one_group(monkeypatch):
    """``hgq.quant_weights`` gives each weight ``quant_weight``'s value,
    bits and gradients (through both the loss and the bits path), and in
    TRAIN reaches the quantizer once for the whole group; a weight
    without f passes through."""
    from repro_torch.core import hgq
    from repro_torch.kernels.hgq_quantize import ref as tref
    rng = np.random.default_rng(11)
    shapes = [((16, 64), (16, 64)), ((64,), (64,)), ((32, 5), (1, 5)),
              ((8,), None)]
    ws = [torch.tensor(rng.normal(size=s).astype(np.float32),
                       requires_grad=True) for s, _ in shapes]
    fs = [None if fs is None else torch.tensor(
        rng.uniform(0, 6, size=fs).astype(np.float32), requires_grad=True)
        for _, fs in shapes]
    calls = []
    real = tref.hgq_quantize_group_ref
    monkeypatch.setattr(tref, "hgq_quantize_group_ref",
                        lambda xs, ffs: calls.append(len(xs)) or real(xs, ffs))
    grouped = hgq.quant_weights(ws, fs, hgq.TRAIN)
    assert calls == [3]
    leaves = ws + [f for f in fs if f is not None]
    for mode in (hgq.TRAIN, hgq.EVAL):
        got = grouped if mode == hgq.TRAIN else \
            hgq.quant_weights(ws, fs, mode)
        one = [hgq.quant_weight(w, f, mode) for w, f in zip(ws, fs)]
        for a, b in zip(got, one):
            assert torch.equal(a.q, b.q)
            assert (a.bits is None) == (b.bits is None)
            if a.bits is not None:
                assert torch.equal(a.bits, b.bits)
        loss = lambda ts: sum((t.q * 1.5).sum() + (0 if t.bits is None
                                                   else t.bits.sum())
                              for t in ts)
        ga = torch.autograd.grad(loss(got), leaves, allow_unused=True)
        gb = torch.autograd.grad(loss(one), leaves, allow_unused=True)
        for a, b in zip(ga, gb):
            assert (a is None and b is None) or torch.equal(a, b)
    assert calls == [3]                                # EVAL: no quantizer


def test_jet_train_forward_groups_its_weights(monkeypatch):
    """A TRAIN forward of the jet tagger quantizes its 8 weights and biases
    in one group and its 4 activations one by one (on the card: one
    grouped launch and four single launches); CALIB and EVAL quantize
    without the training quantizer."""
    from repro_torch.core import hgq
    from repro_torch.kernels.hgq_quantize import ref as tref
    from repro_torch.models import JetTagger
    from repro_torch.nn import HGQConfig
    cfg = HGQConfig(weight_gran="per_parameter", act_gran="per_parameter")
    p, q = JetTagger.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(32, 16)).astype(np.float32))
    groups, singles = [], []
    real = tref.hgq_quantize_ref
    monkeypatch.setattr(tref, "hgq_quantize_group_ref",
                        lambda xs, fs: groups.append(
                            [tuple(t.shape) for t in xs])
                        or [real(a, b) for a, b in zip(xs, fs)])
    monkeypatch.setattr(tref, "hgq_quantize_ref",
                        lambda a, b: singles.append(tuple(a.shape))
                        or real(a, b))
    JetTagger.forward(p, q, {"x": x}, hgq.TRAIN)
    assert groups == [[(16, 64), (64,), (64, 32), (32,), (32, 32), (32,),
                       (32, 5), (5,)]]
    assert singles == [(32, 16), (32, 64), (32, 32), (32, 32)]
    groups.clear()
    singles.clear()
    JetTagger.forward(p, q, {"x": x}, hgq.EVAL)
    assert groups == [] and singles == []
