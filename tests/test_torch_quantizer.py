"""Port parity: the HGQ quantizer grids of ``repro_torch.core.quantizer``
and ``repro_torch.kernels.qmatmul.grid_exponent`` against the JAX
package, bit for bit.

Inputs are made with numpy from a seed and handed to both sides; results
are compared as float32 bit patterns, so a one-ulp grid point (the
``exp2``/``log2`` approximations the exact helpers replace) fails."""
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.nn imports repro.dist lazily)
    from repro.core import ebops as jeb
    from repro.core import hgq as jhgq
    from repro.core import quantizer as jq
    from repro.kernels.qmatmul import ops as jops

from repro_torch.core import ebops as teb
from repro_torch.core import hgq as thgq
from repro_torch.core import quantizer as tq
from repro_torch.kernels.qmatmul import ops as tops

RNG = np.random.default_rng(11)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same(j, t) -> None:
    jb, tb = _bits(j), _bits(t.numpy())
    assert jb.shape == tb.shape
    bad = np.flatnonzero(jb != tb)
    assert bad.size == 0, (f"{bad.size} of {jb.size} differ, first at "
                           f"{bad[0]}: jax {np.asarray(j).flat[bad[0]]!r} "
                           f"port {t.numpy().flat[bad[0]]!r}")


def test_exp2i_exact_and_clamped():
    f = np.concatenate([np.arange(-140, 141), [13, 15, 26, 200, -200]]
                       ).astype(np.float32)
    _same(jq._exp2i(jnp.asarray(f)), tq._exp2i(torch.from_numpy(f)))
    assert float(tq._exp2i(torch.tensor(13.0))) == 8192.0


def test_floor_ceil_log2():
    k = np.arange(-126, 128, dtype=np.float32)
    p2 = np.ldexp(np.float32(1), k.astype(np.int32)).astype(np.float32)
    up = np.nextafter(p2, np.float32(np.inf), dtype=np.float32)
    dn = np.nextafter(p2, np.float32(0), dtype=np.float32)
    x = np.concatenate([p2, up, dn[1:], [1e-12, 3.0, 8191.999, 8192.0],
                        np.abs(RNG.normal(size=200)).astype(np.float32)
                        * 10.0 ** RNG.integers(-20, 20, 200)]
                       ).astype(np.float32)
    x = x[np.isfinite(x) & (x >= np.finfo(np.float32).tiny)]
    _same(jq.floor_log2(jnp.asarray(x)), tq.floor_log2(torch.from_numpy(x)))
    _same(jq.ceil_log2(jnp.asarray(x)), tq.ceil_log2(torch.from_numpy(x)))


@pytest.mark.parametrize("f", [-3.0, 0.0, 2.4, 2.5, 6.0, 13.0, 15.0, 26.0,
                               -130.0, 130.0])
def test_quantize_inference_scalar_f(f):
    x = (RNG.normal(size=(64, 33)) * 10).astype(np.float32)
    fa = np.float32(f)
    _same(jq.quantize_inference(jnp.asarray(x), jnp.asarray(fa)),
          tq.quantize_inference(torch.from_numpy(x), torch.tensor(fa)))


@pytest.mark.parametrize("fi", [0, 3, 13, 15, 26])
def test_quantize_inference_half_steps(fi):
    """Values exactly on the half-step round up (floor(x + 1/2))."""
    k = np.arange(-50, 51, dtype=np.float32)
    x = ((k + 0.5) * np.float32(2.0) ** -fi).astype(np.float32)
    j = jq.quantize_inference(jnp.asarray(x), jnp.float32(fi))
    t = tq.quantize_inference(torch.from_numpy(x), torch.tensor(float(fi)))
    _same(j, t)
    np.testing.assert_array_equal(t.numpy() * np.float32(2.0) ** fi, k + 1)


@pytest.mark.parametrize("shape_f", ["channel", "param"])
def test_quantize_inference_broadcast_f(shape_f):
    x = (RNG.normal(size=(48, 40)) * 4).astype(np.float32)
    f = RNG.uniform(-4, 30, size=(40,) if shape_f == "channel"
                    else (48, 40)).astype(np.float32)
    _same(jq.quantize_inference(jnp.asarray(x), jnp.asarray(f)),
          tq.quantize_inference(torch.from_numpy(x), torch.from_numpy(f)))


def test_int_bits_from_range():
    vals = np.concatenate([[0.0, 1.0, -1.0, 0.5, -0.5, 2.0 ** 13, -2.0 ** 13,
                            1e-12, -1e-12],
                           RNG.normal(size=60) * 100]).astype(np.float32)
    vmin = np.minimum(vals, np.roll(vals, 3)).astype(np.float32)
    vmax = np.maximum(vals, np.roll(vals, 5)).astype(np.float32)
    _same(jq.int_bits_from_range(jnp.asarray(vmin), jnp.asarray(vmax)),
          tq.int_bits_from_range(torch.from_numpy(vmin),
                                 torch.from_numpy(vmax)))


@pytest.mark.parametrize("bits", [4, 5, 6, 7, 8])
def test_grid_exponent(bits):
    qmax = 2 ** (bits - 1) - 1
    amax = np.concatenate([
        [0.0, 1e-12, 1e-30, 1.0, qmax, qmax + 0.5, qmax - 0.5,
         (qmax + 0.5) / 8, 2.0 ** 13, 2.0 ** -20, 3e38],
        np.abs(RNG.normal(size=200)) * 10.0 ** RNG.integers(-8, 8, 200)]
    ).astype(np.float32)
    _same(jops.grid_exponent(jnp.asarray(amax), bits),
          tops.grid_exponent(torch.from_numpy(amax), bits))


def test_f_shape_and_group_size():
    for shape in [(8, 4), (3, 8, 4), ()]:
        for gran in ("per_tensor", "per_channel", "per_parameter"):
            assert tq.f_shape_for(shape, gran) == jq.f_shape_for(shape, gran)
            fs = jq.f_shape_for(shape, gran)
            assert tq.group_size(shape, fs) == jq.group_size(shape, fs)
    with pytest.raises(ValueError):
        tq.f_shape_for((2, 2), "per_row")


def test_train_bits():
    f = RNG.uniform(-2, 8, size=(16,)).astype(np.float32)
    vmin = (-np.abs(RNG.normal(size=16)) * 3).astype(np.float32)
    vmin[::4] = 0.0
    vmax = (np.abs(RNG.normal(size=16)) * 3).astype(np.float32)
    for signed in (True, False):
        _same(jq.train_bits(jnp.asarray(f), jnp.asarray(vmin),
                            jnp.asarray(vmax), signed_bit=signed),
              tq.train_bits(torch.from_numpy(f), torch.from_numpy(vmin),
                            torch.from_numpy(vmax), signed_bit=signed))


# --------------------------- the training half ----------------------------

def test_ste_round_and_grad_scale():
    x = np.float32([-2.5, -1.5, -0.5, 0.49, 0.5, 1.5, 2.4999, 3.7])
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    _same(jq.ste_round(jnp.asarray(x)), tq.ste_round(xt).detach())
    (g,) = torch.autograd.grad(tq.ste_round(xt).sum(), (xt,))
    assert torch.equal(g, torch.ones_like(xt))        # straight through
    y = tq.grad_scale(xt, 0.25)
    assert torch.equal(y.detach(), xt.detach())       # identity forward
    (g,) = torch.autograd.grad((y * 3.0).sum(), (xt,))
    assert torch.equal(g, torch.full_like(xt, 0.75))


def test_quantizer_spec_init_f():
    for gran, shape in (("per_parameter", (6, 4)), ("per_channel", (6, 4)),
                        ("per_tensor", (6, 4))):
        js = jq.QuantizerSpec(granularity=gran, init_frac_bits=3.0)
        ts = tq.QuantizerSpec(granularity=gran, init_frac_bits=3.0)
        _same(js.init_f(shape), ts.init_f(shape, device="cpu"))


def _weights():
    w = np.concatenate([
        [0.0, 0.5, -0.75, 0.140625, 1.0, 1.5, 2.0, 96.0, -3.0, 1e-30, 3e38],
        RNG.normal(size=180) * 10.0 ** RNG.integers(-6, 4, 180)])
    return w.astype(np.float32)


@pytest.mark.parametrize("f", [0.0, 3.0, 6.0, 8.0, 13.0, 30.0, 40.0, 125.0,
                               128.0, -2.0])
def test_occupied_bits_and_mantissa(f):
    w = _weights()
    fa = np.float32(f)
    _same(jq.occupied_bits(jnp.asarray(w), jnp.asarray(fa)),
          tq.occupied_bits(torch.from_numpy(w), torch.tensor(fa)))
    mf = np.abs(w)
    jm, je = jq._mantissa24(jnp.asarray(mf))
    tm, te = tq._mantissa24(torch.from_numpy(mf))
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    _same(je, te)
    _same(jq._trailing_zeros(jm), tq._trailing_zeros(tm))


@pytest.mark.parametrize("f_sh", [(), (1, 6), (5, 1), (5, 6)])
def test_group_occupied_bits(f_sh):
    w = (RNG.normal(size=(5, 6)) * 3).astype(np.float32)
    w[0, 0] = 0.0
    w[:, 2] = 0.0
    f = RNG.uniform(0, 9, size=f_sh).astype(np.float32)
    _same(jq.group_occupied_bits(jnp.asarray(w), jnp.asarray(f), f_sh),
          tq.group_occupied_bits(torch.from_numpy(w), torch.from_numpy(f),
                                 f_sh))
    assert tq._reduce_axes((5, 6), f_sh) == jq._reduce_axes((5, 6), f_sh)


@pytest.mark.parametrize("bx_shape,bw_shape", [((4,), (3, 3, 4, 8)),
                                               ((), ()), ((4,), ()),
                                               ((), (1, 1, 4, 1)),
                                               ((1,), (3, 3, 4, 8))])
def test_ebops_conv2d(bx_shape, bw_shape):
    bx = RNG.uniform(0, 8, size=bx_shape).astype(np.float32)
    bw = RNG.uniform(0, 8, size=bw_shape).astype(np.float32)
    w_shape = (3, 3, 4, 8)
    j = float(jeb.ebops_conv2d(jnp.asarray(bx), jnp.asarray(bw), w_shape))
    t = float(teb.ebops_conv2d(torch.from_numpy(bx), torch.from_numpy(bw),
                               w_shape))
    assert t == pytest.approx(j, rel=1e-6)


@pytest.mark.parametrize("ba_shape,bb_shape", [((4, 6), (6, 5)), ((), ()),
                                               ((4, 1), ()),
                                               ((), (1, 5)), ((1, 6), (6, 1))])
def test_ebops_dyn_matmul(ba_shape, bb_shape):
    ba = RNG.uniform(0, 8, size=ba_shape).astype(np.float32)
    bb = RNG.uniform(0, 8, size=bb_shape).astype(np.float32)
    a_shape, b_shape = (2, 4, 6), (2, 6, 5)
    j = float(jeb.ebops_dyn_matmul(jnp.asarray(ba), jnp.asarray(bb), a_shape,
                                   b_shape))
    t = float(teb.ebops_dyn_matmul(torch.from_numpy(ba), torch.from_numpy(bb),
                                   a_shape, b_shape))
    assert t == pytest.approx(j, rel=1e-6)
    aux = thgq.Aux.zero()
    thgq.dyn_matmul_ebops(aux, torch.from_numpy(ba), torch.from_numpy(bb),
                          a_shape, b_shape)
    assert float(aux.ebops) == t
    with pytest.raises(ValueError):
        teb.ebops_dyn_matmul(torch.from_numpy(ba), torch.from_numpy(bb),
                             (4, 6), (5, 5))


def test_loss_with_resource():
    args = [np.float32(v) for v in (0.7, 3500.0, 120.0, 1e-4, 2e-6)]
    j = float(jeb.loss_with_resource(*map(jnp.asarray, args)))
    t = float(teb.loss_with_resource(*map(torch.tensor, args)))
    assert t == pytest.approx(j, rel=1e-7)


def test_train_mode_quantizers_and_ranges():
    """TRAIN mode: the weight and activation quantizers land on Eq. 4's grid
    (JAX ``quantize_inference``); ranges decay by RANGE_DECAY; bits and the
    L1 term agree with JAX's TRAIN mode (its grad_scale forward is
    x * s + (x * (1 - s)), an ulp from x); the regularizer gradient on f
    is scaled by 1/sqrt(group size) on the bits path only."""
    assert thgq.RANGE_DECAY == jhgq.RANGE_DECAY
    x = (RNG.normal(size=(64, 16)) * 3).astype(np.float32)
    f = RNG.uniform(0, 6, size=(16,)).astype(np.float32)
    st = (np.float32(-1.0) * RNG.uniform(0, 4, 16).astype(np.float32),
          RNG.uniform(0, 4, 16).astype(np.float32))
    jaux = jhgq.Aux.zero()
    jq_, jst = jhgq.quant_act(jnp.asarray(x), jnp.asarray(f),
                              jhgq.ActState(*map(jnp.asarray, st)),
                              jhgq.TRAIN, jaux)
    taux = thgq.Aux.zero()
    ft = torch.from_numpy(f).requires_grad_(True)
    tq_, tst = thgq.quant_act(torch.from_numpy(x), ft,
                              thgq.ActState(*map(torch.from_numpy, st)),
                              thgq.TRAIN, taux)
    _same(jq.quantize_inference(jnp.asarray(x), jnp.asarray(f)),
          tq_.q.detach())
    _same(jst.vmin, tst.vmin)
    _same(jst.vmax, tst.vmax)
    np.testing.assert_allclose(tq_.bits.detach().numpy(),
                               np.asarray(jq_.bits), rtol=1e-6)
    assert float(taux.l1.detach()) == pytest.approx(float(jaux.l1), rel=1e-6)
    # the bits path carries d/df scaled by 1/sqrt(64 rows)
    (gb,) = torch.autograd.grad(tq_.bits.sum(), (ft,))
    live = tq_.bits.detach() > 0
    np.testing.assert_allclose(gb[live].numpy(), 1.0 / 8.0, rtol=1e-7)

    w = (RNG.normal(size=(16, 8)) * 0.5).astype(np.float32)
    fw = RNG.uniform(0, 6, size=(1, 8)).astype(np.float32)
    jw = jhgq.quant_weight(jnp.asarray(w), jnp.asarray(fw), jhgq.TRAIN)
    tw = thgq.quant_weight(torch.from_numpy(w), torch.from_numpy(fw),
                           thgq.TRAIN)
    _same(jq.quantize_inference(jnp.asarray(w), jnp.asarray(fw)),
          tw.q.detach())
    np.testing.assert_allclose(tw.bits.detach().numpy(), np.asarray(jw.bits),
                               rtol=1e-6)
