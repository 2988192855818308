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
    from repro.core import quantizer as jq
    from repro.kernels.qmatmul import ops as jops

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
