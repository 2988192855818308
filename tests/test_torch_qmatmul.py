"""Port parity: weight packing and the packed dequant matmul of
``repro_torch.kernels.qmatmul`` against the JAX package.

Packing (per-channel grids, mantissas, scales, nibbles) is bit-exact.
The product is held to ``|d| <= 1e-5 * (|x| @ |w|) * scale`` elementwise:
the two sides sum the same float32 products in another order.  The JAX
side runs its Pallas kernel in interpret mode, as its own tests do; the
port takes its plain version because the tensors lie on the CPU."""
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.nn imports repro.dist lazily)
    from repro.kernels.qmatmul import ops as jops

from repro_torch.kernels.qmatmul import ops as tops
from repro_torch.kernels.qmatmul import qmatmul

RNG = np.random.default_rng(5)


def _weights(shape):
    w = (RNG.normal(size=shape) * 0.3).astype(np.float32)
    w[..., 0] = 0.0                          # an all-zero channel
    w[..., 1] *= 1e-6                        # a tiny one
    return w


def _f(kind, shape):
    if kind is None:
        return None
    if kind == "channel":
        return RNG.uniform(0, 12, size=shape[:-2] + (1, shape[-1])
                           ).astype(np.float32)
    return RNG.uniform(0, 12, size=shape).astype(np.float32)


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("bits", [4, 5, 6, 7, 8])
@pytest.mark.parametrize("fkind", [None, "channel", "param"])
def test_channel_bits_and_pack_linear_2d(bits, fkind):
    w = _weights((24, 10))
    f = _f(fkind, w.shape)
    jf = None if f is None else jnp.asarray(f)
    tf = None if f is None else torch.from_numpy(f)
    _eq(jops.channel_bits(jnp.asarray(w), jf, bits),
        tops.channel_bits(torch.from_numpy(w), tf, bits))
    jm, js = jops.pack_linear(jnp.asarray(w), jf, bits)
    tm, ts = tops.pack_linear(torch.from_numpy(w), tf, bits)
    assert tm.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(jm, tm)
    _eq(js, ts)


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_linear_stacked(bits):
    w = _weights((3, 16, 12))
    f = _f("channel", w.shape)
    jm, js = jops.pack_linear(jnp.asarray(w), jnp.asarray(f), bits)
    tm, ts = tops.pack_linear(torch.from_numpy(w), torch.from_numpy(f), bits)
    assert tuple(ts.shape) == (3, 12)
    _eq(jm, tm)
    _eq(js, ts)


def test_pack_weights_f_layouts():
    w = _weights((12, 6))
    for f in (np.float32(5.0), RNG.uniform(0, 9, 6).astype(np.float32),
              RNG.uniform(0, 9, (12, 6)).astype(np.float32)):
        jm, js = jops.pack_weights(jnp.asarray(w), jnp.asarray(f))
        tm, ts = tops.pack_weights(torch.from_numpy(w), torch.tensor(f))
        _eq(jm, tm)
        _eq(js, ts)


@pytest.mark.parametrize("axis,shape", [(-1, (5, 7)), (-2, (7, 5)),
                                        (-2, (2, 9, 4)), (0, (6, 3))])
def test_nibbles_round_trip(axis, shape):
    m = RNG.integers(-7, 8, size=shape).astype(np.int8)
    jp = jops.pack_nibbles(jnp.asarray(m), axis=axis)
    tp = tops.pack_nibbles(torch.from_numpy(m), axis=axis)
    _eq(jp, tp)
    n = shape[axis]
    _eq(jops.unpack_nibbles(jp, n, axis=axis),
        tops.unpack_nibbles(tp, n, axis=axis))
    np.testing.assert_array_equal(
        tops.unpack_nibbles(tp, n, axis=axis).numpy(), m)


def test_mantissa_max():
    for b in range(2, 9):
        assert tops.mantissa_max(b) == jops.mantissa_max(b)
    with pytest.raises(ValueError):
        tops.mantissa_max(9)


@pytest.mark.parametrize("lead,K,N", [((5,), 70, 33), ((2, 3), 64, 128),
                                      ((1,), 896 // 7, 40)])
def test_qmatmul_any_matches_jax(lead, K, N):
    x = RNG.normal(size=lead + (K,)).astype(np.float32)
    w = _weights((K, N))
    m, s = tops.pack_linear(torch.from_numpy(w), None, 8)
    yj = np.asarray(jops.qmatmul_any(jnp.asarray(x), jnp.asarray(m.numpy()),
                                     jnp.asarray(s.numpy())))
    before = qmatmul.launches
    yt = tops.qmatmul_any(torch.from_numpy(x), m, s)
    assert qmatmul.launches == before        # CPU tensors: the plain version
    assert tuple(yt.shape) == lead + (N,)
    tol = 1e-5 * (np.abs(x) @ np.abs(m.numpy().astype(np.float32))) \
        * s.numpy()
    assert np.all(np.abs(yt.numpy() - yj) <= tol + 1e-30)


def test_qmatmul_any_transposed_weight():
    """The tied head passes ``table.T`` (an [N, K] layout): same result
    as the contiguous [K, N] weight."""
    x = torch.from_numpy(RNG.normal(size=(3, 32)).astype(np.float32))
    m = torch.from_numpy(RNG.integers(-127, 128, (50, 32)).astype(np.int8))
    s = torch.full((50,), 2.0 ** -6)
    a = tops.qmatmul_any(x, m.T, s)
    b = tops.qmatmul_any(x, m.T.contiguous(), s)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
