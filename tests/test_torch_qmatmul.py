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


def _nibble_storage(w):
    """The serving packer's ``w_nib`` for a 4-bit layer: [K / 2, N] bytes,
    N-major, the even k in the low nibble; and the mantissas and scale."""
    from repro_torch.dist.perf import _pack_one
    packed = _pack_one({"w": torch.from_numpy(w)}, 4, n_major=True)
    m, s = tops.pack_linear(torch.from_numpy(w), None, 4)
    return packed["w_nib"], m, s


@pytest.mark.parametrize("lead,K,N", [((8,), 112, 608), ((16,), 608, 112),
                                      ((2, 3), 50, 24)])
def test_qmatmul_any_nibbles_matches_jax(lead, K, N):
    """The nibble storage as the packer keeps it, against JAX's kernel
    (interpret mode) over the unpacked mantissas, at qwen2-0.5b's MLP
    widths cut by 8 (gate/up [896, 4864] and down [4864, 896]) and an
    odd-shaped one; held to ``1e-5 * (|x| @ |w|) * scale``."""
    x = RNG.normal(size=lead + (K,)).astype(np.float32)
    stored, m, s = _nibble_storage(_weights((K, N)))
    assert tuple(stored.shape) == (K // 2, N)
    assert stored.stride() == (1, K // 2)          # N-major
    yj = np.asarray(jops.qmatmul_any(jnp.asarray(x), jnp.asarray(m.numpy()),
                                     jnp.asarray(s.numpy())))
    before = qmatmul.launches
    yt = tops.qmatmul_any(torch.from_numpy(x), stored, s, nib=True)
    assert qmatmul.launches == before        # CPU tensors: the plain version
    assert tuple(yt.shape) == lead + (N,)
    tol = 1e-5 * (np.abs(x) @ np.abs(m.numpy().astype(np.float32))) \
        * s.numpy()
    assert np.all(np.abs(yt.numpy() - yj) <= tol + 1e-30)
    # the plain version computes one function over either storage
    torch.testing.assert_close(
        tops.qmatmul_any(torch.from_numpy(x), m, s), yt, rtol=0, atol=0)


def test_bf16_split3_is_exact():
    """hi + mid + lo == x for seeded normal fp32 over a wide exponent
    range (summed in float64), and each term times every int8 and int4
    mantissa is exact in fp32 (equal to the float64 product)."""
    from repro_torch.kernels.qmatmul import bf16_split3
    rng = np.random.default_rng(11)
    mag = np.exp2(rng.uniform(-90, 90, 4096)).astype(np.float32)
    x = torch.from_numpy(mag * rng.choice([-1.0, 1.0], 4096)
                         .astype(np.float32))
    x[:4] = torch.tensor([1.0, -3.0, 2.0 ** -100, 1.0 - 2.0 ** -24])
    terms = bf16_split3(x)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.to(torch.float64) for t in terms)
    assert torch.equal(total, x.to(torch.float64))
    mant = torch.arange(-128, 128, dtype=torch.float32)   # int4 is inside
    for t in terms:
        t32 = t.to(torch.float32)[:, None]
        assert torch.equal((t32 * mant).to(torch.float64),
                           t32.to(torch.float64) * mant.to(torch.float64))


def test_qmatmul_split_from_k_and_n_only():
    """The split-K choice takes K and N and nothing else (so never M), its
    parts cover K's groups of 128 with none empty, and qwen2-0.5b's layers
    fill the card: ~2 blocks of 128 channels per SM where K allows."""
    import inspect
    assert list(inspect.signature(tops.qmatmul_split).parameters) == \
        ["K", "N"]
    for K in (1, 64, 127, 128, 129, 896, 4864, 10000):
        for N in (1, 48, 128, 896, 4864, 151936):
            parts, per = tops.qmatmul_split(K, N)
            groups = -(-K // 128)
            assert parts >= 1 and per >= 1
            assert (parts - 1) * per < groups <= parts * per
    blocks = {}
    for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896),
                 (896, 151936)):
        parts, _ = tops.qmatmul_split(K, N)
        blocks[K, N] = parts * -(-N // 128)
    assert blocks == {(896, 896): 49, (896, 128): 7, (896, 4864): 266,
                      (4864, 896): 266, (896, 151936): 1187}
