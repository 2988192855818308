"""Port parity: the wire compression kernels' plain versions
(``repro_torch.kernels.wire_pack.ref``) against the JAX package's
``repro.kernels.wire_pack.ref``, bit for bit, and the wrappers' routing on
the CPU.

Every comparison is of bits (float32 viewed as int32), so signed zeros
and subnormals count.  ``dequant_sum`` is held against JAX's eager
reference, a true division for every ``n``: under ``jax.jit`` XLA turns
``/ n`` into a multiply by ``1 / n``, an ulp off for ``n`` that is not a
power of two (shown below), and the port divides truly on the CPU and on
the card.  The CUDA kernels themselves are held against these plain
versions on the card (``tests/test_torch_package.py``, ``chip_smoke.py``).
Inputs are made from a seed with numpy."""
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.dist  # noqa: F401
    from repro.kernels import wire_pack as jwp
    from repro.kernels.qmatmul.ops import grid_exponent as j_grid_exponent
    from repro.kernels.qmatmul.ops import pack_nibbles as j_pack_nibbles
    from repro.kernels.wire_pack import ref as jref

from repro_torch.kernels import wire_pack as twp
from repro_torch.kernels.qmatmul.ops import grid_exponent, unpack_nibbles
from repro_torch.kernels.wire_pack import ref as tref

# the JAX package's shapes: stacked [L, P] rows and flat single rows with
# odd tails
SHAPES = [(1, 1), (1, 120), (3, 40), (4, 129), (7, 257)]


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(t: torch.Tensor, j) -> None:
    t = t.detach().numpy()
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (t.shape, j.shape,
                                                      t.dtype, j.dtype)
    np.testing.assert_array_equal(_bits(t), _bits(j))


def _rows(shape, seed=0, scale=1.0):
    r = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return r, np.max(np.abs(r), axis=1)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_leaf_matches_jax(bits, shape):
    rows, amax = _rows(shape, seed=bits, scale=3.0)
    rows[0, 0] = 0.0
    jq, js, jr = jref.quantize_leaf_ref(jnp.asarray(rows), jnp.asarray(amax),
                                        bits)
    tq, ts, tr = tref.quantize_leaf_ref(torch.from_numpy(rows),
                                        torch.from_numpy(amax), bits)
    _same(tq, jq)
    _same(ts, js)
    _same(tr, jr)
    # the decomposition error feedback relies on: q * s + residual == rows
    np.testing.assert_array_equal(
        tq.numpy().astype(np.float32) * ts.numpy()[:, None] + tr.numpy(),
        rows)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_chunks_matches_jax(bits, shape):
    e, _ = _rows(shape, seed=10 + bits)
    amax = np.abs(e) + np.float32(1e-3)
    s = np.array(jwp.grid_scale(jnp.asarray(amax.reshape(-1)),
                                bits)).reshape(e.shape)
    jq, jr = jref.quantize_chunks_ref(jnp.asarray(e), jnp.asarray(s), bits)
    tq, tr = tref.quantize_chunks_ref(torch.from_numpy(e),
                                      torch.from_numpy(s), bits)
    _same(tq, jq)
    _same(tr, jr)


def test_subnormal_residual_is_kept():
    """``[1e-38]`` at 2 bits (the falsifying example of the JAX package's
    ``test_property_quantize_leaf_kernel_matches_ref``): amax is clamped
    to 1e-12, so the grid step is 2^-39, q = 0 and the residual is the
    subnormal input itself.  The port keeps it, so ``q * s + residual ==
    rows`` holds exactly (the identity error feedback relies on); XLA on
    the CPU flushes subnormals to zero, and JAX's reference and kernel
    both return 0 there.  The CUDA kernel is built without flush to zero
    and is held to the port's plain version on the card."""
    rows = np.asarray([[1e-38]], np.float32)
    amax = np.abs(rows[:, 0])
    jq, js, _ = jref.quantize_leaf_ref(jnp.asarray(rows), jnp.asarray(amax),
                                       2)
    tq, ts, tr = tref.quantize_leaf_ref(torch.from_numpy(rows),
                                        torch.from_numpy(amax), 2)
    _same(tq, jq)
    _same(ts, js)
    assert int(tq[0, 0]) == 0 and float(ts[0]) == 2.0 ** -39
    np.testing.assert_array_equal(_bits(tr.numpy()), _bits(rows))
    assert 0.0 < float(tr[0, 0]) < np.finfo(np.float32).tiny


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_grid_scale_matches_jax(bits):
    """Zero, tiny, ordinary and large amax, and two values just above
    qmax / 2^k, where ``qmax / amax`` lands an ulp below a power of two:
    PyTorch's ``number / tensor`` (a reciprocal, then a multiply) rounded
    that up to the power of two and took a grid one step finer than JAX's
    until ``grid_exponent`` divided truly."""
    amax = np.asarray([0.0, 1e-30, 1e-12, 1e-3, 0.5, 1.0, 127.0, 3e4,
                       1.9843751192092896, 0.4843750298023224], np.float32)
    _same(tref.grid_scale(torch.from_numpy(amax), bits),
          jwp.grid_scale(jnp.asarray(amax), bits))
    s = tref.grid_scale(torch.from_numpy(amax), bits).numpy()
    frac, _ = np.frexp(s)
    assert np.all(frac == 0.5)                     # exact powers of two


def test_grid_exponent_divides_truly():
    a = torch.tensor([1.9843751192092896], dtype=torch.float32)
    assert float(grid_exponent(a, 8)[0]) == 5.0
    assert float(j_grid_exponent(jnp.asarray(a.numpy()), 8)[0]) == 5.0
    assert float(grid_exponent(torch.tensor([0.4843750298023224]), 6)[0]) \
        == float(j_grid_exponent(jnp.asarray([0.4843750298023224],
                                             jnp.float32), 6)[0])


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (2, 8), (3, 129),
                                   (2, 4, 33), (4, 1000)])
def test_pack_chunks_matches_pack_nibbles(shape):
    q = np.random.default_rng(3).integers(-7, 8, shape).astype(np.int8)
    want = j_pack_nibbles(jnp.asarray(q), axis=-1)
    _same(tref.pack_chunks_ref(torch.from_numpy(q)), want)
    _same(twp.pack_chunks(torch.from_numpy(q)), want)
    back = unpack_nibbles(twp.pack_chunks(torch.from_numpy(q)), shape[-1],
                          axis=-1)
    np.testing.assert_array_equal(back.numpy(), q)


@pytest.mark.parametrize("C", [14, 15, 16, 17, 18, 30, 31, 32, 33, 34, 62,
                               63, 64, 65, 66])
def test_pack_chunks_around_vector_widths_matches_pack_nibbles(C):
    """Even and odd C around the CUDA kernel's 16-byte output vectors (32
    mantissas in, 16 packed bytes out), over three rows."""
    q = np.random.default_rng(C).integers(-8, 8, (3, C)).astype(np.int8)
    want = j_pack_nibbles(jnp.asarray(q), axis=-1)
    _same(twp.pack_chunks(torch.from_numpy(q)), want)


@pytest.mark.parametrize("offset", [1, 2, 3, 4, 7, 8, 15])
@pytest.mark.parametrize("C", [34, 4098, 1001])
def test_pack_chunks_of_an_offset_view_matches_pack_nibbles(offset, C):
    """A contiguous view with a storage offset (a slice of a larger tensor,
    as the wrapper may be handed) packs as its own values do."""
    base = np.random.default_rng(offset).integers(
        -8, 8, 3 * C + 16).astype(np.int8)
    view = torch.from_numpy(base)[offset:offset + 3 * C].view(3, C)
    assert view.is_contiguous() and view.storage_offset() == offset
    want = j_pack_nibbles(jnp.asarray(base[offset:offset + 3 * C]
                                      .reshape(3, C)), axis=-1)
    _same(twp.pack_chunks(view), want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_dequant_sum_matches_eager_jax(n):
    shift = max((n - 1).bit_length(), 0)
    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, (3, 37)).astype(np.int8)
    s = np.array(jwp.grid_scale(jnp.asarray(
        np.abs(rng.normal(size=(37,))).astype(np.float32) + 0.1)))
    want = jref.dequant_sum_ref(jnp.asarray(q), jnp.asarray(s)[None, :],
                                shift, n)
    for ss in (s[None, :], np.broadcast_to(s, q.shape).copy(), s):
        _same(tref.dequant_sum_ref(torch.from_numpy(q),
                                   torch.from_numpy(np.asarray(ss)), shift,
                                   n), want)
        _same(twp.dequant_sum(torch.from_numpy(q),
                              torch.from_numpy(np.asarray(ss)), shift, n),
              want)
    jitted = jax.jit(lambda a, b: jref.dequant_sum_ref(a, b, shift, n))(
        jnp.asarray(q), jnp.asarray(s)[None, :])
    if n & (n - 1) == 0:
        _same(tref.dequant_sum_ref(torch.from_numpy(q), torch.from_numpy(s),
                                   shift, n), jitted)
    elif n in (3, 5):
        # the jitted reference multiplies by 1/n: somewhere an ulp off
        assert not np.array_equal(_bits(jitted), _bits(want))


def test_true_div_is_ieee_division():
    x = torch.from_numpy(np.random.default_rng(6).normal(size=10000)
                         .astype(np.float32))
    for d in (3.0, 5.0, 127.0):
        np.testing.assert_array_equal(
            _bits(tref.true_div(x, d)), _bits(x.numpy() / np.float32(d)))


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the entry points return the plain versions' bits and
    launch nothing; the kernel functions themselves refuse CPU tensors."""
    rows, amax = _rows((3, 41), seed=9, scale=2.3)
    r, a = torch.from_numpy(rows), torch.from_numpy(amax)
    kernels = (twp.wire_quantize_rows, twp.wire_quantize_sflat,
               twp.wire_pack_rows, twp.wire_dequant_rows)
    before = [k.launches for k in kernels]
    for x, y in zip(twp.quantize_leaf(r, a, 4),
                    tref.quantize_leaf_ref(r, a, 4)):
        assert torch.equal(x, y)
    s = tref.grid_scale(a, 8)[:, None].expand(3, 41).contiguous()
    for x, y in zip(twp.quantize_chunks(r, s, 8),
                    tref.quantize_chunks_ref(r, s, 8)):
        assert torch.equal(x, y)
    q = twp.quantize_leaf(r, a, 4)[0]
    assert torch.equal(twp.pack_chunks(q), tref.pack_chunks_ref(q))
    assert torch.equal(twp.dequant_sum(q, s, 2, 4),
                       tref.dequant_sum_ref(q, s, 2, 4))
    assert [k.launches for k in kernels] == before
    with pytest.raises(ValueError):
        twp.wire_quantize_rows(r, a)
    with pytest.raises(ValueError):
        twp.wire_quantize_sflat(r, s)
    with pytest.raises(ValueError):
        twp.wire_pack_rows(q)
    with pytest.raises(ValueError):
        twp.wire_dequant_rows(q, s, 2, 4)


@pytest.mark.parametrize("seed", range(6))
def test_random_rows_match_jax(seed):
    """Rows of random length and scale (down to 1e-30), random widths."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 40))
    bits = int(rng.integers(2, 9))
    vals = (rng.normal(size=(1, n)) * 10.0 ** rng.integers(-30, 3)).astype(
        np.float32)
    amax = np.max(np.abs(vals), axis=1)
    jq, js, jr = jref.quantize_leaf_ref(jnp.asarray(vals), jnp.asarray(amax),
                                        bits)
    tq, ts, tr = tref.quantize_leaf_ref(torch.from_numpy(vals),
                                        torch.from_numpy(amax), bits)
    _same(tq, jq)
    _same(ts, js)
    _same(tr, jr)
