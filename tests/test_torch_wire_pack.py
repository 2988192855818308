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


# ---------------------------------------------------------------------------
# the fused reduce's bucket kernels: plain versions against the JAX package
# ---------------------------------------------------------------------------

# (members ((shape, L, dtype), ...), n, bits): stacked L = 3 with odd C,
# T not a multiple of n, a scalar, bfloat16 leaves, int8 and nibble buckets
# (bits <= 4), n = 3 and 4
BUCKETS = [
    ((((3, 8, 5), 3, "float32"), ((17,), 1, "float32"), ((), 1, "float32"),
      ((2, 3, 7), 1, "float32")), 4, 8),
    ((((3, 8, 5), 3, "float32"), ((17,), 1, "float32"), ((), 1, "float32"),
      ((2, 3, 7), 1, "float32")), 4, 4),
    ((((3, 41, 7), 3, "float32"), ((1001,), 1, "float32"),
      ((33,), 1, "float32")), 3, 8),
    ((((1001,), 1, "bfloat16"), ((3, 8, 5), 3, "bfloat16"),
      ((17,), 1, "float32")), 3, 4),
    ((((5,), 1, "float32"), ((64,), 1, "bfloat16"),
      ((16, 64), 1, "float32")), 4, 3),
]
KERNEL = dict(use_kernel=True, interpret=True)


def _bucket(members, bits, seed):
    """Seeded leaves (numpy float32, and their torch tensors in the member's
    dtype) and their grid steps ``grid_scale(row amax)``: a scale a member
    and a row, a zero, and values on rounding ties of the first row's
    grid."""
    rng = np.random.default_rng(seed)
    vals, leaves, steps = [], [], []
    for k, (shape, L, dt) in enumerate(members):
        T = int(np.prod(shape))
        x = (rng.normal(size=(L, T // L)) * 10.0 ** (k % 3 - 2)
             * np.logspace(-1, 1, L)[:, None]).astype(np.float32)
        if T > 3:
            x.reshape(-1)[0] = 0.0
        t = torch.from_numpy(x.reshape(shape).copy())
        if dt == "bfloat16":
            t = t.to(torch.bfloat16)
        x = t.float().numpy().reshape(L, -1)
        s = tref.grid_scale(torch.from_numpy(np.abs(x).max(axis=1)), bits)
        if T > 6:
            # the second to fourth values on ties (m + 1/2) * step
            x32 = t.float().reshape(-1)
            x32[1:4] = (torch.arange(3.0) - 1.5) * s[0]
            t = x32.reshape(shape).to(t.dtype)
            x = t.float().numpy().reshape(L, -1)
        vals.append(x)
        leaves.append(t)
        steps.append(s)
    return vals, leaves, steps


def _np_layout(vals, steps, n, nibble):
    """The JAX package's chunk layout built in numpy: E and S [n, W] and
    per member (T, C, ceven, off)."""
    es, ss, dims, off = [], [], [], 0
    for x, s in zip(vals, steps):
        L, P = x.shape
        T = L * P
        C = -(-T // n)
        ce = -(-C // 2) * 2 if nibble else C
        e = np.zeros(n * C, np.float32)
        e[:T] = x.reshape(-1)
        sc = np.ones(n * C, np.float32)
        sc[:T] = np.repeat(s.numpy(), P)
        e = np.pad(e.reshape(n, C), ((0, 0), (0, ce - C)))
        sc = np.pad(sc.reshape(n, C), ((0, 0), (0, ce - C)),
                    constant_values=1.0)
        es.append(e)
        ss.append(sc)
        dims.append((T, C, ce, off))
        off += ce
    return np.concatenate(es, axis=1), np.concatenate(ss, axis=1), dims


def _np_member(buf, dim):
    T, C, ce, off = dim
    return np.ascontiguousarray(buf[:, off:off + ce][:, :C]).reshape(-1)[:T]


def _bucket_bits_t(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _bucket_bits(a) -> np.ndarray:
    a = a.detach()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy()
    return _bits(a.numpy())


@pytest.mark.parametrize("case", range(len(BUCKETS)))
def test_quantize_bucket_ref_matches_jax(case):
    """The bucket's payload and each leaf's residual: JAX's
    ``quantize_chunks`` (its Pallas kernel, interpreted) on the chunk layout
    built in numpy, bit for bit; the CPU entry point returns the same."""
    members, n, bits = BUCKETS[case]
    nibble = bits <= 4
    vals, leaves, steps = _bucket(members, bits, seed=case)
    E, S, dims = _np_layout(vals, steps, n, nibble)
    jq, jr = jwp.quantize_chunks(jnp.asarray(E), jnp.asarray(S), bits,
                                 **KERNEL)
    q, res = tref.quantize_bucket_ref(leaves, steps, n, bits, nibble)
    _same(q, jq)
    for r, e, dim in zip(res, leaves, dims):
        assert r.shape == e.shape and r.dtype == torch.float32
        np.testing.assert_array_equal(_bits(r.numpy().reshape(-1)),
                                      _bits(_np_member(np.asarray(jr), dim)))
    q2, res2 = twp.quantize_bucket(leaves, steps, n, bits, nibble)
    assert torch.equal(q2, q)
    assert all(torch.equal(_bucket_bits_t(a), _bucket_bits_t(b))
               for a, b in zip(res2, res))


@pytest.mark.parametrize("case", range(len(BUCKETS)))
def test_dequant_bucket_ref_matches_jax(case):
    """Each leaf's delivered mean and new residual at every rank index:
    JAX's ``dequant_sum`` (eager reference, a true division; the Pallas
    kernel too where n is a power of two) on the gathered payload, the
    owner's remainder ``err2c * S[idx]`` on its chunk and ``residual +
    that`` (a zero elsewhere), bit for bit, cast to the leaf's dtype.  A
    -0.0 residual off the own chunk comes out +0.0; a subnormal stays."""
    members, n, bits = BUCKETS[case]
    nibble = bits <= 4
    shift = (n - 1).bit_length()
    vals, leaves, steps = _bucket(members, bits, seed=10 + case)
    E, S, dims = _np_layout(vals, steps, n, nibble)
    W = E.shape[1]
    rng = np.random.default_rng(20 + case)
    qmax = 2 ** (bits - 1) - 1
    full = rng.integers(-qmax, qmax + 1, (n, W)).astype(np.int8)
    gath = (j_pack_nibbles(jnp.asarray(full), axis=-1) if nibble
            else jnp.asarray(full))
    err = rng.integers(-2 ** shift, 2 ** shift + 1, W).astype(np.float32)
    _, res = tref.quantize_bucket_ref(leaves, steps, n, bits, nibble)
    for r in res:
        r.view(-1)[::3] = -0.0
        r.view(-1)[1::5] = 1e-40
    want_d = np.asarray(jref.dequant_sum_ref(jnp.asarray(full),
                                             jnp.asarray(S), shift, n))
    if n & (n - 1) == 0:
        np.testing.assert_array_equal(
            _bits(want_d), _bits(jwp.dequant_sum(jnp.asarray(full),
                                                 jnp.asarray(S), shift, n,
                                                 **KERNEL)))
    for idx in range(n):
        out = tref.dequant_bucket_ref(torch.from_numpy(np.array(gath)),
                                      torch.from_numpy(err), res, leaves,
                                      steps, n, idx, shift, nibble)
        ecat = err * S[idx]
        for (d, r), e, r0, dim in zip(out, leaves, res, dims):
            T, C, ce, off = dim
            scatter = np.zeros(n * C, np.float32)
            scatter[idx * C:(idx + 1) * C] = ecat[off:off + ce][:C]
            new = r0.numpy().reshape(-1) + scatter[:T]
            for got, want in ((d, _np_member(want_d, dim)), (r, new)):
                assert got.shape == e.shape and got.dtype == e.dtype
                want = torch.from_numpy(np.ascontiguousarray(want)).to(
                    e.dtype).reshape(e.shape)
                np.testing.assert_array_equal(_bucket_bits(got),
                                              _bucket_bits(want))
            own = slice(idx * C, min((idx + 1) * C, T))
            off_own = np.ones(T, bool)
            off_own[own] = False
            rr = r.float().numpy().reshape(-1)
            r0f = r0.numpy().reshape(-1)
            # -0.0 off the own chunk became +0.0
            z = off_own & (r0f == 0) & np.signbit(r0f)
            assert z.any() or T < 4
            assert not np.signbit(rr[z]).any()
            if e.dtype == torch.float32:
                sub = off_own & (r0f == np.float32(1e-40))
                np.testing.assert_array_equal(_bits(rr[sub]),
                                              _bits(r0f[sub]))


def test_bucket_of_65_members_equals_two_launches_of_plain_members():
    """A bucket past the 64 members a launch takes: its payload, residuals
    and decode equal the plain versions over its first 64 members and its
    last one, side by side (the columns of the second from the first's
    width)."""
    members = tuple(((k % 37 + 1,), 1, "bfloat16" if k % 3 == 0
                     else "float32") for k in range(65))
    n, bits = 4, 8
    _, leaves, steps = _bucket(members, bits, seed=65)
    assert [len(g) for g in twp.ops._launch_groups(65)] == [64, 1]
    q, res = tref.quantize_bucket_ref(leaves, steps, n, bits)
    qa, ra = tref.quantize_bucket_ref(leaves[:64], steps[:64], n, bits)
    qb, rb = tref.quantize_bucket_ref(leaves[64:], steps[64:], n, bits)
    assert torch.equal(q, torch.cat([qa, qb], dim=1))
    assert all(torch.equal(_bucket_bits_t(a), _bucket_bits_t(b))
               for a, b in zip(res, ra + rb))
    rng = np.random.default_rng(66)
    gath = torch.from_numpy(rng.integers(-127, 128, q.shape).astype(np.int8))
    err = torch.from_numpy(rng.integers(-4, 5, q.shape[1])
                           .astype(np.float32))
    Wa = qa.shape[1]
    for idx in range(n):
        whole = tref.dequant_bucket_ref(gath, err, res, leaves, steps, n,
                                        idx, 2)
        parts = (tref.dequant_bucket_ref(gath[:, :Wa], err[:Wa], ra,
                                         leaves[:64], steps[:64], n, idx, 2)
                 + tref.dequant_bucket_ref(gath[:, Wa:], err[Wa:], rb,
                                           leaves[64:], steps[64:], n, idx,
                                           2))
        for (d, r), (d2, r2) in zip(whole, parts):
            assert torch.equal(_bucket_bits_t(d), _bucket_bits_t(d2))
            assert torch.equal(_bucket_bits_t(r), _bucket_bits_t(r2))


def test_bucket_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the bucket entry points return the plain versions'
    bits and launch nothing; the kernels themselves refuse CPU tensors."""
    members, n, bits = BUCKETS[1]
    _, leaves, steps = _bucket(members, bits, seed=3)
    kernels = (twp.wire_quantize_bucket, twp.wire_dequant_bucket)
    before = [k.launches for k in kernels]
    q, res = twp.quantize_bucket(leaves, steps, n, bits, True)
    qr, rr = tref.quantize_bucket_ref(leaves, steps, n, bits, True)
    assert torch.equal(q, qr)
    gath = tref.pack_chunks_ref(q)
    err = torch.ones((q.shape[1],))
    got = twp.dequant_bucket(gath, err, res, leaves, steps, n, 1, 2, True)
    want = tref.dequant_bucket_ref(gath, err, rr, leaves, steps, n, 1, 2,
                                   True)
    for (a, b), (c, d) in zip(got, want):
        assert torch.equal(_bucket_bits_t(a), _bucket_bits_t(c))
        assert torch.equal(_bucket_bits_t(b), _bucket_bits_t(d))
    assert [k.launches for k in kernels] == before
    with pytest.raises(ValueError):
        twp.wire_quantize_bucket(leaves, steps, n, bits, True)
    with pytest.raises(ValueError):
        twp.wire_dequant_bucket(gath, err, res, leaves, steps, n, 1, 2, True)
