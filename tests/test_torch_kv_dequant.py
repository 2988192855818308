"""Port parity: the quantized KV cache of ``repro_torch.kernels.kv_dequant``
against the JAX package (whose off-TPU path is its jnp reference).

``kv_quantize`` is bit-exact, mantissas and exponents, including zero
rows and products exactly on .5 (they pin half-to-even rounding).  The
fused attention read is held to 1e-5 without a probs grid; with one, at
most 1% of outputs may differ by more, each by at most one probs step
times (max|v| + |o|): a one-ulp difference in ``exp`` can move one
probability across a grid point, which moves the output by
``step * (v - o) / l`` with ``l >= 1``."""
import math
import warnings
import zlib

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.nn imports repro.dist lazily)
    from repro.kernels.kv_dequant import ops as jkv

from repro_torch.kernels.kv_dequant import (kv_attention_rows,
                                            kv_quantize_rows)
from repro_torch.kernels.kv_dequant import ops as tkv



def _rng(*key):
    """A generator of its own for each test case, so the inputs do not
    depend on which tests ran before in the process."""
    return np.random.default_rng([7, zlib.crc32(repr(key).encode())])


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _rows(shape, bits, rng):
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0                 # a zero row
    hd = shape[-1]
    qmax = 2 ** (bits - 1) - 1
    # amax qmax / 8 puts the row's grid at 2^-3, so k / 16 lands on k / 2
    half = x.reshape(-1, hd)[1]
    half[:] = (np.arange(hd) % (2 * qmax)).astype(np.float32) / 16.0
    half[0] = qmax / 8.0
    return x


@pytest.mark.parametrize("bits", [8, 6, 4])
def test_kv_quantize_bit_exact(bits):
    x = _rows((3, 5, 2, 64), bits, np.random.default_rng(bits))
    qj, fj = jkv.kv_quantize(jnp.asarray(x), bits)
    before = kv_quantize_rows.launches
    qt, ft = tkv.kv_quantize(torch.from_numpy(x), bits)
    assert kv_quantize_rows.launches == before   # CPU: the plain version
    assert qt.dtype == torch.int8 and ft.dtype == torch.int8
    _eq(qj, qt)
    _eq(fj, ft)
    # half to even: a product of exactly k + 1/2 rounds to the even k
    r = qt.reshape(-1, 64)[1].numpy().astype(np.int64)
    prod = x.reshape(-1, 64)[1] * 2.0 ** ft.reshape(-1)[1].item()
    on_half = np.abs(prod - np.floor(prod) - 0.5) == 0
    assert on_half.any()
    assert np.all(r[on_half] % 2 == 0)


def test_kv_dequant_pack_unpack():
    x = _rows((4, 9, 32), 4, np.random.default_rng(1))
    q, f = tkv.kv_quantize(torch.from_numpy(x), 4)
    _eq(jkv.kv_dequant(jnp.asarray(q.numpy()), jnp.asarray(f.numpy())),
        tkv.kv_dequant(q, f))
    pj = jkv.kv_pack(jnp.asarray(q.numpy()))
    pt = tkv.kv_pack(q)
    _eq(pj, pt)
    _eq(jkv.kv_unpack(pj, 32), tkv.kv_unpack(pt, 32))
    torch.testing.assert_close(tkv.kv_unpack(pt, 32), q, rtol=0, atol=0)


def _cache(B, W, KV, hd, bits, rng):
    rows = (rng.normal(size=(2, B, W, KV, hd)) * 2).astype(np.float32)
    q, f = tkv.kv_quantize(torch.from_numpy(rows), bits)
    if bits <= 4:
        q = tkv.kv_pack(q)
    return q[0], f[0], q[1], f[1]


def _positions(B, S, W, ring, rng):
    """Ragged per-row fill levels; a full-width unwindowed cache leaves
    slots past each row's fill empty (tpos < 0), a ring wraps."""
    last = rng.integers(S, 3 * W if ring else W, size=B)
    qpos = last[:, None] - S + 1 + np.arange(S)[None]
    if ring:
        spos = np.arange(W)
        tpos = last[:, None] - np.mod(last[:, None] - spos[None], W)
    else:
        tpos = np.broadcast_to(np.arange(W), (B, W)).copy()
        tpos[tpos > last[:, None]] = -1
    return qpos.astype(np.int32), tpos.astype(np.int32)


def _check(out_t, out_j, vmax, probs_f):
    d = np.abs(out_t - out_j)
    if probs_f is None:
        assert d.max() <= 1e-5, d.max()
        return
    step = 2.0 ** -math.floor(probs_f + 0.5)
    assert np.mean(d > 1e-5) <= 0.01
    assert np.all(d <= step * (vmax + np.abs(out_j)) + 1e-5), d.max()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("probs_f", [None, 6.0])
def test_kv_attention_decode_matches_jax(bits, window, probs_f):
    # 192 query rows: one probability moved across its grid point moves
    # one row's hd outputs, 0.5% of them
    B, S, H, KV, hd, W = 4, 4, 12, 2, 16, 24
    rng = _rng(bits, window, probs_f)
    km, kf, vm, vf = _cache(B, W, KV, hd, bits, rng)
    qh = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    qpos, tpos = _positions(B, S, W, ring=window is not None, rng=rng)
    pf = None if probs_f is None else np.float32(probs_f)
    out_j = np.asarray(jkv.kv_attention_decode(
        jnp.asarray(qh), jnp.asarray(km.numpy()), jnp.asarray(kf.numpy()),
        jnp.asarray(vm.numpy()), jnp.asarray(vf.numpy()), jnp.asarray(qpos),
        jnp.asarray(tpos), window=window, n_kv=KV,
        probs_f=None if pf is None else jnp.asarray(pf)))
    before = kv_attention_rows.launches
    out_t = tkv.kv_attention_decode(
        torch.from_numpy(qh), km, kf, vm, vf, torch.from_numpy(qpos),
        torch.from_numpy(tpos), window=window, n_kv=KV,
        probs_f=None if pf is None else torch.tensor(pf))
    assert kv_attention_rows.launches == before
    assert tuple(out_t.shape) == (B, S, H, hd)
    vdeq = tkv.kv_dequant(tkv.kv_unpack(vm, hd) if bits <= 4 else vm, vf)
    _check(out_t.numpy(), out_j, float(vdeq.abs().max()), probs_f)


def test_kv_attention_empty_rows_are_zero():
    """A row whose every slot is empty (tpos < 0) reads exactly zero."""
    B, S, H, KV, hd, W = 2, 1, 4, 2, 8, 6
    rng = np.random.default_rng(2)
    km, kf, vm, vf = _cache(B, W, KV, hd, 8, rng)
    qh = torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(np.float32))
    qpos = torch.zeros((B, S), dtype=torch.int32)
    tpos = torch.full((B, W), -1, dtype=torch.int32)
    out = tkv.kv_attention_decode(qh, km, kf, vm, vf, qpos, tpos,
                                  window=None, n_kv=KV,
                                  probs_f=torch.tensor(6.0))
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("lead,hd", [((3, 5), 64), ((7,), 80), ((1, 3, 3), 48)])
def test_kv_dequant_matches_jax_kernel(lead, hd):
    """``kv_dequant`` (the plain version on the CPU) bit for bit against
    JAX's ``kv_dequant_rows`` kernel in interpret mode and its reference,
    with an odd number of rows and head dims that are not a multiple of
    128 (the JAX op pads them to its lanes; the port pads nothing)."""
    rng = _rng("dequant", lead, hd)
    q = rng.integers(-128, 128, size=lead + (hd,)).astype(np.int8)
    f = rng.integers(-3, 12, size=lead).astype(np.int8)
    f.reshape(-1)[0] = 127                       # 2^-127: clamped to 2^-126
    assert math.prod(lead) % 2 == 1
    out = tkv.kv_dequant(torch.from_numpy(q), torch.from_numpy(f))
    assert out.dtype == torch.float32 and tuple(out.shape) == lead + (hd,)
    _eq(jkv.kv_dequant(jnp.asarray(q), jnp.asarray(f), use_kernel=True,
                       interpret=True), out)
    _eq(jkv.kv_dequant(jnp.asarray(q), jnp.asarray(f), use_kernel=False),
        out)


def test_attention_cluster_from_w_only():
    """The attention kernel's cluster size takes the ring length W and
    nothing else (so never B or S): 8 blocks at qwen2's 1024-slot ring,
    one for a short ring, never more than the portable 8."""
    import inspect
    from repro_torch.kernels.kv_dequant import attention_cluster
    assert list(inspect.signature(attention_cluster).parameters) == ["W"]
    assert [attention_cluster(W) for W in (1, 20, 128, 129, 1024, 2048,
                                           100000)] == [1, 1, 1, 2, 8, 8, 8]


def _store_slots(B, S, W, window, rng):
    """Ring slots of a chunk of S rows at per-row cache positions, as the
    attention layer computes them: a windowed ring keeps a chunk's newest
    W rows (stale rows get slot W, dropped); an unwindowed cache takes the
    position itself."""
    if window:
        cp = rng.integers(0, 3 * W, size=B)
        qpos = cp[:, None] + np.arange(S)
        last = cp + S - 1
        return np.where(qpos > last[:, None] - W, qpos % W, W)
    cp = rng.integers(0, W - S + 1, size=B)
    return cp[:, None] + np.arange(S)


# (B, S, W, windowed ring, kv bits, hd): S = 1 and 16, int8 and nibble rings,
# windowed rings, chunks longer than the ring (S > W, rows dropped)
STORE_CASES = [(3, 1, 16, False, 8, 64), (3, 1, 16, False, 4, 64),
               (2, 16, 32, False, 8, 64), (2, 16, 32, False, 4, 64),
               (3, 1, 8, True, 8, 64), (2, 5, 8, True, 4, 64),
               (2, 16, 8, True, 8, 64), (2, 16, 8, True, 4, 64),
               (2, 3, 16, False, 8, 40)]


@pytest.mark.parametrize("B,S,W,window,bits,hd", STORE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_store_matches_jax(B, S, W, window, bits, hd, dtype):
    """``kv_quantize_store`` (on the CPU its plain version) writes the ring
    buffers bit for bit as JAX's ``kv_quantize`` per tensor, ``kv_pack``
    and ``.at[bidx, slot].set(mode="drop")`` on each of the four; slots
    the chunk does not reach keep their old bytes."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = _rng("store", B, S, W, window, bits, hd, dtype)
    KV = 2
    hdm = hd // 2 if bits <= 4 else hd
    kh = np.array(jnp.asarray(_rows((B, S, KV, hd), bits, rng), jdt),
                  np.float32)
    vh = np.array(jnp.asarray((rng.normal(size=(B, S, KV, hd)) * 0.7)
                              .astype(np.float32), jdt), np.float32)
    slot = _store_slots(B, S, W, window, rng)
    ring = [rng.integers(-128, 128, size=(B, W, KV, hdm), dtype=np.int8)
            for _ in range(2)]
    ring += [rng.integers(-128, 128, size=(B, W, KV), dtype=np.int8)
             for _ in range(2)]
    km, kf = jkv.kv_quantize(jnp.asarray(kh, jdt), bits)
    vm, vf = jkv.kv_quantize(jnp.asarray(vh, jdt), bits)
    if hdm != hd:
        km, vm = jkv.kv_pack(km), jkv.kv_pack(vm)
    bidx = jnp.arange(B)[:, None]
    js = jnp.asarray(slot)
    want = [jnp.asarray(buf).at[bidx, js].set(new, mode="drop")
            for buf, new in zip(ring, (km, vm, kf, vf))]
    got = [torch.from_numpy(buf.copy()) for buf in ring]
    before = tkv.kv_quantize_store.launches
    tkv.kv_quantize_store(torch.from_numpy(kh).to(tdt),
                          torch.from_numpy(vh).to(tdt),
                          torch.from_numpy(slot), *got, bits)
    assert tkv.kv_quantize_store.launches == before   # CPU: plain version
    for j, t in zip(want, got):
        _eq(j, t)
    if window and S > W:
        assert (slot >= W).any()                       # rows were dropped
