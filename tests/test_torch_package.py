"""The PyTorch port as a package: it stands apart from JAX and from the
JAX package, its entry points default to the card, and its kernel
wrappers route by the device of the tensors they are given.

This file imports no JAX, so its card-only tests (marker ``cuda``) run on
a machine with a CUDA device and no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_package.py
"""
import ast
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.hgq_quantize import (hgq_quantize, hgq_quantize_bwd,
                                              hgq_quantize_fwd,
                                              hgq_quantize_grad_ref,
                                              hgq_quantize_ref)
from repro_torch.kernels.kv_dequant import (kv_attention_decode,
                                            kv_attention_rows, kv_dequant,
                                            kv_dequant_rows, kv_quantize,
                                            kv_quantize_rows)
from repro_torch.kernels.kv_dequant.ref import (kv_attention_ref,
                                                kv_dequant_ref,
                                                kv_quantize_ref)
from repro_torch.kernels.qmatmul import (pack_nibbles, qmatmul, qmatmul_any,
                                         qmatmul_ref)
from repro_torch.kernels import wire_pack as wp

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_imports_no_jax_and_no_reference_package():
    code = (
        "import pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 55, names\n"
        "assert {'repro_torch.models.rwkv', 'repro_torch.nn.recurrent',\n"
        "        'repro_torch.models.griffin', 'repro_torch.models.whisper',\n"
        "        'repro_torch.serving.streaming'} <= set(names), names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_neither_jax_nor_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted(ROOT.glob("torch_*.py")) \
        + sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 20
    assert ROOT / "torch_granite_gaps.py" in files
    assert PKG / "models" / "rwkv.py" in files
    assert PKG / "nn" / "recurrent.py" in files
    assert PKG / "models" / "whisper.py" in files
    assert PKG / "serving" / "streaming.py" in files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {name}"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def _qmatmul_inputs(device, M=5, K=64, N=48):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((M, K), generator=g, device=device)
    w = torch.randint(-127, 128, (K, N), generator=g, device=device,
                      dtype=torch.int8)
    s = torch.full((N,), 2.0 ** -7, device=device)
    return x, w, s


def _kv_inputs(device, B=2, S=3, H=4, KV=2, hd=64, W=20):
    g = torch.Generator(device=device).manual_seed(1)
    rows = torch.randn((2, B, W, KV, hd), generator=g, device=device)
    m, f = kv_quantize_ref(rows, 8)
    qh = torch.randn((B, S, H, hd), generator=g, device=device)
    qpos = torch.tensor([[10, 11, 12], [17, 18, 19]], dtype=torch.int32,
                        device=device)
    tpos = torch.arange(W, dtype=torch.int32, device=device).expand(B, W)
    return rows, (qh, m[0], f[0], m[1], f[1], qpos, tpos)


def test_wrappers_take_the_plain_version_on_cpu():
    counts = (qmatmul.launches, kv_quantize_rows.launches,
              kv_attention_rows.launches)
    x, w, s = _qmatmul_inputs("cpu")
    torch.testing.assert_close(qmatmul_any(x, w, s), qmatmul_ref(x, w, s),
                               rtol=0, atol=0)
    rows, args = _kv_inputs("cpu")
    q, f = kv_quantize(rows, 8)
    qr, fr = kv_quantize_ref(rows, 8)
    assert torch.equal(q, qr) and torch.equal(f, fr)
    pf = torch.tensor(6.0)
    out = kv_attention_decode(*args, window=None, n_kv=2, probs_f=pf)
    qh = args[0]
    ref = kv_attention_ref(qh.reshape(2, 3, 2, 2, 64), *args[1:],
                           window=None, probs_f=pf).reshape(qh.shape)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert counts == (qmatmul.launches, kv_quantize_rows.launches,
                      kv_attention_rows.launches)
    with pytest.raises(ValueError):
        qmatmul(x, w, s)                 # the kernel itself takes no CPU


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wrappers_launch_the_kernels_on_cuda(cuda_device):
    """On CUDA tensors every wrapper launches its kernel (its counter
    moves by one) and agrees with the plain version."""
    x, w, s = _qmatmul_inputs(cuda_device)
    w_nk = w.T.contiguous().T             # N-major, as the packer stores it
    before = qmatmul.launches
    y = qmatmul_any(x, w_nk, s)
    assert qmatmul.launches == before + 1
    ref = qmatmul_ref(x, w, s)
    assert bool(((y - ref).abs() <=
                 1e-5 * qmatmul_ref(x.abs(), w.abs(), s)).all())
    with pytest.raises(ValueError):
        qmatmul_any(x, w, s)              # [K, N] storage: no kernel for it
    assert qmatmul.launches == before + 1

    rows, args = _kv_inputs(cuda_device)
    before = kv_quantize_rows.launches
    q, f = kv_quantize(rows, 8)
    assert kv_quantize_rows.launches == before + 1
    qr, fr = kv_quantize_ref(rows, 8)
    assert torch.equal(q, qr) and torch.equal(f, fr)

    before = kv_attention_rows.launches
    out = kv_attention_decode(*args, window=None, n_kv=2, probs_f=None)
    assert kv_attention_rows.launches == before + 1
    qh = args[0]
    ref = kv_attention_ref(qh.reshape(2, 3, 2, 2, 64), *args[1:],
                           window=None).reshape(qh.shape)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_hgq_quantize_launches_the_kernels_on_cuda(cuda_device):
    """On CUDA tensors the quantizer launches its forward kernel (bit-exact
    against the plain version) and its backward kernel (per parameter
    exact; the per-channel and per-tensor sums within 1e-5 of the sum of
    |terms|, the bound of a reordered float32 sum), one launch each; an
    f shape no kernel takes raises instead of falling back."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    cases = [((64, 16), (16,), torch.float32),
             ((300, 16), (1, 16), torch.float32),      # 10 row tiles
             ((16, 64), (16, 64), torch.float32), ((64,), (64,), torch.float32),
             ((300, 32), (), torch.float32),           # 5 element tiles
             ((300, 32), (), torch.bfloat16), ((200, 5), (5,), torch.bfloat16)]
    for shape, fshape, dtype in cases:
        x = (torch.randn(shape, generator=g, device=cuda_device) * 4).to(dtype)
        f = (torch.rand(fshape, generator=g, device=cuda_device) * 8 - 1)
        f.requires_grad_(True)
        gy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
        before = (hgq_quantize_fwd.launches, hgq_quantize_bwd.launches)
        out = hgq_quantize(x, f)
        (df,) = torch.autograd.grad(out, (f,), gy)
        torch.cuda.synchronize()
        assert (hgq_quantize_fwd.launches, hgq_quantize_bwd.launches) == \
            (before[0] + 1, before[1] + 1), (shape, fshape)
        assert torch.equal(out, hgq_quantize_ref(x, f.detach()))
        ref = hgq_quantize_grad_ref(gy, x, f.detach())
        if fshape == shape:
            assert torch.equal(df, ref)
        else:
            xq = hgq_quantize_ref(x, f.detach()).float()
            scale = (gy.float() * 0.6931471805599453
                     * (x.float() - xq)).abs().sum_to_size(fshape)
            assert bool(((df - ref).abs() <= 1e-5 * scale + 1e-30).all())
    x = torch.randn((16, 64), device=cuda_device)
    before = hgq_quantize_fwd.launches
    with pytest.raises(ValueError):
        hgq_quantize(x, torch.ones((16, 1), device=cuda_device))
    assert hgq_quantize_fwd.launches == before


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
def test_wire_pack_launches_the_kernels_on_cuda(cuda_device):
    """On CUDA tensors each wire entry point launches its kernel once and
    returns the plain version's bits: stacked rows and odd tails at every
    width, zero rows, rounding ties, the subnormal ``[1e-38]`` at 2 bits
    (kept, not flushed), nibble packs of odd length, and the phase-2
    decode for n of 3 and 4 (a true division)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    kernels = (wp.wire_quantize_rows, wp.wire_quantize_sflat,
               wp.wire_pack_rows, wp.wire_dequant_rows)

    def launched(fn, *args):
        before = [k.launches for k in kernels]
        out = fn(*args)
        torch.cuda.synchronize()
        moved = [k.launches - b for k, b in zip(kernels, before)]
        assert sum(moved) == 1, moved
        return out

    cases = [((24, 1000), 8), ((1, 4097), 4), ((3, 40), 2), ((4, 129), 5),
             ((7, 257), 7), ((1, 1), 3), ((2, 6), 6)]
    for shape, bits in cases:
        rows = torch.randn(shape, generator=g, device=cuda_device) * 3
        rows[0] = 0.0                                 # a zero row
        # the last row on rounding ties: (k + 1/2) * 2^-3 with |k + 1/2| up
        # to qmax - 1/2 puts the row's grid at 2^-3 (3 bits and up)
        qmax = 2 ** (bits - 1) - 1
        k = torch.arange(shape[1], device=cuda_device) % (2 * qmax) - qmax
        rows[-1] = (k + 0.5) * 0.125
        amax = rows.abs().amax(dim=1)
        got = launched(wp.quantize_leaf, rows, amax, bits)
        for a, b in zip(got, wp.quantize_leaf_ref(rows, amax, bits)):
            assert torch.equal(_bits(a), _bits(b)), (shape, bits)
        sp = wp.grid_scale(rows.abs().reshape(-1) + 1e-3, bits) \
            .reshape(shape)
        got = launched(wp.quantize_chunks, rows, sp, bits)
        for a, b in zip(got, wp.quantize_chunks_ref(rows, sp, bits)):
            assert torch.equal(_bits(a), _bits(b)), (shape, bits)
    sub = torch.tensor([[1e-38]], device=cuda_device)
    q, s, r = launched(wp.quantize_leaf, sub, sub[:, 0], 2)
    assert torch.equal(_bits(r), _bits(sub)) and int(q[0, 0]) == 0
    for shape in ((1, 1), (3, 7), (4, 1000), (2, 3, 33)):
        q = torch.randint(-7, 8, shape, generator=g, device=cuda_device,
                          dtype=torch.int8)
        assert torch.equal(launched(wp.pack_chunks, q),
                           wp.pack_chunks_ref(q))
    for n in (3, 4):
        shift = (n - 1).bit_length()
        q = torch.randint(-127, 128, (n, 1001), generator=g,
                          device=cuda_device, dtype=torch.int8)
        s = wp.grid_scale(torch.rand((n * 1001,), generator=g,
                                     device=cuda_device) + 0.1).reshape(n, -1)
        for ss in (s, s[0]):
            got = launched(wp.dequant_sum, q, ss, shift, n)
            assert torch.equal(_bits(got),
                               _bits(wp.dequant_sum_ref(q, ss, shift, n)))


# buckets of the fused reduce: (members ((shape, L, dtype), ...), n, bits)
BUCKETS = [
    ((((3, 8, 5), 3, torch.float32), ((17,), 1, torch.float32),
      ((), 1, torch.float32), ((2, 3, 7), 1, torch.float32)), 4, 8),
    ((((3, 41, 7), 3, torch.float32), ((1001,), 1, torch.bfloat16),
      ((33,), 1, torch.float32)), 3, 4),
    ((((5,), 1, torch.bfloat16), ((4099,), 1, torch.float32),
      ((24, 1000), 1, torch.bfloat16)), 4, 4),
    (tuple(((k % 37 + 1,), 1, torch.bfloat16 if k % 3 == 0
            else torch.float32) for k in range(65)), 4, 8),
]


def _wbits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else _bits(t)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("case", range(len(BUCKETS)))
def test_wire_bucket_kernels_on_cuda(cuda_device, case, offset):
    """The fused reduce's bucket kernels on leaves ``offset`` elements past
    a 16-byte boundary: the plain versions' bits (payload, residuals; at
    every rank index the delivered mean and the new residual, -0.0 off
    the own chunk turned +0.0, subnormals kept), one launch of each per
    64 members (two for the 65-member bucket)."""
    members, n, bits = BUCKETS[case]
    nib = bits <= 4
    g = torch.Generator(device=cuda_device).manual_seed(6 + case)
    leaves, steps = [], []
    for shape, L, dtype in members:
        T = int(np.prod(shape))
        buf = torch.randn((T + offset,), generator=g, device=cuda_device)
        leaves.append(buf.to(dtype)[offset:].view(shape))
        rows = leaves[-1].float().reshape(L, -1)
        steps.append(wp.grid_scale(rows.abs().amax(dim=1), bits))
    launches = -(-len(members) // 64)
    before = wp.wire_quantize_bucket.launches
    q, res = wp.wire_quantize_bucket(leaves, steps, n, bits, nib)
    torch.cuda.synchronize()
    assert wp.wire_quantize_bucket.launches == before + launches
    qr, rr = wp.quantize_bucket_ref(leaves, steps, n, bits, nib)
    assert torch.equal(q, qr)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(res, rr))
    W = q.shape[1]
    full = torch.randint(-7, 8, (n, W), generator=g, device=cuda_device,
                         dtype=torch.int8)
    gath = wp.pack_chunks_ref(full) if nib else full
    err = torch.randint(-8, 9, (W,), generator=g, device=cuda_device).float()
    for r in res:
        r.view(-1)[::3] = -0.0
        r.view(-1)[1::5] = 1e-40
    for idx in range(n):
        args = (gath, err, res, leaves, steps, n, idx, (n - 1).bit_length(),
                nib)
        want = wp.dequant_bucket_ref(*args)
        mine = [r.clone() for r in res]
        before = wp.wire_dequant_bucket.launches
        got = wp.wire_dequant_bucket(*args[:2], mine, *args[3:])
        torch.cuda.synchronize()
        assert wp.wire_dequant_bucket.launches == before + launches
        for (d, r), (dw, rw) in zip(got, want):
            assert d.dtype == dw.dtype and r.dtype == rw.dtype
            assert torch.equal(_wbits(d), _wbits(dw))
            assert torch.equal(_wbits(r), _wbits(rw))


@pytest.mark.cuda
def test_fused_reduce_launches_the_bucket_kernels_on_cuda(cuda_device):
    """A fused reduce over LocalMesh(4) (mixed 4/8 widths: two buckets)
    launches each bucket kernel once a bucket a rank and no per-position
    kernel, and delivers the per-leaf path's bits."""
    from repro_torch.dist import LocalMesh, ef_wire_pmean
    g = torch.Generator(device=cuda_device).manual_seed(8)
    tree = {"layers": torch.randn((4, 3, 8, 5), generator=g,
                                  device=cuda_device),
            "vec": torch.randn((4, 17), generator=g, device=cuda_device),
            "w3d": torch.randn((4, 2, 3, 7), generator=g,
                               device=cuda_device)}
    widths = {"layers": 4, "vec": 8, "w3d": 4}
    mesh = LocalMesh(4, cuda_device)
    kernels = (wp.wire_quantize_bucket, wp.wire_dequant_bucket,
               wp.wire_quantize_sflat, wp.wire_dequant_rows)
    before = [k.launches for k in kernels]
    d, r = ef_wire_pmean(tree, mesh, "int8", widths=widths)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [8, 8, 0, 0]
    dl, rl = ef_wire_pmean(tree, mesh, "int8", widths=widths, fused=False)
    for k in tree:
        assert torch.equal(_bits(d[k]), _bits(dl[k]))
        assert torch.equal(_bits(r[k]), _bits(rl[k]))


@pytest.mark.cuda
def test_kv_dequant_launches_its_kernel_on_cuda(cuda_device):
    """``kv_dequant`` on CUDA tensors moves the ``kv_dequant_rows`` counter
    by one and equals the plain version bit for bit: a qwen2 layer's ring
    (hd 64, the 16-byte path) and head dims that are not a multiple of 16
    (hd 72 with 21 rows, hd 24 with 5: the one-value path)."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    for lead, hd in (((2, 1024, 2), 64), ((7, 3), 72), ((5,), 24)):
        q = torch.randint(-128, 128, lead + (hd,), generator=g,
                          device=cuda_device, dtype=torch.int8)
        f = torch.randint(-3, 12, lead, generator=g, device=cuda_device,
                          dtype=torch.int8)
        before = kv_dequant_rows.launches
        out = kv_dequant(q, f)
        torch.cuda.synchronize()
        assert kv_dequant_rows.launches == before + 1
        assert torch.equal(out, kv_dequant_ref(q, f))


# kv_dequant_rows' redesign: (R, hd, byte offset of q into its buffer, f
# drawn from the whole int8 range).  Any hd (the one-value path off
# multiples of 16), rows 1-15 bytes off a 16-byte boundary (one-value
# path), R ragged against a thread's 4 pieces and a block's threads, and
# -128 mantissas at every exponent -128..127 (2^-f clamped to the normal
# range, products that overflow to -inf).
DEQUANT_EDGES = [(16384, 64, 0, False), (393217, 64, 0, False),
                 (1, 64, 0, False), (3, 16, 0, False), (1001, 48, 0, False),
                 (257, 80, 0, False), (33, 256, 0, False), (5, 1, 0, False),
                 (7, 17, 0, False), (1000, 72, 0, False), (999, 64, 1, False),
                 (64, 64, 15, False), (256, 64, 0, True), (129, 16, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,hd,offset,extreme", DEQUANT_EDGES)
def test_kv_dequant_rows_edges_on_cuda(cuda_device, R, hd, offset, extreme):
    """The kernel equals the plain version bit for bit and twice the same
    on every edge of its geometry."""
    g = torch.Generator(device=cuda_device).manual_seed(R + hd + offset)
    buf = torch.randint(-128, 128, (R * hd + offset,), generator=g,
                        device=cuda_device, dtype=torch.int8)
    q = buf[offset:].view(R, hd)
    if extreme:
        f = (torch.arange(R, device=cuda_device) % 256 - 128).to(torch.int8)
        q[::2] = -128
    else:
        f = torch.randint(-3, 12, (R,), generator=g, device=cuda_device,
                          dtype=torch.int8)
    out = kv_dequant_rows(q, f)
    again = kv_dequant_rows(q, f)
    torch.cuda.synchronize()
    ref = kv_dequant_ref(q, f)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    if extreme:
        assert bool(torch.isinf(ref).any())      # the overflow was reached


@pytest.mark.cuda
def test_qmatmul_reads_nibbles_in_the_kernel(cuda_device, monkeypatch):
    """``qmatmul_any`` on the packer's ``w_nib`` storage launches the
    kernel once and unpacks nothing on the way."""
    import repro_torch.dist.perf as perf
    import repro_torch.kernels.qmatmul.ops as qops
    import repro_torch.kernels.qmatmul.ref as qref
    g = torch.Generator(device=cuda_device).manual_seed(4)
    M, K, N = 8, 896, 608
    x = torch.randn((M, K), generator=g, device=cuda_device)
    m = torch.randint(-7, 8, (K, N), generator=g, device=cuda_device,
                      dtype=torch.int8)
    s = torch.full((N,), 2.0 ** -5, device=cuda_device)
    stored = pack_nibbles(m, axis=-2).T.contiguous().T    # as w_nib lies
    ref = qmatmul_ref(x, m, s)
    tol = 1e-5 * qmatmul_ref(x.abs(), m.abs(), s)

    def refuse(*a, **k):
        raise AssertionError("unpack_nibbles on the kernel path")

    for mod in (perf, qops, qref):
        monkeypatch.setattr(mod, "unpack_nibbles", refuse)
    before = qmatmul.launches
    y = qmatmul_any(x, stored, s, nib=True)
    torch.cuda.synchronize()
    assert qmatmul.launches == before + 1
    assert bool(((y - ref).abs() <= tol).all())


@pytest.mark.cuda
def test_qmatmul_rows_bitwise_equal_at_m_1_8_16(cuda_device):
    """A row's result has the same bits alone, in a decode tick of 8 and in
    a prefill chunk of 16, for int8 and nibble storage, with and without
    the split over K."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    for K, N in ((896, 128), (896, 151936 // 16), (4864, 896)):
        x = torch.randn((16, K), generator=g, device=cuda_device)
        s = torch.full((N,), 2.0 ** -6, device=cuda_device)
        m8 = torch.randint(-128, 128, (N, K), generator=g,
                           device=cuda_device, dtype=torch.int8).T
        m4 = torch.randint(-7, 8, (K, N), generator=g, device=cuda_device,
                           dtype=torch.int8)
        for w, nib in ((m8, False), (pack_nibbles(m4, axis=-2).T
                                     .contiguous().T, True)):
            y16 = qmatmul(x, w, s, nib=nib)
            y8 = qmatmul(x[:8].contiguous(), w, s, nib=nib)
            y1 = qmatmul(x[3:4].contiguous(), w, s, nib=nib)
            assert torch.equal(y16[:8], y8)
            assert torch.equal(y16[3:4], y1)


# (B, S, W, hd): RT = 8 query rows a block at B = 8, S = 1, RT = 16 at
# B = 2, S = 16; W = 1500 leaves the cluster's last block ragged, W = 2048
# gives a block two staging rounds, W = 16384 at RT = 16 and W = 32768 at
# RT = 8 keep no scores in shared memory (pass 2 recomputes them), hd = 40
# stages rows without 16-byte loads; hd = 256 (recurrentgemma-2b's 10
# heads over 1 kv head) runs the instance that splits p.v over two halves
# of the head dim, its scores kept at W = 2064 and recomputed at 16384
LONG_RINGS = [(8, 1, 1500, 64), (2, 16, 1500, 64), (8, 1, 2048, 64),
              (2, 16, 2048, 64), (2, 16, 16384, 64), (8, 1, 32768, 64),
              (2, 16, 1500, 40), (8, 1, 2064, 256), (2, 16, 16384, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("nibble", [False, True], ids=["int8", "nibble"])
@pytest.mark.parametrize("B,S,W,hd", LONG_RINGS)
def test_kv_attention_long_rings_on_cuda(cuda_device, B, S, W, hd, nibble):
    """Rings longer than the serving slice's, partly empty, with and
    without a window: within 1e-5 of the plain version, and each request's
    rows bit for bit the same alone as in the batch."""
    from repro_torch.kernels.kv_dequant import kv_pack
    g = torch.Generator(device=cuda_device).manual_seed(W + hd)
    H, KV = (10, 1) if hd == 256 else (14, 2)
    bits = 4 if nibble else 8
    m, f = kv_quantize_ref(torch.randn((2, B, W, KV, hd), generator=g,
                                       device=cuda_device), bits)
    if nibble:
        m = kv_pack(m)
    qh = torch.randn((B, S, H, hd), generator=g, device=cuda_device)
    last = torch.randint(S, W, (B,), generator=g, device=cuda_device)
    qpos = (last[:, None] - S + 1 + torch.arange(S, device=cuda_device)
            ).to(torch.int32)
    tpos = torch.arange(W, device=cuda_device).expand(B, W).clone()
    tpos[tpos > last[:, None]] = -1
    args = (qh, m[0], f[0], m[1], f[1], qpos, tpos.to(torch.int32))
    for window in (None, 700):
        out = kv_attention_rows(*args, window=window, n_kv=KV)
        ref = kv_attention_ref(qh.reshape(B, S, KV, H // KV, hd), *args[1:],
                               window=window).reshape(qh.shape)
        assert float((out - ref).abs().max()) <= 1e-5
        for b in (0, B - 1):
            one = [a[b:b + 1].contiguous() for a in args]
            assert torch.equal(kv_attention_rows(*one, window=window,
                                                 n_kv=KV), out[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(16))
def test_wire_pack_rows_unaligned_views_on_cuda(cuda_device, offset):
    """``wire_pack_rows`` on contiguous views whose base sits ``offset``
    bytes into a tensor: even C (the 16-byte path, its input misaligned
    against its output) and odd C (a row at a time), bit-exact against the
    plain version, one launch each."""
    g = torch.Generator(device=cuda_device).manual_seed(offset)
    for R, C in ((4, 2 * 16 * 100 + 34), (3, 66), (1, 2), (2, 1001)):
        buf = torch.randint(-8, 8, (R * C + 16,), generator=g,
                            device=cuda_device, dtype=torch.int8)
        q = buf[offset:offset + R * C].view(R, C)
        before = wp.wire_pack_rows.launches
        out = wp.wire_pack_rows(q)
        torch.cuda.synchronize()
        assert wp.wire_pack_rows.launches == before + 1
        assert torch.equal(out, wp.pack_chunks_ref(q)), (R, C)


# seconds the profiler runs before the marker and after the profiled launch
PROFILE_SETTLE_S = 0.05

# the backward's per-channel and per-tensor shapes on the training slice
# (batch 1024 on one card, 256 a slice of the compressed step)
TRAINING_BWD = [((1024, 16), (16,)), ((1024, 64), ()), ((1024, 32), ()),
                ((256, 16), (16,)), ((256, 64), ()), ((256, 32), ())]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,fshape", TRAINING_BWD)
def test_hgq_bwd_is_one_launch_at_training_shapes(cuda_device, shape, fshape,
                                                  dtype):
    """At every training shape the per-channel and per-tensor backward is
    one device kernel (a thread block cluster, no scratch, no second pass),
    repeatable bit for bit, within 1e-5 of the sum of |terms| of the plain
    version, and summed in the same order for an unaligned view."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.hgq_quantize.ops import bwd_plan
    lay = "per_channel" if fshape else "per_tensor"
    (_, clusters, _), scratch = bwd_plan(shape[0], shape[1], lay, dtype)
    assert clusters == 1 and scratch == 0
    g = torch.Generator(device=cuda_device).manual_seed(shape[0] + shape[1])
    n = shape[0] * shape[1]
    buf = (torch.randn(2 * n + 1, generator=g, device=cuda_device) * 4
           ).to(dtype)
    x, gy = buf[:n].view(shape), buf[n:2 * n].view(shape)
    f = torch.rand(fshape, generator=g, device=cuda_device) * 8 - 1
    hgq_quantize_bwd(gy, x, f)                                # warm up
    torch.cuda.synchronize()
    # the trace can lack the device record of the first kernel launched
    # after the profiler starts: launch the backward once the profiler has
    # settled, after a marker kernel (torch.cuda._sleep's spin_kernel)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_SETTLE_S)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        df = hgq_quantize_bwd(gy, x, f)
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.name]
    assert len(kernels) == 1 and "hgq_bwd" in kernels[0], kernels
    assert torch.equal(df, hgq_quantize_bwd(gy, x, f))
    ref = hgq_quantize_grad_ref(gy, x, f)
    xq = hgq_quantize_ref(x, f).float()
    scale = (gy.float() * 0.6931471805599453
             * (x.float() - xq)).abs().sum_to_size(fshape)
    assert bool(((df - ref).abs() <= 1e-5 * scale).all())
    xu, gu = buf[1:n + 1].view(shape), buf[n + 1:].view(shape)
    assert torch.equal(hgq_quantize_bwd(gu, xu, f),
                       hgq_quantize_bwd(gu.clone(), xu.clone(), f))


# f at the ends of the grid step's clamp (fi = floor(f + 1/2) in -126..127)
# and past them, each with an x off the grid there (x * 2^fi = m, 2 m or 4 m,
# m in [1, 2)) and a g that keeps the term a normal float32:
# (f, exponent of x, exponent of g)
GRID_EDGES = [(-300.0, 126, -100), (-126.0, 126, -100), (-125.6, 126, -100),
              (126.0, -125, 40), (126.5, -125, 40), (127.0, -125, 40),
              (300.0, -125, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_hgq_bwd_grid_step_at_the_clamp_on_cuda(cuda_device, dtype):
    """The reductions' grid step and its reciprocal (``grid_of``:
    ``2^-fi`` built in the exponent field, ``2^-127`` the subnormal
    ``0x00400000``) at fi = -126, 126 and 127 and past the clamp: ``df`` of
    a one-element tensor per tensor, and of one row per channel, equal the
    plain version bit for bit (one term, nothing else to add)."""
    rng = np.random.default_rng(15)
    m = rng.uniform(1.0, 1.999, size=len(GRID_EDGES))
    xs = [mi * 2.0 ** e for mi, (_, e, _) in zip(m, GRID_EDGES)]
    gs = [rng.uniform(1.0, 2.0) * 2.0 ** e for _, _, e in GRID_EDGES]
    x = torch.tensor([xs], dtype=torch.float32).to(dtype)
    gy = torch.tensor([gs], dtype=torch.float32).to(dtype)
    f = torch.tensor([fv for fv, _, _ in GRID_EDGES], dtype=torch.float32)
    assert bool((hgq_quantize_ref(x, f) != x).all())       # off the grid
    want = hgq_quantize_grad_ref(gy, x, f)
    assert bool(torch.isfinite(want).all() & (want != 0).all())
    on = lambda t: t.to(cuda_device)
    got = hgq_quantize_bwd(on(gy), on(x), on(f)).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for k in range(len(GRID_EDGES)):
        xk, gk, fk = x[:, k:k + 1], gy[:, k:k + 1], f[k]
        want = hgq_quantize_grad_ref(gk, xk, fk)
        got = hgq_quantize_bwd(on(gk.contiguous()), on(xk.contiguous()),
                               on(fk)).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            GRID_EDGES[k]


# a grouped forward's members: the jet tagger's weights, activations of
# every layout, ragged shapes (rows that are not whole 16-byte vectors, a
# last vector cut short), bfloat16, and two qwen2-0.5b layer shapes
GROUP_MEMBERS = [((16, 64), (16, 64), torch.float32),
                 ((64,), (64,), torch.float32),
                 ((1024, 16), (16,), torch.float32),
                 ((300, 5), (5,), torch.bfloat16),
                 ((1001, 33), (), torch.float32),
                 ((37,), (37,), torch.bfloat16),
                 ((1024, 40), (1, 40), torch.bfloat16),
                 ((896, 4864), (1, 4864), torch.float32),
                 ((8192, 896), (), torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "one_element_in"])
def test_hgq_fwd_group_on_cuda(cuda_device, offset):
    """The grouped forward is one launch and gives every member the bits of
    its own ``hgq_quantize_fwd`` launch and of the plain version; views
    one element past a 16-byte boundary (values one by one) give the same
    bits; through the op the gradients are each member's own."""
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_fwd_group,
                                                  hgq_quantize_group)
    g = torch.Generator(device=cuda_device).manual_seed(17)
    xs, fs = [], []
    for shape, fshape, dtype in GROUP_MEMBERS:
        n = int(np.prod(shape))
        buf = (torch.randn(n + 1, generator=g, device=cuda_device) * 4
               ).to(dtype)
        xs.append(buf[offset:offset + n].view(shape))
        nf = int(np.prod(fshape))
        fb = torch.rand(nf + 1, generator=g, device=cuda_device) * 8 - 1
        fs.append(fb[offset:offset + nf].view(fshape))
    before = (hgq_quantize_fwd_group.launches, hgq_quantize_fwd.launches)
    outs = hgq_quantize_fwd_group(xs, fs)
    assert (hgq_quantize_fwd_group.launches, hgq_quantize_fwd.launches) == \
        (before[0] + 1, before[1])
    for x, f, out in zip(xs, fs, outs):
        ref = hgq_quantize_ref(x, f)
        assert torch.equal(_bits16(out), _bits16(ref)), (x.shape, f.shape)
        assert torch.equal(_bits16(out), _bits16(hgq_quantize_fwd(x, f)))
    assert all(torch.equal(_bits16(a), _bits16(b)) for a, b in
               zip(outs, hgq_quantize_fwd_group(xs, fs)))
    small = slice(0, 4)                                # the jet weights etc.
    xg = [x.detach().clone().requires_grad_(True) for x in xs[small]]
    fg = [f.detach().clone().requires_grad_(True) for f in fs[small]]
    gy = [torch.randn(x.shape, generator=g, device=cuda_device).to(x.dtype)
          for x in xg]
    grads = torch.autograd.grad(hgq_quantize_group(xg, fg), xg + fg, gy)
    for i, (x, f) in enumerate(zip(xg, fg)):
        assert torch.equal(grads[i], gy[i])
        want = hgq_quantize_bwd(gy[i], x.detach(), f.detach())
        assert torch.equal(grads[len(xg) + i], want)


def _bits16(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# the per-expert layouts (an MoE layer's expert stacks [E, K, N], f per
# expert): granite's gate stack cut to 8 experts per expert channel and
# tensor, a bfloat16 stack whose rows are not whole vectors, K = 1, and
# each reduction just past the one-cluster line (each expert's clusters and
# second pass)
PER_EXPERT = [((8, 1536, 512), (8, 1, 512), torch.float32),
              ((8, 1536, 512), (8, 1, 1), torch.float32),
              ((5, 37, 33), (5, 1, 33), torch.bfloat16),
              ((40, 1, 512), (40, 1, 1), torch.float32),
              ((3, 2049, 16), (3, 1, 16), torch.float32),
              ((3, 257, 256), (3, 1, 1), torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fshape,dtype", PER_EXPERT)
def test_hgq_per_expert_layouts_on_cuda(cuda_device, shape, fshape, dtype):
    """The per-expert layouts launch the kernels, single and grouped: the
    forward the plain version's bits, df within 1e-5 of the sum of |terms|
    and, expert by expert, the bits of the per-channel or per-tensor
    launch on that expert alone; two launches the same bits.  Another
    broadcast over the experts raises."""
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_fwd_group,
                                                  layout_of)
    lay = layout_of(shape, fshape)
    assert lay in ("per_expert_channel", "per_expert_tensor")
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device=cuda_device) * 4).to(dtype)
    f = torch.rand(fshape, generator=g, device=cuda_device) * 8 - 1
    gy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    before = (hgq_quantize_fwd.launches, hgq_quantize_bwd.launches)
    out, df = hgq_quantize_fwd(x, f), hgq_quantize_bwd(gy, x, f)
    torch.cuda.synchronize()
    assert (hgq_quantize_fwd.launches, hgq_quantize_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(_bits16(out), _bits16(hgq_quantize_ref(x, f)))
    assert torch.equal(_bits16(out),
                       _bits16(hgq_quantize_fwd_group([x], [f])[0]))
    assert torch.equal(df, hgq_quantize_bwd(gy, x, f))
    ref = hgq_quantize_grad_ref(gy, x, f)
    xq = hgq_quantize_ref(x, f).float()
    scale = (gy.float() * 0.6931471805599453
             * (x.float() - xq)).abs().sum_to_size(fshape)
    assert bool(((df - ref).abs() <= 1e-5 * scale + 1e-30).all())
    per = (lambda fe: fe.reshape(-1)) if lay == "per_expert_channel" \
        else (lambda fe: fe.reshape(()))
    for e in range(shape[0]):
        assert torch.equal(df[e].reshape(-1),
                           hgq_quantize_bwd(gy[e], x[e], per(f[e]))
                           .reshape(-1)), e
    with pytest.raises(ValueError):                 # f per expert, 2 wide
        hgq_quantize_fwd(x, torch.zeros((shape[0],) + shape[1:-1] + (2,),
                                        device=cuda_device))


# (B, S, W, windowed ring, kv bits, rows' dtype, byte offset of the ring
# views, element offset of the k/v rows): int8 and nibble rings, a decode
# tick and a prefill chunk, a windowed ring, a chunk longer than the ring
# (rows dropped), bfloat16 rows, views 1-15 bytes into their buffers
STORE_CUDA = ([(8, 1, 1024, False, 8, torch.float32, 0, 0),
               (8, 1, 1024, False, 4, torch.float32, 0, 0),
               (1, 16, 1024, False, 8, torch.float32, 0, 0),
               (1, 16, 1024, False, 4, torch.float32, 0, 0),
               (4, 1, 64, True, 8, torch.float32, 0, 0),
               (2, 16, 8, True, 8, torch.float32, 0, 0),
               (2, 16, 8, True, 4, torch.float32, 0, 0),
               (8, 1, 1024, False, 8, torch.bfloat16, 0, 0),
               (2, 16, 64, True, 4, torch.bfloat16, 0, 0)]
              + [(2, 3, 32, True, 4 if off % 2 else 8, torch.float32, off,
                  off % 4) for off in range(1, 16)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", STORE_CUDA,
                         ids=lambda c: "-".join(str(v) for v in c))
def test_kv_quantize_store_on_cuda(cuda_device, case):
    """The fused store writes the four ring buffers bit for bit as its
    plain version (quantize, pack, ring write), in one launch, leaving the
    slots it does not reach as they were."""
    from repro_torch.kernels.kv_dequant import kv_quantize_store
    from repro_torch.kernels.kv_dequant.ref import kv_quantize_store_ref
    B, S, W, window, bits, dtype, off, xoff = case
    KV, hd = 2, 64
    hdm = hd // 2 if bits <= 4 else hd
    g = torch.Generator(device=cuda_device).manual_seed(W * 31 + S + off)
    n = B * S * KV * hd
    rows = (torch.randn(2 * n + 4, generator=g, device=cuda_device) * 3
            ).to(dtype)
    kh = rows[xoff:xoff + n].view(B, S, KV, hd)
    vh = rows[n + xoff:2 * n + xoff].view(B, S, KV, hd)
    cp = torch.randint(0, 3 * W if window else W - S + 1, (B,), generator=g,
                       device=cuda_device)
    qpos = cp[:, None] + torch.arange(S, device=cuda_device)
    if window:
        last = cp + S - 1
        slot = torch.where(qpos > last[:, None] - W, qpos % W,
                           torch.full_like(qpos, W))
    else:
        slot = qpos

    def ring(shape):
        m = int(np.prod(shape))
        buf = torch.randint(-128, 128, (m + 16,), generator=g,
                            device=cuda_device, dtype=torch.int8)
        return buf[off:off + m].view(shape)

    bufs = [ring((B, W, KV, hdm)), ring((B, W, KV, hdm)), ring((B, W, KV)),
            ring((B, W, KV))]
    want = [b.clone() for b in bufs]
    kv_quantize_store_ref(kh, vh, slot, *want, bits)
    before = kv_quantize_store.launches
    kv_quantize_store(kh, vh, slot, *bufs, bits)
    torch.cuda.synchronize()
    assert kv_quantize_store.launches == before + 1
    for a, b in zip(bufs, want):
        assert torch.equal(a, b)
    kv_quantize_store(kh, vh, slot, *bufs, bits)          # repeatable
    assert all(torch.equal(a, b) for a, b in zip(bufs, want))


@pytest.mark.cuda
def test_launch_tallies_of_a_step_and_a_tick_on_cuda(cuda_device):
    """A jet-tagger training step launches the ``hgq_quantize`` forward
    once grouped (its 8 weights and biases) and 4 times single (its
    activations), and the backward 12 times; a decode tick of a quantized
    ring stores each layer's k and v rows with one ``kv_quantize_store``
    launch and no ``kv_quantize_rows`` launch, int8 and nibble rings."""
    from repro_torch.configs import get
    from repro_torch.core import hgq
    from repro_torch.kernels.hgq_quantize import hgq_quantize_fwd_group
    from repro_torch.kernels.kv_dequant import kv_quantize_store
    from repro_torch.models import JetTagger, TransformerLM
    from repro_torch.nn import HGQConfig
    from repro_torch.train import softmax_xent
    cfg = HGQConfig(weight_gran="per_parameter", act_gran="per_parameter")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p, q = JetTagger.init(gen, cfg, device=cuda_device)
    x = torch.randn((256, 16), generator=gen, device=cuda_device)
    y = torch.randint(0, 5, (256,), generator=gen, device=cuda_device)
    leaves = [t for d in p.values() for t in (
        [d] if isinstance(d, torch.Tensor) else
        [v for w in d.values() for v in (w.values() if isinstance(w, dict)
                                         else [w])])]
    for t in leaves:
        t.requires_grad_(True)
    counts = lambda: (hgq_quantize_fwd.launches,
                      hgq_quantize_fwd_group.launches,
                      hgq_quantize_bwd.launches)
    before = counts()
    logits, _, aux = JetTagger.forward(p, q, {"x": x}, hgq.TRAIN)
    loss = softmax_xent(logits, y) + 1e-6 * aux.ebops
    torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (4, 1, 12)

    mcfg = get("qwen2-0.5b", smoke=True)
    mp, mq = TransformerLM.init(torch.Generator(device=cuda_device)
                                .manual_seed(1), mcfg, device=cuda_device)
    for kv_bits in (8, 4):
        caches = TransformerLM.init_cache(mcfg, 2, 32, kv_bits=kv_bits,
                                          device=cuda_device)
        toks = torch.randint(0, mcfg.vocab, (2, 1), device=cuda_device)
        before = (kv_quantize_store.launches, kv_quantize_rows.launches)
        TransformerLM.decode_step(mp, mq, caches, toks, np.array([3, 7]),
                                  mcfg, kv_bits=kv_bits)
        torch.cuda.synchronize()
        assert (kv_quantize_store.launches - before[0],
                kv_quantize_rows.launches - before[1]) == \
            (mcfg.n_layers, 0)
