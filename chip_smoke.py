#!/usr/bin/env python3
"""Drive the PyTorch port of HGQ (serving, training, data-parallel
training over the compressed gradient wire) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and the CUDA toolkit (``nvcc``), and imports
only the port under ``src/repro_torch``, never JAX.  In order it

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. kernel phase: holds every kernel against its plain PyTorch version at
   the shapes its main path gives it, under the stated tolerances, checks
   that two launches give the same bits where the kernel promises it, and
   that a row's result does not depend on the batch it rides in
   (``qmatmul`` at M = 1, 8 and 16, ``kv_attention_rows`` alone and in a
   batch of 8), and times the kernel, the plain version and a one-call
   library yardstick (where one exists) with CUDA events, beside the least
   time the card could take; holds ``qmatmul``'s exact products against
   a control that drops the lowest bf16 term, and ``kv_attention_rows``
   on rings longer than serving's (up to 32768 slots); holds
   ``wire_pack_rows`` on views 0-15 bytes past a 16-byte boundary, and
   the ``hgq_quantize`` backward on an unaligned view against an aligned
   copy (the same bits); holds the grouped ``hgq_quantize`` forward
   against per-member launches and the plain group (mixed layouts and
   dtypes, unaligned views), and the fused KV store ``kv_quantize_store``
   against its plain version on int8 and nibble rings, S = 1 and 16, a
   windowed ring, a chunk longer than the ring, bfloat16 rows and views
   1-15 bytes into their buffers; holds the fused reduce's bucket kernels
   ``wire_quantize_bucket`` and ``wire_dequant_bucket`` against their
   plain versions at every rank index on int8 and nibble buckets, odd C,
   ragged T, stacked and bfloat16 leaves, leaves and residuals off a
   16-byte boundary, -0.0 and subnormal residuals, and a bucket of 65
   members (two launches of each); times ``kv_dequant_rows`` at one
   qwen2-0.5b layer's ring, one slot's and all 24 layers' (R = 16384,
   2048, 393216, hd 64) beside the empty kernel on the same grid (the
   launch floor), and holds it on its edges (any hd, rows off alignment,
   ragged R, -128 mantissas at every exponent); holds and times the
   ``hgq_quantize`` shapes of the SVHN and muon models (4-D
   per-parameter conv kernels, per-tensor activations up to 1.84 M
   values, their grouped forwards);
4. slice phase: serves qwen2-0.5b at full width (random weights from a
   seed) through the port's ``Engine`` in two configurations, holds the
   tokens against ``generate()`` and the logits against the CPU's plain
   path (a limit that two faulty controls must exceed), checks that every
   serving kernel's launch counter moved and that configuration (a), whose
   MLP is stored in nibbles, unpacks none, and tallies one full tick's
   launches by shape (one ``kv_quantize_store`` a layer); only after every
   timed run is one full tick per configuration traced with
   ``torch.profiler``, whose trace also gives the blocks each
   ``kv_attention_rows`` launch ran (at least 128) and must hold no
   ``stack``, ``index_put`` or ``bitwise`` operation (the KV store is one
   kernel);
5. train phase: trains the paper's jet tagger at its full width with
   ``examples/quickstart.py``'s configuration through the port's
   ``Trainer.run`` (300 steps, batch 1024), calibrates it on a held-out
   batch and checks accuracy, ~EBOPs, layer-0 bits and the fixed-point
   proxy; tallies one step's ``hgq_quantize`` launches by shape (exactly
   one grouped forward of the 8 weights and biases, 4 single forwards,
   12 backward); runs 20
   steps on the card and on the CPU from one init (a limit that two faulty
   controls must exceed) and twice on the card (bit-identical); then
   traces one step with ``torch.profiler``, whose trace must hold five
   ``hgq_fwd_group`` kernels and one ``hgq_bwd`` kernel for each
   per-channel and per-tensor backward (a trace is read only whole, with
   a device kernel for every kernel launch of the step, which runs after
   512 marker kernels, and the step runs again, up to three times, until
   one is); then the paper's SVHN (Table II, batch 128, 120 steps) and
   muon (Table III, batch 1024, 500 steps) models at
   ``benchmarks/paper_tables.py``'s configurations through
   ``Trainer.run``: each calibrated on a held-out batch and its metric
   (accuracy, RMS resolution) and CALIB ~EBOPs held to the JAX package's
   CPU run of the same configuration within stated margins, ~EBOPs seen
   to fall (muon from step 0, SVHN from the peak its growing activation
   ranges first raise), one step's ``hgq_quantize`` launches tallied by
   shape as exact counts (6 single forwards, one grouped forward of the
   12 weights and biases, 18 backward), 20 card steps against 20 CPU
   steps (a limit that two faulty controls exceed: the conv in TF32 and
   the backward without ``ln2 * delta`` for SVHN, that backward and
   ``floor(f)`` rounding for muon), two card runs bit-identical, and one
   step of each traced last as the jet's is (one ``hgq_bwd`` kernel a
   reducing backward, two past the one-cluster line);
6. wire phase: (a) trains the same jet tagger data-parallel over
   ``dist.LocalMesh(4)`` (four ranks as threads on the one card: NCCL
   refuses two ranks on one GPU) with ``reduce="compressed"`` (1D, fused,
   ``mixed_low_plan(params, 4)``: a nibble bucket and an int8 bucket),
   300 steps at batch 1024, calibrates it and holds accuracy, ~EBOPs and
   layer-0 bits against the same code's uncompressed run from one init;
   runs 20 compressed steps on the card and on the CPU from one init (a
   limit that two faulty wires must exceed) and twice on the card
   (bit-identical), and traces one step as the train phase does, which
   must hold no ``aten::constant_pad_nd`` (the bucket kernels build the
   chunk layout; one launch of each a bucket a rank, none of the
   per-position kernels); (b)
   reduces qwen2-0.5b's full-width gradient tree
   (4 shards of seeded values) over the wire, uniform int8 and
   ``plan_mixed_w4w8``, and holds the fused path, the per-leaf path and
   ``simulate_wire_pmean`` equal bit for bit, the card equal to the CPU
   on two leaves, the recorded bytes equal to the byte model, reads the
   fused reduce's own peak memory (its timed calls alone) beside the
   phase's, and traces one mixed reduce (no ``aten::constant_pad_nd``;
   its events counted by name); then holds every ``wire_pack`` kernel
   shape those paths launched against its plain version and times it;
7. prints one JSON line with every kernel's numbers, its times per unit
   of its main path (a full decode tick, a training step -- the jet's,
   with an svhn step and a muon step beside it --, a compressed
   data-parallel step, a qwen2 gradient reduce) weighted by those
   tallies, the TPU kernels still to port, then, last, ``{"ok": true,
   "device": {...}}``.

Kernel groups: ``SERVING`` (``qmatmul``, ``kv_quantize_store``,
``kv_attention_rows``), ``TRAINING`` (``hgq_quantize`` forward, single
and grouped, and backward), ``WIRE`` (``wire_quantize_rows`` on the
per-leaf path, ``wire_quantize_bucket``, ``wire_pack_rows`` and
``wire_dequant_bucket`` on the fused path, ``wire_quantize_sflat`` and
``wire_dequant_rows``); ``kv_dequant_rows``, ``kv_quantize_rows``,
``wire_quantize_sflat`` and ``wire_dequant_rows`` are on no main path
(the entry points of the ops ``kv_dequant``, ``kv_quantize``,
``quantize_chunks`` and ``dequant_sum``; the serving store runs
``kv_quantize_rows``' body as ``kv_quantize_store``, the fused reduce the
per-position kernels' as the bucket kernels) and are held and timed in
the kernel phase only.

Any failure raises and exits non-zero before the last line.
``--phase kernels`` stops after step 3 (a short check of a changed
kernel) and leaves the per-unit fields null; ``--phase train`` runs steps
1-3 and 5; ``--phase wire`` steps 1-3 and 6.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20241016

# NVIDIA H100 SXM data sheet: device memory rate, the float32 rate
# outside the tensor cores, and the dense bf16 tensor-core rate (qmatmul)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_TC_PER_S = 989e12
L2_BYTES = 50 * 2 ** 20

# every pallas_call of the JAX package: (name, file:line of the function)
TPU_KERNELS = [
    ("hgq_quantize_2d", "src/repro/kernels/hgq_quantize/kernel.py:59"),
    ("qmatmul", "src/repro/kernels/qmatmul/kernel.py:40"),
    ("kv_quantize_rows", "src/repro/kernels/kv_dequant/kernel.py:104"),
    ("kv_dequant_rows", "src/repro/kernels/kv_dequant/kernel.py:132"),
    ("kv_attention_rows", "src/repro/kernels/kv_dequant/kernel.py:154"),
    ("wire_quantize_rows", "src/repro/kernels/wire_pack/kernel.py:88"),
    ("wire_quantize_sflat", "src/repro/kernels/wire_pack/kernel.py:117"),
    ("wire_pack_rows", "src/repro/kernels/wire_pack/kernel.py:141"),
    ("wire_dequant_rows", "src/repro/kernels/wire_pack/kernel.py:161"),
]
_CSRC = "src/repro_torch/kernels/csrc/"
# every kernel wrapper of the port: (source, the TPU kernel it replaces)
KERNELS = {
    "qmatmul": (_CSRC + "qmatmul.cu", "qmatmul"),
    "kv_quantize_rows": (_CSRC + "kv_dequant.cu", "kv_quantize_rows"),
    "kv_quantize_store": (_CSRC + "kv_dequant.cu", "kv_quantize_rows"),
    "kv_dequant_rows": (_CSRC + "kv_dequant.cu", "kv_dequant_rows"),
    "kv_attention_rows": (_CSRC + "kv_dequant.cu", "kv_attention_rows"),
    "hgq_quantize_fwd": (_CSRC + "hgq_quantize.cu", "hgq_quantize_2d"),
    "hgq_quantize_fwd_group": (_CSRC + "hgq_quantize.cu", "hgq_quantize_2d"),
    "hgq_quantize_bwd": (_CSRC + "hgq_quantize.cu", "hgq_quantize_2d"),
    "wire_quantize_rows": (_CSRC + "wire_pack.cu", "wire_quantize_rows"),
    "wire_quantize_sflat": (_CSRC + "wire_pack.cu", "wire_quantize_sflat"),
    "wire_pack_rows": (_CSRC + "wire_pack.cu", "wire_pack_rows"),
    "wire_dequant_rows": (_CSRC + "wire_pack.cu", "wire_dequant_rows"),
    "wire_quantize_bucket": (_CSRC + "wire_pack.cu", "wire_quantize_sflat"),
    "wire_dequant_bucket": (_CSRC + "wire_pack.cu", "wire_dequant_rows"),
}
SERVING = ("qmatmul", "kv_quantize_store", "kv_attention_rows")
TRAINING = ("hgq_quantize_fwd", "hgq_quantize_fwd_group", "hgq_quantize_bwd")
# the compressed gradient reduce: the fused path launches FUSED_WIRE, the
# per-leaf path and the simulator wire_quantize_rows; the per-position
# kernels (RETIRED_WIRE, for the 2D exchange) are on no main path and are
# held and timed in the kernel phase only
WIRE = ("wire_quantize_rows", "wire_quantize_sflat", "wire_pack_rows",
        "wire_dequant_rows", "wire_quantize_bucket", "wire_dequant_bucket")
FUSED_WIRE = ("wire_quantize_bucket", "wire_pack_rows", "wire_dequant_bucket")
RETIRED_WIRE = ("wire_quantize_sflat", "wire_dequant_rows")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def bound(nbytes: float, flops: float, peak: float = PEAK_FP32_PER_S):
    """(least ms on the card, what bounds it) for moving ``nbytes`` and
    doing ``flops`` operations of a type whose peak rate is ``peak``."""
    tb, to = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def n_copies(nbytes: int) -> int:
    """Distinct argument sets a timed loop cycles through, so that it
    streams twice the L2 cache from device memory, as a decode tick
    streams every layer's weights and cache once."""
    return max(1, min(1024, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


# calls timed behind one sleep kernel: a stream holds about a thousand
# pending launches, and a host that blocks on a full queue while the device
# sleeps would be timed again
TIME_BATCH = 64


def time_ms(fn, arg_sets, min_calls: int = 64) -> float:
    """Device milliseconds per call of ``fn`` over ``arg_sets``, from CUDA
    events: the median over batches of ``TIME_BATCH`` calls.  A sleep
    kernel queued first holds the device until every call of a batch is
    enqueued, so the events time the calls back to back and not the
    host's launch rate; the median leaves out a batch whose host, slower
    than the sleep allowed for, left the device waiting."""
    calls = max(min_calls, len(arg_sets))
    for args in arg_sets[:3]:
        fn(*args)                                   # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(min(calls, TIME_BATCH)):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    per_call = []
    for b0 in range(0, calls, TIME_BATCH):
        torch.cuda._sleep(int(min(host_s * 1.5 + 1e-3, 2.0) * 2e9))
        start.record()
        b1 = min(calls, b0 + TIME_BATCH)
        for i in range(b0, b1):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / (b1 - b0))
    return float(np.median(per_call))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def qmatmul_case(M, K, N, bits, dev, g):
    """Kernel vs plain vs ``torch.matmul(x, w.float()) * scale`` for one
    shape, the weight stored N-major as the serving packer stores it: int8
    (bits 8) or nibbles two to a byte along K (bits 4), read as they lie.
    At M = 16 also: rows 0-7 alone (M = 8) and row 3 alone (M = 1) give
    the same bits as inside the 16."""
    from repro_torch.kernels.qmatmul import (pack_nibbles, qmatmul,
                                             qmatmul_ref)
    nib = bits == 4
    qmax = 7 if nib else 127

    def make():
        x = torch.randn((M, K), generator=g, device=dev)
        m = torch.randint(-qmax, qmax + 1, (N, K), generator=g, device=dev,
                          dtype=torch.int8)
        f = torch.randint(4, 9, (N,), generator=g, device=dev)
        s = torch.pow(2.0, -f.to(torch.float32))
        w = pack_nibbles(m, axis=-1).T if nib else m.T    # N-major storage
        return x, w, s, m.T

    wbytes = K * N // 2 if nib else K * N
    sets = [make() for _ in range(n_copies(wbytes))]
    x, w, s, m = sets[0]
    y = qmatmul(x, w, s, nib=nib)
    check(torch.equal(y, qmatmul(x, w, s, nib=nib)),
          f"qmatmul {M}x{K}x{N} bits{bits}: two launches differ")
    ref = qmatmul_ref(x, w, s, nib=nib)
    check(torch.equal(ref, qmatmul_ref(x, m, s)),
          f"qmatmul_ref {M}x{K}x{N}: nibble storage != its mantissas")
    tol = 1e-5 * qmatmul_ref(x.abs(), m.abs(), s) + 1e-30
    err = (y - ref).abs()
    check(bool(torch.isfinite(y).all()), f"qmatmul {M}x{K}x{N}: not finite")
    check(bool((err <= tol).all()),
          f"qmatmul {M}x{K}x{N} bits{bits}: max err {float(err.max())} over "
          f"1e-5 * (|x| @ |w|) * scale")
    if M == 16:
        check(torch.equal(qmatmul(x[:8].contiguous(), w, s, nib=nib), y[:8])
              and torch.equal(qmatmul(x[3:4].contiguous(), w, s, nib=nib),
                              y[3:4]),
              f"qmatmul K{K} N{N} bits{bits}: rows differ at M = 1, 8, 16")
    precision = _qmatmul_precision(x, w, s, m, nib, g, f"qmatmul {M}x{K}x{N} "
                                   f"bits{bits}")
    nbytes = M * K * 4 + wbytes + N * 4 + M * N * 4
    # three bf16 terms of x through the tensor cores
    flops = 3 * 2.0 * M * K * N
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_TC_PER_S)

    def kern(x, w, s, m):
        return qmatmul(x, w, s, nib=nib)

    def plain(x, w, s, m):
        return qmatmul_ref(x, w, s, nib=nib)

    def library(x, w, s, m):
        return torch.matmul(x, m.float()) * s

    return {"shape": f"M{M} K{K} N{N} {'nibble' if nib else 'int8'}",
            "max_abs_err": float(err.max()), **precision,
            "ms": time_ms(kern, sets),
            "plain_ms": time_ms(plain, sets, 16),
            "library_ms": time_ms(library, sets, 16),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, "peak": PEAK_BF16_TC_PER_S}


# The kernel splits x into three bf16 terms, so that every product is
# exact.  Two controls tell that split from one that drops the lowest term
# (x rounded to hi + mid before the launch): on a weight with one nonzero
# mantissa a channel, where y must be the one rounding of x * m * scale,
# the share of outputs off it (the kernel at most EXACT_OFF_LIMIT at every
# shape, the two-term control above it); and the largest error against the
# float64 product over (|x| @ |w|) * scale (the kernel at most
# REL_ERR_LIMIT at every shape, the two-term control above it at one shape
# at least).  Readings in PERF.md.
EXACT_OFF_LIMIT = 0.01
REL_ERR_LIMIT = 3e-7


def _qmatmul_precision(x, w, s, m, nib, g, what):
    from repro_torch.kernels.qmatmul import (bf16_split3, pack_nibbles,
                                             qmatmul)
    hi, mid, _ = bf16_split3(x)
    x2 = hi.float() + mid.float()                   # exact: 16 bits
    y64 = x.double() @ m.double() * s.double()
    den = x.abs().double() @ m.abs().double() * s.double() + 1e-300

    def rel(y):
        return float(((y.double() - y64).abs() / den).max())

    rel1, rel2 = rel(qmatmul(x, w, s, nib=nib)), rel(qmatmul(x2, w, s,
                                                             nib=nib))
    # one nonzero mantissa a channel, at a random k
    K, N = m.shape
    qmax = 7 if nib else 127
    k = torch.randint(0, K, (N,), generator=g, device=x.device)
    v = torch.randint(1, qmax + 1, (N,), generator=g, device=x.device) * \
        (2 * torch.randint(0, 2, (N,), generator=g, device=x.device) - 1)
    ms = torch.zeros((N, K), dtype=torch.int8, device=x.device)
    ms[torch.arange(N, device=x.device), k] = v.to(torch.int8)
    ws = pack_nibbles(ms, axis=-1).T if nib else ms.T
    want = x[:, k] * (v.float() * s)                # one rounding
    off1 = float((qmatmul(x, ws, s, nib=nib) != want).float().mean())
    off2 = float((qmatmul(x2, ws, s, nib=nib) != want).float().mean())
    check(off1 <= EXACT_OFF_LIMIT < off2,
          f"{what}: exact-product control: kernel {off1:.4f} of outputs off "
          f"the one rounding of x * m * scale, two-term split {off2:.4f} "
          f"(limit {EXACT_OFF_LIMIT})")
    return {"rel_err": rel1, "rel_err_two_term": rel2,
            "exact_off": off1, "exact_off_two_term": off2}


def _dequant_lib():
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load("kv_dequant")
    ci, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.kv_dequant_grid.argtypes = [ci, ci, pi, pi, pi]
    lib.kv_dequant_grid.restype = None
    lib.kv_empty_launch.argtypes = [ci, ci, ctypes.c_void_p]
    lib.kv_empty_launch.restype = ci
    return lib


def dequant_grid(R, hd):
    """(blocks, threads, 16-byte pieces a lane) ``kv_dequant_rows``
    launches for [R, hd] on its 16-byte path."""
    import ctypes
    out = [ctypes.c_int() for _ in range(3)]
    _dequant_lib().kv_dequant_grid(R, hd, *(ctypes.byref(c) for c in out))
    return tuple(c.value for c in out)


# kv_dequant_rows is timed over more batches than the default: its calls are
# a few microseconds, and the median of four batches steadies the reading
DEQUANT_CALLS = 256


def launch_floor_ms(R, hd, dev):
    """The empty kernel of ``csrc/kv_dequant.cu`` on the grid
    ``kv_dequant_rows`` launches for [R, hd] (16-byte path), timed as
    ``time_ms`` times a kernel: the launch floor beside its time."""
    from repro_torch.kernels import _build
    lib = _dequant_lib()
    blocks, threads, _ = dequant_grid(R, hd)
    stream = _build.stream_ptr(dev)

    def empty():
        _build.check(lib.kv_empty_launch(blocks, threads, stream),
                     "empty kernel")

    return time_ms(empty, [()], DEQUANT_CALLS)


def kv_dequant_case(R, hd, dev, g):
    """Kernel vs plain, bit-exact, two launches identical, vs
    ``torch.ldexp(q, -f)`` (the negated exponents made outside the timed
    call) as yardstick, beside the empty kernel on its grid."""
    from repro_torch.kernels.kv_dequant import kv_dequant_rows
    from repro_torch.kernels.kv_dequant.ref import kv_dequant_ref

    def make():
        q = torch.randint(-128, 128, (R, hd), generator=g, device=dev,
                          dtype=torch.int8)
        f = torch.randint(-3, 12, (R,), generator=g, device=dev,
                          dtype=torch.int8)
        return q, f

    sets = [make() for _ in range(n_copies(5 * R * hd))]
    q, f = sets[0]
    out = kv_dequant_rows(q, f)
    ref = kv_dequant_ref(q, f)
    check(torch.equal(out, ref) and torch.equal(kv_dequant_rows(q, f), out),
          f"kv_dequant_rows R{R} hd{hd}: not bit-exact or not repeatable")
    lib_sets = [(q, (-f)[:, None]) for q, f in sets]
    nbytes = 5 * R * hd + R
    b_ms, b_by = bound(nbytes, 0.0)
    blocks, threads, vecs = dequant_grid(R, hd)
    return {"shape": f"R{R} hd{hd}", "max_abs_err": 0.0,
            "ms": time_ms(kv_dequant_rows, sets, DEQUANT_CALLS),
            "launch_floor_ms": launch_floor_ms(R, hd, dev),
            "grid": {"blocks": blocks, "threads": threads,
                     "pieces_a_lane": vecs},
            "plain_ms": time_ms(kv_dequant_ref, sets, 16),
            "library_ms": time_ms(torch.ldexp, lib_sets, 16),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": 0.0}


# kv_dequant_rows' edges: (R, hd, byte offset of q into its buffer, f over
# the whole int8 range with -128 mantissas): any hd (one value at a time off
# multiples of 16), rows off a 16-byte boundary, R ragged against a thread's
# pieces and a block, products that overflow to -inf (the card-only tests of
# tests/test_torch_package.py hold the same)
DEQUANT_EDGES = ((393217, 64, 0, False), (1, 64, 0, False), (3, 16, 0, False),
                 (1001, 48, 0, False), (257, 80, 0, False),
                 (33, 256, 0, False), (7, 17, 0, False), (999, 64, 1, False),
                 (64, 64, 15, False), (256, 64, 0, True), (129, 16, 0, True))


def _dequant_edge_checks(dev, g):
    from repro_torch.kernels.kv_dequant import kv_dequant_rows
    from repro_torch.kernels.kv_dequant.ref import kv_dequant_ref
    for R, hd, off, extreme in DEQUANT_EDGES:
        buf = torch.randint(-128, 128, (R * hd + off,), generator=g,
                            device=dev, dtype=torch.int8)
        q = buf[off:].view(R, hd)
        if extreme:
            f = (torch.arange(R, device=dev) % 256 - 128).to(torch.int8)
            q[::2] = -128
        else:
            f = torch.randint(-3, 12, (R,), generator=g, device=dev,
                              dtype=torch.int8)
        out = kv_dequant_rows(q, f)
        check(_same_bits(out, kv_dequant_ref(q, f))
              and _same_bits(out, kv_dequant_rows(q, f)),
              f"kv_dequant_rows R{R} hd{hd} offset {off} extreme {extreme}: "
              f"not bit-exact or not repeatable")


def kv_quantize_case(R, hd, bits, dev, g):
    """Kernel vs plain, bit-exact, on rows that include zero rows and
    products that land exactly on .5 (they pin half-to-even)."""
    from repro_torch.kernels.kv_dequant import kv_quantize_rows
    from repro_torch.kernels.kv_dequant.ref import kv_quantize_ref

    def make():
        x = torch.randn((R, hd), generator=g, device=dev) * 3.0
        x[0] = 0.0
        # row 1: amax 127/64 (f = 6 at 8 bits), entries k/128 give x*2^f
        # exactly on k/2
        x[1] = torch.arange(hd, device=dev, dtype=torch.float32) / 128.0
        x[1, 0] = 127.0 / 64.0
        return (x, bits)

    sets = [make() for _ in range(n_copies(R * hd * 4))]
    x = sets[0][0]
    q, f = kv_quantize_rows(x, bits)
    qr, fr = kv_quantize_ref(x, bits)
    check(torch.equal(q, qr) and torch.equal(f, fr),
          f"kv_quantize_rows R{R} bits{bits}: not bit-exact")
    nbytes = R * hd * 4 + R * hd + R
    b_ms, b_by = bound(nbytes, 0.0)
    return {"shape": f"R{R} hd{hd} bits{bits}", "max_abs_err": 0.0,
            "ms": time_ms(kv_quantize_rows, sets),
            "plain_ms": time_ms(kv_quantize_ref, sets, 16),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": 0.0}


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def kv_store_case(key, window, dev, g, off=0, xoff=0, timed=True):
    """The fused store ``kv_quantize_store`` against its plain version on
    one ring, keyed as the wrapper keys its tallies (B, S, KV, hd, W, hdm,
    bits, dtype): the four ring buffers bit for bit (the slots the chunk
    does not reach keep their bytes), two launches the same.  The k/v rows
    lie ``xoff`` elements and the ring views ``off`` bytes into their
    buffers; a windowed ring keeps a chunk's newest W rows and drops the
    rest (slot W), an unwindowed one takes the positions."""
    from repro_torch.kernels.kv_dequant import kv_quantize_store
    from repro_torch.kernels.kv_dequant.ref import kv_quantize_store_ref
    B, S, KV, hd, W, hdm, bits, dt = key
    dtype = _DTYPES[dt]
    n = B * S * KV * hd

    def make():
        rows = (torch.randn(2 * n + 4, generator=g, device=dev) * 3
                ).to(dtype)
        kh = rows[xoff:xoff + n].view(B, S, KV, hd)
        vh = rows[n + xoff:2 * n + xoff].view(B, S, KV, hd)
        cp = torch.randint(0, 3 * W if window else W - S + 1, (B,),
                           generator=g, device=dev)
        qpos = cp[:, None] + torch.arange(S, device=dev)
        if window:
            last = cp + S - 1
            slot = torch.where(qpos > last[:, None] - W, qpos % W,
                               torch.full_like(qpos, W))
        else:
            slot = qpos

        def ring(shape):
            m = math.prod(shape)
            buf = torch.randint(-128, 128, (m + 16,), generator=g,
                                device=dev, dtype=torch.int8)
            return buf[off:off + m].view(shape)

        return (kh, vh, slot, ring((B, W, KV, hdm)), ring((B, W, KV, hdm)),
                ring((B, W, KV)), ring((B, W, KV)), bits)

    item = torch.finfo(dtype).bits // 8
    nbytes = 2 * n * item + 2 * B * W * KV * (hdm + 1)
    sets = [make() for _ in range(n_copies(nbytes) if timed else 1)]
    args = sets[0]
    want = [b.clone() for b in args[3:7]]
    kv_quantize_store_ref(*args[:3], *want, bits)
    kv_quantize_store(*args)
    shape = (f"B{B} S{S} KV{KV} hd{hd} W{W} {'nibble' if hdm != hd else 'int8'}"
             f" bits{bits} {dt}{' windowed' if window else ''}"
             f"{f' rows+{xoff}' if xoff else ''}{f' ring+{off}B' if off else ''}")
    check(all(torch.equal(a, b) for a, b in zip(args[3:7], want)),
          f"kv_quantize_store {shape}: not bit-exact against the plain "
          f"version")
    kv_quantize_store(*args)
    check(all(torch.equal(a, b) for a, b in zip(args[3:7], want)),
          f"kv_quantize_store {shape}: not repeatable")
    kept = int((args[2] < W).sum())
    dropped = B * S - kept
    # rows read once, the slots read, the kept rows' mantissas and exponents
    # written
    nbytes = 2 * n * item + B * S * 8 + 2 * kept * KV * (hdm + 1)
    b_ms, b_by = bound(nbytes, 0.0)
    case = {"shape": shape, "max_abs_err": 0.0, "dropped_rows": dropped,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": 0.0}
    if timed:
        case["ms"] = time_ms(kv_quantize_store, sets)
        case["plain_ms"] = time_ms(kv_quantize_store_ref, sets, 16)
    return case


# the fused store at serving's shapes (a decode tick of 8 slots and a
# prefill chunk of 16, qwen2-0.5b's 2 kv heads of 64, the 1024-slot ring;
# int8 and nibble rings), timed; then checks only: a windowed ring, a
# chunk longer than its ring (rows dropped), bfloat16 rows, and views 1-15
# bytes into their buffers
STORE_TIMED = [(8, 1, 2, 64, 1024, 64, 8, "float32"),
               (8, 1, 2, 64, 1024, 32, 4, "float32"),
               (1, 16, 2, 64, 1024, 64, 8, "float32"),
               (1, 16, 2, 64, 1024, 32, 4, "float32")]
STORE_CHECKS = ([((4, 1, 2, 64, 64, 64, 8, "float32"), True, 0, 0),
                 ((2, 16, 2, 64, 8, 64, 8, "float32"), True, 0, 0),
                 ((2, 16, 2, 64, 8, 32, 4, "float32"), True, 0, 0),
                 ((8, 1, 2, 64, 1024, 64, 8, "bfloat16"), False, 0, 0),
                 ((2, 16, 2, 64, 64, 32, 4, "bfloat16"), True, 0, 0)]
                + [((2, 3, 2, 64, 32, 32 if off % 2 else 64,
                     4 if off % 2 else 8, "float32"), True, off, off % 4)
                   for off in range(1, 16)])


def kv_store_checks(dev, g):
    for key, window, off, xoff in STORE_CHECKS:
        c = kv_store_case(key, window, dev, g, off=off, xoff=xoff,
                          timed=False)
        print(f"[kernels] kv_quantize_store {c['shape']}: bit-exact "
              f"({c['dropped_rows']} rows dropped)", flush=True)


def _attention_inputs(B, S, H, KV, hd, W, nibble, dev, g, ragged=False):
    from repro_torch.kernels.kv_dequant import kv_pack
    qmax = 7 if nibble else 127
    qh = torch.randn((B, S, H, hd), generator=g, device=dev)
    km = torch.randint(-qmax, qmax + 1, (B, W, KV, hd), generator=g,
                       device=dev, dtype=torch.int8)
    vm = torch.randint(-qmax, qmax + 1, (B, W, KV, hd), generator=g,
                       device=dev, dtype=torch.int8)
    lo = 0 if nibble else 4
    kf = torch.randint(lo, lo + 4, (B, W, KV), generator=g, device=dev,
                       dtype=torch.int8)
    vf = torch.randint(lo, lo + 4, (B, W, KV), generator=g, device=dev,
                       dtype=torch.int8)
    if nibble:
        km, vm = kv_pack(km), kv_pack(vm)
    if ragged:
        # per-row fill levels, some slots never written
        last = torch.randint(S, W, (B,), generator=g, device=dev)
        qpos = last[:, None] - S + 1 + torch.arange(S, device=dev)
        tpos = torch.arange(W, device=dev).expand(B, W).clone()
        tpos[tpos > last[:, None]] = -1
    else:
        # a full ring: every slot visible to every query row
        qpos = (W - S + torch.arange(S, device=dev)).expand(B, S)
        tpos = torch.arange(W, device=dev).expand(B, W)
    return (qh, km, kf, vm, vf, qpos.to(torch.int32).contiguous(),
            tpos.to(torch.int32))


def _attention_check(out, ref, vmax, pf, what):
    """No probs grid: within 1e-5.  With one: at most 1% of outputs may
    differ by more, each by at most one probs step times
    (max|v| + |o|) -- a one-ulp exp can move one probability across a
    grid point, which moves the output by step * (v - o) / l, l >= 1."""
    err = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), f"{what}: not finite")
    if pf is None:
        check(bool((err <= 1e-5).all()),
              f"{what}: max err {float(err.max())} > 1e-5")
        return float(err.max())
    step = 2.0 ** -math.floor(pf + 0.5)
    off = err > 1e-5
    frac = float(off.float().mean())
    check(frac <= 0.01, f"{what}: {frac:.4f} of outputs off by more than 1e-5")
    lim = step * (vmax + ref.abs()) + 1e-5
    check(bool((err <= lim).all()),
          f"{what}: max err {float(err.max())} beyond one probs step")
    return float(err.max())


def kv_attention_case(B, S, W, nibble, pf, dev, g, H=14, KV=2, hd=64,
                      yardsticks=True):
    """Kernel vs plain (and a ragged, windowed, partly empty ring for
    correctness only) vs SDPA over the dequantized cache as yardstick.
    Without ``yardsticks`` only the kernel is timed."""
    from repro_torch.kernels.kv_dequant import kv_attention_rows, kv_unpack
    from repro_torch.kernels.kv_dequant.ref import (attention_mask,
                                                    kv_attention_ref,
                                                    kv_dequant_ref)
    pft = torch.tensor([pf], dtype=torch.float32, device=dev)
    hdm = hd // 2 if nibble else hd
    what = (f"kv_attention_rows B{B} S{S} W{W} hd{hd} "
            f"{'nibble' if nibble else 'int8'}")

    def kern(qh, km, kf, vm, vf, qpos, tpos, window=None):
        return kv_attention_rows(qh, km, kf, vm, vf, qpos, tpos,
                                 window=window, n_kv=KV, probs_f=pft)

    def plain(qh, km, kf, vm, vf, qpos, tpos, window=None):
        qg = qh.reshape(B, S, KV, H // KV, hd)
        return kv_attention_ref(qg, km, kf, vm, vf, qpos, tpos,
                                window=window, probs_f=pft).reshape(qh.shape)

    def vmax_of(vm, vf):
        v = kv_dequant_ref(kv_unpack(vm, hd) if nibble else vm, vf)
        return float(v.abs().max())

    for window in (None, 8):
        args = _attention_inputs(B, S, H, KV, hd, W, nibble, dev, g,
                                 ragged=True)
        _attention_check(kern(*args, window=window),
                         plain(*args, window=window),
                         vmax_of(args[3], args[4]), pf,
                         f"{what} ragged window={window}")
    cache_bytes = 2 * B * W * KV * hdm + 2 * B * W * KV
    sets = [_attention_inputs(B, S, H, KV, hd, W, nibble, dev, g)
            for _ in range(n_copies(cache_bytes))]
    args = sets[0]
    out = kern(*args)
    err = _attention_check(out, plain(*args), vmax_of(args[3], args[4]), pf,
                           what)
    check(torch.equal(kern(*args), out), f"{what}: two launches differ")
    # a request's rows have the same bits alone as in the batch
    for b in sorted({0, B - 1}):
        one = [a[b:b + 1] for a in args]
        one[0], one[5] = one[0].contiguous(), one[5].contiguous()
        check(torch.equal(kern(*one), out[b:b + 1]),
              f"{what}: batch row {b} differs alone")
    shape = (f"B{B} S{S} H{H} KV{KV} hd{hd} W{W} "
             f"{'nibble' if nibble else 'int8'} probs_f{pf}")
    if not yardsticks:
        return {"shape": shape, "max_abs_err": err, "ms": time_ms(kern, sets)}

    # yardstick: SDPA over the dequantized cache (dequantized outside the
    # timed call), heads grouped as the port groups them
    def sdpa_args(qh, km, kf, vm, vf, qpos, tpos):
        G = H // KV
        k = kv_dequant_ref(kv_unpack(km, hd) if nibble else km, kf)
        v = kv_dequant_ref(kv_unpack(vm, hd) if nibble else vm, vf)
        k = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
        v = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
        mask = attention_mask(qpos, tpos, None)[:, None]
        return (qh.permute(0, 2, 1, 3).contiguous(), k, v, mask)

    lib_sets = [sdpa_args(*a) for a in sets[:max(1, len(sets) // 4)]]
    nbytes = (2 * B * S * H * hd * 4 + cache_bytes + B * S * 4 + B * W * 4)
    flops = 4.0 * B * S * H * W * hd
    b_ms, b_by = bound(nbytes, flops)
    return {"shape": shape, "max_abs_err": err,
            "ms": time_ms(kern, sets),
            "plain_ms": time_ms(plain, sets, 16),
            "library_ms": time_ms(
                lambda q, k, v, m: torch.nn.functional
                .scaled_dot_product_attention(q, k, v, attn_mask=m),
                lib_sets, 16),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}


# Rings longer than the serving slice's 1024 slots, held to the plain
# version in the kernel phase (not on the main path, not in the kernels
# line): (B, S, W, hd).  B = 8, S = 1 runs RT = 8 query rows a block, B =
# 2, S = 16 RT = 16; W = 1500 leaves the last block of a cluster ragged;
# W = 2048 gives a block two staging rounds; W = 16384 at RT = 16 and W =
# 32768 at RT = 8 (qwen2-0.5b's published context) do not fit a block's
# scores in shared memory, so pass 2 recomputes them; hd = 40 stages rows
# without 16-byte loads.
LONG_RINGS = ((8, 1, 1500, 64), (2, 16, 1500, 64), (8, 1, 2048, 64),
              (2, 16, 2048, 64), (8, 1, 16384, 64), (2, 16, 16384, 64),
              (8, 1, 32768, 64), (8, 1, 1500, 40), (2, 16, 1500, 40))


def long_ring_checks(dev, g):
    for B, S, W, hd in LONG_RINGS:
        for nibble in (False, True):
            c = kv_attention_case(B, S, W, nibble, 6.0, dev, g, hd=hd,
                                  yardsticks=False)
            print(f"[kernels] kv_attention_rows {c['shape']}: max err "
                  f"{c['max_abs_err']:.3g}, {c['ms']:.4f} ms", flush=True)


# the quantizer's shapes: the training slice's own (the jet tagger's input
# quantizer per channel, weights and biases per parameter, outputs per
# tensor, batch 1024), a qwen2-0.5b layer (the MLP weight per channel, a
# prefill's activations per tensor) in float32 and bfloat16, and the MLP
# weight per parameter
HGQ_SHAPES = (
    [((1024, 16), (16,), torch.float32)]
    + [(s, s, torch.float32) for s in ((16, 64), (64, 32), (32, 32), (32, 5),
                                       (64,), (32,), (5,))]
    + [((1024, 64), (), torch.float32), ((1024, 32), (), torch.float32)]
    + [(s, f, dt) for dt in (torch.float32, torch.bfloat16)
       for s, f in (((896, 4864), (1, 4864)), ((8192, 896), ()))]
    + [((896, 4864), (896, 4864), torch.float32)])
# edge shapes of the backward's cluster geometry (csrc/hgq_quantize.cu,
# ``hgq_quantize.ops.bwd_plan``): rows not a multiple of a block's rows, a
# single row, columns not a multiple of 32 (and of a 16-byte vector: values
# loaded one by one), bfloat16 at the training shapes, and one shape of each
# reduction just past the one-cluster line (a second pass)
HGQ_EDGE = (
    [((1001, 16), (16,), torch.float32), ((1, 16), (16,), torch.float32),
     ((1, 64), (), torch.float32), ((1024, 33), (33,), torch.float32),
     ((1001, 33), (), torch.float32), ((300, 5), (5,), torch.bfloat16),
     ((1024, 16), (16,), torch.bfloat16), ((1024, 64), (), torch.bfloat16),
     ((2049, 16), (16,), torch.float32), ((256, 257), (), torch.float32)])


# the paper's SVHN (Table II, batch 128) and muon (Table III, batch 1024)
# models: their weights and biases per parameter (the members of each model's
# grouped forward, in order; conv kernels 4-D, HWIO) and their activations per
# tensor (the SVHN input and first conv output, 1.84 M values, take the
# backward's clusters, scratch and second pass)
SVHN_GROUP = [(s, s, torch.float32) for s in
              ((3, 3, 3, 16), (16,), (3, 3, 16, 16), (16,), (3, 3, 16, 24),
               (24,), (96, 42), (42,), (42, 64), (64,), (64, 10), (10,))]
MUON_GROUP = [(s, s, torch.float32) for s in
              ((150, 32), (32,), (150, 32), (32,), (150, 32), (32,),
               (96, 64), (64,), (64, 32), (32,), (32, 1), (1,))]
PAPER_ACTS = {"svhn": [(128, 32, 32, 3), (128, 30, 30, 16), (128, 13, 13, 16),
                       (128, 4, 4, 24), (128, 42), (128, 64)],
              "muon": [(1024, 3, 150), (1024, 32), (1024, 32), (1024, 32),
                       (1024, 64), (1024, 32)]}
PAPER_SHAPES = [m for m in dict.fromkeys(
    [(s, (), torch.float32) for acts in PAPER_ACTS.values() for s in acts]
    + SVHN_GROUP + MUON_GROUP) if m not in HGQ_SHAPES]


def _bits_of(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def hgq_quantize_case(shape, fshape, dtype, dev, g):
    """Forward and backward kernels vs their plain versions on one shape:
    the forward bit for bit; df bit for bit per parameter, and for the
    per-channel and per-tensor sums within 1e-5 of the sum of |terms| (a
    float32 sum taken in another order); two launches give the same bits.
    Some x sit exactly on rounding ties (k + 1/2) * 2^-fi."""
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_bwd,
                                                  hgq_quantize_fwd,
                                                  hgq_quantize_grad_ref,
                                                  hgq_quantize_ref, layout_of)
    from repro_torch.kernels.hgq_quantize.ref import LN2
    lay = layout_of(shape, fshape)
    n = math.prod(shape)
    fn = math.prod(fshape)
    item = torch.finfo(dtype).bits // 8
    what = f"hgq_quantize {lay} {tuple(shape)} {str(dtype)[6:]}"

    def make():
        x = torch.randn(shape, generator=g, device=dev) * 4
        f = torch.rand(fshape, generator=g, device=dev) * 8 - 1
        fi = torch.floor(torch.broadcast_to(f, shape) + 0.5).reshape(-1)
        ties = min(n, 256)
        k = torch.arange(ties, device=dev, dtype=torch.float32) - ties // 2
        x.view(-1)[:ties] = (k + 0.5) * torch.pow(2.0, -fi[:ties])
        gy = torch.randn(shape, generator=g, device=dev)
        return x.to(dtype), f, gy.to(dtype)

    fwd_bytes = 2 * n * item + fn * 4
    bwd_bytes = 2 * n * item + 2 * fn * 4
    sets = [make() for _ in range(n_copies(bwd_bytes))]
    x, f, gy = sets[0]
    out = hgq_quantize_fwd(x, f)
    ref = hgq_quantize_ref(x, f)
    check(torch.equal(_bits_of(out), _bits_of(ref)),
          f"{what}: forward not bit-exact")
    check(torch.equal(_bits_of(out), _bits_of(hgq_quantize_fwd(x, f))),
          f"{what}: forward not repeatable")
    df = hgq_quantize_bwd(gy, x, f)
    dref = hgq_quantize_grad_ref(gy, x, f)
    check(torch.equal(_bits_of(df), _bits_of(hgq_quantize_bwd(gy, x, f))),
          f"{what}: backward not repeatable")
    err = float((df - dref).abs().max())
    if lay == "per_parameter":
        check(torch.equal(_bits_of(df), _bits_of(dref)),
              f"{what}: df not bit-exact")
    else:
        terms = (gy.float() * LN2 * (x.float() - ref.float())).abs()
        lim = 1e-5 * terms.sum_to_size(fshape)
        check(bool(((df - dref).abs() <= lim).all()),
              f"{what}: df off by {err} beyond 1e-5 * sum |terms|")
    base = {"shape": f"{lay} {tuple(shape)} {str(dtype)[6:]}",
            "library_ms": None}
    key = (lay, tuple(shape), str(dtype)[6:])
    fb_ms, fb_by = bound(fwd_bytes, 5.0 * n)
    bb_ms, bb_by = bound(bwd_bytes, 9.0 * n)
    fwd = dict(base, max_abs_err=0.0,
               ms=time_ms(hgq_quantize_fwd, [a[:2] for a in sets]),
               plain_ms=time_ms(hgq_quantize_ref, [a[:2] for a in sets], 16),
               bound_ms=fb_ms, bound_by=fb_by, bytes=fwd_bytes,
               flops=5.0 * n)
    bsets = [(gg, xx, ff) for xx, ff, gg in sets]
    bwd = dict(base, max_abs_err=err,
               ms=time_ms(hgq_quantize_bwd, bsets),
               plain_ms=time_ms(hgq_quantize_grad_ref, bsets, 16),
               bound_ms=bb_ms, bound_by=bb_by, bytes=bwd_bytes,
               flops=9.0 * n)
    return key, fwd, bwd


# the jet tagger's weights and biases, per parameter, float32: the members
# of a training step's one grouped forward launch, in the model's order
JET_GROUP = [(s, s, torch.float32) for s in
             ((16, 64), (64,), (64, 32), (32,), (32, 32), (32,), (32, 5),
              (5,))]
# a grouped forward of mixed members, checked at aligned and unaligned views:
# every layout, float32 and bfloat16, rows that are not whole vectors, and
# two qwen2-0.5b layer shapes
GROUP_MIXED = [((16, 64), (16, 64), torch.float32),
               ((1024, 16), (16,), torch.float32),
               ((300, 5), (5,), torch.bfloat16),
               ((1001, 33), (), torch.float32),
               ((37,), (37,), torch.bfloat16),
               ((1024, 40), (1, 40), torch.bfloat16),
               ((896, 4864), (1, 4864), torch.float32),
               ((8192, 896), (), torch.bfloat16)]


def _hgq_members(members, dev, g, offset=0):
    """(xs, fs) of a group, each a view ``offset`` elements into a buffer
    of its own."""
    xs, fs = [], []
    for shape, fshape, dtype in members:
        n, nf = math.prod(shape), math.prod(fshape)
        xb = (torch.randn(n + offset, generator=g, device=dev) * 4
              ).to(dtype)
        fb = torch.rand(nf + offset, generator=g, device=dev) * 8 - 1
        xs.append(xb[offset:].view(shape))
        fs.append(fb[offset:].view(fshape))
    return xs, fs


def hgq_group_case(members, dev, g):
    """The grouped forward against per-member launches and the plain group,
    bit for bit, twice the same; timed beside the per-member launches
    (``per_member_launches_ms``).  Keyed as the wrapper keys its tallies."""
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_fwd,
                                                  hgq_quantize_fwd_group,
                                                  hgq_quantize_group_ref,
                                                  layout_of)
    key = tuple((layout_of(s, fs), tuple(s), str(dt)[6:])
                for s, fs, dt in members)
    nbytes = sum(2 * math.prod(s) * (torch.finfo(dt).bits // 8)
                 + 4 * math.prod(fs) for s, fs, dt in members)
    n = sum(math.prod(s) for s, _, _ in members)
    sets = [_hgq_members(members, dev, g) for _ in range(n_copies(nbytes))]
    xs, fs = sets[0]
    outs = hgq_quantize_fwd_group(xs, fs)
    same = lambda a, b: all(torch.equal(_bits_of(u), _bits_of(v))
                            for u, v in zip(a, b))
    check(same(outs, hgq_quantize_group_ref(xs, fs)),
          f"hgq_quantize_fwd_group {key}: not bit-exact against the plain "
          f"group")
    check(same(outs, [hgq_quantize_fwd(x, f) for x, f in zip(xs, fs)]),
          f"hgq_quantize_fwd_group {key}: not the per-member launches' bits")
    check(same(outs, hgq_quantize_fwd_group(xs, fs)),
          f"hgq_quantize_fwd_group {key}: not repeatable")

    def singles(xs, fs):
        return [hgq_quantize_fwd(x, f) for x, f in zip(xs, fs)]

    b_ms, b_by = bound(nbytes, 5.0 * n)
    return key, {"shape": f"{len(members)} members: " + ", ".join(
        f"{lay} {s} {dt}" for lay, s, dt in key),
        "max_abs_err": 0.0, "ms": time_ms(hgq_quantize_fwd_group, sets),
        "plain_ms": time_ms(hgq_quantize_group_ref, sets, 16),
        "per_member_launches_ms": time_ms(singles, sets, 16),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": 5.0 * n}


def _hgq_group_checks(dev):
    """A group of mixed members, at aligned views and one element past a
    16-byte boundary (values one by one): every member the bits of its own
    launch and of the plain version."""
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_fwd,
                                                  hgq_quantize_fwd_group,
                                                  hgq_quantize_ref)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    for offset in (0, 1):
        xs, fs = _hgq_members(GROUP_MIXED, dev, g, offset)
        for x, f, out in zip(xs, fs, hgq_quantize_fwd_group(xs, fs)):
            check(torch.equal(_bits_of(out), _bits_of(hgq_quantize_ref(x, f)))
                  and torch.equal(_bits_of(out),
                                  _bits_of(hgq_quantize_fwd(x, f))),
                  f"hgq_quantize_fwd_group {tuple(x.shape)} f "
                  f"{tuple(f.shape)} {x.dtype} at offset {offset}: not the "
                  f"bits of its own launch and of the plain version")


def _wbits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _bucket_members(members, bits, dev, g, offset=0):
    """(leaves, steps) of a bucket's members ((shape, L, dtype), ...): seeded
    normal values, a scale a member and per grid row (1e-3 .. 10), each leaf
    a view ``offset`` elements into a buffer of its own; the steps are
    ``grid_scale`` of each row's amax at ``bits``, as the reduce makes them."""
    from repro_torch.kernels import wire_pack as wp
    leaves, steps = [], []
    for k, (shape, L, dt) in enumerate(members):
        T = math.prod(shape)
        buf = torch.randn((T + offset,), generator=g, device=dev)
        rows = buf[offset:].view(L, -1)
        rows *= 10.0 ** (-3 + k % 4)
        rows *= torch.logspace(-1, 1, L, device=dev)[:, None]
        buf = buf.to(_DTYPES[dt])
        leaves.append(buf[offset:].view(shape))
        amax = buf[offset:].view(L, -1).float().abs().amax(dim=1) \
            if T else torch.zeros((L,), device=dev)
        steps.append(wp.grid_scale(amax, bits))
    return leaves, steps


def _bucket_cols(members, n, nibble):
    """Per member T, and the bucket's width W (``wire_pack.bucket_layout``
    from the shapes alone)."""
    Ts = [math.prod(shape) for shape, _, _ in members]
    Cs = [-(-T // n) for T in Ts]
    return Ts, sum(C + (C & 1) if nibble else C for C in Cs)


def _bucket_text(n, what, nibble, members):
    return (f"n{n} {what}{' nibble' if nibble else ''} {len(members)} "
            f"members: " + ", ".join(f"{tuple(s)}/{L}/{dt}"
                                     for s, L, dt in members))


def _wire_spec(name, key, dev, g):
    """(make, kernel, plain, bytes, float32 operations, shape text) of one
    wire kernel at one tally key (the wrappers' keys)."""
    from repro_torch.kernels import wire_pack as wp
    if name == "wire_quantize_rows":
        L, P, bits = key
        qmax = 2 ** (bits - 1) - 1

        def make():
            # rows of different scales, a zero row, and the last row on
            # rounding ties (k + 1/2) * 2^-3 (its grid is 2^-3 from 3 bits)
            rows = torch.randn((L, P), generator=g, device=dev)
            rows *= torch.logspace(-4, 1, L, device=dev)[:, None]
            if L > 1:
                rows[0] = 0.0
            k = torch.arange(P, device=dev) % (2 * qmax) - qmax
            rows[-1] = (k + 0.5) * 0.125
            return rows, rows.abs().amax(dim=1), bits

        return (make, wp.wire_quantize_rows, wp.quantize_leaf_ref,
                L * P * 9 + L * 8, 6.0 * L * P, f"L{L} P{P} bits{bits}")
    if name == "wire_quantize_sflat":
        (R, C), bits = key

        def make():
            e = torch.randn((R, C), generator=g, device=dev)
            s = wp.grid_scale(torch.rand((R * C,), generator=g, device=dev)
                              * 4 + 1e-3, bits).reshape(R, C)
            return e, s, bits

        return (make, wp.wire_quantize_sflat, wp.quantize_chunks_ref,
                R * C * 13, 6.0 * R * C, f"R{R} C{C} bits{bits}")
    if name == "wire_pack_rows":
        R, C = key

        def make():
            return (torch.randint(-7, 8, (R, C), generator=g, device=dev,
                                  dtype=torch.int8),)

        # integer operations only: bound by bytes
        return (make, wp.wire_pack_rows, wp.pack_chunks_ref,
                R * C + R * ((C + 1) // 2), 0.0, f"R{R} C{C}")
    if name == "wire_quantize_bucket":
        n, bits, nibble, members = key
        Ts, W = _bucket_cols(members, n, nibble)

        def make():
            leaves, steps = _bucket_members(members, bits, dev, g)
            return leaves, steps, n, bits, nibble

        # the leaf read, the payload and the float32 residual written
        nbytes = sum(T * (torch.finfo(_DTYPES[dt]).bits // 8 + 4) + 4 * L
                     for T, (_, L, dt) in zip(Ts, members)) + n * W
        return (make, wp.wire_quantize_bucket, wp.quantize_bucket_ref,
                nbytes, 6.0 * sum(Ts),
                _bucket_text(n, f"bits{bits}", nibble, members))
    if name == "wire_dequant_bucket":
        n, shift, nibble, members = key
        Ts, W = _bucket_cols(members, n, nibble)

        def make():
            leaves, steps = _bucket_members(members, 4 if nibble else 8, dev,
                                            g)
            qmax = 7 if nibble else 127
            q = torch.randint(-qmax, qmax + 1, (n, W), generator=g,
                              device=dev, dtype=torch.int8)
            if nibble:
                q = wp.pack_chunks_ref(q)
            err = torch.randint(-2 ** shift, 2 ** shift + 1, (W,),
                                generator=g, device=dev).float()
            res = [torch.randn(e.shape, generator=g, device=dev) * s.min()
                   for e, s in zip(leaves, steps)]
            for r in res:
                r.view(-1)[::7] = -0.0           # +0.0 off the own chunk
            return q, err, res, leaves, steps, n, 0, shift, nibble

        # the payload and err read, the residual read and written, the
        # delivered written
        nbytes = (n * W // (2 if nibble else 1) + 4 * W
                  + sum(T * (4 + 2 * torch.finfo(_DTYPES[dt]).bits // 8)
                        + 4 * L for T, (_, L, dt) in zip(Ts, members)))
        return (make, wp.wire_dequant_bucket, wp.dequant_bucket_ref, nbytes,
                5.0 * sum(Ts),
                _bucket_text(n, f"shift{shift}", nibble, members))
    R, C, shift, n = key

    def make():
        q = torch.randint(-127, 128, (R, C), generator=g, device=dev,
                          dtype=torch.int8)
        s = wp.grid_scale(torch.rand((R * C,), generator=g, device=dev)
                          + 0.1).reshape(R, C)
        return q, s, shift, n

    return (make, wp.wire_dequant_rows, wp.dequant_sum_ref, R * C * 9,
            3.0 * R * C, f"R{R} C{C} shift{shift} n{n}")


def _tensors(x):
    """Every tensor of a result, in order (tuples and lists flattened)."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _tensors(v)] \
        if isinstance(x, (list, tuple)) else []


def _fresh(args):
    """The arguments with every tensor cloned: ``wire_dequant_bucket``
    updates a float32 residual in place."""
    if isinstance(args, torch.Tensor):
        return args.clone()
    if isinstance(args, (list, tuple)):
        return type(args)(_fresh(a) for a in args)
    return args


def _same_bits(a, b):
    a, b = _tensors(a), _tensors(b)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(_wbits(x), _wbits(y)) for x, y in zip(a, b))


def wire_case(name, key, dev, g):
    """One wire kernel at one shape against its plain version, bit for bit
    (every output, signed zeros included; the bucket decode at every rank
    index), twice identical, and timed."""
    make, kern, plain, nbytes, flops, shape = _wire_spec(name, key, dev, g)
    sets = [make() for _ in range(n_copies(nbytes))]
    checks = [sets[0]]
    if name == "wire_dequant_bucket":
        checks = [sets[0][:6] + (i,) + sets[0][7:] for i in range(key[0])]
    for args in checks:
        ref = plain(*args)
        out = kern(*_fresh(args))
        check(_same_bits(out, ref),
              f"{name} {shape}: not bit-exact against the plain version")
        check(_same_bits(out, kern(*_fresh(args))),
              f"{name} {shape}: not repeatable")
    del checks, ref, out
    b_ms, b_by = bound(nbytes, flops)
    case = {"shape": shape, "max_abs_err": 0.0,
            "ms": time_ms(kern, sets), "plain_ms": time_ms(plain, sets, 16),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}
    del sets
    return case


# buckets of the fused reduce beside its main paths': a stacked leaf (L =
# 3) with odd C, ragged T (not a multiple of n) and a scalar; bfloat16 and
# float32 leaves in a nibble bucket at n = 3 (a true division); one member
# of 2^22 + 3 values
BUCKET_EDGE = [
    (4, 8, False, (((3, 40, 7), 3, "float32"), ((1001,), 1, "float32"),
                   ((), 1, "float32"))),
    (3, 4, True, (((1001,), 1, "bfloat16"), ((33,), 1, "float32"),
                  ((3, 8, 5), 3, "bfloat16"), ((24, 1000), 1, "float32"))),
    (4, 8, False, (((2 ** 22 + 3,), 1, "float32"),)),
]
# edge shapes of the wire kernels, beside the shapes the wire phase takes
# from its main paths: stacked rows at every width, odd tails, a qwen2 MLP
# leaf (24 layers) and the embedding, n = 3 (a true division) and 4; packs
# of even C around the 16- and 32-byte vectors (16 packed bytes from 32)
WIRE_EDGE = {
    "wire_quantize_rows": [(1, 1, 8), (3, 40, 2), (4, 129, 5), (7, 257, 7),
                           (24, 1000, 3), (24, 896 * 4864, 4),
                           (1, 151936 * 896, 8)],
    "wire_quantize_sflat": [((4, 33), 8), ((4, 1001), 4), ((4, 2 ** 20), 8)],
    "wire_pack_rows": [(1, 1), (3, 7), (4, 1001), (1, 2 ** 20), (1, 14),
                       (3, 16), (1, 18), (3, 30), (1, 32), (3, 34), (2, 62),
                       (1, 64), (2, 66), (3, 2 ** 20 + 2)],
    "wire_dequant_rows": [(3, 1001, 2, 3), (4, 1001, 2, 4),
                          (4, 2 ** 20, 2, 4)],
    "wire_quantize_bucket": [(n, 4 if nib else 8, nib, m)
                             for n, _, nib, m in BUCKET_EDGE],
    "wire_dequant_bucket": [(n, (n - 1).bit_length(), nib, m)
                            for n, _, nib, m in BUCKET_EDGE],
}


def _bucket_edge_checks(dev):
    """The bucket kernels against their plain versions, bit for bit, where
    the timed keys cannot reach: leaves 1-7 elements past a 16-byte
    boundary (bfloat16 2-14 bytes, float32 4-28), residuals handed to the
    decode off the leaves' group grid (element by element), -0.0 and
    subnormal residuals on and off the own chunk (-0.0 + 0.0 is +0.0), every
    rank index, n = 3 and 4, int8 and nibble; and a bucket of 65 members,
    two launches of each kernel, equal to the plain bucket."""
    from repro_torch.kernels import wire_pack as wp
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    mixed = (((3, 8, 5), 3, "float32"), ((17,), 1, "bfloat16"),
             ((), 1, "float32"), ((2, 3, 7), 1, "float32"),
             ((5,), 1, "bfloat16"), ((4099,), 1, "float32"))
    many = tuple(((k % 37 + 1,), 1, "bfloat16" if k % 3 == 0 else "float32")
                 for k in range(65))
    cases = [(mixed, n, nib, off) for n in (3, 4) for nib in (False, True)
             for off in range(8)] + [(many, 4, False, 0), (many, 3, True, 5)]
    for members, n, nib, off in cases:
        bits = 4 if nib else 8
        what = (f"{_bucket_text(n, f'bits{bits}', nib, members)[:60]} at "
                f"offset {off}")
        leaves, steps = _bucket_members(members, bits, dev, g, off)
        launches = [wp.wire_quantize_bucket.launches,
                    wp.wire_dequant_bucket.launches]
        q, res = wp.wire_quantize_bucket(leaves, steps, n, bits, nib)
        check(_same_bits((q, res), wp.quantize_bucket_ref(leaves, steps, n,
                                                          bits, nib)),
              f"wire_quantize_bucket {what}: not the plain version's bits")
        _, W = _bucket_cols(members, n, nib)
        gath = torch.randint(-7, 8, (n, W), generator=g, device=dev,
                             dtype=torch.int8)
        if nib:
            gath = wp.pack_chunks_ref(gath)
        err = torch.randint(-8, 9, (W,), generator=g, device=dev).float()
        for r in res:
            r.view(-1)[::3] = -0.0
            r.view(-1)[1::5] = 1e-40
        # copies of the residuals 0, 1 and 3 elements past a 16-byte
        # boundary (the decode's outputs follow them; the float32 residual
        # is updated in place, so each call takes new copies)
        for k in (0, 1, 3):
            for idx in range(n):
                rs = []
                for r in res:
                    buf = torch.empty((r.numel() + k,), device=dev)
                    rs.append(buf[k:].view(r.shape).copy_(r))
                args = (gath, err, rs, leaves, steps, n, idx,
                        (n - 1).bit_length(), nib)
                want = wp.dequant_bucket_ref(*args)
                check(_same_bits(wp.wire_dequant_bucket(*args), want),
                      f"wire_dequant_bucket {what}, rank {idx}, residual "
                      f"{k} past a boundary: not the plain version's bits")
        moved = [wp.wire_quantize_bucket.launches - launches[0],
                 wp.wire_dequant_bucket.launches - launches[1]]
        want = [-(-len(members) // 64), -(-len(members) // 64) * 3 * n]
        check(moved == want, f"bucket launches {moved}, not {want}: {what}")


def _hgq_alignment_check(dev):
    """The backward's sums do not depend on where g and x lie: views one
    element past a 16-byte boundary (values loaded one by one) give the bits
    of aligned copies (16-byte loads)."""
    from repro_torch.kernels.hgq_quantize import hgq_quantize_bwd
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    for shape, fshape, dtype in (((1024, 16), (16,), torch.float32),
                                 ((1024, 64), (), torch.float32),
                                 ((1024, 16), (16,), torch.bfloat16),
                                 ((512, 257), (), torch.bfloat16)):
        n = math.prod(shape)
        buf = (torch.randn(2 * n + 1, generator=g, device=dev) * 4).to(dtype)
        x, gy = buf[1:n + 1].view(shape), buf[n + 1:].view(shape)
        f = torch.rand(fshape, generator=g, device=dev) * 8 - 1
        a = hgq_quantize_bwd(gy, x, f)
        b = hgq_quantize_bwd(gy.clone(), x.clone(), f)
        check(torch.equal(_bits_of(a), _bits_of(b)),
              f"hgq_quantize_bwd {tuple(shape)} {dtype}: an unaligned view "
              f"sums differently from an aligned copy")


def _pack_offset_check(dev):
    """``wire_pack_rows`` on contiguous views whose base sits 0-15 bytes past
    a 16-byte boundary (a slice of a larger tensor): bit-exact against the
    plain version and repeatable, at even C (the 16-byte path, an input
    misaligned against its output) and odd C."""
    from repro_torch.kernels import wire_pack as wp
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 6)
    for R, C in ((4, 2 * 16 * 1000 + 34), (1, 70), (3, 1001)):
        buf = torch.randint(-7, 8, (R * C + 16,), generator=g, device=dev,
                            dtype=torch.int8)
        for off in range(16):
            q = buf[off:off + R * C].view(R, C)
            out = wp.wire_pack_rows(q)
            check(torch.equal(out, wp.pack_chunks_ref(q))
                  and torch.equal(out, wp.wire_pack_rows(q)),
                  f"wire_pack_rows R{R} C{C} at byte offset {off}: not "
                  f"bit-exact or not repeatable")


def _subnormal_check(dev):
    """``[1e-38]`` at 2 bits: the residual is the subnormal input itself
    (no flush to zero), as the plain version computes."""
    from repro_torch.kernels import wire_pack as wp
    x = torch.tensor([[1e-38]], device=dev)
    q, s, r = wp.wire_quantize_rows(x, x[:, 0], 2)
    check(int(q[0, 0]) == 0 and torch.equal(_wbits(r), _wbits(x)),
          f"wire_quantize_rows flushed a subnormal residual: {float(r)}")


def _division_check(dev):
    """The plain versions divide by a tensor (``wire_pack.ref.true_div``):
    on the card that must be IEEE division, the CPU's, where PyTorch
    divides a float32 tensor by a Python number as a multiply by its
    reciprocal.  Prints how many values that multiply moves."""
    from repro_torch.kernels.wire_pack import true_div
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    x = torch.randn(1 << 20, generator=g, device=dev)
    check(torch.equal(true_div(x, 3).cpu(), x.cpu() / 3.0),
          "true_div on the card is not IEEE division")
    moved = int((x / 3.0 != true_div(x, 3)).sum())
    print(f"[kernels] on the card x / 3 differs from IEEE division "
          f"(true_div) in {moved} of {x.numel()} values", flush=True)


def print_cases(cases, names=None):
    for name, by_shape in cases.items():
        if names is not None and name not in names:
            continue
        print(f"[kernels] {name}: max err "
              f"{max(c['max_abs_err'] for c in by_shape.values()):.3g}",
              flush=True)
        for c in by_shape.values():
            lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
            print(f"    {c['shape']:<44} {c['ms']:.4f} ms  plain "
                  f"{c['plain_ms']:.4f}  library {lib}  bound "
                  f"{c['bound_ms']:.4f} ({c['bound_by']})", flush=True)
            if "rel_err" in c:
                print(f"    {'':<44} err / (|x|@|w|*s) {c['rel_err']:.3g} "
                      f"(two-term {c['rel_err_two_term']:.3g}); off the one "
                      f"rounding {c['exact_off']:.4f} (two-term "
                      f"{c['exact_off_two_term']:.4f})", flush=True)


def kernel_phase(dev):
    """Every kernel at its main path's shapes: {kernel: {shape key:
    case}}, keyed as the wrappers key their launch tallies."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    H, KV, hd, W = 14, 2, 64, 1024
    cases = {name: {} for name in KERNELS}
    for M in (8, 16):
        # int8: q, o; k, v; gate, up; down; the tied head.  nibbles: gate,
        # up; down (configuration (a)'s MLP)
        for K, N, bits in ((896, 896, 8), (896, 128, 8), (896, 4864, 8),
                           (4864, 896, 8), (896, 151936, 8),
                           (896, 4864, 4), (4864, 896, 4)):
            cases["qmatmul"][M, K, N, bits] = qmatmul_case(M, K, N, bits,
                                                           dev, g)
    rel = [c["rel_err"] for c in cases["qmatmul"].values()]
    rel2 = [c["rel_err_two_term"] for c in cases["qmatmul"].values()]
    check(max(rel) <= REL_ERR_LIMIT < max(rel2),
          f"qmatmul: largest error over (|x|@|w|)*scale {max(rel):.3g}, "
          f"two-term control {max(rel2):.3g}, limit {REL_ERR_LIMIT}")
    for R in (16, 32, 64):
        for bits in (8, 4):
            cases["kv_quantize_rows"][R, hd, bits] = kv_quantize_case(
                R, hd, bits, dev, g)
    for key in STORE_TIMED:
        cases["kv_quantize_store"][key] = kv_store_case(key, False, dev, g)
    kv_store_checks(dev, g)
    # one qwen2-0.5b layer's full ring (8 slots x 1024 x 2 kv heads), one
    # slot's, and all 24 layers' rings
    for R in (8 * W * KV, W * KV, 24 * 8 * W * KV):
        cases["kv_dequant_rows"][R, hd] = kv_dequant_case(R, hd, dev, g)
    _dequant_edge_checks(dev, g)
    for B, S in ((8, 1), (1, 16)):
        for nibble in (False, True):
            key = (B, S, H, KV, hd, W, hd // 2 if nibble else hd)
            cases["kv_attention_rows"][key] = kv_attention_case(
                B, S, W, nibble, 6.0, dev, g, H=H, KV=KV, hd=hd)
    long_ring_checks(dev, g)
    for shape, fshape, dtype in HGQ_SHAPES + HGQ_EDGE + PAPER_SHAPES:
        key, fwd, bwd = hgq_quantize_case(shape, fshape, dtype, dev, g)
        cases["hgq_quantize_fwd"][key] = fwd
        cases["hgq_quantize_bwd"][key] = bwd
    for members in (JET_GROUP, SVHN_GROUP, MUON_GROUP):
        key, case = hgq_group_case(members, dev, g)
        cases["hgq_quantize_fwd_group"][key] = case
    _hgq_group_checks(dev)
    _hgq_alignment_check(dev)
    _pack_offset_check(dev)
    _bucket_edge_checks(dev)
    _subnormal_check(dev)
    _division_check(dev)
    for name, keys in WIRE_EDGE.items():
        for key in keys:
            cases[name][key] = wire_case(name, key, dev, g)
    print_cases(cases)
    return cases


def _per_unit(name, by_shape, unit, per):
    """One unit's numbers for a kernel: per-call times weighted by the
    calls of each shape the main path launched in that unit."""
    missing = [k for k in unit if k not in by_shape]
    check(not missing, f"{name}: the main path launched shapes the "
                       f"kernel phase did not time: {missing}")
    check(sum(unit.values()) > 0, f"{name}: not in the unit")
    out = {key: sum(n * by_shape[k][key] for k, n in unit.items())
           for key in ("ms", "plain_ms")}
    out["library_ms"] = (sum(n * by_shape[k]["library_ms"]
                             for k, n in unit.items())
                         if all(by_shape[k]["library_ms"] is not None
                                for k in unit) else None)
    out["bound_ms"], out["bound_by"] = bound(
        sum(n * by_shape[k]["bytes"] for k, n in unit.items()),
        sum(n * by_shape[k]["flops"] for k, n in unit.items()),
        next(iter(by_shape.values())).get("peak", PEAK_FP32_PER_S))
    out["per"] = per
    out["calls_per_unit"] = {by_shape[k]["shape"]: n
                             for k, n in unit.items()}
    print(f"[kernels] {name}: {per}: {sum(unit.values())} calls, "
          f"{out['ms']:.4f} ms (plain {out['plain_ms']:.4f}, bound "
          f"{out['bound_ms']:.4f})", flush=True)
    return out


def kernels_line(cases, tallies):
    """The ``kernels`` entries.  ``tallies`` maps a kernel to a list of
    (its launches by shape in one unit of a main path -- a full decode
    tick of serving configuration (a), a training step, a compressed
    data-parallel step, a qwen2 gradient reduce -- as the wrappers counted
    them, a description of that unit).  The entry's times are the first
    unit's, per-call times weighted by those counts (every counted shape
    must have been timed); further units go under ``other_units``.  A
    kernel without a tally (the kernel phase alone) has null per-unit
    fields."""
    out = []
    for name, by_shape in cases.items():
        source, tpu = KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": dict(TPU_KERNELS)[tpu], "launches": 0,
                 "max_abs_err": max(c["max_abs_err"]
                                    for c in by_shape.values()),
                 "ms": None, "plain_ms": None, "bound_ms": None,
                 "bound_by": None, "library_ms": None,
                 "per": None, "calls_per_unit": None}
        if name == "hgq_quantize_bwd":
            entry["note"] = ("the backward of the kernel's op, the custom_vjp "
                             "at src/repro/kernels/hgq_quantize/ops.py:164; "
                             "per channel and per tensor one launch of a "
                             "thread block cluster (partials summed in rank "
                             "order in rank 0's shared memory, no scratch) up "
                             "to 8 blocks of two batches a thread (65536 "
                             "float32 elements, 2048 rows per channel), "
                             "clusters of 8 and a second pass beyond")
        if name == "hgq_quantize_fwd_group":
            entry["note"] = ("the forward of the same TPU kernel over a group "
                             "of tensors in one launch (a training step's "
                             "weight and bias quantizers: 8 of the jet "
                             "tagger, 12 of the SVHN and the muon models); "
                             "library_ms null: "
                             "torch.fake_quantize_per_channel_affine rounds "
                             "half to even, Eq. 4 half up")
        if name == "kv_quantize_store":
            entry["note"] = ("the kv_quantize_rows body with the serving "
                             "ring write fused in (quantize, nibble pack, "
                             "store at the slots, out-of-ring rows dropped); "
                             "library_ms null: no single PyTorch call "
                             "computes this function")
        if name == "kv_quantize_rows":
            entry["note"] = ("no main path launches it (the entry point of "
                             "the op kv_quantize); the serving store runs its "
                             "body as kv_quantize_store")
        if name in WIRE:
            entry["note"] = ("library_ms null: no single PyTorch call "
                             "computes this function")
        if name in RETIRED_WIRE:
            entry["note"] += ("; no main path launches it (the fused reduce "
                              "runs its bucket form; the 2D exchange, not "
                              "ported, calls it), so its per-unit fields are "
                              "null; per-call numbers under shapes")
        if name in ("wire_quantize_bucket", "wire_dequant_bucket"):
            entry["note"] += ("; one launch a bucket a rank, the members read "
                              "and written where they lie (a member table in "
                              "the kernel's parameter space, the chunk "
                              "layout as index arithmetic)")
        if name == "wire_pack_rows":
            entry["note"] += ("; even C packs the flat bytes in 16-byte "
                              "vectors (two 16-byte loads, prmt, one 16-byte "
                              "store), odd C a row at a time")
        if name == "qmatmul":
            entry["note"] = ("tensor cores (mma.sync bf16, x in three exact "
                             "terms); bound: bytes, or 3 x 2MKN operations "
                             "at the bf16 tensor rate; library_ms on nibble "
                             "shapes multiplies the unpacked int8 mantissas")
        if name == "kv_dequant_rows":
            entry["note"] = ("no main path of either package launches it "
                             "(the entry point of the op kv_dequant), so its "
                             "launches are 0 and its per-unit fields null; "
                             "per-call numbers under shapes, each beside "
                             "launch_floor_ms, the empty kernel on the "
                             "same grid")
        units = [_per_unit(name, by_shape, u, per)
                 for u, per in tallies.get(name, [])]
        if units:
            entry.update(units[0])
        if units[1:]:
            entry["other_units"] = units[1:]
        entry["shapes"] = list(by_shape.values())
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_bwd,
                                                  hgq_quantize_fwd,
                                                  hgq_quantize_fwd_group)
    from repro_torch.kernels.kv_dequant import (kv_attention_rows,
                                                kv_dequant_rows,
                                                kv_quantize_rows,
                                                kv_quantize_store)
    from repro_torch.kernels.qmatmul import qmatmul
    from repro_torch.kernels import wire_pack as wp
    return {"qmatmul": qmatmul, "kv_quantize_rows": kv_quantize_rows,
            "kv_quantize_store": kv_quantize_store,
            "kv_dequant_rows": kv_dequant_rows,
            "kv_attention_rows": kv_attention_rows,
            "hgq_quantize_fwd": hgq_quantize_fwd,
            "hgq_quantize_fwd_group": hgq_quantize_fwd_group,
            "hgq_quantize_bwd": hgq_quantize_bwd,
            **{name: getattr(wp, name) for name in WIRE}}


def _counts(names):
    return {k: fn.launches for k, fn in _counters().items() if k in names}


def _shapes(names):
    return {k: collections.Counter(fn.shapes)
            for k, fn in _counters().items() if k in names}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0
        fn.shapes.clear()


# The profiler's settling time, its markers, and the runs it may take to
# get a whole trace.  The trace can lack the device records of the first
# kernels launched after the profiler starts, though every launch was made
# (readings in PERF.md): one profiled step in 30 lost its first 22 device
# operations when it began as the profiler started; after the serving
# phase the profiled step lost its first launch (an ``aten::fill_``) in
# every run, a settling time or not, and the compressed step its first 8
# behind a marker kernel.  So the profiled function runs after the
# settling time and ``PROFILE_MARKERS`` marker kernels, which nothing
# reads, and a trace is only used whole: every kernel launch of the
# function has its device kernel, else the function is profiled again.
PROFILE_SETTLE_S = 0.05
PROFILE_MARKERS = 512
PROFILE_ATTEMPTS = 3
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
MARKER = "spin_kernel"                   # torch.cuda._sleep's kernel


def _all_threads_config():
    """The profiler option that records host operations on every thread (a
    LocalMesh's ranks are threads; by default only the profiling thread's
    are recorded), or None where this PyTorch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _trace_once(fn, args, settle=PROFILE_SETTLE_S, n_markers=PROFILE_MARKERS,
                all_threads=False):
    """``fn(*args)`` under ``torch.profiler``, after ``settle`` seconds and
    ``n_markers`` marker kernels: (the profiler, the chrome trace's device
    kernels but the markers', where the launches of ``fn`` whose device
    kernel the trace lacks were made, the launches of ``fn``, the markers'
    device kernels the trace kept).  ``all_threads``: host operations of
    every thread recorded, where the profiler can."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    config = _all_threads_config() if all_threads else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **({} if config is None else
                    {"experimental_config": config})) as prof:
        time.sleep(settle)
        for _ in range(n_markers):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        fn(*args)
        torch.cuda.synchronize()
        time.sleep(settle)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    calls = sorted((e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and e.get("name", "").startswith(LAUNCH_CALLS)),
                   key=lambda e: e["ts"])
    check(len(calls) > n_markers, "the profiled function launched no kernel")
    ahead = {e["args"]["correlation"] for e in calls[:n_markers]}
    markers = [e for e in events if e.get("cat") == "kernel"
               and MARKER in e.get("name", "")]
    check(all(e["args"]["correlation"] in ahead for e in markers),
          "a marker kernel is not among the first launches of the trace")
    kernels = [e for e in events if e.get("cat") == "kernel"
               and MARKER not in e.get("name", "")]
    have = {e["args"]["correlation"] for e in kernels}
    calls = calls[n_markers:]
    lost = [_launch_site(events, calls, i) for i, e in enumerate(calls)
            if e["args"]["correlation"] not in have]
    return prof, kernels, lost, calls, len(markers)


def _launch_site(events, calls, i):
    """Launch i of ``calls`` as the host made it: the call, the innermost
    host operator around it, its place among the launches."""
    c = calls[i]
    around = [e for e in events
              if e.get("cat") in ("cpu_op", "user_annotation")
              and e.get("tid") == c.get("tid")
              and e["ts"] <= c["ts"] <= e["ts"] + e.get("dur", 0)]
    op = max(around, key=lambda e: e["ts"])["name"] if around else "no op"
    return f"{c['name']} in {op} (launch {i + 1} of {len(calls)})"


def _profiled(fn, grids_of=None, prepare=None, all_threads=False):
    """``fn()`` (or ``fn(prepare())``, ``prepare`` run before the profiler
    starts) under ``torch.profiler``: (device operations, ms the device
    was busy, the launch grids of the device kernels whose name holds
    ``grids_of``, as CUPTI recorded them, and the names of every event,
    device kernels and host operators -- of every thread with
    ``all_threads``, where the profiler can -- counted), the markers left
    out.  Only a whole trace is read: one with a device kernel for every
    kernel launch of ``fn``."""
    from torch.autograd import DeviceType
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        args = () if prepare is None else (prepare(),)
        prof, kernels, lost, launched, marked = _trace_once(
            fn, args, all_threads=all_threads)
        if marked < PROFILE_MARKERS:
            print(f"[profile] the trace kept {marked} of the "
                  f"{PROFILE_MARKERS} marker kernels", flush=True)
        if not lost:
            break
        print(f"[profile] run {attempt}: the trace lacks the device kernel "
              f"of {len(lost)} of {len(launched)} kernel launches: "
              f"{'; '.join(lost[:4])}", flush=True)
    check(not lost, f"no whole trace in {PROFILE_ATTEMPTS} runs")
    events = [e for e in prof.events() if MARKER not in e.name]
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    grids = [] if grids_of is None else [
        tuple(e["args"]["grid"]) for e in kernels
        if grids_of in e.get("name", "")]
    names = collections.Counter(e.name for e in events)
    return (len(dev), sum(e.time_range.elapsed_us() for e in dev) / 1e3,
            grids, names)


def _serve(eng, reqs):
    """Continuous batching through the public surface, each tick timed
    to its end on the card.  The first tick with every slot busy also
    has its launches tallied by shape."""
    pending = list(reqs)
    tick_ms, tick_shapes = [], None
    while pending or not all(r.done for r in reqs):
        while pending and eng.submit(pending[0]) is not None:
            pending.pop(0)
        torch.cuda.synchronize()
        full = tick_shapes is None and all(r is not None
                                           for r in eng.slot_req)
        if full:
            before = _shapes(SERVING)
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if full:
            after = _shapes(SERVING)
            tick_shapes = {k: after[k] - before[k] for k in after}
    return tick_ms, tick_shapes


def _profile_full_tick(Engine, Request, model, params, qstate, cfg, pl,
                       kv_bits, prompts, dev):
    """Device operations, busy ms and the attention kernel's launch grids
    of one decode tick with all 8 slots busy (B = 8, KV = 2, W = 1024), on
    an engine of its own (a new one for each profiler run), after every
    timed run: the profiler
    slows the host, and may go on doing so once it is stopped.  The
    attention kernel reads the whole ring whatever its fill, so short
    prompts give the same device work as the timed run's."""
    def engine():
        eng = Engine(model, params, qstate, cfg, batch_slots=8,
                     max_len=1024, prefill_chunk=16, packed=True, plan=pl,
                     kv_bits=kv_bits, seed=SEED, device=dev)
        for pr in prompts[:8]:
            check(eng.submit(Request(prompt=list(pr[:16]), max_new=4))
                  is not None, "profile pass: no free slot")
        check(all(r is not None for r in eng.slot_req),
              "profile pass: idle slot")
        return eng

    return _profiled(lambda eng: eng.step(), "kv_attention_kernel",
                     prepare=engine)


# what a KV store outside the fused kernel would run, by the names of host
# operators and device kernels: the stack of k and v, the nibble pack's and /
# or, the scatter writes into the ring.  (A left shift is no sign: every
# activation quantizer builds its 2^f in the exponent field with one.)
STORE_OPS = ("aten::stack", "index_put", "bitwise_and", "bitwise_or",
             "aten::__and__", "aten::__or__")


def _store_ops(names):
    return {k: n for k, n in names.items() if any(o in k for o in STORE_OPS)}


@contextlib.contextmanager
def _counting_unpacks(calls):
    """Count in ``calls[0]`` every ``unpack_nibbles`` call of the port
    (each module that bound the function by name)."""
    from repro_torch.kernels.qmatmul import ref
    real = ref.unpack_nibbles
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("repro_torch")
            and getattr(m, "unpack_nibbles", None) is real]

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    for m in mods:
        m.unpack_nibbles = counted
    try:
        yield
    finally:
        for m in mods:
            m.unpack_nibbles = real


@contextlib.contextmanager
def _bf16_activations_into_qmatmul():
    """Control: every packed matmul takes its activations rounded to
    bfloat16, a subtly wrong product."""
    import repro_torch.models.lm as lm
    import repro_torch.nn.basic as basic
    real = basic.qmatmul_any

    def rounded(x, w, s, **kw):
        return real(x.to(torch.bfloat16).to(x.dtype), w, s, **kw)

    basic.qmatmul_any = lm.qmatmul_any = rounded
    try:
        yield
    finally:
        basic.qmatmul_any = lm.qmatmul_any = real


def _without_act_quantizers(tree):
    """The tree without its activation quantizers (every ``out_f`` and
    ``attnout_f``): packed weights, the cache's grids and the
    probabilities' grid stay."""
    if isinstance(tree, dict):
        return {k: _without_act_quantizers(v) for k, v in tree.items()
                if k not in ("out_f", "attnout_f")}
    return tree


# Card logits against the CPU's plain path.  With the activation
# quantizers on, a one-ulp difference in a sum decides a rounding tie
# somewhere in 24 layers and the logits drift by a few percent: that
# reading only bounds gross faults (LOGITS_REL_GROSS).  Without them the
# function is continuous, and LOGITS_REL_LIMIT lies between the sound
# reading and those of two faulty controls, which the check must catch
# (readings in PERF.md).
LOGITS_REL_GROSS = 0.1
LOGITS_REL_LIMIT = 0.005


def _logits_vs_plain(p, q, cfg, kv_bits, dev):
    """Teacher-forced logits of the card (kernels) against the CPU (plain
    versions) on one prefill chunk and two decode ticks of 2 rows, with
    the activation quantizers on ("full") and off ("continuous"), where
    two controls -- the card path with one subtle fault each -- are read
    too: {witness: {"rel_l2", "argmax_agree", "controls"?}}."""
    from repro_torch.models import TransformerLM
    from repro_torch.tree import tree_map
    g = np.random.default_rng(SEED)
    toks = torch.as_tensor(g.integers(0, cfg.vocab, (2, 16)))
    cpu = torch.device("cpu")

    def run(d, pp, qq):
        c = TransformerLM.init_cache(cfg, 2, 64, kv_bits=kv_bits, device=d)
        lg, c = TransformerLM.decode_step(pp, qq, c, toks.to(d), 0, cfg,
                                          kv_bits=kv_bits)
        seq = [lg[:, -1]]
        nxt = toks[:, -1:]
        for t in range(2):
            lg, c = TransformerLM.decode_step(pp, qq, c, nxt.to(d),
                                              np.array([16 + t, 16 + t]),
                                              cfg, kv_bits=kv_bits)
            seq.append(lg[:, -1])
            nxt = (nxt + 1) % cfg.vocab
        out = torch.stack(seq).cpu()
        check(bool(torch.isfinite(out).all()), f"logits on {d} not finite")
        return out

    def rel(x, y):
        return float((x - y).norm() / y.norm())

    def compare(pp):
        a = run(dev, pp, q)
        b = run(cpu, tree_map(lambda t: t.to(cpu), pp),
                tree_map(lambda t: t.to(cpu), q))
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        return b, {"rel_l2": rel(a, b), "argmax_agree": agree}

    _, full = compare(p)
    pc = _without_act_quantizers(p)
    b, cont = compare(pc)
    # control: probabilities on a grid one step finer in every layer
    attn = dict(pc["layers"]["attn"],
                probs_f=pc["layers"]["attn"]["probs_f"] + 1)
    finer = run(dev, {**pc, "layers": {**pc["layers"], "attn": attn}}, q)
    with _bf16_activations_into_qmatmul():
        bf16 = run(dev, pc, q)
    cont["controls"] = {"probs_grid_one_step_finer": rel(finer, b),
                        "bf16_activations_into_qmatmul": rel(bf16, b)}
    return {"full": full, "continuous": cont}


def slice_phase(dev, cases):
    from repro_torch.configs import get
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import TransformerLM
    from repro_torch.serving import (Engine, Request, generate,
                                     kv_bytes_per_token, packed_nbytes)
    from repro_torch.serving.packed import pack_for_serving

    cfg = get("qwen2-0.5b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
           cfg.vocab) == (24, 896, 14, 2, 4864, 151936), "not qwen2-0.5b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params, qstate = TransformerLM.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"[slice] qwen2-0.5b FULL init on the card: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    plan = PrecisionPlan.from_file(
        str(ROOT / "examples" / "specs" / "plan_mixed_w4w8.json"))
    rng = np.random.default_rng(SEED)
    lens = [16, 256] + [int(n) for n in rng.integers(16, 257, 8)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in lens]
    max_new, max_len = 32, 1024
    configs = (("a", "packed plan_mixed_w4w8 (w4 MLP nibbles), kv_bits 8",
                plan, 8),
               ("b", "packed uniform int8, kv_bits 4", None, 4))
    total = {k: 0 for k in SERVING}
    report, tick_shapes_a = {}, None
    for tag, desc, pl, kv_bits in configs:
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(TransformerLM, params, qstate, cfg, batch_slots=8,
                     max_len=max_len, prefill_chunk=16, packed=True, plan=pl,
                     kv_bits=kv_bits, seed=SEED, device=dev)
        reqs = [Request(prompt=list(pr), max_new=max_new) for pr in prompts]
        torch.cuda.synchronize()
        unpacks = [0]
        _reset_counts()                       # the main path starts here
        t0 = time.perf_counter()
        with _counting_unpacks(unpacks):
            tick_ms, tick_shapes = _serve(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(SERVING)             # ... and ends here
        if tag == "a":
            # the MLP's nibbles stream into qmatmul as they are stored
            check(unpacks[0] == 0, f"(a) {unpacks[0]} unpack_nibbles calls "
                                   f"while serving")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for k in total:
            total[k] += counts[k]
        check(all(c > 0 for c in counts.values()),
              f"({tag}) a kernel was never launched: {counts}")
        check(tick_shapes is not None, f"({tag}) no tick had every slot busy")
        per_tick = {k: sum(c.values()) for k, c in tick_shapes.items()}
        check(all(n > 0 for n in per_tick.values()),
              f"({tag}) a kernel was not launched in a full tick: {per_tick}")
        # the store: one launch a layer, and no separate quantize launch
        rows_launches = _counts(("kv_quantize_rows",))["kv_quantize_rows"]
        check(per_tick["kv_quantize_store"] == cfg.n_layers
              and rows_launches == 0,
              f"({tag}) {per_tick['kv_quantize_store']} kv_quantize_store "
              f"launches in a full tick for {cfg.n_layers} layers, "
              f"{rows_launches} kv_quantize_rows launches while serving")
        if tag == "a":
            tick_shapes_a = tick_shapes
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 8)
        for key in tick_shapes["kv_quantize_store"]:
            if key not in cases["kv_quantize_store"]:
                cases["kv_quantize_store"][key] = kv_store_case(
                    key, cfg.window is not None, dev, g)
        check(all(r.done and len(r.out) == max_new for r in reqs),
              f"({tag}) not every request finished")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
              f"({tag}) token out of range")
        for i in (0, len(reqs) - 1):           # first admitted, last joiner
            ref = generate(TransformerLM, params, qstate, cfg, [prompts[i]],
                           max_new, cache_len=max_len, packed=True, plan=pl,
                           kv_bits=kv_bits, device=dev)
            check(ref[0].tolist() == reqs[i].out,
                  f"({tag}) Engine != generate() for request {i}")
        pp, qq = pack_for_serving(params, qstate, pl)
        logits = _logits_vs_plain(pp, qq, cfg, kv_bits, dev)
        full, cont = logits["full"], logits["continuous"]
        print(f"[slice] ({tag}) card vs CPU logits: {json.dumps(logits)} "
              f"(limits: full {LOGITS_REL_GROSS}, continuous "
              f"{LOGITS_REL_LIMIT})", flush=True)
        check(full["rel_l2"] <= LOGITS_REL_GROSS,
              f"({tag}) card vs CPU logits rel L2 {full['rel_l2']}")
        check(cont["rel_l2"] <= LOGITS_REL_LIMIT,
              f"({tag}) card vs CPU logits without activation quantizers: "
              f"rel L2 {cont['rel_l2']}")
        check(cont["argmax_agree"] == 1.0,
              f"({tag}) card vs CPU argmax without activation quantizers: "
              f"{cont['argmax_agree']}")
        check(all(c > LOGITS_REL_LIMIT for c in cont["controls"].values()),
              f"({tag}) the logits check misses a control: {cont}")
        toks = sum(len(r.out) for r in reqs)
        med = float(np.median(tick_ms))
        report[tag] = {
            "config": desc, "requests": len(reqs),
            "prompt_tokens": sum(lens), "new_tokens": toks,
            "decode_tick_ms_median": med, "ticks": len(tick_ms),
            "tokens_per_s": toks / wall, "wall_s": wall,
            "peak_mem_gib": peak, "packed_weight_bytes": packed_nbytes(eng.p),
            "kv_bytes_per_token": kv_bytes_per_token(cfg.n_kv, cfg.hd,
                                                     cfg.n_layers, kv_bits),
            "launches": counts, "launches_per_full_tick": per_tick,
            "unpack_nibbles_calls": unpacks[0],
            "logits_vs_cpu": logits}
        print(f"[slice] ({tag}) {desc}: {len(reqs)} requests, prompts "
              f"{min(lens)}-{max(lens)} tokens, {toks} new tokens in "
              f"{wall:.2f} s = {toks / wall:.1f} tok/s; decode tick median "
              f"{med:.2f} ms over {len(tick_ms)} ticks; peak memory "
              f"{peak:.2f} GiB; packed weights "
              f"{report[tag]['packed_weight_bytes'] / 1e6:.1f} MB; KV "
              f"{report[tag]['kv_bytes_per_token']} B/token; launches "
              f"{counts}; per full tick {per_tick}; Engine == generate() "
              f"on requests 0 and {len(reqs) - 1}", flush=True)
        del eng
    # profiled only now, after every timed run
    for tag, desc, pl, kv_bits in configs:
        ops, busy, grids, names = _profile_full_tick(
            Engine, Request, TransformerLM, params, qstate, cfg, pl, kv_bits,
            prompts, dev)
        stray = _store_ops(names)
        check(not stray, f"({tag}) the profiled tick holds operations of a "
                         f"KV store outside its kernel: {stray}")
        med = report[tag]["decode_tick_ms_median"]
        blocks = sorted({math.prod(gr) for gr in grids})
        check(len(grids) == cfg.n_layers and min(blocks) >= 128,
              f"({tag}) the profiled tick's kv_attention_rows launches: "
              f"{len(grids)} of {cfg.n_layers}, blocks {blocks}, fewer than "
              f"128")
        report[tag]["profiled_full_tick"] = {
            "device_ops": ops, "device_busy_ms": busy,
            "idle_share_of_median_tick": 1.0 - busy / med,
            "attention_grids": sorted(set(grids)),
            "kv_store_kernels": sum(n for k, n in names.items()
                                    if "kv_store_kernel" in k),
            "stack_index_put_bitwise_ops": stray}
        print(f"[slice] ({tag}) profiled full tick: {ops} device operations, "
              f"device busy {busy:.2f} ms, idle {1.0 - busy / med:.1%} of the "
              f"median tick; kv_attention_rows grids {sorted(set(grids))}",
              flush=True)
    return total, report, tick_shapes_a


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

QUICKSTART = dict(steps=300, lr=3e-3, beta0=1e-6, beta1=1e-3, gamma=2e-6)
# launches of one jet-tagger step: the 8 weight and bias quantizers' forward
# in one grouped launch, the 4 activation quantizers' one launch each, and
# one backward launch a quantizer
HGQ_PER_STEP = {"hgq_quantize_fwd": 4, "hgq_quantize_fwd_group": 1,
                "hgq_quantize_bwd": 12}
# the layouts each of them takes
HGQ_LAYOUTS = {"hgq_quantize_fwd": {"per_tensor", "per_channel"},
               "hgq_quantize_fwd_group": {"per_parameter"},
               "hgq_quantize_bwd": {"per_tensor", "per_channel",
                                    "per_parameter"}}


def _layouts(name, key):
    """The layouts of one tally key: a member's, or a group's members'."""
    return {m[0] for m in key} if name == "hgq_quantize_fwd_group" \
        else {key[0]}
# The card's loss and ~EBOPs against the CPU's, at every one of 20 steps.
# The forward lands on exact grids on both, so only the backward's
# summation order differs.  The limit lies between that sound reading and
# two faulty controls, which the check must catch (readings in PERF.md).
# The loss alone misses a backward that drops a partial sum: the bitwidths
# it misleads move ~EBOPs at once but cross no rounding point in 20 steps.
TRAJ_REL_LIMIT = 1e-5


def _jet():
    from repro_torch.models import JetTagger
    from repro_torch.nn import HGQConfig
    from repro_torch.train import softmax_xent
    cfg = HGQConfig(weight_gran="per_parameter", act_gran="per_parameter",
                    init_weight_f=2.0, init_act_f=2.0)
    fwd = lambda p, q, b, mode: JetTagger.forward(p, q, b, mode)
    loss = lambda out, b: softmax_xent(out, b["y"])
    return JetTagger, cfg, fwd, loss


def _quickstart(dev):
    """examples/quickstart.py's configuration through the port's
    ``Trainer.run`` on the card, then a CALIB pass on a held-out batch
    and the fixed-point proxy."""
    from repro_torch.core import hgq
    from repro_torch.core.calibrate import (assert_no_overflow,
                                            fixed_spec_from_range)
    from repro_torch.data import DataSpec, make_pipeline
    from repro_torch.train import TrainConfig, Trainer, accuracy
    JetTagger, cfg, fwd, loss = _jet()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params, qstate = JetTagger.init(gen, cfg, device=dev)
    widths = [tuple(params[f"d{i}"]["kernel"]["w"].shape) for i in range(4)]
    check(widths == [(16, 64), (64, 32), (32, 32), (32, 5)],
          f"not the JetTagger 16-64-32-32-5: {widths}")
    pipe = make_pipeline(DataSpec(kind="jet", batch=1024), device=dev)
    starts = []

    def timed_pipe(step):
        # a step runs from one batch request to the next
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return pipe(step)

    tcfg = TrainConfig(log_every=50, **QUICKSTART)
    trainer = Trainer(fwd, loss, tcfg, params, qstate, pipeline=timed_pipe)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_counts()                           # the main path starts here
    t0 = time.perf_counter()
    trainer.run(log=lambda line: print(f"[train] {line}", flush=True))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = _counts(TRAINING)                # ... and ends here
    shapes = _shapes(TRAINING)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = tcfg.steps
    step_ms = np.diff(starts + [t1]) * 1e3
    per_step = {}
    for name, by_shape in shapes.items():
        check(all(c % steps == 0 for c in by_shape.values()),
              f"{name}: launches not a multiple of the steps: {by_shape}")
        per_step[name] = collections.Counter(
            {k: c // steps for k, c in by_shape.items()})
        n = sum(per_step[name].values())
        check(n == HGQ_PER_STEP[name],
              f"{name}: {n} launches a step, not {HGQ_PER_STEP[name]}: "
              f"{dict(per_step[name])}")
        lays = set().union(*(_layouts(name, k) for k in per_step[name]))
        check(lays == HGQ_LAYOUTS[name],
              f"{name}: layouts on the path {lays}")
    with torch.no_grad():
        batch = pipe(10 ** 6)                 # held out
        logits, qcal, aux = JetTagger.forward(trainer.params, trainer.qstate,
                                              batch, mode=hgq.CALIB)
        acc = float(accuracy(logits, batch["y"]))
        ebops = float(aux.ebops)
        f0 = trainer.params["d0"]["kernel"]["f"]
        spec = fixed_spec_from_range(qcal["inp"], trainer.params["inp_f"])
        fits = bool(assert_no_overflow(batch["x"], spec,
                                       trainer.params["inp_f"]))
        o1, _, _ = JetTagger.forward(trainer.params, qcal, batch,
                                     mode=hgq.EVAL)
        o2, _, _ = JetTagger.forward(trainer.params, qcal, batch,
                                     mode=hgq.EVAL)
    ebops0 = trainer.history[0]["ebops"]
    report = {
        "config": "examples/quickstart.py: JetTagger 16-64-32-32-5, "
                  "per-parameter weights and activations, init f 2, jet "
                  "batch 1024, 300 steps, lr 3e-3, beta 1e-6 -> 1e-3, "
                  "gamma 2e-6",
        "accuracy": acc, "calib_ebops": ebops, "step0_ebops": ebops0,
        "layer0_f": {"mean": float(f0.mean()), "min": float(f0.min()),
                     "max": float(f0.max())},
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "samples_per_s": steps * 1024 / (t1 - t0), "wall_s": t1 - t0,
        "peak_mem_gib": peak, "launches": counts,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items()},
        "proxy_input_fits": fits,
        "eval_repeatable": torch.equal(o1, o2)}
    print(f"[train] quickstart on the card: {json.dumps(report)}", flush=True)
    check(acc >= 0.99, f"quickstart accuracy {acc} < 0.99")
    check(ebops <= 1000.0, f"quickstart CALIB ~EBOPs {ebops} > 1000")
    check(report["layer0_f"]["mean"] < 2.0,
          f"layer-0 mean f {report['layer0_f']['mean']} >= 2")
    check(fits, "calibration input overflows its calibrated type")
    check(report["eval_repeatable"], "two EVAL forwards differ")
    check(counts == {k: n * steps for k, n in HGQ_PER_STEP.items()},
          f"launches {counts}, not {HGQ_PER_STEP} a step over {steps} steps")
    return trainer, report, per_step


def _trajectory(dev, params, qstate, batches, fwd=None, loss=None,
                config=QUICKSTART):
    """20 steps of ``config`` (the quickstart's by default, the jet
    tagger's forward and loss) on ``dev`` from the given init and batches:
    ([(loss, ~EBOPs)] per step, final params)."""
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_map
    if fwd is None:
        _, _, fwd, loss = _jet()
    to = lambda t: t.to(dev)
    tcfg = TrainConfig(log_every=1, **dict(config, steps=len(batches)))
    tr = Trainer(fwd, loss, tcfg, tree_map(to, params), tree_map(to, qstate),
                 pipeline=lambda s: tree_map(to, batches[s]))
    tr.run(log=lambda *a: None)
    return ([(h["loss"], h["ebops"]) for h in tr.history],
            tree_map(lambda t: t.cpu(), tr.params))


@contextlib.contextmanager
def _df_without_last_block():
    """Control: the per-channel and per-tensor backward drops the rows of
    its last block (a reduction that loses a block's partial sum; per
    tensor, every row that holds one of the last block's elements)."""
    import repro_torch.kernels.hgq_quantize.ops as ops
    real = ops.hgq_quantize_bwd

    def dropped(g, x, f):
        if f.shape == x.shape:
            return real(g, x, f)
        cols = x.shape[-1]
        rows = x.numel() // cols
        lay = "per_channel" if f.ndim else "per_tensor"
        (_, _, span), _ = ops.bwd_plan(rows, cols, lay, x.dtype)
        units = rows if f.ndim else rows * cols
        start = (units - 1) // span * span       # the last block's first
        keep = start if f.ndim else start // cols
        return real(g.reshape(rows, cols)[:keep].contiguous(),
                    x.reshape(rows, cols)[:keep].contiguous(), f)

    # the wrapper counts its launches on the module's name: these land here
    dropped.launches, dropped.shapes = 0, collections.Counter()
    ops.hgq_quantize_bwd = dropped
    try:
        yield
    finally:
        ops.hgq_quantize_bwd = real


@contextlib.contextmanager
def _rounding_down():
    """Control: the forward rounds f with floor(f), not floor(f + 1/2)
    (single and grouped quantizers)."""
    import repro_torch.core.hgq as hgq_mod
    real, real_group = hgq_mod.quantize, hgq_mod.quantize_group
    hgq_mod.quantize = lambda x, f: real(x, f - 0.5)
    hgq_mod.quantize_group = lambda xs, fs: real_group(
        xs, [f - 0.5 for f in fs])
    try:
        yield
    finally:
        hgq_mod.quantize, hgq_mod.quantize_group = real, real_group


@contextlib.contextmanager
def _conv_tf32():
    """Control: the conv lets cuDNN run in TF32 (PyTorch's default for
    float32 convolutions), forward and backward."""
    from repro_torch.nn.basic import CUDNN_FLAGS
    real = CUDNN_FLAGS["allow_tf32"]
    CUDNN_FLAGS["allow_tf32"] = True
    try:
        yield
    finally:
        CUDNN_FLAGS["allow_tf32"] = real


@contextlib.contextmanager
def _df_without_ln2_delta():
    """Control: the backward drops its ``ln2 * delta`` term (df = 0 from
    the loss; f moves by the ~EBOPs and L1 terms alone)."""
    import repro_torch.kernels.hgq_quantize.ops as ops
    real = ops.hgq_quantize_bwd

    def zero(g, x, f):
        return torch.zeros_like(f)

    zero.launches, zero.shapes = 0, collections.Counter()
    ops.hgq_quantize_bwd = zero
    try:
        yield
    finally:
        ops.hgq_quantize_bwd = real


def _gaps(run, ref, ref_p):
    """A run's largest relative gaps to the reference in loss and ~EBOPs
    over the steps, and its largest |dparam| at the end."""
    from repro_torch.tree import tree_leaves
    hist, p = run
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    out = {"loss_rel": max(rel(h[0], r[0]) for h, r in zip(hist, ref)),
           "ebops_rel": max(rel(h[1], r[1]) for h, r in zip(hist, ref)),
           "param_abs": max(float((a - b).abs().max()) for a, b in zip(
               tree_leaves(p), tree_leaves(ref_p)))}
    out["gap"] = max(out["loss_rel"], out["ebops_rel"])
    return out


def _card_vs_cpu(dev, what, model, batches, controls, limit, traj_kw=None):
    """The 20-step trajectory on the card (kernels) and on the CPU (plain
    versions) from one init (``model``'s, on the CPU) and one set of
    batches, twice on the card, and under each faulty control: gaps in
    loss and ~EBOPs, largest |dparam|; the sound gap under ``limit``, every
    control's above it, the two card runs bit-identical."""
    from repro_torch.tree import tree_leaves
    traj_kw = traj_kw or {}
    cpu = torch.device("cpu")
    params, qstate = model
    ref, ref_p = _trajectory(cpu, params, qstate, batches, **traj_kw)
    card1 = _trajectory(dev, params, qstate, batches, **traj_kw)
    card2 = _trajectory(dev, params, qstate, batches, **traj_kw)
    same = card1[0] == card2[0] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(card1[1]),
                                          tree_leaves(card2[1])))
    faulty = {}
    for name, control in controls.items():
        with control():
            faulty[name] = _gaps(_trajectory(dev, params, qstate, batches,
                                             **traj_kw), ref, ref_p)
    out = {"sound": _gaps(card1, ref, ref_p), "repeat_bit_identical": same,
           "controls": faulty, "cpu_final_loss": ref[-1][0]}
    print(f"[train] {what}: card vs CPU, {len(batches)} steps: "
          f"{json.dumps(out)} (limit on the larger relative gap of loss and "
          f"~EBOPs: {limit})", flush=True)
    check(same, f"{what}: two card runs of the {len(batches)} steps differ")
    check(out["sound"]["gap"] <= limit,
          f"{what}: card vs CPU trajectory gap {out['sound']}")
    check(all(c["gap"] > limit for c in faulty.values()),
          f"{what}: the trajectory check misses a control: {faulty}")
    return out


def _jet_card_vs_cpu(dev):
    from repro_torch.data import jet_batch
    JetTagger, cfg, _, _ = _jet()
    cpu = torch.device("cpu")
    model = JetTagger.init(torch.Generator().manual_seed(SEED + 1), cfg,
                           device=cpu)
    batches = [jet_batch(SEED, s, 1024, device=cpu) for s in range(20)]
    return _card_vs_cpu(dev, "quickstart", model, batches,
                        {"df_drops_last_block": _df_without_last_block,
                         "forward_fi_floor_f": _rounding_down},
                        TRAJ_REL_LIMIT)


def _bwd_kernels(grids, per_step, what):
    """Every per-channel and per-tensor backward of a profiled step was one
    device kernel, or two past the one-cluster line (clusters, then the
    second pass over their partials, ``hgq_quantize.ops.bwd_plan``): the
    trace holds that many ``hgq_bwd_*`` kernels."""
    from repro_torch.kernels.hgq_quantize.ops import bwd_plan
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    calls = passes = 0
    for (lay, shape, dt), n in per_step["hgq_quantize_bwd"].items():
        if lay == "per_parameter":
            continue
        cols = shape[-1] if shape else 1
        rows = math.prod(shape) // cols
        calls += n
        passes += n * (1 + (bwd_plan(rows, cols, lay, dtypes[dt])[1] > 0))
    check(len(grids) == passes,
          f"{what}: {len(grids)} hgq_bwd device kernels for {calls} "
          f"per-channel and per-tensor backward calls ({passes} expected)")
    return {"hgq_bwd_kernels": len(grids), "reducing_bwd_calls": calls,
            "hgq_bwd_grids": sorted(set(grids))}


def _profile_step(trainer, per_step, what, median_ms):
    """One step of ``trainer`` under the profiler, after every timed run:
    device operations, busy ms, idle share of the median step, and one
    grouped-forward kernel a forward launch, the backward's kernels."""
    step = trainer.tcfg.steps
    batch = trainer.pipeline(step)
    ops, busy, grids, names = _profiled(lambda: trainer.step_fn(
        trainer.params, trainer.qstate, trainer.opt, batch, step),
        grids_of="hgq_bwd")
    fwd_kernels = sum(n for k, n in names.items() if "hgq_fwd_group" in k)
    fwd_launches = sum(per_step["hgq_quantize_fwd"].values()) + sum(
        per_step["hgq_quantize_fwd_group"].values())
    check(fwd_kernels == fwd_launches,
          f"{what}: profiled step: {fwd_kernels} hgq_quantize forward "
          f"kernels for {fwd_launches} launches")
    out = {"device_ops": ops, "device_busy_ms": busy,
           "idle_share_of_median_step": 1.0 - busy / median_ms,
           "hgq_fwd_kernels": fwd_kernels,
           **_bwd_kernels(grids, per_step, f"{what}: profiled step")}
    print(f"[train] {what}: profiled step: {ops} device operations, device "
          f"busy {busy:.3f} ms, idle {out['idle_share_of_median_step']:.1%} "
          f"of the median step ({median_ms:.3f} ms); {len(grids)} hgq_bwd "
          f"kernels", flush=True)
    return out


# ---------------------------------------------------------------------------
# the paper's SVHN (Table II) and muon (Table III) models
# ---------------------------------------------------------------------------

# benchmarks/paper_tables.py's configurations (per-parameter weight f,
# per-tensor activation f, initial f 6); gamma is the Trainer's default
PAPER = {"svhn": dict(steps=120, lr=2e-3, beta0=1e-7, beta1=1e-4,
                      gamma=2e-6),
         "muon": dict(steps=500, lr=3e-3, beta0=3e-6, beta1=6e-4,
                      gamma=2e-6)}
PAPER_BATCH = {"svhn": 128, "muon": 1024}
# The JAX package at those configurations on the CPU, as
# benchmarks/paper_tables.py trains it (its own quantizer, init key 0, data
# seed 0; ``python tests/test_torch_tasks.py --reference``): SVHN accuracy
# 1.0 and CALIB ~EBOPs 367214.0, muon RMS resolution 11.471 mrad and CALIB
# ~EBOPs 89074.7.  The port draws its init and data from its own generators
# (the port on the CPU from seeds 0 and 1, ``--reference both --port``:
# accuracy 1.0 and 1.0, ~EBOPs 365280 and 363609; 12.67 and 12.14 mrad,
# ~EBOPs 95047 and 90942), so the card's run is held to margins: accuracy
# at least 1.0 - 0.02; the resolution, and each model's CALIB ~EBOPs,
# within 30% of the reference.
PAPER_REF = {"svhn": (1.0, 367214.0), "muon": (11.471, 89074.7)}
PAPER_ACC_MARGIN = 0.02
PAPER_REL_MARGIN = 0.3
# the card's 20 steps against the CPU's (readings in PERF.md)
PAPER_TRAJ_REL_LIMIT = {"svhn": 1e-5, "muon": 1e-5}


def _paper(name):
    """(model class, config, forward, loss, metric, data batch function)."""
    from repro_torch.data import muon_batch, svhn_batch
    from repro_torch.models import MuonTracker, SVHNNet
    from repro_torch.nn import HGQConfig
    from repro_torch.train import accuracy, mse, rms_resolution, softmax_xent
    cfg = HGQConfig(weight_gran="per_parameter", act_gran="per_tensor",
                    init_weight_f=6.0, init_act_f=6.0)
    if name == "svhn":
        return (SVHNNet, cfg, lambda p, q, b, mode: SVHNNet.forward(
            p, q, b, mode), lambda o, b: softmax_xent(o, b["y"]),
            lambda o, b: accuracy(o, b["y"]), svhn_batch)
    return (MuonTracker, cfg, lambda p, q, b, mode: MuonTracker.forward(
        p, q, b, mode), lambda o, b: mse(o, b["target"]) * 1e-3,
        lambda o, b: rms_resolution(o, b["target"]), muon_batch)


def _paper_per_step(name):
    """A step's ``hgq_quantize`` launches by shape, as the wrappers key
    them: each activation quantizer's forward, the 12 weights and biases
    in one grouped forward, one backward a quantizer."""
    acts = [("per_tensor", s, "float32") for s in PAPER_ACTS[name]]
    group = SVHN_GROUP if name == "svhn" else MUON_GROUP
    members = [("per_parameter", s, "float32") for s, _, _ in group]
    return {"hgq_quantize_fwd": collections.Counter(acts),
            "hgq_quantize_fwd_group": collections.Counter([tuple(members)]),
            "hgq_quantize_bwd": collections.Counter(acts + members)}


def _per_step(shapes, steps):
    """Launches by shape in one step, from a run's tallies."""
    out = {}
    for name, by_shape in shapes.items():
        check(all(c % steps == 0 for c in by_shape.values()),
              f"{name}: launches not a multiple of the steps: {by_shape}")
        out[name] = collections.Counter(
            {k: c // steps for k, c in by_shape.items()})
    return out


def _paper_run(dev, name):
    """The paper's configuration through the port's ``Trainer.run`` on the
    card, then a CALIB pass on a held-out batch, held to the JAX
    reference."""
    from repro_torch.core import hgq
    from repro_torch.data import DataSpec, make_pipeline
    from repro_torch.train import TrainConfig, Trainer
    M, cfg, fwd, loss, metric, _ = _paper(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params, qstate = M.init(gen, cfg, device=dev)
    pipe = make_pipeline(DataSpec(kind=name, batch=PAPER_BATCH[name]),
                         device=dev)
    starts = []

    def timed_pipe(step):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return pipe(step)

    tcfg = TrainConfig(log_every=10, **PAPER[name])
    trainer = Trainer(fwd, loss, tcfg, params, qstate, pipeline=timed_pipe)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_counts()                           # the main path starts here
    t0 = time.perf_counter()
    trainer.run(log=lambda line: print(f"[train] {name} {line}", flush=True))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = _counts(TRAINING)                # ... and ends here
    per_step = _per_step(_shapes(TRAINING), tcfg.steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = np.diff(starts + [t1]) * 1e3
    with torch.no_grad():
        batch = pipe(10 ** 6)                 # held out
        out, qcal, aux = M.forward(trainer.params, trainer.qstate, batch,
                                   mode=hgq.CALIB)
        value = float(metric(out, batch))
        ebops = float(aux.ebops)
        o1, _, _ = M.forward(trainer.params, qcal, batch, mode=hgq.EVAL)
        o2, _, _ = M.forward(trainer.params, qcal, batch, mode=hgq.EVAL)
    hist = {h["step"]: h["ebops"] for h in trainer.history}
    peak_step = max(hist, key=hist.get)
    last = max(hist)
    ref_value, ref_ebops = PAPER_REF[name]
    report = {
        "config": f"benchmarks/paper_tables.py {name}: batch "
                  f"{PAPER_BATCH[name]}, {PAPER[name]}, per-parameter "
                  f"weights, per-tensor activations, init f 6",
        "metric": ("accuracy" if name == "svhn" else "rms_resolution_mrad"),
        "value": value, "jax_cpu_reference": ref_value,
        "calib_ebops": ebops, "jax_cpu_calib_ebops": ref_ebops,
        "train_ebops": {"step0": hist[0], "peak": hist[peak_step],
                        "peak_step": peak_step, "last": hist[last],
                        "last_step": last},
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "samples_per_s": tcfg.steps * PAPER_BATCH[name] / (t1 - t0),
        "wall_s": t1 - t0, "peak_mem_gib": peak, "launches": counts,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items()},
        "eval_repeatable": torch.equal(o1, o2)}
    print(f"[train] {name} on the card: {json.dumps(report)}", flush=True)
    want = _paper_per_step(name)
    check(per_step == want,
          f"{name}: launches a step {per_step}, not {want}")
    check(counts == {k: sum(c.values()) * tcfg.steps
                     for k, c in want.items()},
          f"{name}: launches {counts} over {tcfg.steps} steps")
    if name == "svhn":
        check(value >= ref_value - PAPER_ACC_MARGIN,
              f"svhn accuracy {value} below the JAX reference {ref_value} "
              f"by more than {PAPER_ACC_MARGIN}")
    else:
        check(abs(value - ref_value) <= PAPER_REL_MARGIN * ref_value,
              f"muon resolution {value} mrad not within "
              f"{PAPER_REL_MARGIN:.0%} of the JAX reference {ref_value}")
    check(abs(ebops - ref_ebops) <= PAPER_REL_MARGIN * ref_ebops,
          f"{name}: CALIB ~EBOPs {ebops} not within {PAPER_REL_MARGIN:.0%} "
          f"of the JAX reference {ref_ebops}")
    # the beta ramp's pressure: ~EBOPs fall from step 0 (muon), or, where
    # the growing activation ranges first raise them (SVHN, as in the
    # reference), from their peak
    fell_from = 0 if name == "muon" else peak_step
    check(hist[last] < hist[fell_from] and peak_step < last,
          f"{name}: ~EBOPs did not fall: {report['train_ebops']}")
    check(report["eval_repeatable"], f"{name}: two EVAL forwards differ")
    return trainer, report, per_step


def _paper_card_vs_cpu(dev, name):
    M, cfg, fwd, loss, _, batch_fn = _paper(name)
    cpu = torch.device("cpu")
    model = M.init(torch.Generator().manual_seed(SEED + 1), cfg, device=cpu)
    batches = [batch_fn(SEED, s, PAPER_BATCH[name], device=cpu)
               for s in range(20)]
    controls = ({"conv_tf32": _conv_tf32,
                 "df_without_ln2_delta": _df_without_ln2_delta}
                if name == "svhn" else
                {"df_without_ln2_delta": _df_without_ln2_delta,
                 "forward_fi_floor_f": _rounding_down})
    return _card_vs_cpu(dev, name, model, batches, controls,
                        PAPER_TRAJ_REL_LIMIT[name],
                        dict(fwd=fwd, loss=loss, config=PAPER[name]))


def train_phase(dev):
    """The jet tagger (quickstart), then the SVHN and muon models; every
    step profiled after every timed run.  Returns the report and each
    model's launches a step by shape."""
    trainer, report, per_step = _quickstart(dev)
    report["card_vs_cpu"] = _jet_card_vs_cpu(dev)
    runs = {"jet": (trainer, report, per_step)}
    for name in ("svhn", "muon"):
        tr, rep, ps = _paper_run(dev, name)
        rep["card_vs_cpu"] = _paper_card_vs_cpu(dev, name)
        runs[name] = (tr, rep, ps)
        report[name] = rep
    # profiled only now, after every timed run
    for name, (tr, rep, ps) in runs.items():
        rep["profiled_step"] = _profile_step(
            tr, ps, "quickstart" if name == "jet" else name,
            rep["step_ms_median"])
    return report, {name: ps for name, (_, _, ps) in runs.items()}


# ---------------------------------------------------------------------------
# wire phase: data-parallel training over the compressed gradient wire
# ---------------------------------------------------------------------------

WIRE_N = 4                 # data shards of the LocalMesh on the one card
# The compressed quickstart (batch 1024 over 4 shards, mixed 4/8 plan)
# against the same code's uncompressed run from one init, after 300 steps
# and CALIB.  Limits from the CPU rehearsal (examples/torch_dp_quickstart.py
# --device cpu; readings in PERF.md).
DP_ACC_GAP = 0.005
DP_EBOPS_REL = 1.0
DP_F0_GAP = 0.15
# The card's 20 compressed steps against the CPU's plain path from one
# init, the larger relative gap of loss and ~EBOPs at any step.  The wire
# turns an ulp of a gradient sum that crosses a rounding point into a
# whole grid step of one element, so the gap is larger than the
# uncompressed step's; the limit lies between the sound reading and two
# faulty controls, which the check must catch (readings in PERF.md).
DP_TRAJ_REL_LIMIT = 1e-4
QWEN_PLAN = "examples/specs/plan_mixed_w4w8.json"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _dp_run(dev, params, qstate, batches, *, compressed=True, plan=None,
            steps=None, on_step=None):
    """The quickstart's configuration from the given init, over
    LocalMesh(WIRE_N) with reduce="compressed" (1D, fused) or the full
    reduce: ([(loss, ~EBOPs)] per step, params, qstate).  ``batches`` is a
    list or a step -> batch function."""
    from repro_torch.dist import EFState, LocalMesh, ef_wire_init
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.tree import tree_map
    _, _, fwd, loss = _jet()
    get = batches if callable(batches) else (lambda s: batches[s])
    steps = steps or len(batches)
    to = lambda t: t.to(dev)
    p, q = tree_map(to, params), tree_map(to, qstate)
    tcfg = TrainConfig(**dict(QUICKSTART, steps=steps))
    opt = adamw_init(p)
    if compressed:
        step_fn = make_train_step(fwd, loss, tcfg, reduce="compressed",
                                  mesh=LocalMesh(WIRE_N, dev),
                                  wire_widths=plan)
        ef = EFState(residual=ef_wire_init(p, WIRE_N))
    else:
        step_fn = make_train_step(fwd, loss, tcfg)
    hist = []
    for s in range(steps):
        b = tree_map(to, get(s))
        if on_step is not None:
            on_step(s)
        if compressed:
            p, q, opt, m, ef = step_fn(p, q, opt, b, s, ef)
        else:
            p, q, opt, m = step_fn(p, q, opt, b, s)
        hist.append((float(m["loss"]), float(m["ebops"])))
    _sync(dev)
    return hist, p, q


def _calib_report(dev, params, qstate, pipe):
    """CALIB on a held-out batch: accuracy, ~EBOPs, layer-0 f."""
    from repro_torch.core import hgq
    from repro_torch.train import accuracy
    JetTagger, _, _, _ = _jet()
    with torch.no_grad():
        batch = pipe(10 ** 6)
        logits, _, aux = JetTagger.forward(params, qstate, batch,
                                           mode=hgq.CALIB)
    f0 = params["d0"]["kernel"]["f"]
    return {"accuracy": float(accuracy(logits, batch["y"])),
            "calib_ebops": float(aux.ebops),
            "layer0_f": {"mean": float(f0.mean()), "min": float(f0.min()),
                         "max": float(f0.max())}}


@contextlib.contextmanager
def _no_phase2_feedback():
    """Control: the chunk owner drops the phase-2 shift remainder instead
    of keeping it in its residual (the requantize hands on a zero
    remainder)."""
    import repro_torch.dist.collectives as coll
    real = coll._phase2_requantize

    def dropped(chunk_sum, n, kind):
        q2, err = real(chunk_sum, n, kind)
        return q2, torch.zeros_like(err)

    coll._phase2_requantize = dropped
    try:
        yield
    finally:
        coll._phase2_requantize = real


@contextlib.contextmanager
def _finer_wire_grid():
    """Control: the wire quantizes on a grid one step finer than
    ``grid_scale`` (the largest values saturate)."""
    import repro_torch.kernels.wire_pack as wp
    real = wp.grid_scale
    wp.grid_scale = lambda amax, bits=8: real(amax, bits) * 0.5
    try:
        yield
    finally:
        wp.grid_scale = real


# the fused reduce's chunk layout built in PyTorch (F.pad) -- the bucket
# kernels make it index arithmetic, and no other op of the compressed step
# or the reduce pads
PAD_OP = "aten::constant_pad_nd"


@contextlib.contextmanager
def _counting_pads(calls):
    """Count in ``calls[0]`` every ``torch.nn.functional.pad`` call, on any
    thread: the LocalMesh ranks are threads, whose host operations the
    profiler records only with its all-threads option."""
    real = torch.nn.functional.pad
    lock = threading.Lock()

    def counted(*a, **k):
        with lock:
            calls[0] += 1
        return real(*a, **k)

    torch.nn.functional.pad = counted
    try:
        yield
    finally:
        torch.nn.functional.pad = real


def _profiled_without_pads(fn, what, **kw):
    """``_profiled(fn, all_threads=True, **kw)``, checked to have run no
    ``F.pad`` call and no ``aten::constant_pad_nd`` event; also returns
    whether the trace holds the ranks' host operations."""
    pads = [0]
    with _counting_pads(pads):
        ops, busy, grids, names = _profiled(fn, all_threads=True, **kw)
    check(pads[0] == 0 and names.get(PAD_OP, 0) == 0,
          f"{what} ran {pads[0]} F.pad calls, {names.get(PAD_OP, 0)} "
          f"{PAD_OP} events")
    return ops, busy, grids, names, _all_threads_config() is not None


def _dp_jet(dev):
    """(a): the quickstart over LocalMesh(4) with the compressed wire and
    the mixed plan, against the same code uncompressed from one init;
    then 20 steps on the card against the CPU, twice on the card, and
    with two faulty controls."""
    from repro_torch.core.plan import mixed_low_plan
    from repro_torch.data import DataSpec, jet_batch, make_pipeline
    from repro_torch.tree import tree_leaves, tree_map
    JetTagger, cfg, _, _ = _jet()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params, qstate = JetTagger.init(gen, cfg, device=dev)
    plan = mixed_low_plan(params, 4)
    widths = sorted({(k, e.wire_bits) for k, e in plan.layers.items()})
    check([w for _, w in widths] == [4] * 4, f"mixed plan {widths}")
    pipe = make_pipeline(DataSpec(kind="jet", batch=1024), device=dev)
    steps = QUICKSTART["steps"]
    starts = []

    def on_step(s):
        # a step runs from one batch request to the next
        _sync(dev)
        starts.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    _reset_counts()                           # the main path starts here
    hist_c, p_c, q_c = _dp_run(dev, params, qstate, pipe, plan=plan,
                               steps=steps, on_step=on_step)
    t1 = time.perf_counter()
    counts = _counts(TRAINING + WIRE)         # ... and ends here
    shapes = _shapes(TRAINING + WIRE)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {}
    for name, by_shape in shapes.items():
        check(all(c % steps == 0 for c in by_shape.values()),
              f"{name}: launches not a multiple of the steps: {by_shape}")
        per_step[name] = collections.Counter(
            {k: c // steps for k, c in by_shape.items()})
    for name in TRAINING:
        n = sum(per_step[name].values())
        check(n == HGQ_PER_STEP[name] * WIRE_N,
              f"{name}: {n} launches a step, not "
              f"{HGQ_PER_STEP[name] * WIRE_N}")
    for name in FUSED_WIRE:
        check(counts[name] > 0, f"{name} was never launched: {counts}")
    for name in ("wire_quantize_rows",) + RETIRED_WIRE:
        check(counts[name] == 0, f"the fused path launched {name}: {counts}")
    # one bucket a width (4 and 8 bits) on each of the ranks, one launch of
    # each bucket kernel a bucket a rank
    for name in ("wire_quantize_bucket", "wire_dequant_bucket"):
        n = sum(per_step[name].values())
        check(n == 2 * WIRE_N, f"{name}: {n} launches a step, not "
                               f"{2 * WIRE_N}")
    step_ms = np.diff(starts + [t1]) * 1e3
    rep_c = _calib_report(dev, p_c, q_c, pipe)
    hist_u, p_u, q_u = _dp_run(dev, params, qstate, pipe, compressed=False,
                               steps=steps)
    rep_u = _calib_report(dev, p_u, q_u, pipe)
    gaps = {"accuracy": abs(rep_c["accuracy"] - rep_u["accuracy"]),
            "calib_ebops_rel": abs(rep_c["calib_ebops"] - rep_u["calib_ebops"])
            / rep_u["calib_ebops"],
            "layer0_f_mean": abs(rep_c["layer0_f"]["mean"]
                                 - rep_u["layer0_f"]["mean"])}
    report = {
        "config": f"examples/quickstart.py's jet tagger and schedule, batch "
                  f"1024 over LocalMesh({WIRE_N}) (256 a shard), "
                  f"reduce='compressed', 1D, fused, int8 wire with "
                  f"mixed_low_plan(params, 4) (the four kernels' w and f at "
                  f"4 bits, the rest at 8)",
        "compressed": {**rep_c, "final_loss": hist_c[-1][0]},
        "uncompressed": {**rep_u, "final_loss": hist_u[-1][0]},
        "gaps": gaps, "limits": {"accuracy": DP_ACC_GAP,
                                 "calib_ebops_rel": DP_EBOPS_REL,
                                 "layer0_f_mean": DP_F0_GAP},
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "samples_per_s": steps * 1024 / (t1 - starts[0]),
        "peak_mem_gib": peak, "launches": counts,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items()}}
    print(f"[wire] (a) jet tagger over the compressed wire: "
          f"{json.dumps(report)}", flush=True)
    check(rep_c["accuracy"] >= 0.99, f"compressed accuracy {rep_c}")
    check(rep_c["calib_ebops"] <= 1000.0, f"compressed ~EBOPs {rep_c}")
    check(rep_c["layer0_f"]["mean"] < 2.0, f"compressed layer-0 f {rep_c}")
    check(gaps["accuracy"] <= DP_ACC_GAP
          and gaps["calib_ebops_rel"] <= DP_EBOPS_REL
          and gaps["layer0_f_mean"] <= DP_F0_GAP,
          f"compressed vs uncompressed beyond the limits: {gaps}")

    # 20 steps: card against the CPU's plain path, twice on the card, and
    # the controls on the card
    cpu = torch.device("cpu")
    p0, q0 = JetTagger.init(torch.Generator().manual_seed(SEED + 1), cfg,
                            device=cpu)
    plan0 = mixed_low_plan(p0, 4)
    batches = [jet_batch(SEED, s, 1024, device=cpu) for s in range(20)]
    ref, ref_p, _ = _dp_run(cpu, p0, q0, batches, plan=plan0)

    def gap(run):
        hist, p, _ = run
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
        out = {"loss_rel": max(rel(h[0], r[0]) for h, r in zip(hist, ref)),
               "ebops_rel": max(rel(h[1], r[1]) for h, r in zip(hist, ref)),
               "param_abs": max(float((a.cpu() - b).abs().max()) for a, b in
                                zip(tree_leaves(p), tree_leaves(ref_p)))}
        out["gap"] = max(out["loss_rel"], out["ebops_rel"])
        return out

    card1 = _dp_run(dev, p0, q0, batches, plan=plan0)
    card2 = _dp_run(dev, p0, q0, batches, plan=plan0)
    same = card1[0] == card2[0] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(card1[1]),
                                          tree_leaves(card2[1])))
    with _no_phase2_feedback():
        no_ef = _dp_run(dev, p0, q0, batches, plan=plan0)
    with _finer_wire_grid():
        finer = _dp_run(dev, p0, q0, batches, plan=plan0)
    traj = {"sound": gap(card1), "repeat_bit_identical": same,
            "controls": {"no_phase2_error_feedback": gap(no_ef),
                         "wire_grid_one_step_finer": gap(finer)},
            "cpu_final_loss": ref[-1][0]}
    print(f"[wire] (a) card vs CPU, 20 compressed steps: {json.dumps(traj)} "
          f"(limit on the larger relative gap of loss and ~EBOPs: "
          f"{DP_TRAJ_REL_LIMIT})", flush=True)
    check(same, "two card runs of the 20 compressed steps differ")
    check(traj["sound"]["gap"] <= DP_TRAJ_REL_LIMIT,
          f"card vs CPU compressed trajectory gap {traj['sound']}")
    check(all(c["gap"] > DP_TRAJ_REL_LIMIT
              for c in traj["controls"].values()),
          f"the trajectory check misses a control: {traj['controls']}")
    report["card_vs_cpu"] = traj
    report["step_breakdown"] = _step_breakdown(dev, p_c, q_c, plan,
                                               pipe(steps))
    print(f"[wire] (a) step breakdown: "
          f"{json.dumps(report['step_breakdown'])}", flush=True)
    # profiled only now, after every timed run
    b = pipe(steps)
    step_fn = _profile_step_fn(dev, p_c, q_c, plan)
    ops, busy, grids, names, threads = _profiled_without_pads(
        lambda: step_fn(b), "the profiled compressed step",
        grids_of="hgq_bwd")
    med = report["step_ms_median"]
    report["profiled_step"] = {"device_ops": ops, "device_busy_ms": busy,
                               "idle_share_of_median_step": 1.0 - busy / med,
                               **_bwd_kernels(grids, per_step,
                                              "profiled compressed step"),
                               "host_ops_of_every_thread": threads,
                               "events_by_name": dict(names.most_common())}
    print(f"[wire] (a) profiled compressed step: {ops} device operations, "
          f"device busy {busy:.3f} ms, idle {1.0 - busy / med:.1%} of the "
          f"median step ({med:.3f} ms); {len(grids)} hgq_bwd kernels, one a "
          f"reducing backward; events by name: "
          f"{json.dumps(dict(names.most_common()))}", flush=True)
    return report, counts, per_step


def _host_ms(fn, dev, k=10):
    """Median host milliseconds of ``fn()``, synchronized, after one
    warm-up call."""
    fn()
    out = []
    for _ in range(k):
        _sync(dev)
        t = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def _step_breakdown(dev, params, qstate, plan, batch):
    """Where a compressed step's time goes: the four slices' forward and
    backward, the wire reduce of their gradients on LocalMesh(4), and the
    same reduce by the collective-free simulator (the same arithmetic in
    one thread)."""
    from repro_torch.dist import LocalMesh, ef_wire_pmean, simulate_wire_pmean
    from repro_torch.train import TrainConfig
    from repro_torch.train.loop import _value_and_grad
    from repro_torch.tree import tree_map
    _, _, fwd, loss = _jet()
    tcfg = TrainConfig(**QUICKSTART)
    mesh = LocalMesh(WIRE_N, dev)
    slices = [tree_map(lambda b, i=i: b.reshape(
        (WIRE_N, -1) + tuple(b.shape[1:]))[i], batch) for i in range(WIRE_N)]
    beta = torch.tensor(1e-4)

    def grads():
        return [_value_and_grad(fwd, loss, tcfg, params, qstate, sl,
                                beta)[4] for sl in slices]

    e = tree_map(lambda *xs: torch.stack(xs), *grads())
    widths = plan.wire_bits_tree(params)
    wire = lambda: ef_wire_pmean(e, mesh, "int8", widths=widths)
    return {"slices_fwd_bwd_ms": _host_ms(grads, dev),
            "wire_reduce_ms": _host_ms(wire, dev),
            "simulate_ms": _host_ms(lambda: simulate_wire_pmean(
                e, "int8", widths=widths), dev)}


def _profile_step_fn(dev, params, qstate, plan):
    """One compressed step from the trained state (a fresh residual)."""
    from repro_torch.dist import EFState, LocalMesh, ef_wire_init
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    _, _, fwd, loss = _jet()
    step_fn = make_train_step(fwd, loss, TrainConfig(**QUICKSTART),
                              reduce="compressed",
                              mesh=LocalMesh(WIRE_N, dev), wire_widths=plan)
    opt = adamw_init(params)
    ef = EFState(residual=ef_wire_init(params, WIRE_N))
    return lambda b: step_fn(params, qstate, opt, b, QUICKSTART["steps"], ef)


def _qwen2_grads(dev):
    """Per-shard gradients of qwen2-0.5b's full-width tree: the leaves of
    ``TransformerLM.init`` with a leading [4] shard axis, seeded normal
    values, a scale per leaf (1e-4 .. 1e-1) and, for stacked leaves, per
    layer (x 1/8 .. 8)."""
    from repro_torch.configs import get
    from repro_torch.dist import stacked_tree
    from repro_torch.models import TransformerLM
    from repro_torch.tree import tree_leaves, tree_unflatten
    cfg = get("qwen2-0.5b")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab)
          == (24, 896, 4864, 151936), "not qwen2-0.5b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params, _ = TransformerLM.init(gen, cfg, device=dev)
    flags = tree_leaves(stacked_tree(params))
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    leaves = []
    for i, (leaf, st) in enumerate(zip(tree_leaves(params), flags)):
        x = torch.randn((WIRE_N,) + tuple(leaf.shape), generator=g,
                        device=dev)
        x *= 10.0 ** (-4 + (i * 7) % 4)
        if st and leaf.ndim >= 3:
            x *= torch.logspace(-3, 3, leaf.shape[0], base=2.0, device=dev
                                ).reshape((1, -1) + (1,) * (leaf.ndim - 1))
        leaves.append(x)
    tree = tree_unflatten(params, leaves)
    del params
    return tree


def _equal_trees(a, b):
    from repro_torch.tree import tree_leaves
    return all(torch.equal(_wbits(x), _wbits(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _dp_qwen2(dev):
    """(b): the compressed reduce of qwen2-0.5b's gradient tree over
    LocalMesh(4), uniform int8 and plan_mixed_w4w8: fused == per-leaf ==
    simulate on the card, the card == the CPU on the embedding and a
    stacked MLP leaf, recorded bytes == the byte model, times, memory."""
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.dist import (LocalMesh, ef_wire_pmean,
                                  record_wire_bytes, simulate_wire_pmean)
    from repro_torch.dist import collectives as coll
    from repro_torch.tree import tree_flatten_with_path, tree_leaves
    t0 = time.perf_counter()
    tree = _qwen2_grads(dev)
    _sync(dev)
    n_elem = sum(x[0].numel() for x in tree_leaves(tree))
    print(f"[wire] (b) qwen2-0.5b gradient tree: {len(tree_leaves(tree))} "
          f"leaves, {n_elem} elements a shard, x{WIRE_N} shards, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mesh = LocalMesh(WIRE_N, dev)
    plan = PrecisionPlan.from_file(str(ROOT / QWEN_PLAN))
    configs = (("int8", None), ("mixed_w4w8", plan.wire_bits_tree(tree)))
    report, units = {}, {}
    torch.cuda.reset_peak_memory_stats()
    phase_peak = 0                            # over the phase, in bytes
    _sync(dev)
    _reset_counts()                           # the main path starts here
    for tag, widths in configs:
        flags = coll._stacked_flags(tree, None)
        wflags = coll._width_flags(tree, widths)
        want = sum(coll.wire_bytes_model(
            x[0].numel(), WIRE_N, "int8",
            n_scale_rows=x.shape[1] if (st and x.ndim >= 4) else 1, bits=w)
            for x, st, w in zip(tree_leaves(tree), flags, wflags))
        times = []
        # the fused reduce's own peak: the timed calls alone (the tree, and
        # the previous call's outputs while the next runs)
        _sync(dev)
        phase_peak = max(phase_peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        for i in range(3):
            before = _shapes(WIRE)
            _sync(dev)
            t = time.perf_counter()
            with record_wire_bytes() as rec:
                d_f, r_f = ef_wire_pmean(tree, mesh, "int8", widths=widths)
            _sync(dev)
            times.append((time.perf_counter() - t) * 1e3)
            after = _shapes(WIRE)
            if i == 0:
                fused_unit = {k: after[k] - before[k] for k in after}
            check(abs(rec.total() - want) <= 1e-9 * want,
                  f"({tag}) recorded {rec.total()} B, model {want} B")
        fused_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        before = _shapes(WIRE)
        d_l, r_l = ef_wire_pmean(tree, mesh, "int8", widths=widths,
                                 fused=False)
        _sync(dev)
        after = _shapes(WIRE)
        leaf_unit = {k: after[k] - before[k] for k in after}
        same_leaf = _equal_trees(d_f, d_l) and _equal_trees(r_f, r_l)
        del d_l, r_l
        d_s, r_s = simulate_wire_pmean(tree, "int8", widths=widths)
        same_sim = _equal_trees(d_f, d_s) and _equal_trees(r_f, r_s)
        del d_s, r_s
        # the CPU's plain path on the embedding and a stacked MLP leaf
        keep = ("embed/table/w", "layers/mlp/down/kernel/w")
        sub = {"embed": {"table": {"w": tree["embed"]["table"]["w"].cpu()}},
               "layers": {"mlp": {"down": {"kernel": {
                   "w": tree["layers"]["mlp"]["down"]["kernel"]["w"].cpu()}}}}}
        sw = None if widths is None else plan.wire_bits_tree(sub)
        d_c, r_c = simulate_wire_pmean(sub, "int8", widths=sw)
        card = {"/".join(p): (d, r) for (p, d), (_, r) in zip(
            tree_flatten_with_path(d_f), tree_flatten_with_path(r_f))}
        cpu_same = all(
            torch.equal(_wbits(card[k][0].cpu()), _wbits(d))
            and torch.equal(_wbits(card[k][1].cpu()), _wbits(r))
            for k, (d, r) in zip(keep, zip(tree_leaves(d_c),
                                           tree_leaves(r_c))))
        # card holds the outputs too: none may outlive the next timed calls
        del d_c, r_c, sub, d_f, r_f, card
        report[tag] = {
            "reduce_ms_median": float(np.median(times)), "reduce_ms": times,
            "bytes_per_element": want / n_elem,
            "fp32_ring_bytes_per_element":
                coll.fp32_allreduce_bytes(n_elem, WIRE_N) / n_elem,
            "fused_peak_mem_gib": fused_peak,
            "fused_eq_per_leaf": same_leaf, "fused_eq_simulate": same_sim,
            "card_eq_cpu_on": list(keep) if cpu_same else [],
            "launches_fused": {k: sum(v.values())
                               for k, v in fused_unit.items()},
            "launches_per_leaf": {k: sum(v.values())
                                  for k, v in leaf_unit.items()}}
        units[tag] = (fused_unit, leaf_unit)
        print(f"[wire] (b) qwen2-0.5b reduce ({tag}): "
              f"{json.dumps(report[tag])}", flush=True)
        check(same_leaf, f"({tag}) fused != per-leaf on the card")
        check(same_sim, f"({tag}) fused != simulate on the card")
        check(cpu_same, f"({tag}) card != CPU on {keep}")
    counts = _counts(WIRE)                    # ... and ends here
    peak = max(phase_peak, torch.cuda.max_memory_allocated()) / 2 ** 30
    check(all(counts[k] > 0 for k in FUSED_WIRE + ("wire_quantize_rows",)),
          f"(b) a wire kernel was never launched: {counts}")
    check(all(counts[k] == 0 for k in RETIRED_WIRE),
          f"(b) a per-position wire kernel was launched: {counts}")
    report["launches"] = counts
    report["peak_mem_gib"] = peak
    report["elements_per_shard"] = n_elem
    # profiled only now, after every timed run
    widths = configs[1][1]
    ops, busy, _, names, threads = _profiled_without_pads(
        lambda: ef_wire_pmean(tree, mesh, "int8", widths=widths),
        "the profiled mixed reduce")
    med = report["mixed_w4w8"]["reduce_ms_median"]
    report["profiled_mixed_reduce"] = {
        "device_ops": ops, "device_busy_ms": busy,
        "idle_share_of_median_reduce": 1.0 - busy / med,
        "host_ops_of_every_thread": threads,
        "events_by_name": dict(names.most_common())}
    print(f"[wire] (b) peak memory {peak:.2f} GiB over the phase, of the "
          f"fused reduce's timed calls "
          f"{report['mixed_w4w8']['fused_peak_mem_gib']:.2f} (mixed_w4w8), "
          f"{report['int8']['fused_peak_mem_gib']:.2f} (int8); profiled "
          f"mixed reduce: {ops} device operations, device busy {busy:.2f} "
          f"ms, idle {1.0 - busy / med:.1%} of the median reduce "
          f"({med:.2f} ms); events by name: "
          f"{json.dumps(dict(names.most_common()))}", flush=True)
    del tree
    return report, counts, units["mixed_w4w8"]


def _fshape(lay, shape):
    return {"per_tensor": (), "per_channel": shape[-1:],
            "per_parameter": shape}[lay]


def wire_phase(dev, cases):
    """(a) and (b), then every wire-kernel shape their main paths launched
    held against its plain version and timed.  Returns the report, the
    launches of both main paths and the per-unit tallies."""
    jet, counts_a, per_step = _dp_jet(dev)
    qwen, counts_b, (fused_unit, leaf_unit) = _dp_qwen2(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    for name in WIRE:
        for key in set(per_step[name]) | set(fused_unit[name]) \
                | set(leaf_unit[name]):
            if key not in cases[name]:
                cases[name][key] = wire_case(name, key, dev, g)
    # the slices' quantizer shapes (batch 256), where the train phase's
    # batch of 1024 did not time them
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for lay, shape, dt in set(per_step["hgq_quantize_fwd"]) \
            | set(per_step["hgq_quantize_bwd"]):
        key = (lay, shape, dt)
        if key in cases["hgq_quantize_fwd"] \
                and key in cases["hgq_quantize_bwd"]:
            continue
        _, fwd, bwd = hgq_quantize_case(shape, _fshape(lay, shape),
                                        dtypes[dt], dev, g)
        cases["hgq_quantize_fwd"][key] = fwd
        cases["hgq_quantize_bwd"][key] = bwd
    for key in per_step["hgq_quantize_fwd_group"]:
        if key not in cases["hgq_quantize_fwd_group"]:
            members = [(s, _fshape(lay, s), dtypes[dt]) for lay, s, dt in key]
            cases["hgq_quantize_fwd_group"][key] = hgq_group_case(
                members, dev, g)[1]
    print_cases(cases, WIRE + TRAINING)
    launches = collections.Counter(counts_a) + collections.Counter(counts_b)
    per_a = ("one compressed data-parallel step of the jet tagger (batch "
             "1024 over 4 shards, mixed plan), calls by shape as counted on "
             "the main path")
    per_b = ("one qwen2-0.5b gradient reduce over 4 shards (plan_mixed_w4w8)"
             ", {} path, calls by shape as counted on the main path")
    tallies = {k: [(per_step[k], per_a + " (4 slices)")] for k in TRAINING}
    for k in FUSED_WIRE:
        tallies[k] = [(per_step[k], per_a), (fused_unit[k],
                                             per_b.format("fused"))]
    tallies["wire_quantize_rows"] = [(leaf_unit["wire_quantize_rows"],
                                      per_b.format("per-leaf"))]
    return {"jet": jet, "qwen2": qwen}, dict(launches), tallies


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "train", "wire"),
                    default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script ({src})",
              file=sys.stderr)
        return 1
    # cuBLAS picks a deterministic workspace before its first handle, so a
    # repeated training run is bit-identical
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(src))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(smi, flush=True)
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {json.dumps(built)}; all in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        print(f"[build] {name} ptxas:\n{_build.ptxas_report(name)}",
              flush=True)

    cases = kernel_phase(dev)
    tallies = collections.defaultdict(list)
    launches = collections.Counter()
    slice_report = train_report = wire_report = None
    if args.phase == "all":
        total, slice_report, tick_shapes = slice_phase(dev, cases)
        launches.update(total)
        per = ("one full decode tick of serving configuration (a), calls by "
               "shape as counted on the main path")
        for k in SERVING:
            tallies[k].append((tick_shapes[k], per))
    if args.phase in ("all", "train"):
        train_report, per_step = train_phase(dev)
        units = {"jet": "one training step of the quickstart jet tagger",
                 "svhn": "one svhn step: a training step of SVHNNet at the "
                         "paper's configuration (batch 128)",
                 "muon": "one muon step: a training step of MuonTracker at "
                         "the paper's configuration (batch 1024)"}
        for name, unit in units.items():
            rep = train_report if name == "jet" else train_report[name]
            launches.update(rep["launches"])
            for k in TRAINING:
                tallies[k].append((per_step[name][k], unit + ", calls by "
                                   "shape as counted on the main path"))
    if args.phase in ("all", "wire"):
        wire_report, wire_launches, wire_tallies = wire_phase(dev, cases)
        launches.update(wire_launches)
        for k, units in wire_tallies.items():
            tallies[k].extend(units)
    kernels = kernels_line(cases, tallies)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    ported = {KERNELS[k["name"]][1] for k in kernels}
    still = [{"name": n, "replaces": r} for n, r in TPU_KERNELS
             if n not in ported]
    check(not still, f"TPU kernels without a counterpart: {still}")
    print(json.dumps({
        "kernels": kernels,
        "still_to_port": still,
        "slice": slice_report, "train": train_report,
        "wire": wire_report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
