#!/usr/bin/env python3
"""Drive the PyTorch port of HGQ (serving and training) on one CUDA card.

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
   times the kernel, the plain version and a one-call library yardstick
   (where one exists) with CUDA events, beside the least time the card
   could take;
4. slice phase: serves qwen2-0.5b at full width (random weights from a
   seed) through the port's ``Engine`` in two configurations, holds the
   tokens against ``generate()`` and the logits against the CPU's plain
   path (a limit that two faulty controls must exceed), checks that every
   serving kernel's launch counter moved, and tallies one full tick's
   launches by shape; only after every timed run is one full tick per
   configuration traced with ``torch.profiler``;
5. train phase: trains the paper's jet tagger at its full width with
   ``examples/quickstart.py``'s configuration through the port's
   ``Trainer.run`` (300 steps, batch 1024), calibrates it on a held-out
   batch and checks accuracy, ~EBOPs, layer-0 bits and the fixed-point
   proxy; tallies one step's ``hgq_quantize`` launches by shape; runs 20
   steps on the card and on the CPU from one init (a limit that two faulty
   controls must exceed) and twice on the card (bit-identical); then
   traces one step with ``torch.profiler``;
6. prints one JSON line with every kernel's numbers, its times per unit
   of its main path (a full decode tick, a training step) weighted by
   those tallies, then, last, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.
``--phase kernels`` stops after step 3 (a short check of a changed
kernel) and leaves the per-unit fields null; ``--phase train`` skips
step 4.
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
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20241016

# NVIDIA H100 SXM data sheet: device memory rate and the float32 rate
# outside the tensor cores (every kernel here multiplies in float32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
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
    "kv_attention_rows": (_CSRC + "kv_dequant.cu", "kv_attention_rows"),
    "hgq_quantize_fwd": (_CSRC + "hgq_quantize.cu", "hgq_quantize_2d"),
    "hgq_quantize_bwd": (_CSRC + "hgq_quantize.cu", "hgq_quantize_2d"),
}
SERVING = ("qmatmul", "kv_quantize_rows", "kv_attention_rows")
TRAINING = ("hgq_quantize_fwd", "hgq_quantize_bwd")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def bound(nbytes: float, flops: float):
    """(least ms on the card, what bounds it) for moving ``nbytes`` and
    doing ``flops`` float32 operations."""
    tb, to = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def n_copies(nbytes: int) -> int:
    """Distinct argument sets a timed loop cycles through, so that it
    streams twice the L2 cache from device memory, as a decode tick
    streams every layer's weights and cache once."""
    return max(1, min(1024, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def time_ms(fn, arg_sets, min_calls: int = 64) -> float:
    """Device milliseconds per call of ``fn`` over ``arg_sets``, from CUDA
    events.  A sleep kernel queued first holds the device until every call
    is enqueued, so the events time the calls back to back and not the
    host's launch rate."""
    calls = max(min_calls, len(arg_sets))
    for args in arg_sets[:3]:
        fn(*args)                                   # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(host_s * 1.5 + 1e-3, 2.0) * 2e9))
    start.record()
    for i in range(calls):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def qmatmul_case(M, K, N, dev, g):
    """Kernel vs plain vs ``torch.matmul(x, w.float()) * scale`` for one
    shape, the weight stored N-major as the serving packer stores it."""
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_ref

    def make():
        x = torch.randn((M, K), generator=g, device=dev)
        w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int8)
        f = torch.randint(4, 9, (N,), generator=g, device=dev)
        s = torch.pow(2.0, -f.to(torch.float32))
        return x, w.T, s

    wbytes = K * N
    sets = [make() for _ in range(n_copies(wbytes))]
    x, w, s = sets[0]
    y = qmatmul(x, w, s)
    ref = qmatmul_ref(x, w, s)
    tol = 1e-5 * qmatmul_ref(x.abs(), w.abs(), s) + 1e-30
    err = (y - ref).abs()
    check(bool(torch.isfinite(y).all()), f"qmatmul {M}x{K}x{N}: not finite")
    check(bool((err <= tol).all()),
          f"qmatmul {M}x{K}x{N}: max err {float(err.max())} over "
          f"1e-5 * (|x| @ |w|) * scale")
    nbytes = M * K * 4 + wbytes + N * 4 + M * N * 4
    b_ms, b_by = bound(nbytes, 2.0 * M * K * N)

    def library(x, w, s):
        return torch.matmul(x, w.float()) * s

    return {"shape": f"M{M} K{K} N{N}",
            "max_abs_err": float(err.max()),
            "ms": time_ms(qmatmul, sets),
            "plain_ms": time_ms(qmatmul_ref, sets, 16),
            "library_ms": time_ms(library, sets, 16),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": 2.0 * M * K * N}


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


def kv_attention_case(B, S, W, nibble, pf, dev, g, H=14, KV=2, hd=64):
    """Kernel vs plain (and a ragged, windowed, partly empty ring for
    correctness only) vs SDPA over the dequantized cache as yardstick."""
    from repro_torch.kernels.kv_dequant import kv_attention_rows, kv_unpack
    from repro_torch.kernels.kv_dequant.ref import (attention_mask,
                                                    kv_attention_ref,
                                                    kv_dequant_ref)
    pft = torch.tensor([pf], dtype=torch.float32, device=dev)
    hdm = hd // 2 if nibble else hd
    what = f"kv_attention_rows B{B} S{S} W{W} {'nibble' if nibble else 'int8'}"

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
    err = _attention_check(kern(*args), plain(*args),
                           vmax_of(args[3], args[4]), pf, what)

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
    return {"shape": f"B{B} S{S} H{H} KV{KV} hd{hd} W{W} "
                     f"{'nibble' if nibble else 'int8'} probs_f{pf}",
            "max_abs_err": err,
            "ms": time_ms(kern, sets),
            "plain_ms": time_ms(plain, sets, 16),
            "library_ms": time_ms(
                lambda q, k, v, m: torch.nn.functional
                .scaled_dot_product_attention(q, k, v, attn_mask=m),
                lib_sets, 16),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}


# the quantizer's shapes: the training slice's own (the jet tagger's input
# quantizer per channel, weights and biases per parameter, outputs per
# tensor, batch 1024), a qwen2-0.5b layer (the MLP weight per channel, a
# prefill's activations per tensor) in float32 and bfloat16
HGQ_SHAPES = (
    [((1024, 16), (16,), torch.float32)]
    + [(s, s, torch.float32) for s in ((16, 64), (64, 32), (32, 32), (32, 5),
                                       (64,), (32,), (5,))]
    + [((1024, 64), (), torch.float32), ((1024, 32), (), torch.float32)]
    + [(s, f, dt) for dt in (torch.float32, torch.bfloat16)
       for s, f in (((896, 4864), (1, 4864)), ((8192, 896), ()))])
# rows of one partial sum of the backward kernel (csrc/hgq_quantize.cu):
# TILE_ROWS per channel, TILE_ELEMS / cols per tensor
HGQ_TILE_ROWS, HGQ_TILE_ELEMS = 32, 2048


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


def kernel_phase(dev):
    """Every kernel at its main path's shapes: {kernel: {shape key:
    case}}, keyed as the wrappers key their launch tallies."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    H, KV, hd, W = 14, 2, 64, 1024
    cases = {"qmatmul": {}, "kv_quantize_rows": {}, "kv_attention_rows": {},
             "hgq_quantize_fwd": {}, "hgq_quantize_bwd": {}}
    for M in (8, 16):
        # q, o; k, v; gate, up; down; the tied head
        for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896),
                     (896, 151936)):
            cases["qmatmul"][M, K, N] = qmatmul_case(M, K, N, dev, g)
    for R in (16, 32, 64):
        for bits in (8, 4):
            cases["kv_quantize_rows"][R, hd, bits] = kv_quantize_case(
                R, hd, bits, dev, g)
    for B, S in ((8, 1), (1, 16)):
        for nibble in (False, True):
            key = (B, S, H, KV, hd, W, hd // 2 if nibble else hd)
            cases["kv_attention_rows"][key] = kv_attention_case(
                B, S, W, nibble, 6.0, dev, g, H=H, KV=KV, hd=hd)
    for shape, fshape, dtype in HGQ_SHAPES:
        key, fwd, bwd = hgq_quantize_case(shape, fshape, dtype, dev, g)
        cases["hgq_quantize_fwd"][key] = fwd
        cases["hgq_quantize_bwd"][key] = bwd
    for name, by_shape in cases.items():
        print(f"[kernels] {name}: max err "
              f"{max(c['max_abs_err'] for c in by_shape.values()):.3g}",
              flush=True)
        for c in by_shape.values():
            lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
            print(f"    {c['shape']:<44} {c['ms']:.4f} ms  plain "
                  f"{c['plain_ms']:.4f}  library {lib}  bound "
                  f"{c['bound_ms']:.4f} ({c['bound_by']})", flush=True)
    return cases


def kernels_line(cases, tallies):
    """The ``kernels`` entries.  ``tallies`` maps a kernel to (its
    launches by shape in one unit of its main path -- a full decode tick
    of serving configuration (a), or a training step -- as the wrappers
    counted them, a description of that unit).  Each time is the unit's:
    per-call times weighted by those counts; every counted shape must have
    been timed.  A kernel without a tally (the kernel phase alone) has
    null per-unit fields."""
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
                             "at src/repro/kernels/hgq_quantize/ops.py:164")
        if name in tallies:
            unit, per = tallies[name]
            missing = [k for k in unit if k not in by_shape]
            check(not missing, f"{name}: the main path launched shapes the "
                               f"kernel phase did not time: {missing}")
            check(sum(unit.values()) > 0, f"{name}: not in the unit")
            for key in ("ms", "plain_ms"):
                entry[key] = sum(n * by_shape[k][key] for k, n in unit.items())
            if all(by_shape[k]["library_ms"] is not None for k in unit):
                entry["library_ms"] = sum(n * by_shape[k]["library_ms"]
                                          for k, n in unit.items())
            entry["bound_ms"], entry["bound_by"] = bound(
                sum(n * by_shape[k]["bytes"] for k, n in unit.items()),
                sum(n * by_shape[k]["flops"] for k, n in unit.items()))
            entry["per"] = per
            entry["calls_per_unit"] = {by_shape[k]["shape"]: n
                                       for k, n in unit.items()}
            print(f"[kernels] {name}: {per}: {sum(unit.values())} calls, "
                  f"{entry['ms']:.4f} ms (plain {entry['plain_ms']:.4f}, "
                  f"bound {entry['bound_ms']:.4f})", flush=True)
        entry["shapes"] = list(by_shape.values())
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_bwd,
                                                  hgq_quantize_fwd)
    from repro_torch.kernels.kv_dequant import (kv_attention_rows,
                                                kv_quantize_rows)
    from repro_torch.kernels.qmatmul import qmatmul
    return {"qmatmul": qmatmul, "kv_quantize_rows": kv_quantize_rows,
            "kv_attention_rows": kv_attention_rows,
            "hgq_quantize_fwd": hgq_quantize_fwd,
            "hgq_quantize_bwd": hgq_quantize_bwd}


def _counts(names):
    return {k: fn.launches for k, fn in _counters().items() if k in names}


def _shapes(names):
    return {k: collections.Counter(fn.shapes)
            for k, fn in _counters().items() if k in names}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0
        fn.shapes.clear()


def _profiled(fn):
    """``fn()`` under ``torch.profiler``: (device operations, ms the
    device was busy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(dev), sum(e.time_range.elapsed_us() for e in dev) / 1e3


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
    """Device operations and busy ms of one decode tick with all 8 slots
    busy, on an engine of its own, after every timed run: the profiler
    slows the host, and may go on doing so once it is stopped.  The
    attention kernel reads the whole ring whatever its fill, so short
    prompts give the same device work as the timed run's."""
    eng = Engine(model, params, qstate, cfg, batch_slots=8, max_len=1024,
                 prefill_chunk=16, packed=True, plan=pl, kv_bits=kv_bits,
                 seed=SEED, device=dev)
    for pr in prompts[:8]:
        check(eng.submit(Request(prompt=list(pr[:16]), max_new=4))
              is not None, "profile pass: no free slot")
    check(all(r is not None for r in eng.slot_req), "profile pass: idle slot")
    return _profiled(eng.step)


@contextlib.contextmanager
def _bf16_activations_into_qmatmul():
    """Control: every packed matmul takes its activations rounded to
    bfloat16, a subtly wrong product."""
    import repro_torch.models.lm as lm
    import repro_torch.nn.basic as basic
    real = basic.qmatmul_any

    def rounded(x, w, s):
        return real(x.to(torch.bfloat16).to(x.dtype), w, s)

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


def slice_phase(dev):
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
        _reset_counts()                       # the main path starts here
        t0 = time.perf_counter()
        tick_ms, tick_shapes = _serve(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(SERVING)             # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for k in total:
            total[k] += counts[k]
        check(all(c > 0 for c in counts.values()),
              f"({tag}) a kernel was never launched: {counts}")
        check(tick_shapes is not None, f"({tag}) no tick had every slot busy")
        per_tick = {k: sum(c.values()) for k, c in tick_shapes.items()}
        check(all(n > 0 for n in per_tick.values()),
              f"({tag}) a kernel was not launched in a full tick: {per_tick}")
        if tag == "a":
            tick_shapes_a = tick_shapes
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
        ops, busy = _profile_full_tick(Engine, Request, TransformerLM, params,
                                       qstate, cfg, pl, kv_bits, prompts, dev)
        med = report[tag]["decode_tick_ms_median"]
        report[tag]["profiled_full_tick"] = {
            "device_ops": ops, "device_busy_ms": busy,
            "idle_share_of_median_tick": 1.0 - busy / med}
        print(f"[slice] ({tag}) profiled full tick: {ops} device operations, "
              f"device busy {busy:.2f} ms, idle {1.0 - busy / med:.1%} of the "
              f"median tick", flush=True)
    return total, report, tick_shapes_a


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

QUICKSTART = dict(steps=300, lr=3e-3, beta0=1e-6, beta1=1e-3, gamma=2e-6)
HGQ_PER_STEP = 12          # quantizers of one jet-tagger step, each way
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
        check(n == HGQ_PER_STEP, f"{name}: {n} launches a step, not "
                                 f"{HGQ_PER_STEP}: {dict(per_step[name])}")
        lays = {k[0] for k in per_step[name]}
        check(lays == {"per_tensor", "per_channel", "per_parameter"},
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
    check(counts["hgq_quantize_fwd"] == counts["hgq_quantize_bwd"]
          == HGQ_PER_STEP * steps, f"launches {counts}")
    return trainer, report, per_step


def _trajectory(dev, params, qstate, batches):
    """20 steps of the quickstart's configuration on ``dev`` from the given
    init and batches: ([(loss, ~EBOPs)] per step, final params)."""
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_map
    _, _, fwd, loss = _jet()
    to = lambda t: t.to(dev)
    tcfg = TrainConfig(log_every=1, **dict(QUICKSTART, steps=len(batches)))
    tr = Trainer(fwd, loss, tcfg, tree_map(to, params), tree_map(to, qstate),
                 pipeline=lambda s: tree_map(to, batches[s]))
    tr.run(log=lambda *a: None)
    return ([(h["loss"], h["ebops"]) for h in tr.history],
            tree_map(lambda t: t.cpu(), tr.params))


@contextlib.contextmanager
def _df_without_last_tile():
    """Control: the per-channel and per-tensor backward skips its last
    tile of rows (a reduction that drops a partial sum)."""
    import repro_torch.kernels.hgq_quantize.ops as ops
    real = ops.hgq_quantize_bwd

    def dropped(g, x, f):
        if f.shape == x.shape:
            return real(g, x, f)
        cols = x.shape[-1]
        rows = x.numel() // cols
        tile = HGQ_TILE_ROWS if f.ndim else max(1, HGQ_TILE_ELEMS // cols)
        keep = rows - ((rows - 1) % tile + 1)
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
    """Control: the forward rounds f with floor(f), not floor(f + 1/2)."""
    import repro_torch.core.hgq as hgq_mod
    real = hgq_mod.quantize
    hgq_mod.quantize = lambda x, f: real(x, f - 0.5)
    try:
        yield
    finally:
        hgq_mod.quantize = real


def _card_vs_cpu(dev):
    """The 20-step trajectory on the card (kernels) and on the CPU (plain
    versions) from one init and one set of batches, twice on the card, and
    with each faulty control: gaps in loss and ~EBOPs, largest |dparam|."""
    from repro_torch.data import jet_batch
    from repro_torch.tree import tree_leaves
    JetTagger, cfg, _, _ = _jet()
    cpu = torch.device("cpu")
    params, qstate = JetTagger.init(torch.Generator().manual_seed(SEED + 1),
                                    cfg, device=cpu)
    batches = [jet_batch(SEED, s, 1024, device=cpu) for s in range(20)]
    ref, ref_p = _trajectory(cpu, params, qstate, batches)

    def gaps(run):
        hist, p = run
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
        out = {"loss_rel": max(rel(h[0], r[0]) for h, r in zip(hist, ref)),
               "ebops_rel": max(rel(h[1], r[1]) for h, r in zip(hist, ref)),
               "param_abs": max(float((a - b).abs().max()) for a, b in zip(
                   tree_leaves(p), tree_leaves(ref_p)))}
        out["gap"] = max(out["loss_rel"], out["ebops_rel"])
        return out

    card1 = _trajectory(dev, params, qstate, batches)
    card2 = _trajectory(dev, params, qstate, batches)
    same = card1[0] == card2[0] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(card1[1]),
                                          tree_leaves(card2[1])))
    with _df_without_last_tile():
        drop = _trajectory(dev, params, qstate, batches)
    with _rounding_down():
        floor = _trajectory(dev, params, qstate, batches)
    out = {"sound": gaps(card1), "repeat_bit_identical": same,
           "controls": {"df_drops_last_row_tile": gaps(drop),
                        "forward_fi_floor_f": gaps(floor)},
           "cpu_final_loss": ref[-1][0]}
    print(f"[train] card vs CPU, 20 steps: {json.dumps(out)} (limit on the "
          f"larger relative gap of loss and ~EBOPs: {TRAJ_REL_LIMIT})",
          flush=True)
    check(same, "two card runs of the 20 steps differ")
    check(out["sound"]["gap"] <= TRAJ_REL_LIMIT,
          f"card vs CPU trajectory gap {out['sound']}")
    check(all(c["gap"] > TRAJ_REL_LIMIT for c in out["controls"].values()),
          f"the trajectory check misses a control: {out['controls']}")
    return out


def train_phase(dev):
    trainer, report, per_step = _quickstart(dev)
    report["card_vs_cpu"] = _card_vs_cpu(dev)
    # profiled only now, after every timed run
    step = QUICKSTART["steps"]
    batch = trainer.pipeline(step)
    ops, busy = _profiled(lambda: trainer.step_fn(
        trainer.params, trainer.qstate, trainer.opt, batch, step))
    med = report["step_ms_median"]
    report["profiled_step"] = {"device_ops": ops, "device_busy_ms": busy,
                               "idle_share_of_median_step": 1.0 - busy / med}
    print(f"[train] profiled step: {ops} device operations, device busy "
          f"{busy:.3f} ms, idle {1.0 - busy / med:.1%} of the median step "
          f"({med:.3f} ms)", flush=True)
    return report, per_step


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "train"),
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
    tallies, launches = {}, {}
    slice_report = train_report = None
    if args.phase == "all":
        total, slice_report, tick_shapes = slice_phase(dev)
        launches.update(total)
        per = ("one full decode tick of serving configuration (a), calls by "
               "shape as counted on the main path")
        tallies.update({k: (tick_shapes[k], per) for k in SERVING})
    if args.phase in ("all", "train"):
        train_report, per_step = train_phase(dev)
        launches.update(train_report["launches"])
        per = ("one training step of the quickstart jet tagger, calls by "
               "shape as counted on the main path")
        tallies.update({k: (per_step[k], per) for k in TRAINING})
    kernels = kernels_line(cases, tallies)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    ported = {KERNELS[k["name"]][1] for k in kernels}
    print(json.dumps({
        "kernels": kernels,
        "still_to_port": [{"name": n, "replaces": r}
                          for n, r in TPU_KERNELS if n not in ported],
        "slice": slice_report, "train": train_report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
