#!/usr/bin/env python3
"""Geometry sweeps behind the build-time constants of the PyTorch port's
kernels, on one CUDA card.  Run from the repository root:

    python3 torch_kernel_sweep.py [--part all|pack|bwd|fwd|bucket|dequant|
                                          reduce]
                                  [--out build/kernel_sweep.json]
                                  [--src DIR] [--default-only]

Each variant is the kernel's own source built with other ``-D`` values
(``kernels._build.variant``) and called through the port's wrapper, so no
geometry is copied here:

1. ``wire_pack_rows`` (``csrc/wire_pack.cu``, even C): ``WIRE_PACK_VECS``
   vectors a thread by ``WIRE_PACK_BLOCKS_PER_SM`` (0: no cap on the
   grid), at the qwen2 reduce's two large shapes, the input aligned and
   1 byte into a tensor; each variant checked bit for bit.
2. The ``hgq_quantize`` backward (``csrc/hgq_quantize.cu``):
   ``HGQ_CLUSTER`` blocks a cluster by ``HGQ_ONE_CLUSTER_BATCHES`` (where
   one cluster gives way to several and a second pass), at the training
   shapes, at per-tensor and per-channel shapes either side of that line
   and at two qwen2-layer shapes, float32 and bfloat16; each variant's
   plan from ``ops.bwd_plan`` and its ``df`` held to ``1e-5 * sum|terms|``.
3. The ``hgq_quantize`` forward (``csrc/hgq_quantize.cu``):
   ``HGQ_FWD_THREADS`` a block by ``HGQ_FWD_UNROLL`` (16-byte units a
   thread loads before it computes) by ``HGQ_FWD_BLOCKS_PER_SM`` (a
   member's blocks at most 132 times this), at four qwen2-0.5b layer
   shapes (per tensor float32 and bfloat16, per channel, per parameter),
   two training shapes, and the jet tagger's grouped weights (beside
   their eight single launches); each variant checked bit for bit.
   ``--src DIR`` times the forward of the package under ``DIR`` (another
   tree's ``src``, e.g. the parent commit unpacked with ``git archive``)
   with its default build: no variants, and a tree without the grouped
   forward times the group as single launches.  ``--default-only``
   builds no variants.
4. The fused reduce's bucket kernels (``csrc/wire_pack.cu``):
   ``WIRE_BUCKET_QUANT_GROUPS`` and ``WIRE_BUCKET_DEQUANT_GROUPS``
   (16-byte groups a thread loads before it computes) with
   ``WIRE_BUCKET_QUANT_MIN_BLOCKS`` and ``WIRE_BUCKET_DEQUANT_MIN_BLOCKS``
   (blocks an SM each build asks for),
   ``wire_quantize_bucket`` and ``wire_dequant_bucket`` at the
   qwen2 reduce's two largest buckets (the embedding alone at 8 bits, a
   stacked MLP leaf in nibbles), each variant checked bit for bit against
   the plain version (at rank 0 for the decode).
5. ``kv_dequant_rows`` (``csrc/kv_dequant.cu``, the 16-byte path):
   ``KV_DEQUANT_VECS`` (the most 16-byte pieces a lane loads before it
   stores; the launch halves it while an SM would have no block) by
   ``KV_DEQUANT_THREADS`` (a block) by ``KV_DEQUANT_BLOCKS_PER_SM``
   (the grid's blocks an SM at most), at one qwen2-0.5b layer's K ring
   (R = 16384, hd 64) and all 24 layers' (R = 393216), each variant
   checked bit for bit, with its registers and spills and the empty
   kernel on its grid (the launch floor), beside ``zero_`` over the
   output's bytes (what the card takes to write them alone).
6. ``reduce`` (not in ``all``): the fused reduce of qwen2-0.5b's gradient
   tree over ``LocalMesh(4)`` (``chip_smoke._qwen2_grads``), uniform int8
   and ``plan_mixed_w4w8``, of the package under ``--src``: the peak
   memory of three calls after one warm-up (the tree, and the previous
   call's outputs while the next runs), their host-clock median, and one
   call traced with ``chip_smoke._profiled`` (device operations, busy ms,
   ``aten::constant_pad_nd`` events of every thread, ``F.pad`` calls).  Run it on the parent's tree and
   this one in one chip call, parent, change, change, parent.

Times are CUDA-event times per call from ``chip_smoke.time_ms``.  Prints
the card, then one JSON line per reading, and writes them all to
``--out``.  The default build is the variant without ``-D`` flags.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

from chip_smoke import bound, n_copies, time_ms  # noqa: E402

# the -D flags of each variant; () is the default build
PACK_VARIANTS = [()] + [(f"-DWIRE_PACK_VECS={v}",
                         f"-DWIRE_PACK_BLOCKS_PER_SM={b}")
                        for v in (1, 2, 4) for b in (0, 2, 4, 8, 16)]
BWD_VARIANTS = [()] + [(f"-DHGQ_CLUSTER={c}", f"-DHGQ_ONE_CLUSTER_BATCHES={b}")
                       for c in (4, 8, 16) for b in (1, 2, 4)]
PACK_SHAPES = ((4, 26148864), (1, 26148864))
# the training slice's reducing shapes (batch 1024; 256 a compressed-step
# slice), per tensor and per channel around the one-cluster line, two
# qwen2-0.5b layer shapes
BWD_SHAPES = ([("per_channel", (1024, 16)), ("per_tensor", (1024, 64)),
               ("per_tensor", (1024, 32)), ("per_channel", (256, 16)),
               ("per_tensor", (256, 64)), ("per_tensor", (256, 32))]
              + [("per_tensor", (r, 1024)) for r in (32, 64, 128, 256)]
              + [("per_channel", (r, 16)) for r in (1024, 2048, 4096, 8192)]
              + [("per_channel", (896, 4864)), ("per_tensor", (8192, 896))])
FWD_VARIANTS = ([()] + [(f"-DHGQ_FWD_THREADS={t}", f"-DHGQ_FWD_UNROLL={u}")
                        for t in (128, 256, 512) for u in (1, 2, 4)
                        if (t, u) != (256, 2)]
                + [(f"-DHGQ_FWD_BLOCKS_PER_SM={b}",) for b in (2, 4, 16)])
# qwen2-0.5b layer shapes (a prefill's activations per tensor, the MLP
# weight per channel and per parameter) and two training shapes
FWD_SHAPES = [("per_tensor", (8192, 896), "float32"),
              ("per_tensor", (8192, 896), "bfloat16"),
              ("per_channel", (896, 4864), "float32"),
              ("per_parameter", (896, 4864), "float32"),
              ("per_tensor", (1024, 64), "float32"),
              ("per_channel", (1024, 16), "float32")]
BUCKET_VARIANTS = [()] + [
    (f"-DWIRE_BUCKET_QUANT_GROUPS={q}", f"-DWIRE_BUCKET_QUANT_MIN_BLOCKS={qb}",
     f"-DWIRE_BUCKET_DEQUANT_GROUPS={d}",
     f"-DWIRE_BUCKET_DEQUANT_MIN_BLOCKS={db}")
    for q, qb, d, db in ((2, 1, 1, 1), (8, 1, 1, 4), (4, 3, 4, 4),
                         (4, 1, 2, 3), (4, 1, 2, 1))]
# the qwen2 reduce's two largest buckets, as the tallies key them
BUCKET_SHAPES = [(4, 8, False, (((151936, 896), 1, "float32"),)),
                 (4, 4, True, (((24, 4864, 896), 24, "float32"),))]
DEQUANT_VARIANTS = [()] + [
    (f"-DKV_DEQUANT_VECS={v}", f"-DKV_DEQUANT_THREADS={t}",
     f"-DKV_DEQUANT_BLOCKS_PER_SM={b}")
    for v, t, b in ((1, 256, 8), (2, 256, 8), (4, 256, 8), (4, 256, 16),
                    (8, 256, 16), (8, 128, 8), (8, 128, 16), (8, 512, 4),
                    (8, 512, 8), (8, 256, 4))]
DEQUANT_SHAPES = ((16384, 64), (393216, 64))
# the jet tagger's weights and biases: one grouped launch a training step
JET_GROUP = [(16, 64), (64,), (64, 32), (32,), (32, 32), (32,), (32, 5),
             (5,)]


def _build_variants(parts, fwd_variants):
    """Every variant's library, one nvcc each, all started together."""
    from repro_torch.kernels import _build
    jobs = []
    if "pack" in parts:
        jobs += [("wire_pack", d) for d in PACK_VARIANTS]
    if "bwd" in parts:
        jobs += [("hgq_quantize", d) for d in BWD_VARIANTS]
    if "fwd" in parts:
        jobs += [("hgq_quantize", d) for d in fwd_variants]
    if "bucket" in parts:
        jobs += [("wire_pack", d) for d in BUCKET_VARIANTS]
    if "dequant" in parts:
        jobs += [("kv_dequant", d) for d in DEQUANT_VARIANTS]
    if "reduce" in parts:
        jobs += [("wire_pack", ())]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda j: _build.build_all([j[0]], j[1]), jobs))


def _pack_sweep(dev, g):
    from repro_torch.kernels import _build
    from repro_torch.kernels import wire_pack as wops
    rows = []
    for R, C in PACK_SHAPES:
        nbytes = R * C + R * C // 2
        bufs = [torch.randint(-8, 8, (R * C + 16,), generator=g, device=dev,
                              dtype=torch.int8)
                for _ in range(n_copies(nbytes))]
        for off in (0, 1):
            sets = [(b[off:off + R * C].view(R, C),) for b in bufs]
            want = wops.pack_chunks_ref(sets[0][0])
            for defines in PACK_VARIANTS:
                with _build.variant("wire_pack", defines):
                    exact = torch.equal(wops.wire_pack_rows(*sets[0]), want)
                    ms = time_ms(wops.wire_pack_rows, sets)
                rows.append({"kernel": "wire_pack_rows",
                             "shape": f"R{R} C{C}", "offset": off,
                             "defines": list(defines) or "default",
                             "exact": exact, "ms": ms,
                             "bound_ms": bound(nbytes, 0)[0]})
                print(json.dumps(rows[-1]), flush=True)
        del bufs, sets
    return rows


def _bwd_sweep(dev, g):
    from repro_torch.kernels import _build
    from repro_torch.kernels.hgq_quantize import ops as hops
    from repro_torch.kernels.hgq_quantize.ref import (hgq_quantize_grad_ref,
                                                      hgq_quantize_ref)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.finfo(dtype).bits // 8
        for lay, (r, c) in BWD_SHAPES:
            fshape = (c,) if lay == "per_channel" else ()
            # g and x read, f read and df written
            nbytes = 2 * r * c * item + 8 * (c if fshape else 1)
            sets = []
            for _ in range(n_copies(nbytes)):
                x = (torch.randn((r, c), generator=g, device=dev) * 4
                     ).to(dtype)
                gy = torch.randn((r, c), generator=g, device=dev).to(dtype)
                f = torch.rand(fshape, generator=g, device=dev) * 8 - 1
                sets.append((gy, x, f))
            gy, x, f = sets[0]
            ref = hgq_quantize_grad_ref(gy, x, f)
            scale = (gy.float() * 0.6931471805599453 * (
                x.float() - hgq_quantize_ref(x, f).float())
                     ).abs().sum_to_size(fshape)
            for defines in BWD_VARIANTS:
                with _build.variant("hgq_quantize", defines):
                    plan, scratch = hops.bwd_plan(r, c, lay, dtype)
                    df = hops.hgq_quantize_bwd(gy, x, f)
                    ok = bool(((df - ref).abs() <= 1e-5 * scale).all())
                    ms = time_ms(hops.hgq_quantize_bwd, sets)
                rows.append({"kernel": "hgq_quantize_bwd", "layout": lay,
                             "shape": [r, c], "dtype": str(dtype)[6:],
                             "defines": list(defines) or "default",
                             "cs_nc_span": list(plan), "scratch": scratch,
                             "df_ok": ok, "ms": ms,
                             "bound_ms": bound(nbytes, 0)[0]})
                print(json.dumps(rows[-1]), flush=True)
            del sets
    return rows


def _fwd_sweep(dev, g, variants, label):
    from repro_torch.kernels import _build
    from repro_torch.kernels.hgq_quantize import ops as hops
    from repro_torch.kernels.hgq_quantize.ref import hgq_quantize_ref
    grouped = hasattr(hops, "hgq_quantize_fwd_group")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = []

    def fshape(lay, shape):
        return {"per_tensor": (), "per_channel": shape[-1:],
                "per_parameter": shape}[lay]

    def same(a, b):
        v = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16
                             else torch.int32)
        return all(torch.equal(v(x), v(y)) for x, y in zip(a, b))

    def member(shape, fsh, dtype):
        return ((torch.randn(shape, generator=g, device=dev) * 4).to(dtype),
                torch.rand(fsh, generator=g, device=dev) * 8 - 1)

    for lay, shape, dt in FWD_SHAPES:
        dtype = dtypes[dt]
        n = shape[0] * shape[1]
        fsh = fshape(lay, shape)
        # x read, out written, f read
        nbytes = 2 * n * (torch.finfo(dtype).bits // 8) + 4 * (
            n if lay == "per_parameter" else shape[1] if fsh else 1)
        sets = [member(shape, fsh, dtype) for _ in range(n_copies(nbytes))]
        want = hgq_quantize_ref(*sets[0])
        for defines in variants:
            with _build.variant("hgq_quantize", defines):
                exact = same([hops.hgq_quantize_fwd(*sets[0])], [want])
                ms = time_ms(hops.hgq_quantize_fwd, sets)
            rows.append({"kernel": "hgq_quantize_fwd", "src": label,
                         "layout": lay, "shape": list(shape), "dtype": dt,
                         "defines": list(defines) or "default",
                         "exact": exact, "ms": ms,
                         "bound_ms": bound(nbytes, 0)[0]})
            print(json.dumps(rows[-1]), flush=True)
        del sets
    nbytes = sum(2 * 4 * math.prod(s) + 4 * math.prod(s) for s in JET_GROUP)
    sets = []
    for _ in range(n_copies(nbytes)):
        ms_ = [member(s, s, torch.float32) for s in JET_GROUP]
        sets.append(([x for x, _ in ms_], [f for _, f in ms_]))
    want = [hgq_quantize_ref(x, f) for x, f in zip(*sets[0])]

    def singles(xs, fs):
        return [hops.hgq_quantize_fwd(x, f) for x, f in zip(xs, fs)]

    for defines in variants:
        with _build.variant("hgq_quantize", defines):
            kinds = [("single launches", singles)]
            if grouped:
                kinds.append(("one grouped launch",
                              hops.hgq_quantize_fwd_group))
            for kind, fn in kinds:
                exact = same(fn(*sets[0]), want)
                ms = time_ms(fn, sets)
                rows.append({"kernel": "hgq_quantize_fwd", "src": label,
                             "layout": "per_parameter",
                             "shape": "jet tagger weights and biases, "
                                      + kind, "dtype": "float32",
                             "defines": list(defines) or "default",
                             "exact": exact, "ms": ms,
                             "bound_ms": bound(nbytes, 0)[0]})
                print(json.dumps(rows[-1]), flush=True)
    return rows


def _registers(name, defines, source="wire_pack", kernel=None):
    """(registers, spill stores) ptxas reported for a kernel's build (a
    bucket kernel by its wrapper's name: ``wire_quantize_bucket`` ->
    ``quantize_bucket_kernel``; else the first entry whose mangled name
    holds ``kernel``)."""
    from repro_torch.kernels import _build
    kernel = kernel or name.replace("wire_", "") + "_kernel"
    lines = _build.ptxas_report(source, defines).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            spill = int(lines[i + 1].split("bytes spill stores")[0]
                        .split(",")[-1])
            regs = int(lines[i + 2].split("Used ")[1].split(" registers")[0])
            return regs, spill
    return None


def _bucket_sweep(dev, g):
    from chip_smoke import _fresh, _same_bits, _wire_spec
    from repro_torch.kernels import _build
    rows = []
    for n, bits, nib, members in BUCKET_SHAPES:
        keys = [("wire_quantize_bucket", (n, bits, nib, members)),
                ("wire_dequant_bucket", (n, (n - 1).bit_length(), nib,
                                         members))]
        for name, key in keys:
            make, kern, plain, nbytes, _, shape = _wire_spec(name, key, dev,
                                                            g)
            sets = [make() for _ in range(n_copies(nbytes))]
            for defines in BUCKET_VARIANTS:
                # the decode updates float32 residuals in place: the plain
                # version reads them as the last timing left them
                want = plain(*sets[0])
                with _build.variant("wire_pack", defines):
                    exact = _same_bits(kern(*_fresh(sets[0])), want)
                    ms = time_ms(kern, sets)
                rows.append({"kernel": name, "shape": shape,
                             "defines": list(defines) or "default",
                             "registers": _registers(name, defines),
                             "exact": exact, "ms": ms,
                             "bound_ms": bound(nbytes, 0)[0]})
                print(json.dumps(rows[-1]), flush=True)
            del sets, want
    return rows


def _dequant_sweep(dev, g):
    from chip_smoke import DEQUANT_CALLS, dequant_grid, launch_floor_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.kv_dequant import kv_dequant_rows
    from repro_torch.kernels.kv_dequant.ref import kv_dequant_ref
    rows = []
    for R, hd in DEQUANT_SHAPES:
        nbytes = 5 * R * hd + R
        # what the card writes alone: zero_ over the output's bytes
        zero = [(torch.empty((R, hd), device=dev),)
                for _ in range(n_copies(4 * R * hd))]
        rows.append({"kernel": "torch.Tensor.zero_", "shape": f"R{R} hd{hd}",
                     "ms": time_ms(torch.Tensor.zero_, zero, DEQUANT_CALLS),
                     "bound_ms": bound(4 * R * hd, 0)[0]})
        print(json.dumps(rows[-1]), flush=True)
        del zero
        sets = [(torch.randint(-128, 128, (R, hd), generator=g, device=dev,
                               dtype=torch.int8),
                 torch.randint(-3, 12, (R,), generator=g, device=dev,
                               dtype=torch.int8))
                for _ in range(n_copies(nbytes))]
        want = kv_dequant_ref(*sets[0])
        for defines in DEQUANT_VARIANTS:
            with _build.variant("kv_dequant", defines):
                exact = torch.equal(kv_dequant_rows(*sets[0]).view(
                    torch.int32), want.view(torch.int32))
                ms = time_ms(kv_dequant_rows, sets, DEQUANT_CALLS)
                floor = launch_floor_ms(R, hd, dev)
                blocks, threads, vecs = dequant_grid(R, hd)
            rows.append({"kernel": "kv_dequant_rows", "shape": f"R{R} hd{hd}",
                         "defines": list(defines) or "default",
                         "grid": [blocks, threads, vecs],
                         "registers": _registers(
                             "kv_dequant_rows", defines, "kv_dequant",
                             f"kv_dequant_vec_kernelIjLi{vecs}E"),
                         "exact": exact, "ms": ms, "launch_floor_ms": floor,
                         "bound_ms": bound(nbytes, 0)[0]})
            print(json.dumps(rows[-1]), flush=True)
        del sets, want
    return rows


def _reduce_reading(dev, label):
    from chip_smoke import (PAD_OP, QWEN_PLAN, WIRE_N, _all_threads_config,
                            _counting_pads, _profiled, _qwen2_grads)
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.dist import LocalMesh, ef_wire_pmean
    tree = _qwen2_grads(dev)
    mesh = LocalMesh(WIRE_N, dev)
    plan = PrecisionPlan.from_file(str(ROOT / QWEN_PLAN))
    rows = []
    for tag, widths in (("int8", None),
                        ("mixed_w4w8", plan.wire_bits_tree(tree))):
        run = lambda: ef_wire_pmean(tree, mesh, "int8", widths=widths)
        out = run()                                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del out
        pads = [0]
        with _counting_pads(pads):
            ops, busy, _, names = _profiled(run, all_threads=True)
        rows.append({"reduce": tag, "src": label,
                     "fused_peak_mem_gib": peak,
                     "host_ms_median": sorted(times)[1],
                     "device_ops": ops, "device_busy_ms": busy,
                     "host_ops_of_every_thread":
                         _all_threads_config() is not None,
                     "constant_pad_nd": names.get(PAD_OP, 0),
                     "pad_calls": pads[0]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/kernel_sweep.json")
    ap.add_argument("--part", choices=("all", "pack", "bwd", "fwd",
                                       "bucket", "dequant", "reduce"),
                    default="all")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch is timed (fwd or "
                         "reduce only unless it is this repository's)")
    ap.add_argument("--default-only", action="store_true",
                    help="build and time no geometry variants")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    other = src != (ROOT / "src").resolve()
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(smi, flush=True)
    parts = (("pack", "bwd", "fwd", "bucket", "dequant") if args.part == "all"
             else (args.part,))
    if other and parts not in (("fwd",), ("reduce",)):
        print("torch_kernel_sweep: --src times the forward or the reduce "
              "only (--part fwd, reduce)", file=sys.stderr)
        return 2
    fwd_variants = [()] if other or args.default_only else FWD_VARIANTS
    if args.default_only:
        global PACK_VARIANTS, BWD_VARIANTS, BUCKET_VARIANTS, DEQUANT_VARIANTS
        PACK_VARIANTS, BWD_VARIANTS, BUCKET_VARIANTS = [()], [()], [()]
        DEQUANT_VARIANTS = [()]
    _build_variants(parts, fwd_variants)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    readings = {"card": smi, "src": str(src)}
    if "pack" in parts:
        readings["wire_pack_rows"] = _pack_sweep(dev, g)
    if "bwd" in parts:
        readings["hgq_quantize_bwd"] = _bwd_sweep(dev, g)
    if "fwd" in parts:
        readings["hgq_quantize_fwd"] = _fwd_sweep(
            dev, g, fwd_variants, "other tree" if other else "this tree")
    if "bucket" in parts:
        readings["wire_bucket"] = _bucket_sweep(dev, g)
    if "dequant" in parts:
        readings["kv_dequant_rows"] = _dequant_sweep(dev, g)
    if "reduce" in parts:
        readings["reduce"] = _reduce_reading(
            dev, "other tree" if other else "this tree")
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(readings, indent=1))
    bad = [r for k in ("wire_pack_rows", "hgq_quantize_bwd",
                       "hgq_quantize_fwd", "wire_bucket", "kv_dequant_rows")
           for r in readings.get(k, ())
           if not r.get("exact", r.get("df_ok", r["kernel"].startswith(
               "torch.")))]
    for r in bad:
        print("wrong result:", json.dumps(r), file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
