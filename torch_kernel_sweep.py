#!/usr/bin/env python3
"""Geometry sweeps behind the build-time constants of two of the PyTorch
port's kernels, on one CUDA card.  Run from the repository root:

    python3 torch_kernel_sweep.py [--part all|pack|bwd]
                                  [--out build/kernel_sweep.json]

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

Times are CUDA-event times per call from ``chip_smoke.time_ms``.  Prints
the card, then one JSON line per reading, and writes them all to
``--out``.  The default build is the variant without ``-D`` flags.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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


def _build_variants(parts):
    """Every variant's library, one nvcc each, all started together."""
    from repro_torch.kernels import _build
    jobs = []
    if "pack" in parts:
        jobs += [("wire_pack", d) for d in PACK_VARIANTS]
    if "bwd" in parts:
        jobs += [("hgq_quantize", d) for d in BWD_VARIANTS]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/kernel_sweep.json")
    ap.add_argument("--part", choices=("all", "pack", "bwd"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(smi, flush=True)
    parts = ("pack", "bwd") if args.part == "all" else (args.part,)
    _build_variants(parts)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    readings = {"card": smi}
    if "pack" in parts:
        readings["wire_pack_rows"] = _pack_sweep(dev, g)
    if "bwd" in parts:
        readings["hgq_quantize_bwd"] = _bwd_sweep(dev, g)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(readings, indent=1))
    bad = [r for k in ("wire_pack_rows", "hgq_quantize_bwd")
           for r in readings.get(k, ()) if not r.get("exact", r.get("df_ok"))]
    for r in bad:
        print("wrong result:", json.dumps(r), file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
