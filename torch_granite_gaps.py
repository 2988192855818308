#!/usr/bin/env python3
"""The granite training part's card-vs-CPU gaps over several inits, on one
CUDA card.  Run from the repository root:

    python3 torch_granite_gaps.py [--inits 4] [--tie-report]
                                  [--out build/granite_gaps.json]

``chip_smoke.py --phase train`` holds granite-moe-3b-a800m (2 layers at
full width, seq 128) on the card against the CPU from one init
(``SEED + 1``), in two readings: continuous (no activation quantizers)
and as trained.  This script takes the same readings
(``chip_smoke._granite_readings``: the sound gaps, each control's, and
the repeat's bits) from the inits ``SEED + 1`` to ``SEED + inits``, and
adds one quantity the script does not hold: ``moment_rel_l2``, the
largest over the leaves of the first moments' relative L2 gap.  Then, for
each reading and quantity, the largest sound gap and each control's
smallest over the inits, beside the script's limits: a limit is sound
where it lies above every sound reading and below, for each control, one
quantity's smallest reading.

With ``--tie-report``, step 0's TRAIN forward of each reading from the
first init runs once on the card and once on the CPU, recording every
single quantizer call and every MoE routing: for each call whose output
differs (the first 6), its shape, the values that differ and the smallest
and largest gap between the two inputs there in ulps of the CPU's (a few
ulps: a rounding tie that float32 noise decided apart; many: a difference
carried from an earlier call), and the routes that differ by MoE call.

Prints the card, then one JSON line per init and reading, then the
summary, and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def _gaps(run, ref, limits):
    """``chip_smoke._granite_gaps`` and the moments' largest per-leaf
    relative L2 gap."""
    out = cs._granite_gaps(run, ref, limits)
    out["moment_rel_l2"] = max(
        float(torch.linalg.vector_norm(a - b))
        / max(float(torch.linalg.vector_norm(b)), 1e-30)
        for a, b in zip(run[1], ref[1]))
    return out


def _recorded_forward(dev, params, qstate, batch, cfg):
    """Step 0's TRAIN forward on ``dev``, recording every single
    quantizer call's (x, f, output) and every MoE routing's expert ids,
    in call order, on the CPU."""
    import repro_torch.kernels.hgq_quantize.ops as ops
    import repro_torch.nn.moe as moe
    from repro_torch.core import hgq
    from repro_torch.models import TransformerLM
    from repro_torch.tree import tree_map
    calls, routes = [], []

    def quant(real):
        def rec(x, f):
            out = real(x, f)
            calls.append(tuple(t.detach().to("cpu", copy=True)
                               for t in (x, f, out)))
            return out
        return rec

    def route(real):
        def rec(logits, k):
            gates, eidx = real(logits, k)
            routes.append(eidx.to("cpu", copy=True))
            return gates, eidx
        return rec

    to = lambda t: t.to(dev)
    with cs._patched(ops, "hgq_quantize", quant), \
            cs._patched(moe, "route", route), torch.no_grad():
        TransformerLM.forward(tree_map(to, params), tree_map(to, qstate),
                              tree_map(to, batch), cfg, hgq.TRAIN)
    return calls, routes


def _tie_report(dev, seed):
    """{reading: where the card's step-0 forward parts from the CPU's}."""
    from repro_torch.data import lm_batch
    from repro_torch.models import TransformerLM
    cfg = cs._granite_small_cfg()
    cpu = torch.device("cpu")
    params, qstate = TransformerLM.init(
        torch.Generator().manual_seed(seed), cfg, device=cpu)
    batch = lm_batch(cs.SEED, 0, cs.GRANITE_BATCH, cs.GRANITE_SMALL_SEQ,
                     cfg.vocab, device=cpu)
    out = {}
    for name, tree in (("continuous", cs._continuous(params)),
                       ("as_trained", params)):
        card, card_routes = _recorded_forward(dev, tree, qstate, batch, cfg)
        ref, ref_routes = _recorded_forward(cpu, tree, qstate, batch, cfg)
        if len(card) != len(ref) or len(card_routes) != len(ref_routes):
            raise RuntimeError("the card and the CPU made other quantizer "
                               "calls")
        parted = []
        for i, ((x, f, a), (x0, f0, b)) in enumerate(zip(card, ref)):
            diff = a != b
            if not bool(diff.any()):
                continue
            u = x0.float()[diff]
            ulp = torch.abs(torch.nextafter(u, torch.full_like(u, math.inf))
                            - u)
            gap = torch.abs(x.float()[diff] - u) / ulp
            parted.append({"call": i, "shape": list(x.shape),
                           "values_differ": int(diff.sum()),
                           "input_gap_ulps_min": float(gap.min()),
                           "input_gap_ulps_max": float(gap.max())})
        out[name] = {"quantizer_calls": len(ref),
                     "calls_that_differ": len(parted), "first": parted[:6],
                     "routes_differ": [int((a != b).sum()) for a, b in
                                       zip(card_routes, ref_routes)]}
    return out


def _summary(per_init):
    """{reading: {"limits", "sound_max": {quantity: largest},
    "control_min": {control: {quantity: smallest}}}} over the inits."""
    out = {}
    for name in per_init[0]["readings"]:
        rs = [r["readings"][name] for r in per_init]
        keys = [k for k, v in rs[0]["sound"].items()
                if isinstance(v, float) and k != "gap"]
        out[name] = {
            "limits": rs[0]["limits"],
            "sound_max": {k: max(r["sound"][k] for r in rs) for k in keys},
            "control_min": {c: {k: min(r["controls"][c][k] for r in rs)
                                for k in keys}
                            for c in rs[0]["controls"]},
            "every_repeat_bit_identical": all(r["repeat_bit_identical"]
                                              for r in rs)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inits", type=int, default=4)
    ap.add_argument("--tie-report", action="store_true")
    ap.add_argument("--out", default="build/granite_gaps.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_granite_gaps: no CUDA device", file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build_all()
    dev = torch.device("cuda")
    result = {"card": smi, "inits": []}
    if args.tie_report:
        result["tie_report"] = _tie_report(dev, cs.SEED + 1)
        print(json.dumps({"tie_report": result["tie_report"]}), flush=True)
    for i in range(1, args.inits + 1):
        r = {"seed": f"SEED+{i}",
             "readings": cs._granite_readings(dev, cs.SEED + i, gaps=_gaps)}
        result["inits"].append(r)
        for name, reading in r["readings"].items():
            print(json.dumps({"seed": r["seed"], "reading": name,
                              **reading}), flush=True)
    result["summary"] = _summary(result["inits"])
    print(json.dumps({"summary": result["summary"]}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
