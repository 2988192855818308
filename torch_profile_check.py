#!/usr/bin/env python3
"""How often a ``torch.profiler`` trace lacks the device kernel of a kernel
launch, on one CUDA card.  Run from the repository root:

    python3 torch_profile_check.py [--runs 400] [--out build/profile_check.json]

The checks of ``chip_smoke.py`` and the card-only tests that count kernels
in a trace read too few when the trace lacks a launch's device record.
This script profiles two functions ``--runs`` times in each of several
guards and counts the traces that lack at least one record, through
``chip_smoke._trace_once`` (a launch without its device kernel, matched by
correlation id):

1. one launch of the ``hgq_quantize`` backward at the jet tagger's
   per-channel shape (1024, 16) float32, as the card-only test
   ``test_hgq_bwd_is_one_launch_at_training_shapes`` profiles it: bare
   (the launch right after the profiler starts), behind the test's guard
   (the settling time and one marker kernel) and behind the script's
   (the settling time and ``PROFILE_MARKERS`` marker kernels);
2. one quickstart training step (``chip_smoke._quickstart``'s trainer),
   a tenth as many times, bare and behind the script's guard.

Prints the card, then one JSON line per reading, and writes them all to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# (settling seconds, marker kernels) of each guard
GUARDS = {"bare": (0.0, 0), "test": (cs.PROFILE_SETTLE_S, 1),
          "script": (cs.PROFILE_SETTLE_S, cs.PROFILE_MARKERS)}


def _rate(fn, runs, guard):
    """Traces of ``runs`` that lack a device record, the most lacked in
    one, and the launch sites of the first such trace."""
    settle, n_markers = GUARDS[guard]
    bad, most, first = 0, 0, []
    for _ in range(runs):
        _, _, lost, launched, _ = cs._trace_once(fn, (), settle, n_markers)
        if lost:
            bad += 1
            most = max(most, len(lost))
            first = first or lost[:4]
    return {"guard": guard, "runs": runs, "traces_lacking": bad,
            "most_lacked": most, "launches": len(launched),
            "first_lacking": first}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=400)
    ap.add_argument("--out", default="build/profile_check.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_check: no CUDA device", file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(smi, flush=True)
    from repro_torch.kernels import _build
    from repro_torch.kernels.hgq_quantize import hgq_quantize_bwd
    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(1024, 16, generator=g, device=dev) * 4
    gy = torch.randn(1024, 16, generator=g, device=dev)
    f = torch.rand(16, generator=g, device=dev) * 8 - 1
    hgq_quantize_bwd(gy, x, f)                                # warm up
    readings = {"card": smi, "launch": [], "step": []}
    for guard in GUARDS:
        r = _rate(lambda: hgq_quantize_bwd(gy, x, f), args.runs, guard)
        readings["launch"].append(r)
        print(json.dumps({"launch": r}), flush=True)
    trainer, _, _ = cs._quickstart(dev)
    step = cs.QUICKSTART["steps"]
    batch = trainer.pipeline(step)
    for guard in ("bare", "script"):
        r = _rate(lambda: trainer.step_fn(trainer.params, trainer.qstate,
                                          trainer.opt, batch, step),
                  max(1, args.runs // 10), guard)
        readings["step"].append(r)
        print(json.dumps({"step": r}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
