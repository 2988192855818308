#!/usr/bin/env python3
"""Peak device memory of the spec-built train step with and without its
in-place update, on one CUDA card.

For the launcher's step (``examples/specs/host_1x1.json --full``, batch
2, seq 256) and the 2D step (``examples/specs/host_2x4_int8wire2d.json
--full``: qwen2-0.5b over ``LocalMesh(2, model=4)``) it builds
``build(spec).init_training()`` twice: once as built (the step updates
params, both AdamW moments and the EF residual in place:
``train_shardings``' donate tuple), once with the step rebuilt with
``donate=()`` (new trees every step).  Each runs ``--steps`` steps after
the peak counter is reset at the end of the init.

    python3 torch_donation_peak.py [--steps 2] [--out build/donation_peak.json]

Prints the card's name and power limit, then one line a run: the spec,
in place or not, the GiB held after the init, the peak GiB of the steps
and the step ms (median); the same records go to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SPECS = ROOT / "examples" / "specs"
RUNS = (("launcher", ["--spec", str(SPECS / "host_1x1.json"), "--full",
                      "--batch", "2", "--seq", "256"]),
        ("2d", ["--spec", str(SPECS / "host_2x4_int8wire2d.json"),
                "--full"]))
GIB = 2 ** 30


def run(argv, in_place: bool, steps: int) -> dict:
    from repro_torch.api import RunSpec, build
    gc.collect()
    torch.cuda.empty_cache()
    setup = build(RunSpec.from_args(argv)).init_training()
    if not in_place:
        setup.step_fn = setup.ctx.make_train_step(donate=())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / GIB
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for s in range(steps):
        t = time.perf_counter()
        setup.step(s)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / GIB
    del setup
    return {"in_place": in_place, "held_after_init_gib": held,
            "steps_peak_gib": peak, "step_ms": ms,
            "step_ms_median": float(np.median(ms))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "donation_peak.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_donation_peak: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = []
    for name, spec_argv in RUNS:
        for in_place in (True, False):
            rec = {"run": name, "argv": spec_argv[2:], "card": smi,
                   **run(spec_argv, in_place, args.steps)}
            out.append(rec)
            print(f"[donation] {name} in_place={in_place}: held "
                  f"{rec['held_after_init_gib']:.2f} GiB, the steps' peak "
                  f"{rec['steps_peak_gib']:.2f} GiB, step "
                  f"{rec['step_ms_median']:.1f} ms", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
