"""Lint the programs of every shipped spec (the port's counterpart of
``tools/lint_programs.py``).

For each ``examples/specs/*.json`` (``plan_*.json`` are PrecisionPlans,
not programs -- skipped) this builds the spec's train step and -- on 1x1
meshes -- its serving decode tick, runs each once under
``repro_torch.analysis`` (at SMOKE width unless the spec says ``full``;
on the CPU unless ``--device`` says otherwise), runs the rule registry
over the runs and emits a JSON program report: collective launches by
primitive and logical axes, by primitive and dtype, data-axis-crossing
counts, in-place buffer counts, kernel-op calls, float64 operations,
violations.

The report is diffed against the committed golden
(``src/repro_torch/analysis/programs.json``) with the same
direction-aware ``--update`` / ``--override`` flow as
``benchmarks/check_regression.py`` -- default tolerance is zero (program
shapes are deterministic counts).  Rule violations fail the run
regardless of what the baseline says.

Usage:
    python torch_lint_programs.py [--out REPORT_programs.json]
Re-baseline after an intentional program change:
    python torch_lint_programs.py --update
Widen one metric:
    ... --override 'train:*.kernels.*=0.25'

Prints one ``lint_programs: analyzing <spec>`` line a spec, ``note``
lines for metrics that moved in their good direction or appeared,
``FAIL`` lines (stderr) for violations and regressions, and a last line
saying whether the programs are clean.

Exit codes: 0 = clean, 1 = violations or regression, 2 = missing
baseline / bad invocation.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_SPECS = os.path.join(ROOT, "examples", "specs")
DEFAULT_BASELINE = os.path.join(ROOT, "src", "repro_torch", "analysis",
                                "programs.json")


def _spec_paths(specs_dir: str):
    return [p for p in sorted(glob.glob(os.path.join(specs_dir, "*.json")))
            if not os.path.basename(p).startswith("plan_")]


def _parse_override(s: str):
    if "=" not in s:
        raise argparse.ArgumentTypeError(
            f"--override wants PATTERN=TOL, got {s!r}")
    pattern, _, tol = s.rpartition("=")
    return pattern, float(tol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="lint the programs of the shipped specs")
    ap.add_argument("--specs-dir", default=DEFAULT_SPECS)
    ap.add_argument("--out", default="REPORT_programs.json",
                    help="where to write the fresh report JSON")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--update", action="store_true",
                    help="copy the fresh report over the baseline "
                         "instead of diffing (still fails on violations)")
    ap.add_argument("--override", action="append", default=[],
                    type=_parse_override, metavar="PATTERN=TOL",
                    help="relative tolerance for matching metrics "
                         "(fnmatch, last match wins, default 0)")
    ap.add_argument("--device", default="cpu",
                    help="where the programs run (the golden is the "
                         "CPU's)")
    args = ap.parse_args(argv)

    paths = _spec_paths(args.specs_dir)
    if not paths:
        print(f"no specs under {args.specs_dir}", file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import analysis
    from repro_torch.api import RunSpec

    arts = []
    for p in paths:
        spec = RunSpec.from_json(open(p).read())
        rel = os.path.relpath(p, ROOT)
        print(f"lint_programs: analyzing {rel} "
              f"(mesh {spec.mesh.data}x{spec.mesh.model})")
        arts.extend(analysis.artifacts_for_spec(spec, rel,
                                                device=args.device))

    report = analysis.collect(arts)
    with open(args.out, "w") as f:
        f.write(analysis.dumps(report))
    print(f"lint_programs: wrote {args.out} "
          f"({len(report['programs'])} programs)")

    violations = [v for rep in report["programs"].values()
                  for v in rep["violations"]]
    for v in violations:
        print(f"FAIL {v}", file=sys.stderr)

    if args.update:
        os.makedirs(os.path.dirname(os.path.abspath(args.baseline)),
                    exist_ok=True)
        shutil.copyfile(args.out, args.baseline)
        print(f"lint_programs: baseline updated -> {args.baseline}")
        return 1 if violations else 0

    if not os.path.exists(args.baseline):
        print(f"missing baseline {args.baseline} — run with --update to "
              f"create it", file=sys.stderr)
        return 2
    baseline = json.load(open(args.baseline))
    failures, notes = analysis.compare(baseline, report,
                                       overrides=args.override)
    for n in notes:
        print(f"note {n}")
    for f_ in failures:
        print(f"FAIL regression {f_}", file=sys.stderr)
    if failures or violations:
        print("lint_programs: FAILED — fix the program or re-baseline "
              "deliberately with --update / widen with --override "
              "'PATTERN=TOL'", file=sys.stderr)
        return 1
    print("lint_programs: all programs clean and within baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main())
