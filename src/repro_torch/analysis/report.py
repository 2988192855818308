"""Program reports: the census, serialized and baseline-gated
(counterpart of ``repro/analysis/report.py``).

``program_report`` turns one :class:`ProgramArtifacts` into a plain-JSON
dict; ``collect`` bundles every analyzed program of a repo checkout into
the report ``torch_lint_programs.py`` writes and diffs against the
committed golden (``src/repro_torch/analysis/programs.json``, SMOKE
width on the CPU).

The census is the load-bearing part: ``launches`` (the collectives the
program issued), the per-primitive/per-dtype counts (which catch a *new*
f32 exchange appearing even when every hard rule still passes), the
in-place buffers, and, the port's additions, ``kernels.<name>`` (kernel
op calls, the same count on the CPU's plain versions and the card's
kernels) and ``f64_ops`` (float64 operations: a new leak shows as drift
even inside the deliberate modules).

``compare`` mirrors ``benchmarks/check_regression.py`` semantics —
direction-aware metrics, fnmatch overrides with last-match-wins, exit
codes 0/1/2 — but with a default tolerance of **zero**: program shapes
are deterministic counts, so any drift is a real change that either gets
fixed or deliberately re-baselined with ``--update``.
"""
from __future__ import annotations

import fnmatch
import json
from typing import Dict, List, Sequence, Tuple

from .program import ProgramArtifacts
from .rules import PROGRAM_RULES, SCALAR_MAX, run_rules

# metric-name suffix -> direction ("lower" is better / "higher" is
# better).  Counts of launches, collectives, kernel ops and float64
# operations want to go down; aliased buffers (donations that actually
# landed) want to go up.
METRIC_DIRECTIONS = (
    ("aliased_buffers", "higher"),
    ("launches", "lower"),
    ("collectives.", "lower"),
    ("crossing.", "lower"),
    ("kernels.", "lower"),
    ("f64_ops", "lower"),
)


def direction_for(name: str) -> str:
    for frag, direction in METRIC_DIRECTIONS:
        if frag in name:
            return direction
    return "lower"


def program_report(art: ProgramArtifacts) -> Dict:
    """One program's census + rule verdicts as a plain-JSON dict."""
    explicit: Dict[str, int] = {}
    census: Dict[str, int] = {}
    crossing: Dict[str, int] = {}
    for c in art.explicit_collectives():
        key = f"{c.primitive}[{','.join(c.axes)}]"
        explicit[key] = explicit.get(key, 0) + 1
        key = f"{c.primitive}.{c.dtype}"
        census[key] = census.get(key, 0) + 1
        if c.numel >= SCALAR_MAX and c.over("data"):
            crossing[key] = crossing.get(key, 0) + 1
    return {
        "kind": art.kind,
        "spec": art.spec_path,
        "mesh": list(art.mesh_shape),
        "launches": sum(explicit.values()),
        "explicit": dict(sorted(explicit.items())),
        "collectives": dict(sorted(census.items())),
        "crossing": dict(sorted(crossing.items())),
        "aliased_buffers": art.aliased_buffers(),
        "kernels": dict(sorted(art.kernel_ops().items())),
        "f64_ops": sum(art.f64_ops().values()),
        "violations": [str(v) for v in run_rules(art, PROGRAM_RULES)],
    }


def collect(arts: Sequence[ProgramArtifacts]) -> Dict:
    return {"report": "programs",
            "programs": {a.name: program_report(a) for a in arts}}


def dumps(report: Dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True) + "\n"


def extract_metrics(report: Dict) -> Dict[str, float]:
    """Flatten a collected report to gateable ``name -> value`` pairs.
    Violations are deliberately NOT metrics: they fail the run outright
    regardless of what any baseline says."""
    out: Dict[str, float] = {}
    for prog, rep in sorted(report.get("programs", {}).items()):
        out[f"{prog}.launches"] = float(rep.get("launches", 0))
        out[f"{prog}.aliased_buffers"] = float(rep.get("aliased_buffers", 0))
        for k, v in sorted(rep.get("explicit", {}).items()):
            out[f"{prog}.explicit.{k}"] = float(v)
        for k, v in sorted(rep.get("collectives", {}).items()):
            out[f"{prog}.collectives.{k}"] = float(v)
        for k, v in sorted(rep.get("crossing", {}).items()):
            out[f"{prog}.crossing.{k}"] = float(v)
        for k, v in sorted(rep.get("kernels", {}).items()):
            out[f"{prog}.kernels.{k}"] = float(v)
        if "f64_ops" in rep:
            out[f"{prog}.f64_ops"] = float(rep["f64_ops"])
    return out


def tolerance_for(name: str,
                  overrides: Sequence[Tuple[str, float]]) -> float:
    """Relative slack for one metric: default 0 (exact counts), widened
    by ``--override 'PATTERN=TOL'`` entries — fnmatch patterns, last
    match wins, same contract as check_regression.py."""
    tol = 0.0
    for pattern, value in overrides:
        if fnmatch.fnmatch(name, pattern):
            tol = value
    return tol


def compare(baseline: Dict, fresh: Dict,
            overrides: Sequence[Tuple[str, float]] = ()
            ) -> Tuple[List[str], List[str]]:
    """(failures, notes) of fresh vs baseline metrics.  A metric moving
    in its bad direction past tolerance is a failure; moving in its good
    direction, or appearing/disappearing, is a note (re-baseline with
    --update when intentional)."""
    base = extract_metrics(baseline)
    new = extract_metrics(fresh)
    failures, notes = [], []
    for name in sorted(set(base) | set(new)):
        if name not in new:
            notes.append(f"{name}: in baseline only "
                         f"(baseline={base[name]:g}) — gone from report")
            continue
        if name not in base:
            notes.append(f"{name}: new metric (value={new[name]:g}) — "
                         f"not in baseline, re-baseline to gate it")
            continue
        b, f = base[name], new[name]
        if b == f:
            continue
        tol = tolerance_for(name, overrides)
        worse = f > b if direction_for(name) == "lower" else f < b
        limit = abs(b) * tol
        if worse and abs(f - b) > limit:
            failures.append(
                f"{name}: {b:g} -> {f:g} "
                f"({'+' if f > b else ''}{f - b:g}, tol {tol:g})")
        else:
            notes.append(f"{name}: {b:g} -> {f:g} (ok)")
    return failures, notes
