"""EBOPs-vs-metric Pareto-front checkpoint tracker (paper SSec. V;
counterpart of ``repro/core/pareto.py``, the same JSON).

The paper recovers the whole accuracy/resource trade-off curve from a single
training run by checkpointing every epoch that lands on the running Pareto
front of (validation metric, EBOPs).  This module implements that tracker.

``better_metric``: 'max' (accuracy) or 'min' (resolution / loss).

Fronts serialize to JSON (``to_json``/``from_json``) so a sweep's
accuracy/EBOPs curve — including per-point ``core.plan.PrecisionPlan``
payloads — survives the run that produced it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Tuple


@dataclasses.dataclass
class ParetoPoint:
    metric: float
    ebops: float
    step: int
    payload: Any = None  # e.g. a checkpoint path or params snapshot


class ParetoFront:
    def __init__(self, better_metric: str = "max"):
        if better_metric not in ("max", "min"):
            raise ValueError(f"better_metric must be 'max' or 'min', "
                             f"got {better_metric!r}")
        self.sign = 1.0 if better_metric == "max" else -1.0
        self.points: List[ParetoPoint] = []

    def _dominates(self, a: ParetoPoint, b: ParetoPoint) -> bool:
        """a dominates b: no worse on both axes, strictly better on one."""
        am, bm = self.sign * a.metric, self.sign * b.metric
        return (am >= bm and a.ebops <= b.ebops
                and (am > bm or a.ebops < b.ebops))

    def offer(self, metric: float, ebops: float, step: int,
              payload: Any = None) -> bool:
        """Insert if non-dominated; prune anything the new point dominates.
        Returns True iff the point joined the front (=> checkpoint it)."""
        cand = ParetoPoint(float(metric), float(ebops), int(step), payload)
        for p in self.points:
            if self._dominates(p, cand) or (p.metric == cand.metric
                                            and p.ebops == cand.ebops):
                return False
        self.points = [p for p in self.points if not self._dominates(cand, p)]
        self.points.append(cand)
        self.points.sort(key=lambda p: p.ebops)
        return True

    def front(self) -> List[Tuple[float, float, int]]:
        return [(p.metric, p.ebops, p.step) for p in self.points]

    def best(self, max_ebops: Optional[float] = None) -> Optional[ParetoPoint]:
        """Best-metric point within the EBOPs budget; metric ties break
        toward the cheaper (lower-EBOPs) point — the front is the set of
        equally-accurate models, so under a resource metric the cheapest
        one is the right checkpoint to deploy."""
        elig = [p for p in self.points
                if max_ebops is None or p.ebops <= max_ebops]
        if not elig:
            return None
        return max(elig, key=lambda p: (self.sign * p.metric, -p.ebops))

    # --------------------------- serialization ---------------------------

    def to_dict(self) -> dict:
        """JSON view.  Payloads serialize when they are a
        ``core.plan.PrecisionPlan`` (the sweep's per-point width tables)
        or already JSON-native; anything else drops to ``None`` (a live
        params snapshot is not a checkpointable artifact)."""
        from .plan import PrecisionPlan

        def payload(p: Any) -> Any:
            if isinstance(p, PrecisionPlan):
                return {"plan": p.to_dict()}
            if p is None or isinstance(p, (str, int, float, bool)):
                return p
            return None

        return {
            "better_metric": "max" if self.sign > 0 else "min",
            "points": [{"metric": p.metric, "ebops": p.ebops,
                        "step": p.step, "payload": payload(p.payload)}
                       for p in self.points],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "ParetoFront":
        from .plan import PrecisionPlan
        front = cls(d["better_metric"])
        for row in d["points"]:
            pay = row.get("payload")
            if isinstance(pay, dict) and set(pay) == {"plan"}:
                pay = PrecisionPlan.from_dict(pay["plan"])
            front.points.append(ParetoPoint(
                float(row["metric"]), float(row["ebops"]),
                int(row["step"]), pay))
        front.points.sort(key=lambda p: p.ebops)
        return front

    @classmethod
    def from_json(cls, s: str) -> "ParetoFront":
        return cls.from_dict(json.loads(s))
