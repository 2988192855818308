"""The collectives a program wrote, with their logical axes (counterpart
of ``repro/analysis/jaxpr.py``'s ``explicit_collectives``).

In the reference, GSPMD adds collectives of its own at compile time and
the jaxpr sees only the exchanges the repo's code wrote (the wire's
all_to_all / all_gather, the scale pmax), each with its logical axis
names.  The port has no compiler in between: every collective is one the
code wrote, issued by a mesh's rank (``dist.mesh``: ``pmax``,
``all_to_all``, ``all_gather`` of ``LocalMesh`` and
``ProcessGroupMesh``).  The recording rank of a mesh notes each one in
the recorder in scope, ``dist.collectives.record_wire_bytes``, beside
its wire-bytes records (whose totals are what they were); this module
reads those notes as :class:`ExplicitCollective` records.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, List, Tuple

from ..dist.collectives import record_wire_bytes
from ..launch.roofline import DTYPE_BYTES

# what the port's meshes issue (the reference's list, as the port names
# them)
COLLECTIVE_PRIMITIVES = frozenset({"pmax", "all_to_all", "all_gather"})


@dataclasses.dataclass(frozen=True)
class ExplicitCollective:
    """One collective a program's code issued."""
    primitive: str            # "pmax", "all_to_all", "all_gather"
    axes: Tuple[str, ...]     # logical axis names it exchanges over
    dtype: str                # "float32", "int8", ...
    dims: Tuple[int, ...]     # result shape on the recording rank

    @property
    def numel(self) -> int:
        return math.prod(self.dims) if self.dims else 1

    @property
    def nbytes(self) -> float:
        return float(self.numel * DTYPE_BYTES[self.dtype])

    def over(self, axis: str) -> bool:
        return axis in self.axes


class CollectiveRecord:
    """What :func:`record_collectives` yields: the collectives of the
    block, read after it."""

    def __init__(self, rec: record_wire_bytes):
        self._rec = rec

    @property
    def collectives(self) -> List[ExplicitCollective]:
        return [ExplicitCollective(p, a, d, s)
                for p, a, d, s in self._rec.collectives]


@contextlib.contextmanager
def record_collectives() -> Iterator[CollectiveRecord]:
    """Record every collective issued inside the block (one rank of a
    mesh records, as one trace does in the reference)."""
    with record_wire_bytes() as rec:
        yield CollectiveRecord(rec)


def summed_elements(colls) -> dict:
    """``{(primitive, axes, dtype): summed elements}`` of a record: the
    form in which two records of one exchange compare."""
    out: dict = {}
    for c in colls:
        key = (c.primitive, tuple(c.axes), c.dtype)
        out[key] = out.get(key, 0) + c.numel
    return out
