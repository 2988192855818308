"""Meshes for the compressed gradient reduce: the port's stand-in for
``jax.make_mesh`` plus ``shard_map`` over a ``data x model`` mesh.

A collective body (``dist.collectives``) is written for one rank and
talks to the others through a small interface, a *rank*:

* ``size`` (ranks in the mesh), ``index`` (this rank, ``d * M + m`` for
  data index ``d`` and model index ``m`` on a ``D x M`` mesh),
  ``data_index``, ``model_index``;
* ``pmax(x)``: the elementwise max over every rank of the mesh;
* ``all_to_all(x)``: over the data axis, among the ranks of this model
  index: ``x`` is ``[D, ...]``; row ``j`` goes to data rank ``j``, and
  row ``j`` of the result came from data rank ``j``;
* ``all_gather(x, axis="data")``: ``[D, ...]``, row ``j`` from data rank
  ``j`` of this model index; ``axis="model"``: ``[M, ...]``, row ``j``
  from model rank ``j`` of this data index;
* ``records``: whether this rank writes the wire-bytes records and notes
  the collectives it issues in the recorder in scope (``RECORDER``, which
  ``collectives.record_wire_bytes`` binds; a JAX trace records once per
  program, so one rank of a mesh does);
* ``delivers``: whether this rank's result is the one the mesh returns
  (every rank of a ``ProcessGroupMesh``; rank 0 of a ``LocalMesh``,
  whose ranks share one device and return one delivered tree).

A mesh has ``axis_names`` (``("data", "model")``) and ``axis_sizes``
(``(D, M)``), which the placement rules (``dist.sharding``) and the axis
registry (``dist.axes``) read, and ``data`` and ``model``, the two sizes.
A mesh of ``model`` 1 is a data mesh: its collectives are the 1D
exchange's, rank ``d`` of ``D``.

Two meshes run such bodies:

* :class:`LocalMesh` -- ``D x M`` ranks as threads of one process on
  one device, exchanging tensors through shared slots.  This is how one
  card runs a mesh: NCCL refuses two ranks on one GPU.  The ranks take
  turns: one runs at a time, up to its next collective, where it leaves
  its value in its slot and hands the turn to the next rank; the last
  rank's deposit completes the exchange, and each rank reads the slots
  when its turn comes back.  So no two ranks contend for the
  interpreter (their host work is serial under it anyway).  Every rank
  issues its work on the caller's current device and stream (both are
  per thread in PyTorch), so a tensor one rank hands over is complete,
  in stream order, before another rank's later work reads it.  Each rank
  runs in a copy of the caller's ``contextvars`` context, with autograd
  off, inside the context managers ``RANK_SCOPES`` gives (a thread does
  not inherit the caller's dispatch modes: a work counter adds its own).
  Every rank takes part in every exchange (the bodies issue one sequence
  of collectives on every rank) and reads the slots of its own row or
  column.
* :class:`ProcessGroupMesh` -- one rank per process over a
  ``torch.distributed`` process group (gloo on the CPU, NCCL across
  cards): ``all_to_all_single``, list-form ``all_gather`` and
  ``all_reduce(MAX)``, over one group per model index (the data axis) and
  one per data index (the model axis).

``mesh.shards`` is how many data shards a process holds: ``D`` for a
``LocalMesh`` (tensors with a leading ``[D]`` shard axis, as
``shard_map`` sees the global array) and 1 for a ``ProcessGroupMesh``
(leading axis 1, this process's own shard).  ``mesh.local_ranks`` lists
the ``(data shard, model index)`` of each rank the process runs, in
order; ``mesh.run(body, args)`` runs ``body(rank, args[i])`` for each of
them and returns the results in order.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Any, Callable, ContextManager, List, Optional, Sequence, \
    Tuple

import torch

from ..device import resolve_device
from .scope import Scoped


AXIS_NAMES = ("data", "model")

# the recorder in scope (``collectives.record_wire_bytes``): it takes the
# wire-bytes records and each collective a recording rank issues
RECORDER: Scoped[Optional[Any]] = Scoped("repro_torch.dist.recorder", None)
# factories of the context managers every LocalMesh rank thread enters
RANK_SCOPES: Scoped[Tuple[Callable[[], ContextManager], ...]] = Scoped(
    "repro_torch.dist.rank_scopes", ())


def _note(rank, primitive: str, axes: Tuple[str, ...],
          out: torch.Tensor) -> torch.Tensor:
    """Note one collective's result in the recorder in scope (on the rank
    that records); returns ``out``."""
    rec = RECORDER.get()
    if rec is not None and rank.records:
        rec.collective(primitive, axes, out)
    return out


def _pmax_axes(mesh) -> Tuple[str, ...]:
    """The logical axes ``pmax`` spans: every rank of the mesh."""
    return AXIS_NAMES if mesh.model > 1 else AXIS_NAMES[:1]


class LocalMesh:
    """``n x model`` ranks as threads of one process on one device."""

    def __init__(self, n: int, device=None, model: int = 1):
        if n < 1 or model < 1:
            raise ValueError(f"a mesh needs at least one rank on each axis, "
                             f"got {n} x {model}")
        self.data = int(n)
        self.model = int(model)
        self.size = self.data * self.model
        self.shards = self.data
        self.axis_names = AXIS_NAMES
        self.axis_sizes = (self.data, self.model)
        self.local_ranks = [(d, m) for d in range(self.data)
                            for m in range(self.model)]
        self.device = resolve_device(device)
        # two generations of slots: rank i reads generation g while the
        # ranks before it already deposit g + 1
        self._slots: List[List[Any]] = [[None] * self.size,
                                        [None] * self.size]
        self._turns = [threading.Event() for _ in range(self.size)]
        self._gen = [0] * self.size
        self._broken = False

    def __repr__(self) -> str:
        model = f", model={self.model}" if self.model > 1 else ""
        return f"LocalMesh({self.data}{model}, device={self.device})"

    def _hand_on(self, index: int) -> None:
        self._turns[(index + 1) % self.size].set()

    def _wait_turn(self, index: int) -> None:
        self._turns[index].wait()
        self._turns[index].clear()
        if self._broken:
            raise threading.BrokenBarrierError

    def _exchange(self, index: int, value: Any) -> List[Any]:
        """Every rank's ``value``, in rank order."""
        slots = self._slots[self._gen[index] % 2]
        self._gen[index] += 1
        slots[index] = value
        self._hand_on(index)
        self._wait_turn(index)
        return list(slots)

    def run(self, body: Callable[[Any, Any], Any],
            args: Sequence[Any]) -> List[Any]:
        if len(args) != self.size:
            raise ValueError(f"{len(args)} shards for a mesh of {self.size}")
        if self.size == 1:
            with torch.no_grad():
                return [body(_LocalRank(self, 0), args[0])]
        results: List[Any] = [None] * self.size
        errors: List[Optional[BaseException]] = [None] * self.size
        self._broken = False
        self._gen = [0] * self.size
        for ev in self._turns:
            ev.clear()
        # the current device and stream are per thread: the ranks take the
        # caller's, so the work of every rank lands on one stream
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def rank_main(i: int) -> None:
            try:
                self._wait_turn(i)
                with contextlib.ExitStack() as stack:
                    if stream is not None:
                        stack.enter_context(torch.cuda.device(self.device))
                        stack.enter_context(torch.cuda.stream(stream))
                    stack.enter_context(torch.no_grad())
                    for scope in RANK_SCOPES.get():
                        stack.enter_context(scope())
                    results[i] = body(_LocalRank(self, i), args[i])
                self._hand_on(i)
            except BaseException as e:          # noqa: BLE001
                errors[i] = e
                self._broken = True             # release the other ranks
                for ev in self._turns:
                    ev.set()

        threads = [threading.Thread(
            target=contextvars.copy_context().run, args=(rank_main, i),
            name=f"LocalMesh-rank{i}") for i in range(self.size)]
        for t in threads:
            t.start()
        self._turns[0].set()
        for t in threads:
            t.join()
        # the rank that failed first, not the ranks its abort released
        failed = sorted((isinstance(e, threading.BrokenBarrierError), i)
                        for i, e in enumerate(errors) if e is not None)
        if failed:
            raise errors[failed[0][1]]
        return results

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """``[shards, ...]`` -> ``[data, ...]``: every shard is local."""
        return x


class _LocalRank:
    """One thread's view of a :class:`LocalMesh`."""

    def __init__(self, mesh: LocalMesh, index: int):
        self.mesh = mesh
        self.size = mesh.size
        self.index = index
        self.data_index, self.model_index = divmod(index, mesh.model)
        self.records = self.delivers = index == 0

    def _group(self, axis: str) -> range:
        """The ranks along ``axis`` through this one, in axis order."""
        M = self.mesh.model
        if axis == "data":
            return range(self.model_index, self.size, M)
        if axis == "model":
            return range(self.data_index * M, (self.data_index + 1) * M)
        raise ValueError(f"axis must be 'data' or 'model', got {axis!r}")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        vals = self.mesh._exchange(self.index, x)
        out = vals[0]
        for v in vals[1:]:
            out = torch.maximum(out, v)
        return _note(self, "pmax", _pmax_axes(self.mesh), out)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        vals = self.mesh._exchange(self.index, x)
        return _note(self, "all_to_all", ("data",), torch.stack(
            [vals[j][self.data_index] for j in self._group("data")]))

    def all_gather(self, x: torch.Tensor, axis: str = "data"
                   ) -> torch.Tensor:
        group = self._group(axis)
        vals = self.mesh._exchange(self.index, x)
        return _note(self, "all_gather", (axis,),
                     torch.stack([vals[j] for j in group]))


class ProcessGroupMesh:
    """One rank per process over a ``torch.distributed`` group (initialized
    by the caller): ``data x model`` ranks, rank ``r`` of the group at data
    index ``r // model`` and model index ``r % model``.  With ``model`` above
    1 every process creates one group per model index and one per data
    index, in one order."""

    def __init__(self, group=None, model: int = 1):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        if model < 1 or self.size % model:
            raise ValueError(f"a model axis of {model} does not divide "
                             f"{self.size} ranks")
        self.model = int(model)
        self.data = self.size // self.model
        self.data_index, self.model_index = divmod(self.index, self.model)
        self.axis_names = AXIS_NAMES
        self.axis_sizes = (self.data, self.model)
        self.shards = 1
        self.local_ranks = [(0, 0)]
        self.records = self.delivers = True
        self._groups = {"data": group, "model": None}
        if self.model > 1:
            ranks = (list(range(self.size)) if group is None
                     else dist.get_process_group_ranks(group))
            D, M = self.data, self.model
            cols = [dist.new_group([ranks[d * M + m] for d in range(D)])
                    for m in range(M)]
            rows = [dist.new_group([ranks[d * M + m] for m in range(M)])
                    for d in range(D)]
            self._groups = {"data": cols[self.model_index],
                            "model": rows[self.data_index]}

    def __repr__(self) -> str:
        return (f"ProcessGroupMesh(rank {self.index} of {self.data} x "
                f"{self.model})")

    def run(self, body: Callable[[Any, Any], Any],
            args: Sequence[Any]) -> List[Any]:
        if len(args) != 1:
            raise ValueError(f"a process holds one shard, got {len(args)}")
        with torch.no_grad():
            return [body(self, args[0])]

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        self._dist.all_reduce(y, op=self._dist.ReduceOp.MAX, group=self.group)
        return _note(self, "pmax", _pmax_axes(self), y)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x, group=self._groups["data"])
        return _note(self, "all_to_all", ("data",), out)

    def all_gather(self, x: torch.Tensor, axis: str = "data"
                   ) -> torch.Tensor:
        if axis not in self._groups:
            raise ValueError(f"axis must be 'data' or 'model', got {axis!r}")
        x = x.contiguous()
        n = self.data if axis == "data" else self.model
        if n == 1:
            return _note(self, "all_gather", (axis,), x[None])
        parts = [torch.empty_like(x) for _ in range(n)]
        self._dist.all_gather(parts, x, group=self._groups[axis])
        return _note(self, "all_gather", (axis,), torch.stack(parts))

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, ...]`` -> ``[data, ...]``: every data shard."""
        return self.all_gather(x[0])
