"""Data meshes for the compressed gradient reduce: the port's stand-in for
``jax.make_mesh`` plus ``shard_map`` over the data axes.

A collective body (``dist.collectives``) is written for one rank and
talks to the others through a small interface, a *rank*:

* ``size`` (ranks in the mesh), ``index`` (this rank);
* ``pmax(x)``: the elementwise max over ranks;
* ``all_to_all(x)``: ``x`` is ``[size, ...]``; row ``j`` goes to rank
  ``j``, and row ``j`` of the result came from rank ``j``;
* ``all_gather(x)``: ``[size, ...]``, row ``j`` from rank ``j``;
* ``records``: whether this rank writes the wire-bytes records (a JAX
  trace records once per program, so one rank of a mesh does).

Two meshes run such bodies:

* :class:`LocalMesh` -- ``n`` ranks as ``n`` threads of one process on
  one device, exchanging tensors through shared slots and a
  ``threading.Barrier``.  This is how one card runs a data-parallel mesh:
  NCCL refuses two ranks on one GPU.  Every rank issues its work on the
  caller's current device and stream (both are per thread in PyTorch),
  so a tensor one rank hands over is complete, in stream order, before
  another rank's later work reads it.  Each rank runs in a copy of the
  caller's ``contextvars`` context, with autograd off.
* :class:`ProcessGroupMesh` -- one rank per process over a
  ``torch.distributed`` process group (gloo on the CPU, NCCL across
  cards): ``all_to_all_single``, list-form ``all_gather`` and
  ``all_reduce(MAX)``.

``mesh.shards`` is how many ranks' data a process holds: ``n`` for a
``LocalMesh`` (tensors with a leading ``[n]`` shard axis, as ``shard_map``
sees the global array) and 1 for a ``ProcessGroupMesh`` (leading axis 1,
this process's own shard).  ``mesh.run(body, args)`` runs ``body(rank,
args[i])`` for each local shard ``i`` and returns the results in order.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Any, Callable, List, Optional, Sequence

import torch

from ..device import resolve_device


class LocalMesh:
    """``n`` data ranks as threads of one process on one device."""

    def __init__(self, n: int, device=None):
        if n < 1:
            raise ValueError(f"a mesh needs at least one rank, got {n}")
        self.size = int(n)
        self.shards = self.size
        self.device = resolve_device(device)
        self._slots: List[Any] = [None] * self.size
        self._barrier = threading.Barrier(self.size)

    def __repr__(self) -> str:
        return f"LocalMesh({self.size}, device={self.device})"

    def _exchange(self, index: int, value: Any) -> List[Any]:
        """Every rank's ``value``, in rank order."""
        self._slots[index] = value
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()         # nobody overwrites a slot still read
        return out

    def run(self, body: Callable[[Any, Any], Any],
            args: Sequence[Any]) -> List[Any]:
        if len(args) != self.size:
            raise ValueError(f"{len(args)} shards for a mesh of {self.size}")
        if self.size == 1:
            with torch.no_grad():
                return [body(_LocalRank(self, 0), args[0])]
        results: List[Any] = [None] * self.size
        errors: List[Optional[BaseException]] = [None] * self.size
        self._barrier.reset()
        # the current device and stream are per thread: the ranks take the
        # caller's, so the work of every rank lands on one stream
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def rank_main(i: int) -> None:
            try:
                with contextlib.ExitStack() as stack:
                    if stream is not None:
                        stack.enter_context(torch.cuda.device(self.device))
                        stack.enter_context(torch.cuda.stream(stream))
                    stack.enter_context(torch.no_grad())
                    results[i] = body(_LocalRank(self, i), args[i])
            except BaseException as e:          # noqa: BLE001
                errors[i] = e
                self._barrier.abort()           # release the other ranks

        threads = [threading.Thread(
            target=contextvars.copy_context().run, args=(rank_main, i),
            name=f"LocalMesh-rank{i}") for i in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # the rank that failed first, not the ranks its abort released
        failed = sorted((isinstance(e, threading.BrokenBarrierError), i)
                        for i, e in enumerate(errors) if e is not None)
        if failed:
            raise errors[failed[0][1]]
        return results

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """``[shards, ...]`` -> ``[size, ...]``: every shard is local."""
        return x


class _LocalRank:
    """One thread's view of a :class:`LocalMesh`."""

    def __init__(self, mesh: LocalMesh, index: int):
        self.mesh = mesh
        self.size = mesh.size
        self.index = index
        self.records = index == 0

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        vals = self.mesh._exchange(self.index, x)
        out = vals[0]
        for v in vals[1:]:
            out = torch.maximum(out, v)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        vals = self.mesh._exchange(self.index, x)
        return torch.stack([v[self.index] for v in vals])

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self.mesh._exchange(self.index, x))


class ProcessGroupMesh:
    """One data rank per process over a ``torch.distributed`` group
    (initialized by the caller)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.shards = 1
        self.records = True

    def __repr__(self) -> str:
        return f"ProcessGroupMesh(rank {self.index} of {self.size})"

    def run(self, body: Callable[[Any, Any], Any],
            args: Sequence[Any]) -> List[Any]:
        if len(args) != 1:
            raise ValueError(f"a process holds one shard, got {len(args)}")
        with torch.no_grad():
            return [body(self, args[0])]

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        self._dist.all_reduce(y, op=self._dist.ReduceOp.MAX, group=self.group)
        return y

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, ...]`` -> ``[size, ...]``: every process's shard."""
        return self.all_gather(x[0])
