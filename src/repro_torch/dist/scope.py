"""Per-call dynamic scope for knobs that must not be module globals
(counterpart of ``repro/dist/scope.py``; the port keeps its own copy).

:class:`Scoped` holds one immutable default plus a ``contextvars``-backed
stack of overrides: ``get()`` returns the innermost override, else the
default; ``scope(value)`` pushes an override for the extent of a block
(re-entrant); ``set_default`` / ``reset_default`` rebind the process
default.  Overrides are task- and thread-local: a thread started inside
a scope sees it only when it runs in a copy of the caller's context
(``contextvars.copy_context()``), as ``dist.mesh.LocalMesh`` runs its
ranks.  Its users: the axis registry (``dist.axes``), the compute dtype
and the packed routing (``dist.perf``), and the wire-bytes recorder of
``dist.collectives``.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Generic, Iterator, Tuple, TypeVar

T = TypeVar("T")


class Scoped(Generic[T]):
    """One trace-time knob: an immutable default + a scoped override stack."""

    def __init__(self, name: str, default: T):
        self._var: ContextVar[Tuple[T, ...]] = ContextVar(name, default=())
        self._initial = default
        # one-element list, not a module global: rebound only through
        # set_default (the deprecated-shim delegation point)
        self._default = [default]

    def get(self) -> T:
        stack = self._var.get()
        return stack[-1] if stack else self._default[0]

    def set_default(self, value: T) -> None:
        """Rebind the process-wide default (deprecated shims only)."""
        self._default[0] = value

    def reset_default(self) -> None:
        """Back to the construction-time default (tests)."""
        self._default[0] = self._initial

    @contextlib.contextmanager
    def scope(self, value: T) -> Iterator[T]:
        """Push ``value`` for the dynamic extent of the block (re-entrant)."""
        token = self._var.set(self._var.get() + (value,))
        try:
            yield value
        finally:
            self._var.reset(token)
