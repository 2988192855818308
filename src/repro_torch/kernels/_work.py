"""The work of a kernel op, counted the same whatever implements it.

Every entry point that picks between a hand-written kernel (a CUDA
tensor) and its plain PyTorch version (any other tensor, ``meta``
included) is wrapped by :func:`kernel_op`.  Where a work counter is
active (``analysis.trace.ProgramTrace``, a ``TorchDispatchMode``), the
call is counted once as the op: its FLOPs and bytes from a formula over
its arguments' shapes (each formula sits beside the op's plain version,
in the package's ``ref.py``), its writes, and its name.  The ATen
operations it runs inside (the plain body on the CPU, the output
allocations of a kernel's wrapper on the card) are not counted a second
time.  So a count is the same on the CPU, on the card and on ``meta``.

A formula ``work(out, *args, **kwargs)`` sees the op's result and its
arguments and returns ``(flops, nbytes, writes)``: matmul FLOPs (0 for
an elementwise op), the bytes the op must move (its inputs read once,
its outputs written once, as the roofline counts them), and the tensors
it writes in place (``()`` when it writes only fresh outputs).

The same decorator counts one plain-PyTorch op whose sizes depend on
the data (the embedding gradient's segmented sum, ``nn.basic``): given a
``meta`` function, it returns that function's result of the right shape
on ``meta`` tensors, where the data it would read does not exist, and
its formula counts it the same everywhere.

Where no counter is active the wrapper costs one call of
``torch._C._len_torch_dispatch_stack``.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Iterable, Optional, Tuple

import torch

Work = Tuple[float, float, Tuple[torch.Tensor, ...]]


def active_counters() -> Tuple[Any, ...]:
    """The dispatch modes that count kernel ops (nested counts each count
    every op).  Found through the dispatch-mode stack, which PyTorch hands
    to the autograd engine's threads, so a backward on the card is counted
    too."""
    if not torch._C._len_torch_dispatch_stack():
        return ()
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return tuple(m for m in _get_current_dispatch_mode_stack()
                 if hasattr(m, "kernel_op"))


def kernel_op(name: str, work: Callable[..., Work],
              flops_dtype: str = "float32",
              meta: Optional[Callable[..., Any]] = None):
    """Decorator: count each call of the wrapped entry point as one
    ``name`` op of ``work``'s FLOPs and bytes (see the module docstring);
    ``flops_dtype`` names the peak its FLOPs run at (``launch.roofline``:
    ``"bfloat16"`` for the tensor cores ``qmatmul`` runs on); ``meta``,
    where given, stands for the op on ``meta`` tensors."""
    def wrap(fn):
        body = fn if meta is None else _or_meta(fn, meta)

        @functools.wraps(fn)
        def counted(*args, **kwargs):
            counters = active_counters()
            if not counters:
                return body(*args, **kwargs)
            with contextlib.ExitStack() as inside:
                for c in counters:
                    inside.enter_context(c.kernel_op(name))
                out = body(*args, **kwargs)
            flops, moved, writes = work(out, *args, **kwargs)
            for c in counters:
                c.add_kernel_op(name, _shapes(args), flops, moved, writes,
                                flops_dtype)
            return out
        return counted
    return wrap


def _or_meta(fn, meta):
    def run(*args, **kwargs):
        if any(t.is_meta for t in tensors(args)):
            return meta(*args, **kwargs)
        return fn(*args, **kwargs)
    return run


def _shapes(args) -> Tuple:
    return tuple(tuple(a.shape) for a in tensors(args))


def tensors(x: Any) -> Iterable[torch.Tensor]:
    """The tensors of ``x``: a tensor, or lists / tuples of them (None and
    other values skipped)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors(v)


def nbytes(*xs: Any) -> float:
    """Bytes of every tensor in ``xs`` (see :func:`tensors`)."""
    return float(sum(t.numel() * t.element_size()
                     for x in xs for t in tensors(x)))


def io_work(out: Any, *args: Any) -> Work:
    """The work of an elementwise op: no matmul FLOPs, every tensor
    argument read once and every output written once."""
    return 0.0, nbytes(args) + nbytes(out), ()


def rows_of(x: torch.Tensor) -> int:
    """Rows of ``x`` viewed as [rows, last axis]."""
    return math.prod(x.shape[:-1]) if x.ndim else 1
