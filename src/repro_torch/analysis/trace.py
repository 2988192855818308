"""What one run of a program did (the port's counterpart of
``repro/analysis/hlo.py``, which parses a compiled module).

The port runs eagerly, so there is no compiled module to parse: a
:class:`ProgramTrace` (a ``TorchDispatchMode``) watches one run and
reads, with the kernel wrappers' tallies:

* every ATen operation, by name and output dtype, with its matmul FLOPs
  (``torch.utils.flop_counter``'s formulas) and bytes (each tensor
  argument read once, each output that is not a view written once; a
  copy between the host and the device is no device-memory traffic);
* the port's kernel ops (``kernels._work``): each call counted once with
  its own FLOP and byte formula, the ATen operations inside it not again,
  so the count is the same whatever implements the op (the plain version
  on the CPU and on ``meta``, the kernel on the card);
* the kernels launched, by name and shape (the wrappers' ``shapes``
  tallies; none on the CPU);
* every float64 operation, by the module of the port it comes from (a
  backward operation by the module whose forward made its autograd node);
* the storages written in place (ATen arguments the schema marks as
  written, and a kernel op's declared writes): the port's counterpart of
  a compiled module's input-output aliases;
* the collectives the program's meshes issued (``analysis.collectives``).

The ranks of a ``dist.LocalMesh`` are threads, which do not inherit a
dispatch mode: the trace hands them one of their own through
``dist.mesh.RANK_SCOPES``.  Autograd's own threads (the backward on the
card) carry the caller's dispatch modes.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import sys
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..dist.mesh import RANK_SCOPES
from ..kernels._work import tensors
from .collectives import ExplicitCollective, record_collectives

# the modules that sum in float64 on purpose (ROADMAP Queue 3's parity
# rules): norm means, the RWKV contractions, the fixed-point proxy
F64_SITES = ("repro_torch.nn.basic", "repro_torch.nn.recurrent",
             "repro_torch.core.fixedpoint")

# every kernel wrapper of the port: (name, module, function), whose
# ``shapes`` tally counts its launches by shape
LAUNCH_TALLIES = tuple(
    (name, f"repro_torch.kernels.{pkg}.ops", name) for pkg, names in (
        ("qmatmul", ("qmatmul",)),
        ("kv_dequant", ("kv_quantize_rows", "kv_quantize_store",
                        "kv_dequant_rows", "kv_attention_rows")),
        ("hgq_quantize", ("hgq_quantize_fwd", "hgq_quantize_fwd_group",
                          "hgq_quantize_bwd")),
        ("wire_pack", ("wire_quantize_rows", "wire_quantize_sflat",
                       "wire_pack_rows", "wire_dequant_rows",
                       "wire_quantize_bucket", "wire_dequant_bucket")))
    for name in names)

_CONVOLUTIONS = ("convolution", "_convolution", "cudnn_convolution",
                 "convolution_overrideable", "_slow_conv2d_forward",
                 "convolution_backward")
_COPIES = ("_to_copy", "copy_", "_copy_from", "_copy_from_and_resize")


def _launch_fns():
    return [(name, getattr(importlib.import_module(mod), fn))
            for name, mod, fn in LAUNCH_TALLIES]


def storage_id(t: torch.Tensor) -> int:
    """An identity of ``t``'s storage that also holds on ``meta`` (where
    every data pointer is 0)."""
    return t.untyped_storage()._cdata


def peak_class(dtype: torch.dtype, conv: bool) -> str:
    """The peak class of a matmul or convolution on ``dtype``: float32
    runs at the TF32 rate where the port lets it (the flags as set when
    the operation runs)."""
    if dtype == torch.float32:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tf32 = (torch.backends.cudnn.allow_tf32 if conv
                    else torch.backends.cuda.matmul.allow_tf32)
        return "tf32" if tf32 else "float32"
    return str(dtype).replace("torch.", "")


class _Sites(TorchFunctionMode):
    """Maps each autograd node a float64 result comes from to the module
    that made it, so the backward's float64 operations (which run with no
    frame of the port on the stack) are charged to that module."""

    def __init__(self, trace: "ProgramTrace"):
        super().__init__()
        self.trace = trace

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = list(tensors(out))
        if any(t.dtype == torch.float64 for t in outs) or any(
                t.dtype == torch.float64 for t in tensors(args)):
            site = _python_site()
            for t in outs:
                if t.grad_fn is not None:
                    self.trace._node_site[t.grad_fn] = site
        return out


def _python_site() -> Optional[str]:
    """The innermost module of the port on the Python stack, above any
    autograd engine frame (the analysis and the kernel-op counter
    skipped); None where there is none."""
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and not mod.startswith(
                ("repro_torch.analysis", "repro_torch.kernels._work")):
            return mod
        if mod.startswith("torch.autograd") and f.f_code.co_name in (
                "_engine_run_backward", "grad", "backward"):
            return None
        f = f.f_back
    return None


class ProgramTrace(TorchDispatchMode):
    """Counts and records one run (see the module docstring).  Use as a
    context manager around the run; read the fields after it.  With
    ``formulas=False`` a kernel op's ATen operations are counted in place
    of its formula (what its plain version runs on the CPU: the check
    that the formulas and the plain bodies agree)."""

    def __init__(self, formulas: bool = True):
        super().__init__()
        self.formulas = formulas
        self.ops: collections.Counter = collections.Counter()
        self.flops_by_dtype: collections.Counter = collections.Counter()
        self.bytes = 0.0
        self.kernel_ops: collections.Counter = collections.Counter()
        self.f64_ops: collections.Counter = collections.Counter()
        self.writes: set = set()
        self.launches: collections.Counter = collections.Counter()
        self.collectives: List[ExplicitCollective] = []
        self._node_site: Dict[Any, str] = {}
        self._schemas: Dict[Any, Tuple] = {}
        self._local = threading.local()
        self._lock = threading.Lock()
        self._stack: List[Any] = []

    # --------------------------- the run --------------------------------

    def __enter__(self):
        fns = _launch_fns()
        self._tallies = [(name, fn, collections.Counter(fn.shapes))
                         for name, fn in fns]
        rec = record_collectives()
        self._stack = [rec, RANK_SCOPES.scope(
            RANK_SCOPES.get() + (self._rank_mode,)), _Sites(self)]
        self._record = self._stack[0].__enter__()
        for cm in self._stack[1:]:
            cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        for cm in reversed(self._stack[1:]):
            cm.__exit__(*exc)
        self.collectives = self._record.collectives
        self._stack[0].__exit__(*exc)
        self._stack = []
        for name, fn, before in self._tallies:
            for key, n in fn.shapes.items():
                if n - before.get(key, 0):
                    self.launches[name, key] += n - before.get(key, 0)
        return out

    def _rank_mode(self):
        return _RankMode(self)

    # ------------------------- kernel ops -------------------------------

    def kernel_op(self, name: str):
        """The extent of one kernel op on this thread: ATen operations in
        it are not counted (``kernels._work``)."""
        return _Inside(self._local if self.formulas else None)

    def add_kernel_op(self, name: str, shapes: Tuple, flops: float,
                      nbytes: float, writes, flops_dtype: str) -> None:
        with self._lock:
            self.kernel_ops[name] += 1
            if self.formulas:
                if flops:
                    self.flops_by_dtype[flops_dtype] += flops
                self.bytes += nbytes
            for t in writes:
                self.writes.add(storage_id(t))

    # --------------------------- ATen ops -------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not getattr(self._local, "depth", 0):
            self._count(func, args, kwargs, out)
        return out

    def _schema(self, func):
        info = self._schemas.get(func)
        if info is None:
            schema = func._schema
            written = tuple(
                (i, a.name) for i, a in enumerate(schema.arguments)
                if a.alias_info is not None and a.alias_info.is_write)
            views = tuple(r.alias_info is not None
                          and not r.alias_info.is_write
                          for r in schema.returns)
            info = self._schemas[func] = (written, views)
        return info

    def _count(self, func, args, kwargs, out) -> None:
        written, views = self._schema(func)
        packet = func._overloadpacket
        name = packet.__name__
        outs = list(tensors(out))
        ins = list(tensors(args)) + list(tensors(list(kwargs.values())))
        moved = sum(t.numel() * t.element_size() for t in ins)
        rets = out if isinstance(out, (list, tuple)) else (out,)
        for i, r in enumerate(rets):
            if not (i < len(views) and views[i]):
                moved += sum(t.numel() * t.element_size()
                             for t in tensors(r))
        if len(views) and all(views) and not written:
            moved = 0                          # a view moves nothing
        if name in _COPIES and len({t.device for t in ins + outs}) > 1:
            # a copy between the host and the device: not device-memory
            # traffic of the program (on the CPU the same line copies
            # nothing, on the card and on meta it crosses)
            moved = 0
        flops = 0
        fn = flop_registry.get(packet)
        if fn is not None:
            flops = fn(*args, **kwargs, out_val=out)
        f64 = any(t.dtype == torch.float64 for t in ins + outs)
        site = _site(self) if f64 else None
        dtype = str(outs[0].dtype).replace("torch.", "") if outs else ""
        with self._lock:
            self.ops[name, dtype] += 1
            self.bytes += moved
            if flops:
                first = next(iter(tensors(args)), None)
                self.flops_by_dtype[peak_class(
                    first.dtype if first is not None else torch.float32,
                    name in _CONVOLUTIONS)] += flops
            if f64:
                self.f64_ops[site] += 1
            for i, arg_name in written:
                t = args[i] if i < len(args) else kwargs.get(arg_name)
                for w in tensors(t):
                    self.writes.add(storage_id(w))

    # ------------------------- the readings -----------------------------

    @property
    def flops(self) -> float:
        """Matmul FLOPs of the run: ATen operations outside kernel ops,
        plus each kernel op's own count."""
        return float(sum(self.flops_by_dtype.values()))

    @property
    def kernel_launches(self) -> Dict[str, int]:
        out: Dict[str, int] = collections.Counter()
        for (name, _), n in self.launches.items():
            out[name] += n
        return dict(out)

    def f64_outside(self, sites=F64_SITES) -> Dict[str, int]:
        """Float64 operations charged to modules other than ``sites``."""
        return {m: n for m, n in self.f64_ops.items() if m not in sites}

    def written_in_place(self, before, after) -> int:
        """How many of the leaves ``before`` (the state a program took) are
        the storages of ``after`` (the state it returned), unchanged, and
        were written during the run."""
        return sum(1 for b, a in zip(before, after)
                   if storage_id(b) == storage_id(a)
                   and storage_id(b) in self.writes)


def _site(trace: ProgramTrace) -> str:
    site = _python_site()
    if site is not None:
        return site
    node = torch._C._current_autograd_node()
    if node is not None:
        return trace._node_site.get(node, f"autograd:{node.name()}")
    return "<no module of the port>"


class _Inside:
    """Marks one thread as inside a kernel op (nestable; ``local`` None:
    marks nothing)."""

    def __init__(self, local: Optional[threading.local]):
        self.local = local

    def __enter__(self):
        if self.local is not None:
            self.local.depth = getattr(self.local, "depth", 0) + 1

    def __exit__(self, *exc):
        if self.local is not None:
            self.local.depth -= 1


class _RankMode(TorchDispatchMode):
    """A LocalMesh rank thread's share of a trace: the same counts."""

    def __init__(self, trace: ProgramTrace):
        super().__init__()
        self.trace = trace

    def kernel_op(self, name: str):
        return self.trace.kernel_op(name)

    def add_kernel_op(self, *args) -> None:
        self.trace.add_kernel_op(*args)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not getattr(self.trace._local, "depth", 0):
            self.trace._count(func, args, kwargs, out)
        return out


@dataclasses.dataclass
class ProgramRun:
    """One traced run of a program and the state around it: ``inputs``
    and ``outputs`` map a role (``"params"``, ``"moments"``,
    ``"residual"``, ``"caches"``, ``"returned"``, ...) to the tensor
    leaves the program took or gave back, in one order per role."""
    trace: ProgramTrace
    inputs: Dict[str, List[torch.Tensor]]
    outputs: Dict[str, List[torch.Tensor]]

    def in_place(self, role: str) -> int:
        """Leaves of ``role`` returned in the storage they came in, and
        written during the run."""
        return self.trace.written_in_place(self.inputs.get(role, []),
                                           self.outputs.get(role, []))

    def moved(self, role: str) -> int:
        """Leaves of ``role`` returned in another storage than they came
        in (a copy of the state)."""
        return sum(1 for a, b in zip(self.inputs.get(role, []),
                                     self.outputs.get(role, []))
                   if storage_id(a) != storage_id(b))


def trace_program(fn, *args, **kwargs) -> Tuple[Any, ProgramTrace]:
    """``(fn(*args, **kwargs), the trace of that run)``."""
    with ProgramTrace() as tr:
        out = fn(*args, **kwargs)
    return out, tr
