"""The differentiable HGQ quantizer and its kernel wrappers (counterpart
of ``repro/kernels/hgq_quantize/ops.py``).

``hgq_quantize(x, f)`` is Eq. 4 with the Algorithm-1 gradient:
straight-through in x (``dx = g``) and ``df = sum g * ln2 * (x - xq)``
over the axes f is broadcast along.  On CUDA tensors the forward and the
backward launch the hand-written kernels of ``csrc/hgq_quantize.cu``
(no fallback); on CPU tensors they take the plain versions in
``ref.py``.  The backward saves x and f, not the quantization error, and
recomputes ``xq``: one float32 tensor less per quantizer.

Five layouts of f reach the kernels, x viewed as [rows, cols] over its
last axis: per tensor (``f.ndim == 0``), per channel (``f`` of shape
``(N,)`` or ``(1, ..., 1, N)``, N the last axis), per parameter
(``f.shape == x.shape``), and over an MoE layer's expert stack x ``(E,
K, ..., N)`` per expert channel (``f`` of shape ``(E, 1, ..., 1, N)``) and
per expert tensor (``(E, 1, ..., 1)``), x's rows in E groups of K each
(``group_rows``).  On CUDA any other broadcast raises.

``hgq_quantize_group(xs, fs)`` quantizes a list of independent tensors,
each in its own layout and dtype, in one forward launch (a training
step's weight and bias quantizers); its backward is each member's
``hgq_quantize_bwd``.
"""
from __future__ import annotations

import collections
import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build
from . import ref

LAYOUTS = ("per_tensor", "per_channel", "per_parameter",
           "per_expert_channel", "per_expert_tensor")
_PER_EXPERT = ("per_expert_channel", "per_expert_tensor")
_DTYPES = (torch.float32, torch.bfloat16)


def layout_of(x_shape: Sequence[int], f_shape: Sequence[int]
              ) -> Optional[str]:
    """The kernel layout of f against x, or None if no kernel takes it."""
    x_shape, f_shape = tuple(x_shape), tuple(f_shape)
    if not f_shape:
        return "per_tensor"
    if f_shape == x_shape:
        return "per_parameter"
    if (x_shape and len(f_shape) <= len(x_shape)
            and f_shape[-1] == x_shape[-1]
            and all(d == 1 for d in f_shape[:-1])):
        return "per_channel"
    if (len(f_shape) == len(x_shape) >= 3 and f_shape[0] == x_shape[0]
            and all(d == 1 for d in f_shape[1:-1])):
        if f_shape[-1] == x_shape[-1]:
            return "per_expert_channel"
        if f_shape[-1] == 1:
            return "per_expert_tensor"
    return None


def _rows_cols(x: torch.Tensor) -> Tuple[int, int]:
    cols = x.shape[-1] if x.ndim else 1
    return (x.numel() // cols if cols else 0), cols


def _group_rows(x: torch.Tensor, lay: str) -> int:
    """The rows of x's [rows, cols] view an f group covers: an expert's
    under the per-expert layouts, all of them otherwise."""
    rows, _ = _rows_cols(x)
    return rows // x.shape[0] if lay in _PER_EXPERT else rows


def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed on first use."""
    lib = _build.load("hgq_quantize")
    if not getattr(lib, "typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hgq_quantize_fwd_launch.argtypes = [vp, vp, vp, ll, ci, ci, ci,
                                                ll, vp]
        lib.hgq_quantize_fwd_launch.restype = ci
        lib.hgq_quantize_fwd_group_launch.argtypes = [vp, ci, vp]
        lib.hgq_quantize_fwd_group_launch.restype = ci
        lib.hgq_quantize_fwd_group_max.argtypes = []
        lib.hgq_quantize_fwd_group_max.restype = ci
        lib.hgq_quantize_bwd_launch.argtypes = [vp, vp, vp, vp, vp, ll, ci,
                                                ci, ci, ll, vp]
        lib.hgq_quantize_bwd_launch.restype = ci
        lib.hgq_quantize_bwd_plan.argtypes = [ll, ci, ci, ci, ll, vp]
        lib.hgq_quantize_bwd_plan.restype = ll
        lib.typed = True
    return lib


def _check(what: str, f: torch.Tensor, *xs: torch.Tensor) -> str:
    x = xs[0]
    if not all(t.is_cuda and t.device == x.device for t in (f,) + xs):
        raise ValueError(f"{what} needs its tensors on one CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in xs):
        raise TypeError(f"{what} takes float32 or bfloat16 x (and g), got "
                        f"{[t.dtype for t in xs]}")
    if f.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 f, got {f.dtype}")
    if not all(t.is_contiguous() for t in (f,) + xs):
        raise ValueError(f"{what} needs contiguous tensors")
    if any(t.shape != x.shape for t in xs):
        raise ValueError(f"{what}: g {tuple(xs[-1].shape)} vs x "
                         f"{tuple(x.shape)}")
    lay = layout_of(x.shape, f.shape)
    if lay is None:
        raise ValueError(f"{what}: no kernel for f {tuple(f.shape)} against "
                         f"x {tuple(x.shape)} (per tensor, per channel over "
                         f"the last axis, per parameter, or per expert "
                         f"channel or tensor over the first axis)")
    return lay


def _key(lay: str, x: torch.Tensor) -> Tuple[str, Tuple[int, ...], str]:
    return lay, tuple(x.shape), str(x.dtype).replace("torch.", "")


def hgq_quantize_fwd(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The forward kernel: Eq. 4 of contiguous CUDA x (float32 or
    bfloat16) at contiguous float32 f in one of the five layouts."""
    lay = _check("hgq_quantize_fwd", f, x)
    out = torch.empty_like(x)
    rows, cols = _rows_cols(x)
    if rows == 0:
        return out
    _build.check(_lib().hgq_quantize_fwd_launch(
        x.data_ptr(), f.data_ptr(), out.data_ptr(), rows, cols,
        LAYOUTS.index(lay), int(x.dtype == torch.bfloat16),
        _group_rows(x, lay), _build.stream_ptr(x.device)), "hgq_quantize_fwd")
    hgq_quantize_fwd.launches += 1
    hgq_quantize_fwd.shapes[_key(lay, x)] += 1
    return out


# launches of the kernel, in all and by (layout, x shape, dtype)
hgq_quantize_fwd.launches = 0
hgq_quantize_fwd.shapes = collections.Counter()


def _member(x: torch.Tensor, f: torch.Tensor, out: torch.Tensor,
            lay: str) -> Tuple[int, ...]:
    rows, cols = _rows_cols(x)
    return (x.data_ptr(), f.data_ptr(), out.data_ptr(), rows, cols,
            LAYOUTS.index(lay), int(x.dtype == torch.bfloat16),
            _group_rows(x, lay))


# the values of a member's row of the grouped launch's table (``_member``)
_DESC = 8


def hgq_quantize_fwd_group(xs: Sequence[torch.Tensor],
                           fs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The forward kernel over a group: Eq. 4 of each contiguous CUDA x
    (float32 or bfloat16) at its contiguous float32 f, every member in
    its own layout, in one launch (of 64 members at most).  Returns the
    outputs in order."""
    if len(xs) != len(fs):
        raise ValueError(f"hgq_quantize_fwd_group: {len(xs)} x, {len(fs)} f")
    outs, members, keys = [], [], []
    for i, (x, f) in enumerate(zip(xs, fs)):
        lay = _check(f"hgq_quantize_fwd_group member {i}", f, x)
        if x.device != xs[0].device:
            raise ValueError("hgq_quantize_fwd_group needs one CUDA device")
        out = torch.empty_like(x)
        outs.append(out)
        if x.numel():
            members.append(_member(x, f, out, lay))
            keys.append(_key(lay, x))
    if not members:
        return outs
    lib = _lib()
    if len(members) > lib.hgq_quantize_fwd_group_max():
        raise ValueError(f"hgq_quantize_fwd_group: {len(members)} members, "
                         f"more than one launch takes")
    desc = (ctypes.c_longlong * (_DESC * len(members)))(
        *(v for m in members for v in m))
    _build.check(lib.hgq_quantize_fwd_group_launch(
        desc, len(members), _build.stream_ptr(xs[0].device)),
        "hgq_quantize_fwd_group")
    hgq_quantize_fwd_group.launches += 1
    hgq_quantize_fwd_group.shapes[tuple(keys)] += 1
    return outs


# launches of the kernel, in all and by the members' (layout, x shape,
# dtype) in order
hgq_quantize_fwd_group.launches = 0
hgq_quantize_fwd_group.shapes = collections.Counter()


def bwd_plan(rows: int, cols: int, layout: str, dtype: torch.dtype,
             group_rows: Optional[int] = None
             ) -> Tuple[Tuple[int, int, int], int]:
    """The backward kernel's geometry for x viewed as [rows, cols] at a
    per-channel, per-tensor or per-expert layout (``group_rows`` rows an
    expert, all of them by default): ((blocks a cluster, clusters, rows
    (per channel) or elements (per tensor) a block), each expert's alike,
    floats of scratch).  One cluster a group needs no scratch and no
    second launch."""
    plan = (ctypes.c_longlong * 3)()
    n = _lib().hgq_quantize_bwd_plan(
        rows, cols, LAYOUTS.index(layout), int(dtype == torch.bfloat16),
        rows if group_rows is None else group_rows, plan)
    if n < 0:
        raise ValueError(f"no backward plan for {layout} [{rows}, {cols}]")
    return tuple(plan), n


def hgq_quantize_bwd(g: torch.Tensor, x: torch.Tensor,
                     f: torch.Tensor) -> torch.Tensor:
    """The backward kernel: ``df`` (float32, f's shape) from contiguous
    CUDA g and x of one dtype and float32 f; a fixed-order reduction, one
    launch of thread block clusters (one an expert under the per-expert
    layouts) wherever one cluster a group suffices (``bwd_plan``)."""
    lay = _check("hgq_quantize_bwd", f, x, g)
    rows, cols = _rows_cols(x)
    if rows == 0:
        return torch.zeros_like(f)
    df = torch.empty_like(f)
    scratch = None
    grows = _group_rows(x, lay)
    if lay != "per_parameter":
        _, n_scratch = bwd_plan(rows, cols, lay, x.dtype, grows)
        if n_scratch:
            scratch = torch.empty((n_scratch,), dtype=torch.float32,
                                  device=x.device)
    _build.check(_lib().hgq_quantize_bwd_launch(
        g.data_ptr(), x.data_ptr(), f.data_ptr(), df.data_ptr(),
        None if scratch is None else scratch.data_ptr(), rows, cols,
        LAYOUTS.index(lay), int(x.dtype == torch.bfloat16), grows,
        _build.stream_ptr(x.device)), "hgq_quantize_bwd")
    hgq_quantize_bwd.launches += 1
    hgq_quantize_bwd.shapes[_key(lay, x)] += 1
    return df


# launches of the kernel, in all and by (layout, x shape, dtype)
hgq_quantize_bwd.launches = 0
hgq_quantize_bwd.shapes = collections.Counter()


class _HGQQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f):
        if x.is_cuda:
            x, f = x.contiguous(), f.contiguous()
            out = hgq_quantize_fwd(x, f)
        else:
            out = ref.hgq_quantize_ref(x, f)
        ctx.save_for_backward(x, f)
        return out

    @staticmethod
    def backward(ctx, g):
        x, f = ctx.saved_tensors
        df = None
        if ctx.needs_input_grad[1]:
            if x.is_cuda:
                df = hgq_quantize_bwd(g.contiguous(), x, f)
            else:
                df = ref.hgq_quantize_grad_ref(g, x, f)
        return (g if ctx.needs_input_grad[0] else None), df


class _HGQQuantizeGroup(torch.autograd.Function):
    """Inputs: the n x, then the n f; outputs: the n quantized x."""

    @staticmethod
    def forward(ctx, *xf):
        n = len(xf) // 2
        xs, fs = list(xf[:n]), list(xf[n:])
        if xs[0].is_cuda:
            xs = [x.contiguous() for x in xs]
            fs = [f.contiguous() for f in fs]
            outs = hgq_quantize_fwd_group(xs, fs)
        else:
            outs = ref.hgq_quantize_group_ref(xs, fs)
        ctx.save_for_backward(*xs, *fs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        n = len(saved) // 2
        dxs, dfs = [], []
        for i, g in enumerate(gs):
            x, f = saved[i], saved[n + i]
            dxs.append(g if ctx.needs_input_grad[i] else None)
            df = None
            if ctx.needs_input_grad[n + i]:
                if x.is_cuda:
                    df = hgq_quantize_bwd(g.contiguous(), x, f)
                else:
                    df = ref.hgq_quantize_grad_ref(g, x, f)
            dfs.append(df)
        return (*dxs, *dfs)


def hgq_quantize_group(xs: Sequence[torch.Tensor],
                       fs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`hgq_quantize` of each (x, f) pair, member by member the same
    values and gradients; on CUDA the forwards are one launch
    (``hgq_quantize_fwd_group``) and each backward one
    ``hgq_quantize_bwd``.  All members lie on one device."""
    if len(xs) != len(fs):
        raise ValueError(f"hgq_quantize_group: {len(xs)} x, {len(fs)} f")
    if not xs:
        return []
    dev = xs[0].device
    if any(t.device != dev for t in (*xs, *fs)):
        raise ValueError("hgq_quantize_group needs its tensors on one device")
    return list(_HGQQuantizeGroup.apply(*xs, *fs))


def hgq_quantize(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Differentiable HGQ quantizer (Alg. 1): Eq. 4 forward in x's dtype;
    ``dx = g``, ``df = sum g * ln2 * (x - xq)`` down to f's shape.

    f: a scalar (per tensor), ``(N,)`` / ``(1, ..., 1, N)`` over x's last
    axis (per channel), ``x.shape`` (per parameter), ``(E, 1, ..., 1, N)``
    or ``(E, 1, ..., 1)`` over an expert stack x ``(E, K, ..., N)`` (per
    expert channel or tensor); on the CPU any shape that broadcasts
    against x."""
    return _HGQQuantize.apply(x, f)

