"""Packed-weight dequant matmul: packing helpers and the kernel wrapper
(counterpart of ``repro/kernels/qmatmul/ops.py``).

``pack_linear`` turns HGQ (w, f) into the serving form (int8-stored
mantissas + per-channel 2^-f scale); ``qmatmul_any`` multiplies by it.
On a CUDA tensor ``qmatmul_any`` launches the hand-written kernel of
``csrc/qmatmul.cu`` (no fallback); on a CPU tensor it takes the plain
version in ``ref.py``.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import torch

from ...core.quantizer import _exp2i, floor_log2
from .. import _build
from .ref import pack_ref, qmatmul_ref, unpack_nibbles


def mantissa_max(bits: int = 8) -> int:
    """Largest symmetric mantissa of a ``bits``-wide signed grid."""
    if not 2 <= bits <= 8:
        raise ValueError(f"grid width must be in [2, 8], got {bits!r}")
    return 2 ** (bits - 1) - 1


def grid_exponent(amax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Largest exponent ``f`` whose ``bits``-wide grid 2^-f fits
    magnitudes up to ``amax``; one lower where rounding still saturates.
    ``qmax / amax`` is a true division: PyTorch computes ``number /
    tensor`` as ``reciprocal(tensor) * number``, which can land an ulp
    below a power of two and drop ``f`` by one."""
    qmax = float(mantissa_max(bits))
    amax = torch.as_tensor(amax, dtype=torch.float32)
    fcap = floor_log2(torch.full_like(amax, qmax)
                      / torch.clamp(amax, min=1e-12))
    return torch.where(torch.floor(amax * _exp2i(fcap) + 0.5) > qmax,
                       fcap - 1.0, fcap)


def channel_bits(w: torch.Tensor, f: Optional[torch.Tensor],
                 bits: int = 8) -> torch.Tensor:
    """Per-output-channel fractional bits for packing ``w [..., K, N]``:
    the channel max of the trained ``f``, capped so the channel amax fits
    the ``bits``-wide mantissa (the cap alone when ``f`` is None)."""
    w32 = w.to(torch.float32)
    amax = torch.amax(torch.abs(w32), dim=-2)
    fgrid = grid_exponent(amax, bits)
    if f is None:
        return fgrid
    fb = torch.broadcast_to(torch.as_tensor(f, dtype=torch.float32,
                                            device=w.device), w32.shape)
    fi = torch.amax(torch.floor(fb + 0.5), dim=-2)
    return torch.minimum(fi, fgrid)


def pack_weights(w: torch.Tensor, f: torch.Tensor, bits: int = 8
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] fp weights + fractional bits (scalar | [N] | [K, N]) ->
    (int8-stored mantissas, [N] scale)."""
    f = torch.as_tensor(f, dtype=torch.float32, device=w.device)
    if f.ndim == 0:
        fcol = torch.full((w.shape[1],), float(f), device=w.device)
    elif f.ndim == 1:
        fcol = torch.broadcast_to(f, (w.shape[1],))
    else:
        fcol = torch.amax(torch.broadcast_to(f, w.shape), dim=0)
    return pack_ref(w, fcol, bits)


def pack_linear(w: torch.Tensor, f: Optional[torch.Tensor] = None,
                bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """``w [..., K, N]`` (leading stacked-layer axes allowed) ->
    ``(mantissas [..., K, N], scale [..., N])`` at the capped per-channel
    bits of :func:`channel_bits`."""
    w32 = w.to(torch.float32)
    return pack_ref(w32, channel_bits(w32, f, bits), bits)


def pack_nibbles(m: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int4-range mantissas two per int8 byte along ``axis`` (even
    index in the low nibble; odd lengths pad one zero nibble)."""
    m = torch.movedim(m.to(torch.int8), axis, -1)
    if m.shape[-1] % 2:
        m = torch.nn.functional.pad(m, (0, 1))
    lo, hi = m[..., 0::2], m[..., 1::2]
    packed = torch.bitwise_or(torch.bitwise_and(lo, 0x0F),
                              torch.bitwise_left_shift(hi, 4))
    return torch.movedim(packed.to(torch.int8), -1, axis)


def _lib() -> ctypes.CDLL:
    """The built library, its entry point typed on first use."""
    lib = _build.load("qmatmul")
    if not getattr(lib, "typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmatmul_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                       ci, vp]
        lib.qmatmul_launch.restype = ci
        lib.typed = True
    return lib


# the kernel's block covers this many output channels; a split-K part
# covers whole groups of KGROUP k values (so int8 and nibble storage cut K
# at the same places); SPLIT_TARGET blocks fill the 132 SMs twice
BLOCK_N, KGROUP, SPLIT_TARGET = 128, 128, 264


def qmatmul_split(K: int, N: int) -> Tuple[int, int]:
    """(parts, groups of 128 k per part) of the kernel's split-K, from K
    and N alone: enough parts that ~2 blocks land on every SM, at most one
    part per group.  Never from M, so a row's sum runs in the same order
    at M = 1, 8 and 16."""
    groups = -(-K // KGROUP)
    want = max(1, min(groups, -(-SPLIT_TARGET // -(-N // BLOCK_N))))
    per = -(-groups // want)
    return -(-groups // per), per


def qmatmul(x: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor, *,
            nib: bool = False) -> torch.Tensor:
    """The CUDA kernel: x [M, K] fp32, scale [N] fp32 -> [M, N] fp32.
    ``w_int`` is stored N-major (each output channel's row contiguous, as
    the serving packer stores every layer and as the tied head's
    ``table.T`` reads without a copy): [K, N] int8 with strides (1, K),
    or with ``nib`` the packed nibble storage [K / 2, N] with strides
    (1, K / 2), read as it is.  Raises on anything the kernel does not
    take."""
    M, K = x.shape
    rows, N = w_int.shape
    if rows != (K // 2 if nib else K) or (nib and K % 2) \
            or tuple(scale.shape) != (N,):
        raise ValueError(f"qmatmul shapes x{tuple(x.shape)} "
                         f"w{tuple(w_int.shape)} scale{tuple(scale.shape)}"
                         f"{' (nibbles)' if nib else ''}")
    if not (x.is_cuda and w_int.is_cuda and scale.is_cuda):
        raise ValueError("qmatmul kernel needs CUDA tensors")
    if x.dtype != torch.float32 or scale.dtype != torch.float32 \
            or w_int.dtype != torch.int8:
        raise TypeError("qmatmul kernel takes fp32 x / scale, int8 w")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("qmatmul kernel needs contiguous x and scale")
    if w_int.stride() != (1, rows):
        raise ValueError(f"qmatmul kernel takes N-major [N, K] storage, "
                         f"got strides {w_int.stride()}")
    parts, per = qmatmul_split(K, N)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ws = torch.empty((parts, M, N), dtype=torch.float32, device=x.device) \
        if parts > 1 else None
    _build.check(_lib().qmatmul_launch(
        x.data_ptr(), w_int.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), M, K, N, int(nib), parts,
        per * KGROUP, _build.stream_ptr(x.device)), "qmatmul")
    qmatmul.launches += 1
    qmatmul.shapes[M, K, N, 4 if nib else 8] += 1
    return y


# launches of the kernel, in all and by (M, K, N, bits of the storage)
qmatmul.launches = 0
qmatmul.shapes = collections.Counter()


def qmatmul_any(x: torch.Tensor, w_int: torch.Tensor,
                scale: torch.Tensor, *, nib: bool = False) -> torch.Tensor:
    """``x [..., K] @ packed w`` scaled per output channel, in x's dtype;
    ``w_int`` is [K, N] int8 or, with ``nib``, the nibble storage
    [K / 2, N].  CUDA tensors go through the kernel, CPU tensors through
    the plain version."""
    N = w_int.shape[1]
    K = x.shape[-1]
    lead = x.shape[:-1]
    M = math.prod(lead) if lead else 1
    x2 = x.reshape(M, K).to(torch.float32)
    if x.is_cuda:
        out = qmatmul(x2.contiguous(), w_int, scale.to(torch.float32)
                      .contiguous(), nib=nib)
    else:
        out = qmatmul_ref(x2, w_int, scale, nib=nib)
    return out.reshape(*lead, N).to(x.dtype)
