"""Plain PyTorch versions of the wire compression kernels (counterpart of
``repro/kernels/wire_pack/ref.py``): by definition the elementwise math of
the compressed gradient reduce (``dist.collectives``).

Divisions are true divisions on every device: a float32 tensor divided by
a Python number on CUDA is a multiply by its reciprocal in PyTorch, an ulp
off for ``n`` that is not a power of two, so the divisor here is a tensor
(:func:`true_div`).

The bucket versions (:func:`quantize_bucket_ref`, :func:`dequant_bucket_ref`)
are the fused reduce's per-bucket composition: the members' padded chunk
layout ``[n, W]`` (member ``i`` at columns ``off_i .. off_i + ceven_i``,
position ``t = d * C + c`` of its flat values in chunk row ``d``, column
``c``) built by pads, expands and a concatenation, around the per-position
kernels' plain versions."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...core.quantizer import _exp2i
from ..qmatmul.ops import (grid_exponent, mantissa_max, pack_nibbles,
                           unpack_nibbles)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on the CPU and on the card alike."""
    return x / torch.tensor(float(d), dtype=x.dtype, device=x.device)


def grid_scale(amax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-row wire grid step ``2^-f`` = ``_exp2i(-grid_exponent(amax))``:
    the one scale phase 1 quantizes on and phase 2 decodes with."""
    return _exp2i(-grid_exponent(amax, bits))


def quantize_leaf_ref(rows: torch.Tensor, amax: torch.Tensor, bits: int = 8
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[L, P] float32 rows + per-row shared amax [L] -> (int8 mantissas
    [L, P], scale [L], float32 residual ``rows - q * scale``)."""
    rows = rows.to(torch.float32)
    scale = grid_scale(amax, bits)
    qmax = mantissa_max(bits)
    q = torch.clamp(torch.round(rows / scale[:, None]), -qmax,
                    qmax).to(torch.int8)
    residual = rows - q.to(torch.float32) * scale[:, None]
    return q, scale, residual


def quantize_chunks_ref(e: torch.Tensor, s: torch.Tensor, bits: int = 8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same with a scale per position (``e`` and ``s`` share a shape)
    -> (int8 mantissas, float32 residual)."""
    e = e.to(torch.float32)
    qmax = mantissa_max(bits)
    q = torch.clamp(torch.round(e / s), -qmax, qmax).to(torch.int8)
    return q, e - q.to(torch.float32) * s


def pack_chunks_ref(q: torch.Tensor) -> torch.Tensor:
    """Two int4-range mantissas per byte along the last axis (odd lengths
    pad one zero nibble): ``qmatmul.pack_nibbles``'s format."""
    return pack_nibbles(q, axis=-1)


def dequant_sum_ref(q: torch.Tensor, s: torch.Tensor, shift: int,
                    n: int) -> torch.Tensor:
    """Phase-2 decode: gathered requantized mantissa sums -> the float32
    delivered mean ``((q * 2^shift) * s) / n``, in that order, with a true
    division; ``s`` broadcasts against ``q``."""
    return true_div(q.to(torch.float32) * (2 ** shift) * s, n)


def own_chunk(vals: torch.Tensor, idx: int, n: int, C: int,
              T: int) -> torch.Tensor:
    """A flat [T] tensor holding ``vals`` in chunk ``idx`` of ``n`` and
    zeros elsewhere: the phase-2 error the chunk owner keeps."""
    out = torch.zeros((n * C,), dtype=torch.float32, device=vals.device)
    out[idx * C:(idx + 1) * C] = vals
    return out[:T]


def bucket_layout(leaves: Sequence[torch.Tensor],
                  steps: Sequence[torch.Tensor], n: int, nibble: bool
                  ) -> Tuple[List[Tuple[int, int, int, int, int, int]], int]:
    """Per member ``(L, P, T, C, ceven, off)`` and the bucket's width
    ``W``: ``L`` grid rows (``steps[i]`` is [L]), ``P = T / L``, chunk
    width ``C = ceil(T / n)``, ``ceven`` that width rounded up to even in
    a nibble bucket (a zero mantissa on scale 1 pads it, the zero nibble
    ``pack_nibbles`` would add), ``off`` the member's first column."""
    dims, off = [], 0
    for e, s in zip(leaves, steps):
        T, L = e.numel(), s.numel()
        C = -(-T // n)
        ce = -(-C // 2) * 2 if nibble else C
        dims.append((L, T // L, T, C, ce, off))
        off += ce
    return dims, off


def _chunked(v: torch.Tensor, n: int, C: int, T: int, ce: int,
             value: float) -> torch.Tensor:
    """Flat [T] values in padded chunk layout [n, ce]."""
    v = F.pad(v, (0, n * C - T), value=value).reshape(n, C)
    return F.pad(v, (0, ce - C), value=value) if ce != C else v


def _scale_chunks(steps, dims, n) -> torch.Tensor:
    """The bucket's grid step per position, [n, W] (1 on the padding)."""
    return torch.cat([_chunked(s[:, None].expand(L, P).reshape(-1), n, C, T,
                               ce, 1.0)
                      for s, (L, P, T, C, ce, _) in zip(steps, dims)], dim=1)


def _member(buf: torch.Tensor, dim) -> torch.Tensor:
    """A member's flat [T] values back out of bucket columns [n, W]."""
    _, _, T, C, ce, off = dim
    return buf[:, off:off + ce][:, :C].reshape(-1)[:T]


def quantize_bucket_ref(leaves: Sequence[torch.Tensor],
                        steps: Sequence[torch.Tensor], n: int,
                        bits: int = 8, nibble: bool = False
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Phase 1 of one bucket: each leaf (float32 or bfloat16, any shape,
    ``steps[i]`` its [L] grid steps) into the int8 payload [n, W] (0 on
    the padding) and its float32 residual in the leaf's shape."""
    dims, _ = bucket_layout(leaves, steps, n, nibble)
    E = torch.cat([_chunked(e.to(torch.float32).reshape(-1), n, C, T, ce,
                            0.0)
                   for e, (_, _, T, C, ce, _) in zip(leaves, dims)], dim=1)
    payload, R = quantize_chunks_ref(E, _scale_chunks(steps, dims, n), bits)
    return payload, [_member(R, dim).reshape(e.shape)
                     for e, dim in zip(leaves, dims)]


def dequant_bucket_ref(q: torch.Tensor, err2c: torch.Tensor,
                       residuals: Sequence[torch.Tensor],
                       leaves: Sequence[torch.Tensor],
                       steps: Sequence[torch.Tensor], n: int, idx: int,
                       shift: int, nibble: bool = False
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Phase-2 decode of one bucket on rank ``idx``: the gathered payload
    ``q`` ([n, W] int8, or nibble pairs [n, W / 2]) and this rank's
    own-chunk remainder ``err2c`` [W] (mantissa units) -> per leaf (the
    delivered mean, ``residuals[i]`` plus the remainder on its own
    chunk), both in the leaf's shape and dtype."""
    dims, W = bucket_layout(leaves, steps, n, nibble)
    if nibble:
        q = unpack_nibbles(q, W, axis=-1)
    S = _scale_chunks(steps, dims, n)
    dcat = dequant_sum_ref(q, S, shift, n)
    ecat = err2c * S[idx]
    out = []
    for e, r, dim in zip(leaves, residuals, dims):
        _, _, T, C, ce, off = dim
        delivered = _member(dcat, dim).reshape(e.shape)
        scatter = own_chunk(ecat[off:off + ce][:C], idx, n, C, T)
        out.append((delivered.to(e.dtype),
                    (r + scatter.reshape(e.shape)).to(e.dtype)))
    return out
