"""Task losses in float32 (counterpart of ``repro/train/losses.py``)."""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy; the gold logit is picked with an iota mask and
    a sum, as the reference does."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(iota == labels[..., None], logits,
                                 torch.zeros((), device=logits.device)),
                     dim=-1)
    return torch.mean(logz - gold)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy: predict tokens[:, 1:] from logits[:, :-1]."""
    return softmax_xent(logits[:, :-1], tokens[:, 1:])


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.to(torch.float32)
                                   - target.to(torch.float32)))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))


def rms_resolution(pred: torch.Tensor, target: torch.Tensor,
                   outlier_mrad: float = 30.0) -> torch.Tensor:
    """Paper SSec. V.D: RMS of the reconstruction error, excluding
    |err| > 30 mrad."""
    err = pred.to(torch.float32) - target.to(torch.float32)
    keep = torch.abs(err) <= outlier_mrad
    n = torch.clamp(torch.sum(keep), min=1)
    return torch.sqrt(torch.sum(torch.where(keep, err * err,
                                            torch.zeros_like(err))) / n)
