"""Training loop: the Eq.-16 loss, joint weight + bitwidth optimization,
Pareto checkpointing, fault-tolerant resume (counterpart of
``repro/train/loop.py``).

``make_train_step`` builds the step function; :class:`Trainer` is the
host-side loop with checkpoint / restart and the paper's beta-ramp
Pareto sweep.  Both run wherever the params live (the card by default,
through the model's ``init``).  Gradient compression (``grad_tx``,
``reduce="compressed"``) belongs to the data-parallel slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core import hgq
from ..core.pareto import ParetoFront
from ..core.schedule import Schedule, constant, log_ramp
from ..optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from ..tree import tree_leaves, tree_unflatten
from . import checkpoint as ckpt_lib

Forward = Callable[..., Tuple[torch.Tensor, Any, Any]]
LossFn = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]

_DIST_SLICE = ("gradient compression (grad_tx, reduce='compressed') is not "
               "ported yet: it comes with the data-parallel slice "
               "(repro_torch.dist)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 1000
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    beta0: float = 1e-6          # Eq. 16 resource coefficient (ramped)
    beta1: float = 1e-4
    gamma: float = 2e-6          # Eq. 16 L1 coefficient (paper: fixed 2e-6)
    beta_const: Optional[float] = None  # HGQ-c* variant: fixed beta
    log_every: int = 50
    eval_every: int = 100
    ckpt_every: int = 200
    ckpt_dir: str = ""
    keep_ckpts: int = 3


def make_train_step(forward: Forward, loss_fn: LossFn, tcfg: TrainConfig,
                    lr_sched: Optional[Schedule] = None,
                    grad_tx: Optional[Callable] = None,
                    reduce: str = "full"):
    """The step ``(params, qstate, opt, batch, step) -> (params, qstate,
    opt, metrics)``: value and gradient of the Eq.-16 total over the
    params' leaves (``torch.autograd.grad``), global-norm clipping, AdamW.
    Returns new trees; the inputs stay as they were."""
    if reduce not in ("full", "compressed"):
        raise ValueError(f"reduce must be 'full' or 'compressed', "
                         f"got {reduce!r}")
    if grad_tx is not None or reduce == "compressed":
        raise NotImplementedError(_DIST_SLICE)
    beta_sched = (constant(tcfg.beta_const) if tcfg.beta_const is not None
                  else log_ramp(tcfg.beta0, tcfg.beta1, tcfg.steps))
    lr_sched = lr_sched or constant(tcfg.lr)

    def step_fn(params, qstate, opt: AdamWState, batch, step):
        beta = beta_sched(step)
        lr = lr_sched(step)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            out, newq, aux = forward(tree_unflatten(params, leaves), qstate,
                                     batch, mode=hgq.TRAIN)
            base = loss_fn(out, batch)
            total = base + beta * aux.ebops + tcfg.gamma * aux.l1
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        new_params, opt = adamw_update(grads, opt, params, lr=lr,
                                       weight_decay=tcfg.weight_decay)
        metrics = {"loss": base.detach(), "total": total.detach(),
                   "ebops": aux.ebops.detach(), "gnorm": gnorm,
                   "beta": beta}
        return new_params, newq, opt, metrics

    return step_fn


class Trainer:
    """Host-side loop: steps, logs, evaluations, checkpoints, resume,
    Pareto tracking."""

    def __init__(self, forward: Forward, loss_fn: LossFn, tcfg: TrainConfig,
                 params, qstate, *,
                 eval_fn: Optional[Callable] = None,
                 pipeline: Optional[Callable[[int], Dict]] = None,
                 better_metric: str = "max",
                 grad_tx: Optional[Callable] = None,
                 tx_state: Optional[Any] = None):
        if grad_tx is not None or tx_state is not None:
            raise NotImplementedError(_DIST_SLICE)
        self.tcfg = tcfg
        self.forward = forward
        self.pipeline = pipeline
        self.eval_fn = eval_fn
        self.params = params
        self.qstate = qstate
        self.opt = adamw_init(params)
        self.start_step = 0
        self.pareto = ParetoFront(better_metric)
        self.step_fn = make_train_step(forward, loss_fn, tcfg)
        self.history = []

    # -------------------------- fault tolerance --------------------------
    def maybe_resume(self) -> bool:
        if not self.tcfg.ckpt_dir:
            return False
        last = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return False
        _, trees = ckpt_lib.restore(self.tcfg.ckpt_dir, last, {
            "params": self.params, "qstate": self.qstate, "opt": self.opt})
        self.params = trees["params"]
        self.qstate = trees["qstate"]
        self.opt = trees["opt"]
        self.start_step = last
        return True

    def checkpoint(self, step: int, pareto: bool = False) -> Optional[str]:
        if not self.tcfg.ckpt_dir:
            return None
        path = ckpt_lib.save(self.tcfg.ckpt_dir, step,
                             {"params": self.params, "qstate": self.qstate,
                              "opt": self.opt}, keep=self.tcfg.keep_ckpts)
        if pareto:
            ckpt_lib.mark_pareto(path)
        return path

    # ------------------------------- run ---------------------------------
    def run(self, steps: Optional[int] = None, log=print) -> Dict[str, Any]:
        tcfg = self.tcfg
        steps = steps or tcfg.steps
        t0 = time.time()
        m = {}
        for step in range(self.start_step, steps):
            batch = self.pipeline(step)
            self.params, self.qstate, self.opt, m = self.step_fn(
                self.params, self.qstate, self.opt, batch, step)
            if step % tcfg.log_every == 0:
                mm = {k: float(v) for k, v in m.items()}
                log(f"step {step}: loss={mm['loss']:.4f} "
                    f"ebops={mm['ebops']:.3g} beta={mm['beta']:.2g}")
                self.history.append({"step": step, **mm})
            # checkpoints are labelled with the steps APPLIED (the next
            # step to run): after the step above that is step + 1, and the
            # Pareto front records the same label, so its entries map to
            # their pinned checkpoint directories
            saved_pareto = False
            if self.eval_fn and step and step % tcfg.eval_every == 0:
                out = self.eval_fn(self.params, self.qstate)
                # (metric, ebops) or (metric, ebops, payload)
                metric, ebops = out[0], out[1]
                payload = out[2] if len(out) > 2 else None
                if self.pareto.offer(metric, ebops, step + 1, payload):
                    self.checkpoint(step + 1, pareto=True)
                    saved_pareto = True
            if (tcfg.ckpt_dir and step and step % tcfg.ckpt_every == 0
                    and not saved_pareto):  # don't clobber the PARETO pin
                self.checkpoint(step + 1)
        return {"metrics": {k: float(v) for k, v in m.items()},
                "wall_s": time.time() - t0,
                "pareto": self.pareto.front()}
