"""Training loop: the Eq.-16 loss, joint weight + bitwidth optimization,
Pareto checkpointing, fault-tolerant resume (counterpart of
``repro/train/loop.py``).

``make_train_step`` builds the step function; :class:`Trainer` is the
host-side loop with checkpoint / restart and the paper's beta-ramp
Pareto sweep.  Both run wherever the params live (the card by default,
through the model's ``init``).  Gradients may be compressed after the
reduce (``grad_tx``, e.g. ``dist.ef_compress``) or inside it
(``reduce="compressed"`` over a data mesh, ``dist.collectives``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core import hgq
from ..core.pareto import ParetoFront
from ..core.schedule import Schedule, constant, log_ramp
from ..dist import collectives, ef_compress, ef_init
from ..optim import (AdamWState, adamw_init, adamw_update,
                     clip_by_global_norm, clip_by_global_norm_)
from ..tree import tree_leaves, tree_map, tree_unflatten
from . import checkpoint as ckpt_lib

Forward = Callable[..., Tuple[torch.Tensor, Any, Any]]
LossFn = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]

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


def _merge_sliced_qstate(newqs):
    """Per-slice activation-range states ([n_slices, ...] leaves) back into
    one qstate: extremes merge with min / max over the slices, what the
    unsliced forward would have observed on the whole batch; any other
    leaf takes the mean."""
    def merge(node):
        if isinstance(node, hgq.ActState):
            return hgq.ActState(vmin=torch.amin(node.vmin, dim=0),
                                vmax=torch.amax(node.vmax, dim=0))
        if isinstance(node, dict):
            return {k: merge(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(merge(v) for v in node)
        if node is None:
            return None
        return torch.mean(node, dim=0)
    return merge(newqs)


def _value_and_grad(forward: Forward, loss_fn: LossFn, tcfg: TrainConfig,
                    params, qstate, batch, beta):
    """The Eq.-16 total of one batch and its gradient over the params'
    leaves: (total, new qstate, ~EBOPs, base loss, grads tree)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        out, newq, aux = forward(tree_unflatten(params, leaves), qstate,
                                 batch, mode=hgq.TRAIN)
        base = loss_fn(out, batch)
        total = base + beta * aux.ebops + tcfg.gamma * aux.l1
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])
    return total.detach(), newq, aux.ebops.detach(), base.detach(), grads


def make_train_step(forward: Forward, loss_fn: LossFn, tcfg: TrainConfig,
                    lr_sched: Optional[Schedule] = None,
                    grad_tx: Optional[Callable] = None,
                    reduce: str = "full", mesh=None,
                    wire_kind: str = "int8", wire_layout: str = "auto",
                    wire_widths: Optional[Any] = None,
                    wire_fused: bool = True, donate=False):
    """The step ``(params, qstate, opt, batch, step) -> (params, qstate,
    opt, metrics)``: value and gradient of the Eq.-16 total over the
    params' leaves (``torch.autograd.grad``), global-norm clipping, AdamW.
    Returns new trees; the inputs stay as they were.  With ``donate`` (the
    reference's ``donate_argnums``: ``True``, or the tuple of argument
    positions) the step writes the new params and AdamW moments over the
    given ones (positions 0 and 2) and the new error-feedback residual
    over the given one (position 5, the ``tx_state``), and returns them:
    the same bits, one copy of the state.

    With ``grad_tx`` (a ``(grads, state) -> (grads, state)`` transform
    applied after clipping, e.g. ``dist.ef_compress``) the step takes and
    returns one more argument, ``tx_state``.

    ``reduce="compressed"`` moves the compression into the data-parallel
    reduce over ``mesh`` (a ``dist.LocalMesh`` or ``dist.ProcessGroupMesh``
    of ``n_data x n_model`` ranks): the batch splits into ``n_data`` equal
    slices, each slice's forward and backward run whole (on one card, its
    model ranks share them), each slice's gradient is its shard's (no
    float32 mean is ever formed), and the wire delivers their mean over the
    int8 / nibble (``wire_kind="int8"``) or bf16 wire.  ``wire_layout``
    picks the exchange:

    * ``"1d"``: ``collectives.ef_wire_pmean`` over the data axis;
      ``tx_state`` is an ``EFState`` whose residual leads with the mesh's
      local shards (``collectives.ef_wire_init``);
    * ``"2d"``: ``collectives.ef_wire_pmean_2d``, each ``(data, model)``
      rank reducing its 1/(D*M) slice and one int8 all_gather over
      ``model`` rematerializing the gradient; the gradients go in raw (the
      residual add happens on the slice) and ``tx_state``'s residual is
      the sliced ``[n_data, n_model, C]`` stack
      (``collectives.ef_wire2d_init``);
    * ``"auto"``: ``"2d"`` when the mesh's model axis is above 1 (with one
      data rank too: the pure tensor-parallel mesh), else ``"1d"``.

    ``wire_widths`` (a ``PrecisionPlan``) gives per-leaf wire widths
    through its ``wire_bits_tree``; ``wire_fused`` picks the bucketed path
    (bit for bit the per-leaf one).  Global-norm clipping applies to the
    delivered mean.  With no mesh, or one rank and no model axis, the
    compressed step is the post-reduce ``ef_compress(kind=wire_kind)``
    transform, bit for bit.
    """
    if reduce not in ("full", "compressed"):
        raise ValueError(f"reduce must be 'full' or 'compressed', "
                         f"got {reduce!r}")
    if wire_layout not in ("auto", "1d", "2d"):
        raise ValueError(f"wire_layout must be 'auto', '1d' or '2d', "
                         f"got {wire_layout!r}")
    beta_sched = (constant(tcfg.beta_const) if tcfg.beta_const is not None
                  else log_ramp(tcfg.beta0, tcfg.beta1, tcfg.steps))
    lr_sched = lr_sched or constant(tcfg.lr)

    in_place, residual_in_place = _donated(donate)
    if reduce == "compressed":
        if grad_tx is not None:
            raise ValueError(
                "grad_tx and reduce='compressed' are mutually exclusive: "
                "the compressed reduction IS the gradient transform "
                "(wire_kind selects its quantization)")
        n_data = collectives.data_axis_size(mesh)
        n_model = collectives.model_axis_size(mesh)
        if wire_layout == "auto":
            wire_layout = "2d" if n_model > 1 else "1d"
        if n_data <= 1 and not (wire_layout == "2d" and n_model > 1):
            # one rank: the wire is a no-op, and the post-reduce
            # error-feedback path is the compressed path, exactly
            grad_tx = lambda g, s: ef_compress(g, s, kind=wire_kind)
        else:
            return _make_compressed_step(forward, loss_fn, tcfg, beta_sched,
                                         lr_sched, mesh, wire_kind, n_data,
                                         wire_layout, wire_widths,
                                         wire_fused, in_place,
                                         residual_in_place)

    def _step(params, qstate, opt: AdamWState, batch, step, tx_state):
        beta = beta_sched(step)
        lr = lr_sched(step)
        total, newq, ebops, base, grads = _value_and_grad(
            forward, loss_fn, tcfg, params, qstate, batch, beta)
        # the clipped leaves replace the raw ones one at a time
        leaves = tree_leaves(grads)
        del grads
        gnorm = clip_by_global_norm_(leaves, tcfg.clip_norm)
        grads = tree_unflatten(params, leaves)
        del leaves
        if grad_tx is not None:
            old = tx_state
            grads, tx_state = grad_tx(grads, tx_state)
            if residual_in_place:
                tx_state = _written_over(old, tx_state)
        new_params, opt = adamw_update(grads, opt, params, lr=lr,
                                       weight_decay=tcfg.weight_decay,
                                       in_place=in_place)
        metrics = {"loss": base, "total": total, "ebops": ebops,
                   "gnorm": gnorm, "beta": beta}
        return new_params, newq, opt, metrics, tx_state

    if grad_tx is None:
        def step_fn(params, qstate, opt: AdamWState, batch, step):
            return _step(params, qstate, opt, batch, step, None)[:4]
        return step_fn

    def step_fn_tx(params, qstate, opt: AdamWState, batch, step, tx_state):
        return _step(params, qstate, opt, batch, step, tx_state)
    return step_fn_tx


def _donated(donate) -> Tuple[bool, bool]:
    """(params and moments in place, residual in place) of ``donate``:
    a bool, or the donated argument positions (0 params, 2 AdamW, 5 the
    error-feedback state)."""
    if isinstance(donate, bool):
        return donate, donate
    pos = set(donate)
    if pos - {0, 2, 5} or (0 in pos) != (2 in pos):
        raise ValueError(f"donate takes positions 0 and 2 (params and "
                         f"AdamW, together) and 5 (the residual), got "
                         f"{tuple(donate)}")
    return 0 in pos, 5 in pos


def _written_over(old, new):
    """``new``'s error-feedback residual written over ``old``'s leaves
    (``old`` returned): the state keeps its storage from step to step."""
    for o, n in zip(tree_leaves(old.residual), tree_leaves(new.residual)):
        if n is not o:
            o.copy_(n)
    return old


def _make_compressed_step(forward: Forward, loss_fn: LossFn,
                          tcfg: TrainConfig, beta_sched, lr_sched, mesh,
                          wire_kind: str, n_data: int,
                          wire_layout: str = "1d",
                          wire_widths: Optional[Any] = None,
                          wire_fused: bool = True, in_place: bool = False,
                          residual_in_place: bool = False):
    """The step over the compressed wire (see ``make_train_step``): one
    forward and backward per local batch slice, the wire collective
    (``ef_wire_pmean`` or ``ef_wire_pmean_2d`` by ``wire_layout``) the only
    gradient communication.  ``in_place`` updates the params and moments
    where they lie, ``residual_in_place`` the residual."""
    def step_fn_wire(params, qstate, opt: AdamWState, batch, step, tx_state):
        beta = beta_sched(step)
        lr = lr_sched(step)

        def slice_leaf(b):
            if b.shape[0] % n_data:
                raise ValueError(
                    f"compressed reduce needs the batch axis ({b.shape[0]}) "
                    f"divisible by the {n_data} data shards")
            return b.reshape((n_data, b.shape[0] // n_data) + b.shape[1:])

        sliced = tree_map(slice_leaf, batch)
        own = (range(n_data) if mesh.shards == n_data
               else [mesh.data_index])
        outs = [_value_and_grad(forward, loss_fn, tcfg, params, qstate,
                                tree_map(lambda b, i=i: b[i], sliced), beta)
                for i in own]
        stack = lambda *xs: mesh.gather_shards(torch.stack(xs))
        totals, newqs, ebops_s, bases = (
            tree_map(stack, *[o[j] for o in outs]) for j in range(4))
        grads = tree_map(lambda *gs: torch.stack(gs), *[o[4] for o in outs])
        newq = _merge_sliced_qstate(newqs)
        widths = (None if wire_widths is None
                  else wire_widths.wire_bits_tree(params))
        if wire_layout == "2d":
            delivered, residual = collectives.ef_wire_pmean_2d(
                grads, tx_state.residual, mesh, wire_kind, widths=widths,
                fused=wire_fused)
        else:
            err = tree_map(torch.add, grads, tx_state.residual)
            delivered, residual = collectives.ef_wire_pmean(
                err, mesh, wire_kind, widths=widths, fused=wire_fused)
        delivered, gnorm = clip_by_global_norm(delivered, tcfg.clip_norm)
        new_params, opt = adamw_update(delivered, opt, params, lr=lr,
                                       weight_decay=tcfg.weight_decay,
                                       in_place=in_place)
        metrics = {"loss": torch.mean(bases), "total": torch.mean(totals),
                   "ebops": torch.mean(ebops_s), "gnorm": gnorm,
                   "beta": beta}
        new_state = type(tx_state)(residual=residual)
        if residual_in_place:
            new_state = _written_over(tx_state, new_state)
        return new_params, newq, opt, metrics, new_state

    return step_fn_wire


class Trainer:
    """Host-side loop: steps, logs, evaluations, checkpoints, resume,
    Pareto tracking."""

    def __init__(self, forward: Forward, loss_fn: LossFn, tcfg: TrainConfig,
                 params, qstate, *,
                 eval_fn: Optional[Callable] = None,
                 pipeline: Optional[Callable[[int], Dict]] = None,
                 better_metric: str = "max",
                 grad_tx: Optional[Callable] = None,
                 tx_state: Optional[Any] = None, donate: bool = False):
        """``donate``: each step updates the params and the optimizer
        state in place (``make_train_step``'s ``donate``); the trees
        given here are the Trainer's to overwrite."""
        self.tcfg = tcfg
        self.forward = forward
        self.pipeline = pipeline
        self.eval_fn = eval_fn
        self.params = params
        self.qstate = qstate
        self.opt = adamw_init(params)
        self.start_step = 0
        self.pareto = ParetoFront(better_metric)
        # grad_tx reaches the step: a step built without it would drop the
        # configured gradient compression without a word
        self.grad_tx = grad_tx
        if grad_tx is not None:
            if tx_state is None:
                tx_state = ef_init(params)
            # the residual threads from step to step like the optimizer
            self.step_fn = make_train_step(forward, loss_fn, tcfg,
                                           grad_tx=grad_tx, donate=donate)
        else:
            if tx_state is not None:
                raise ValueError("tx_state given but no grad_tx transform; "
                                 "gradient compression would be silently "
                                 "ignored")
            self.step_fn = make_train_step(forward, loss_fn, tcfg,
                                           donate=donate)
        self.tx_state = tx_state
        self.history = []

    # -------------------------- fault tolerance --------------------------
    def maybe_resume(self) -> bool:
        if not self.tcfg.ckpt_dir:
            return False
        last = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return False
        tmpl = {"params": self.params, "qstate": self.qstate, "opt": self.opt}
        # the EF residual resumes rather than resetting (a zero residual
        # would bias the first window), when the checkpoint has one: a run
        # may turn compression on midway
        if self.tx_state is not None and ckpt_lib.has_tree(
                self.tcfg.ckpt_dir, last, "ef"):
            tmpl["ef"] = self.tx_state
        _, trees = ckpt_lib.restore(self.tcfg.ckpt_dir, last, tmpl)
        self.params = trees["params"]
        self.qstate = trees["qstate"]
        self.opt = trees["opt"]
        self.tx_state = trees.get("ef", self.tx_state)
        self.start_step = last
        return True

    def checkpoint(self, step: int, pareto: bool = False) -> Optional[str]:
        if not self.tcfg.ckpt_dir:
            return None
        trees = {"params": self.params, "qstate": self.qstate,
                 "opt": self.opt}
        if self.tx_state is not None:
            trees["ef"] = self.tx_state
        path = ckpt_lib.save(self.tcfg.ckpt_dir, step, trees,
                             keep=self.tcfg.keep_ckpts)
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
            if self.grad_tx is not None:
                (self.params, self.qstate, self.opt, m,
                 self.tx_state) = self.step_fn(
                    self.params, self.qstate, self.opt, batch, step,
                    self.tx_state)
            else:
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
