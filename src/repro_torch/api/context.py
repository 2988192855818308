"""RunContext: build a whole run -- mesh, axis registry, train step,
serving engine -- from a :class:`repro_torch.api.RunSpec`, with no
module-level mutable state (counterpart of ``repro/api/context.py``).

A :class:`RunContext` carries its configuration and activates it as a
dynamic scope (``dist.scope``) around every call it owns: the axis
registry, the compute dtype and the packed-kernel routing.  Two contexts
with different precision coexist in one process, and an engine keeps
the configuration of the context that built it::

    ctx = repro_torch.api.build(spec)            # the card by default
    setup = ctx.init_training()                  # params, AdamW, EF, step
    metrics = setup.step(0)
    eng = ctx.make_engine(params, qstate, max_len=1024)

How it differs from the reference's:

* ``build(spec, device=None)`` runs on the card unless given another
  device (``device.resolve_device``), and passes the device down;
* meshes are the port's: ``MeshSpec.host(d, m)`` is no mesh at 1 x 1 and
  ``dist.LocalMesh(d, device, model=m)`` otherwise (``d x m`` ranks as
  threads on the one device); the reference's TPU pod meshes
  (``kind="production"``) have no counterpart here and raise
  ``NotImplementedError``, whose message names the dry run's chip count
  (``launch.dryrun --chips N``) instead;
* the train step runs eagerly (no jit): each data shard's forward and
  backward run whole on the device, and the ``model`` axis partitions the
  gradient exchange and its residual (``wire_layout="2d"``);
  ``train_shardings`` gives the reference's placement as the port's spec
  trees (``dist.sharding``), which the 2D exchange slices by.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import types
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import get as get_config
from ..data import make_pipeline
from ..data.synthetic import DataSpec
from ..device import resolve_device
from ..dist import EFState, LocalMesh, collectives, ef_compress, ef_init
from ..dist.axes import AxisRegistry, axis_scope, registry_for_mesh
from ..dist.perf import compute_dtype_scope, packed_matmul
from ..dist.sharding import (batch_sharding, ef_residual_sharding,
                             replicated, shard_tree)
from ..models import model_for
from ..optim import adamw_init
from ..train import checkpoint as ckpt_lib
from ..train import lm_loss, make_train_step
from .spec import MeshSpec, RunSpec

_DTYPES = types.MappingProxyType(
    {None: None, "bfloat16": torch.bfloat16, "float32": torch.float32})

_PRODUCTION = ("production meshes are the reference's TPU pod slices, "
               "which have no counterpart in the port; for a cell's "
               "roofline on N cards run the dry run with its chip count: "
               "python -m repro_torch.launch.dryrun --arch A --shape S "
               "--chips N")


def build_mesh(mspec: MeshSpec, device=None) -> Optional[LocalMesh]:
    """The port's mesh for a :class:`MeshSpec`: ``None`` for 1x1, else a
    ``dist.LocalMesh`` of ``data x model`` ranks on ``device``."""
    if mspec.kind == "production":
        raise NotImplementedError(_PRODUCTION)
    if mspec.data == 1 and mspec.model == 1:
        return None
    return LocalMesh(mspec.data, resolve_device(device), model=mspec.model)


@dataclasses.dataclass(frozen=True)
class GradCompression:
    """The resolved gradient compression of one (spec, mesh) pair: a
    post-reduce ``grad_tx`` transform, or the in-reduction wire
    collective (``wire=True``)."""
    wire: bool
    wire_layout: str                  # "1d" | "2d" (resolved; wire only)
    reduce: str                       # "full" | "compressed"
    grad_tx: Optional[Callable]
    kind: str

    def init_state(self, params, n_data: int, n_model: int
                   ) -> Optional[EFState]:
        if self.kind == "none":
            return None
        if self.wire and self.wire_layout == "2d":
            return EFState(residual=collectives.ef_wire2d_init(
                params, n_data, n_model))
        if self.wire:
            return EFState(residual=collectives.ef_wire_init(params,
                                                             n_data))
        return ef_init(params)


class TrainSetup:
    """What ``RunContext.init_training`` builds: the state trees, the
    step and the pipeline.  ``step`` threads the AdamW and (with
    compression on) the EF residual state through itself."""

    def __init__(self, ctx: "RunContext", params, qstate, opt, ef_state,
                 step_fn, pipeline):
        self.ctx = ctx
        self.params = params
        self.qstate = qstate
        self.opt = opt
        self.ef_state = ef_state
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.start_step = 0

    def step(self, step: int) -> Dict[str, torch.Tensor]:
        batch = self.pipeline(step)
        if self.ef_state is not None:
            (self.params, self.qstate, self.opt, metrics,
             self.ef_state) = self.step_fn(self.params, self.qstate,
                                           self.opt, batch, step,
                                           self.ef_state)
        else:
            self.params, self.qstate, self.opt, metrics = self.step_fn(
                self.params, self.qstate, self.opt, batch, step)
        return metrics

    # --------------------- checkpointing / resume ----------------------

    def maybe_resume(self, log=print) -> bool:
        """Resume params, qstate and AdamW (and the EF residual, when the
        checkpoint has one of the same shapes) from the newest
        checkpoint."""
        ckpt_dir = self.ctx.spec.train.ckpt_dir
        if not ckpt_dir:
            return False
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is None:
            return False
        tmpl = {"params": self.params, "qstate": self.qstate,
                "opt": self.opt}
        start, trees = ckpt_lib.restore(ckpt_dir, last, tmpl)
        self.params, self.qstate, self.opt = (
            trees["params"], trees["qstate"], trees["opt"])
        # the 1D wire residual is [n_data, ...] and the 2D one [n_data,
        # n_model, C]: a run on another mesh (or layout), or one that
        # turned compression on or changed its kind, cannot re-chunk it,
        # so it restarts at zero (one biased window) and the run goes on
        if self.ef_state is not None and ckpt_lib.has_tree(
                ckpt_dir, last, "ef"):
            try:
                _, eft = ckpt_lib.restore(ckpt_dir, last,
                                          {"ef": self.ef_state})
                self.ef_state = eft["ef"]
            except (ValueError, KeyError):
                log("warning: checkpointed EF residual does not match "
                    "the current mesh/compression kind; restarting it "
                    "at zero")
        self.start_step = start
        return True

    def checkpoint(self, steps_applied: int) -> None:
        """Save under the 'steps applied' label (= next step to run)."""
        trees = {"params": self.params, "qstate": self.qstate,
                 "opt": self.opt}
        if self.ef_state is not None:
            trees["ef"] = self.ef_state
        ckpt_lib.save(self.ctx.spec.train.ckpt_dir, steps_applied, trees)


class RunContext:
    """A built run: the spec, its device, mesh, axis registry and resolved
    precision, and constructors for every derived object.  Cheap to build:
    no parameters exist until ``init_state`` / ``init_training``."""

    def __init__(self, spec: RunSpec, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.cfg = get_config(spec.arch, smoke=not spec.full)
        self.model = model_for(self.cfg)
        self.mesh = build_mesh(spec.mesh, self.device)
        self.axes: AxisRegistry = registry_for_mesh(self.mesh)
        self.compute_dtype = _DTYPES[spec.precision.compute_dtype]
        self.n_data = collectives.data_axis_size(self.mesh)
        self.n_model = collectives.model_axis_size(self.mesh)
        # a missing plan and an explicit uniform-int8 plan both resolve to
        # None: every consumer takes the uniform int8 path
        plan = spec.plan
        self.plan = None if plan is None or plan.is_uniform_int8 else plan
        # kv_bits resolution reads every entry of the plan as given (a
        # wire/pack-uniform plan may still carry narrow KV widths)
        self._full_plan = spec.plan

    # --------------------------- activation ----------------------------

    @contextlib.contextmanager
    def activate(self, packed: Optional[bool] = None):
        """Bind this context's configuration (axis registry, compute dtype,
        packed-kernel routing) for the enclosed block; re-entrant and
        nestable across contexts."""
        if packed is None:
            packed = self.spec.precision.packed_kernels
        with axis_scope(self.axes), \
                compute_dtype_scope(self.compute_dtype), \
                packed_matmul(packed):
            yield self

    def wrap(self, fn: Callable, packed: Optional[bool] = None) -> Callable:
        """``fn`` run under :meth:`activate` on every call."""
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            with self.activate(packed=packed):
                return fn(*args, **kwargs)
        return scoped

    # ------------------------- derived objects -------------------------

    @property
    def forward(self) -> Callable:
        cfg = self.cfg
        model = self.model
        return lambda p, q, b, mode: model.forward(p, q, b, cfg, mode)

    def data_spec(self) -> DataSpec:
        """The run's :class:`DataSpec` with vocab resolved from the
        architecture (a spec file may leave ``vocab=0``)."""
        ds = self.spec.data
        if ds.kind in ("lm", "asr") and ds.vocab == 0:
            ds = dataclasses.replace(ds, vocab=self.cfg.vocab)
        return ds

    def make_pipeline(self) -> Callable[[int], Dict[str, torch.Tensor]]:
        ds = self.data_spec()
        if ds.kind == "asr":
            return make_pipeline(ds, self.device, d_model=self.cfg.d_model,
                                 enc_seq=self.cfg.enc_seq)
        return make_pipeline(ds, self.device)

    def init_state(self) -> Tuple[Any, Any]:
        """Seeded model init (``RunSpec.seed``) on the context's device,
        under this context."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.spec.seed)
        with self.activate():
            return self.model.init(gen, self.cfg, device=self.device)

    # ---------------------- gradient compression -----------------------

    def grad_compression(self) -> GradCompression:
        """Resolve ``CompressionSpec`` against this mesh: wire kinds run
        the in-reduction collective where the mesh carries it, and the
        post-reduce int8 path on one device (the same numbers)."""
        comp = self.spec.compression
        kind = comp.kind
        if kind == "none":
            return GradCompression(False, "1d", "full", None, kind)
        if comp.is_wire:
            layout = comp.resolved_wire_layout(self.n_model)
            wire = self.n_data > 1 or (layout == "2d" and self.n_model > 1)
            if wire:
                return GradCompression(True, layout, "compressed", None,
                                       kind)
            # one device: the wire is a no-op, and post-reduce int8 error
            # feedback is the compressed path, number for number
            return GradCompression(
                False, layout, "full",
                lambda g, s: ef_compress(g, s, kind="int8"), kind)
        return GradCompression(
            False, "1d", "full",
            lambda g, s: ef_compress(g, s, kind=kind), kind)

    # --------------------------- training ------------------------------

    def make_train_step(self, loss_fn: Optional[Callable] = None,
                        comp: Optional[GradCompression] = None,
                        donate: Tuple[int, ...] = ()) -> Callable:
        """The train step of this spec, run under this context.
        ``loss_fn`` defaults to the LM loss; ``donate`` the argument
        positions the step updates in place (``train_shardings``'
        ``donate_argnums``)."""
        comp = comp or self.grad_compression()
        loss_fn = loss_fn or (lambda out, b: lm_loss(out, b["tokens"]))
        step = make_train_step(
            self.forward, loss_fn, self.spec.train, grad_tx=comp.grad_tx,
            reduce=comp.reduce, mesh=self.mesh if comp.wire else None,
            wire_kind=self.spec.compression.wire_kind,
            wire_layout=comp.wire_layout if comp.wire else "auto",
            wire_widths=self.plan,
            wire_fused=self.spec.compression.fused, donate=donate)
        return self.wrap(step)

    def _batch_shardings(self, mesh) -> Dict[str, Any]:
        """Batch-axis placements of the pipeline's batch dict (tokens
        ``[B, S]``; ASR batches add ``[B, T, d]`` frame embeddings)."""
        b = self.spec.data.batch
        sh = {"tokens": batch_sharding(mesh, b, 2)}
        if self.spec.data.kind == "asr":
            sh["frame_embeds"] = batch_sharding(mesh, b, 3)
        return sh

    def train_shardings(self, params, qstate, opt,
                        ef_state: Optional[EFState],
                        comp: GradCompression) -> Tuple[tuple, tuple]:
        """(in_shardings, donate_argnums) of the train step, the
        reference's: spec trees (``dist.sharding.NamedSharding`` leaves) of
        params, qstate, AdamW, batch and step, and of the EF residual (the
        wire's 1D or 2D layout)."""
        mesh = self.mesh
        in_shardings = (shard_tree(params, mesh, "train"),
                        shard_tree(qstate, mesh, "train"),
                        type(opt)(step=replicated(mesh),
                                  mu=shard_tree(opt.mu, mesh, "train"),
                                  nu=shard_tree(opt.nu, mesh, "train")),
                        self._batch_shardings(mesh),
                        replicated(mesh))
        donate = (0, 2)
        if ef_state is not None:
            layout = self.spec.compression.resolved_residual_layout(
                self.n_model)
            res_sh = (ef_residual_sharding(ef_state.residual, mesh,
                                           layout=layout) if comp.wire
                      else shard_tree(ef_state.residual, mesh, "train"))
            in_shardings += (EFState(residual=res_sh),)
            donate += (5,)  # the residual threads step to step like opt
        return in_shardings, donate

    def init_training(self, loss_fn: Optional[Callable] = None
                      ) -> TrainSetup:
        """Params, AdamW and EF state, the step and the pipeline, all from
        the spec alone.  The step updates the trees that
        ``train_shardings`` donates in place, as the reference's jitted
        step donates them: params, both AdamW moments and the EF
        residual keep their storage from step to step."""
        params, qstate = self.init_state()
        opt = adamw_init(params)
        comp = self.grad_compression()
        ef_state = comp.init_state(params, self.n_data, self.n_model)
        _, donate = self.train_shardings(params, qstate, opt, ef_state, comp)
        return TrainSetup(self, params, qstate, opt, ef_state,
                          self.make_train_step(loss_fn, comp, donate),
                          self.make_pipeline())

    # --------------------------- serving -------------------------------

    def pack_params(self, params: Any) -> Any:
        """The HGQ packed serving tree (``serving/packed.py``) under this
        context: int8 by default, nibbles where the spec's plan says so."""
        from ..serving.packed import pack_tree
        with self.activate():
            return pack_tree(params, self.plan)

    def make_engine(self, params, qstate, **kwargs):
        """A continuous-batching ``serving.Engine`` for this spec: slots,
        packing, KV-cache storage, prefix reuse and admitted workloads from
        ``spec.serving`` (and the spec's plan), on the context's device;
        the engine keeps this context's configuration.  With ``"asr"``
        among the workloads it is a :class:`serving.StreamingEngine`, with
        ``spec.serving.audio``'s arrival chunk and admission cap.  Knobs
        the spec does not own (``max_len``, ``eos_id``, ``prefill_chunk``,
        ``seed``) pass through."""
        from ..serving import Engine, StreamingEngine, resolve_kv_bits
        sv = self.spec.serving
        removed = {"batch_slots": "serving.slots",
                   "packed": "serving.packed", "plan": "RunSpec.plan"}
        for kw in removed:
            if kw in kwargs:
                raise TypeError(f"make_engine({kw}=...) was removed: set "
                                f"RunSpec.{removed[kw]} in the spec "
                                f"instead")
        kwargs.setdefault("kv_bits",
                          resolve_kv_bits(sv.kv_cache, self._full_plan))
        kwargs.setdefault("ring_slack", sv.ring_slack or None)
        kwargs.setdefault("prefix_reuse", sv.prefix_reuse)
        kwargs.setdefault("device", self.device)
        cls = Engine
        if "asr" in sv.workloads:
            cls = StreamingEngine
            kwargs.setdefault("audio_chunk", sv.audio.chunk_frames)
            kwargs.setdefault("max_frames", sv.audio.max_frames or None)
        with self.activate(packed=False):
            return cls(self.model, params, qstate, self.cfg,
                       batch_slots=sv.slots,
                       packed=sv.resolved_packed(self.spec.precision),
                       plan=self.plan, **kwargs)

    def plan_summary(self) -> Optional[Dict[str, Any]]:
        """Reporting view of the effective plan (None: uniform int8)."""
        return None if self.plan is None else self.plan.summary()


def build(spec: RunSpec, device=None) -> RunContext:
    """``RunSpec -> RunContext`` on ``device`` (the card by default): the
    one entry point the launcher and the examples share."""
    return RunContext(spec, device)
