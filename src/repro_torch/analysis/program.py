"""Spec -> program artifacts: the linter's unit of analysis (counterpart
of ``repro/analysis/program.py``).

For each ``RunSpec`` the repo ships (``examples/specs/*.json``) two
programs matter:

* the **train step**: ``repro_torch.api.build(spec).init_training()``'s
  step, exactly as the launcher runs it (mesh, donation, wire collective
  and all); and
* the **serving decode tick**: the ``serving.Engine``'s ragged decode
  tick (``Engine.decode_program``), built with 2 slots and a 32-token
  cache and the spec's packing and KV flags.

The port runs eagerly, so a program is one traced run of it
(``analysis.trace.ProgramRun``): the state it took and gave back and what
the run did.  The rules (``analysis.rules``) and the census
(``analysis.report``) read these :class:`ProgramArtifacts`.
"""
from __future__ import annotations

import dataclasses
import os
import types
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..api import RunSpec, build
from ..dist import collectives
from ..tree import tree_leaves
from .collectives import ExplicitCollective
from .trace import LAUNCH_TALLIES, ProgramRun, ProgramTrace

KERNELS = frozenset(name for name, _, _ in LAUNCH_TALLIES)

# the state a program updates in place, by kind: what the reference
# donates (params, AdamW moments, the EF residual; the decode cache)
DONATED_ROLES = types.MappingProxyType({
    "train": ("params", "moments", "residual"), "decode": ("caches",)})


@dataclasses.dataclass
class ProgramArtifacts:
    """One traced program plus everything the rules need to judge it."""
    # "train:host_1x1", "decode:serving_packed" -- colon, not brackets:
    # these names feed fnmatch override patterns, where [..] is a class
    name: str
    kind: str                     # "train" | "decode"
    spec: RunSpec
    spec_path: str                # "" when built from an in-memory spec
    mesh_shape: Tuple[int, int]   # (data, model)
    run: Optional[ProgramRun]     # the traced run
    meta: Dict[str, Any]          # kind-specific facts (see builders)

    # derived views ------------------------------------------------------
    def explicit_collectives(self) -> List[ExplicitCollective]:
        return list(self.run.trace.collectives)

    def aliased_buffers(self) -> int:
        """Donated leaves returned in their own storage and written."""
        return sum(self.run.in_place(r) for r in DONATED_ROLES[self.kind])

    def moved_buffers(self) -> int:
        """Donated leaves returned in a new storage (a copy)."""
        return sum(self.run.moved(r) for r in DONATED_ROLES[self.kind])

    def state(self, inputs: bool = True, outputs: bool = True
              ) -> List[Tuple[str, str, int]]:
        """``(role, dtype, numel)`` of every leaf the program took
        (``inputs``) and gave back (``outputs``)."""
        out = []
        for side, on in ((self.run.inputs, inputs),
                         (self.run.outputs, outputs)):
            if on:
                for role, leaves in side.items():
                    out += [(role, str(t.dtype).replace("torch.", ""),
                             t.numel()) for t in leaves]
        return out

    def f64_ops(self) -> Dict[str, int]:
        """Float64 operations of the run, by module of the port."""
        return dict(self.run.trace.f64_ops)

    def kernel_ops(self) -> Dict[str, int]:
        """Kernel-op calls of the run, by kernel (the same count on the
        CPU's plain versions and on the card's kernels); ops counted by
        formula that are no kernel (``embedding_grad``) left out."""
        return {k: n for k, n in self.run.trace.kernel_ops.items()
                if k in KERNELS}


def _spec_name(spec_path: str, spec: RunSpec) -> str:
    if spec_path:
        return os.path.splitext(os.path.basename(spec_path))[0]
    return f"{spec.arch}_{spec.mesh.data}x{spec.mesh.model}"


def _tensors(xs) -> List[torch.Tensor]:
    return [x for x in xs if isinstance(x, torch.Tensor)]


def _train_state(setup) -> Dict[str, List[torch.Tensor]]:
    return {"params": tree_leaves(setup.params),
            "qstate": tree_leaves(setup.qstate),
            "moments": (tree_leaves(setup.opt.mu)
                        + tree_leaves(setup.opt.nu)),
            "residual": ([] if setup.ef_state is None
                         else tree_leaves(setup.ef_state.residual))}


def train_run(setup, step: Optional[int] = None) -> ProgramRun:
    """One step of a ``TrainSetup`` (its next, ``start_step``, unless
    given) as a traced program run."""
    step = setup.start_step if step is None else step
    before = _train_state(setup)
    with ProgramTrace() as tr:
        metrics = setup.step(step)
    after = _train_state(setup)
    after["returned"] = _tensors(metrics.values())
    return ProgramRun(trace=tr, inputs=before, outputs=after)


def train_artifacts(spec: RunSpec, spec_path: str = "", device=None,
                    setup=None, step: Optional[int] = None
                    ) -> ProgramArtifacts:
    """The spec's train step (``build(spec).init_training()``, one step),
    or one more step of a given ``setup`` of that spec."""
    if setup is None:
        setup = build(spec, device=device).init_training()
    ctx = setup.ctx
    comp = ctx.grad_compression()
    n_leaves = len(tree_leaves(setup.params))
    # the reference's count of donated leaves that must come back in
    # place: params + opt.mu / nu, and the EF residual on top
    donated = 2 * n_leaves + len(tree_leaves(setup.opt.mu)) \
        + len(tree_leaves(setup.opt.nu)) - n_leaves
    if setup.ef_state is not None:
        donated += len(tree_leaves(setup.ef_state.residual))
    # one quantization grid a stacked layer of a rank >= 3 leaf, one a
    # leaf else: what the wire's amax pmax carries
    flags = collectives._stacked_flags(setup.params, None)
    rows = sum(p.shape[0] if (st and p.ndim >= 3) else 1
               for p, st in zip(tree_leaves(setup.params), flags))
    run = train_run(setup, step)
    return ProgramArtifacts(
        name=f"train:{_spec_name(spec_path, spec)}",
        kind="train", spec=spec, spec_path=spec_path,
        mesh_shape=(ctx.n_data, ctx.n_model), run=run,
        meta={
            "wire": comp.wire,
            "wire_layout": comp.wire_layout,
            "compression": spec.compression.kind,
            "wire_payload": spec.compression.wire_kind,
            "donated_leaves": donated,
            "param_leaves": n_leaves,
            "scale_rows": rows,
        })


def decode_artifacts(spec: RunSpec, spec_path: str = "", device=None,
                     engine=None, unpacked_param_bytes: int = 0
                     ) -> ProgramArtifacts:
    """The serving decode tick of a (1x1-mesh) spec: the engine's ragged
    tick with the spec's serving and packing flags.  The census engine is
    built small (2 slots, 32-token cache) but otherwise exactly as
    ``make_engine`` would serve the spec; ``engine`` (with the bytes of
    the float32 tree it was packed from) lints a given one."""
    if engine is None:
        spec = dataclasses.replace(
            spec, serving=dataclasses.replace(spec.serving, slots=2))
        ctx = build(spec, device=device)
        params, qstate = ctx.init_state()
        unpacked_param_bytes = sum(a.numel() * a.element_size()
                                   for a in tree_leaves(params))
        engine = ctx.make_engine(params, qstate, max_len=32)
        del params, qstate
    run = engine.decode_program()
    return ProgramArtifacts(
        name=f"decode:{_spec_name(spec_path, spec)}",
        kind="decode", spec=spec, spec_path=spec_path,
        mesh_shape=(1, 1), run=run,
        meta={
            # what the spec asks for (the engine built from it agrees)
            "packed": bool(spec.serving.resolved_packed(spec.precision)),
            "unpacked_param_bytes": int(unpacked_param_bytes),
            "kv_cache": spec.serving.kv_cache,
            "kv_bits": engine.kv_bits,
            # quantized cache trees are int8: what the quantized-kv rule
            # requires the inputs to hold as integer bytes
            "kv_cache_int_bytes": (0 if engine.kv_bits is None else sum(
                c.numel() for c in engine.caches
                if c is not None and c.dtype == torch.int8)),
        })


def artifacts_for_spec(spec: RunSpec, spec_path: str = "",
                       kinds: Optional[Tuple[str, ...]] = None,
                       device=None) -> List[ProgramArtifacts]:
    """Every analyzable program of one spec.  The train step runs on the
    spec's mesh (a ``LocalMesh`` on one device); the decode engine is a
    single-replica object, so it is built only for 1x1-mesh specs."""
    out = []
    if kinds is None or "train" in kinds:
        out.append(train_artifacts(spec, spec_path, device))
    if (kinds is None or "decode" in kinds) \
            and spec.mesh.device_count == 1:
        out.append(decode_artifacts(spec, spec_path, device))
    return out
