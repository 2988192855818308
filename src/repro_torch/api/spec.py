"""RunSpec: the one declarative, serializable run configuration
(counterpart of ``repro/api/spec.py``).

A run is a value of :class:`RunSpec`, a frozen composition of
:class:`MeshSpec` (mesh topology), :class:`PrecisionSpec` (matmul compute
dtype, packed serving weights, packed-kernel routing),
:class:`CompressionSpec` (gradient compression), :class:`ServingSpec`
(slots, ring slack, packing, KV-cache storage, prefix reuse, admitted
workloads), the port's :class:`repro_torch.train.TrainConfig` and
:class:`repro_torch.data.DataSpec`, the seed and an optional
:class:`repro_torch.core.plan.PrecisionPlan`.

``to_json`` writes the reference's bytes for the same value, so every
file of ``examples/specs/`` loads here and re-serializes to itself.
``RunSpec.from_args`` is the launchers' shared parser: ``--spec
run.json`` loads a file and the other flags override its fields.
:func:`repro_torch.api.build` turns a spec into a
:class:`repro_torch.api.RunContext`.

This module is pure configuration: it touches no device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.plan import PrecisionPlan
from ..data.synthetic import DataSpec
from ..train.loop import TrainConfig

GRAD_COMPRESSION_KINDS = ("none", "bf16", "int8", "int8-wire",
                          "int8-wire-2d")
WIRE_LAYOUTS = ("auto", "1d", "2d")
COMPUTE_DTYPES = (None, "bfloat16", "float32")
# mirrors serving.kvcache.KV_CACHE_MODES (this module touches no device)
KV_CACHE_MODES = ("fp", "int8", "plan")
SERVING_WORKLOADS = ("lm", "asr")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Mesh topology as data.

    ``kind="host"`` is a ``data x model`` mesh: ``MeshSpec()`` the 1x1
    mesh, ``MeshSpec(data=4)`` four data ranks (a ``dist.LocalMesh`` on
    one device in the port), ``MeshSpec(data=2, model=4)`` the 2x4 FSDP x
    TP mesh (a ``dist.LocalMesh(2, model=4)`` on one device).
    ``kind="production"`` is the reference's 16x16 TPU pod slice;
    ``pods=2`` adds the outer ``pod`` data axis (2x16x16).  Both kinds
    round-trip here; ``build`` refuses what the port cannot run.
    """
    kind: str = "host"          # "host" | "production"
    data: int = 1
    model: int = 1
    pods: int = 1

    def __post_init__(self):
        _check(self.kind in ("host", "production"),
               f"MeshSpec.kind must be 'host' or 'production', "
               f"got {self.kind!r}")
        _check(self.data >= 1 and self.model >= 1 and self.pods >= 1,
               f"MeshSpec sizes must be >= 1, got {self}")
        _check(self.kind == "production" or self.pods == 1,
               "multi-pod meshes are production meshes (pods > 1 needs "
               "kind='production')")

    @classmethod
    def host(cls, data: int = 1, model: int = 1) -> "MeshSpec":
        return cls(kind="host", data=data, model=model)

    @classmethod
    def production(cls, multi_pod: bool = False) -> "MeshSpec":
        """The 16x16 = 256-chip pod slice (2 pods = 512 chips)."""
        return cls(kind="production", data=16, model=16,
                   pods=2 if multi_pod else 1)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (("pod", "data", "model") if self.pods > 1
                else ("data", "model"))

    @property
    def shape(self) -> Tuple[int, ...]:
        return ((self.pods, self.data, self.model) if self.pods > 1
                else (self.data, self.model))

    @property
    def device_count(self) -> int:
        return self.pods * self.data * self.model

    @property
    def data_size(self) -> int:
        """Total data-parallel degree (pod is outer data parallelism)."""
        return self.pods * self.data


@dataclasses.dataclass(frozen=True)
class PrecisionSpec:
    """Compute/serving precision as data.

    * ``compute_dtype`` — matmul operand cast (``dist.perf
      .cast_for_matmul``): ``None`` (no cast), ``"bfloat16"`` or
      ``"float32"``;
    * ``packed_serving`` — serve from the HGQ int8-packed weight tree
      (``serving/packed.py``);
    * ``packed_matmul`` — route packed weights onto the ``qmatmul``
      kernel (``dist.perf.packed_matmul``); ``None`` follows
      ``packed_serving``.
    """
    compute_dtype: Optional[str] = None
    packed_serving: bool = False
    packed_matmul: Optional[bool] = None

    def __post_init__(self):
        _check(self.compute_dtype in COMPUTE_DTYPES,
               f"PrecisionSpec.compute_dtype must be one of "
               f"{COMPUTE_DTYPES}, got {self.compute_dtype!r}")

    @property
    def packed_kernels(self) -> bool:
        """The resolved packed-kernel routing flag."""
        return (self.packed_serving if self.packed_matmul is None
                else self.packed_matmul)


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Gradient-compression configuration as data.

    * ``kind`` — ``none`` | post-reduce error feedback (``bf16``,
      ``int8``) | in-reduction wire compression (``int8-wire``,
      ``int8-wire-2d``);
    * ``wire_layout`` — exchange topology for the wire kinds: ``1d``
      (data axes only), ``2d`` (sliced over data x model), or ``auto``
      (2d whenever the mesh has a model axis of size > 1 — the strictly
      better choice there);
    * ``residual_layout`` — error-feedback residual placement;
      ``auto`` follows the resolved wire layout (``sharding
      .ef_residual_sharding``'s ``[n_data, ...]`` stack vs the sliced
      ``[n_data, n_model, C]`` tree);
    * ``fused`` — the wire fast path: quantize/pack through the
      ``kernels.wire_pack`` fused kernels with leaves exchanged in
      size-bucketed pipelined buffers (bit-for-bit the per-leaf trace;
      ``False`` keeps the one-collective-set-per-leaf reference).
    """
    kind: str = "none"
    wire_layout: str = "auto"
    residual_layout: str = "auto"
    fused: bool = True

    def __post_init__(self):
        _check(self.kind in GRAD_COMPRESSION_KINDS,
               f"CompressionSpec.kind must be one of "
               f"{GRAD_COMPRESSION_KINDS}, got {self.kind!r}")
        _check(isinstance(self.fused, bool),
               f"CompressionSpec.fused must be a bool, got {self.fused!r}")
        _check(self.wire_layout in WIRE_LAYOUTS,
               f"CompressionSpec.wire_layout must be one of "
               f"{WIRE_LAYOUTS}, got {self.wire_layout!r}")
        _check(self.residual_layout in WIRE_LAYOUTS,
               f"CompressionSpec.residual_layout must be one of "
               f"{WIRE_LAYOUTS}, got {self.residual_layout!r}")
        _check(not (self.kind == "int8-wire-2d"
                    and self.wire_layout == "1d"),
               "int8-wire-2d IS the 2D layout; wire_layout='1d' "
               "contradicts it")

    @property
    def is_wire(self) -> bool:
        return self.kind in ("int8-wire", "int8-wire-2d")

    @property
    def wire_kind(self) -> str:
        """Payload dtype of the wire collective (int8 unless bf16)."""
        return "bf16" if self.kind == "bf16" else "int8"

    def resolved_wire_layout(self, model_size: int) -> str:
        """The concrete exchange layout on a mesh with ``model_size`` TP
        shards: the 2D sliced exchange is strictly better whenever the
        mesh has a model axis (int8 instead of fp32 crosses it)."""
        if self.kind == "int8-wire-2d":
            return "2d"
        if self.wire_layout != "auto":
            return self.wire_layout
        return "2d" if model_size > 1 else "1d"

    def resolved_residual_layout(self, model_size: int) -> str:
        if self.residual_layout != "auto":
            return self.residual_layout
        return self.resolved_wire_layout(model_size)


@dataclasses.dataclass(frozen=True)
class AudioSpec:
    """Streaming-audio admission parameters for the ``"asr"`` serving
    workload (``serving/streaming.py``).

    * ``chunk_frames`` — default arrival granularity, in encoder frames:
      each engine tick delivers one ``chunk_frames``-frame block per
      in-flight stream; ``0`` = whole audio arrives at once (offline
      admission through the streaming path);
    * ``max_frames`` — admission cap on total frames per request; ``0``
      resolves to the architecture's ``enc_seq`` at build time.
    """
    chunk_frames: int = 0
    max_frames: int = 0

    def __post_init__(self):
        _check(self.chunk_frames >= 0,
               f"AudioSpec.chunk_frames must be >= 0, "
               f"got {self.chunk_frames}")
        _check(self.max_frames >= 0,
               f"AudioSpec.max_frames must be >= 0, "
               f"got {self.max_frames}")


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """Serving configuration as data — the whole ``RunContext
    .make_engine`` surface.

    * ``slots`` — continuous-batching slot count (``Engine`` batch rows);
    * ``ring_slack`` — extra ring-buffer slots beyond the attention
      window; ``0`` = auto (follow the prefill chunk, the exactness
      floor for chunked prefill);
    * ``packed`` — serve from the HGQ int8-packed weight tree; ``None``
      follows ``PrecisionSpec.packed_serving``;
    * ``kv_cache`` — KV ring-buffer storage: ``"fp"`` (the bf16 cache),
      ``"int8"`` (8-bit mantissas on
      per-row 2^-f grids), or ``"plan"`` (the narrowest ``kv_bits`` the
      run's :class:`core.plan.PrecisionPlan` resolves — nibble-packed
      two-per-byte at <= 4 bits);
    * ``prefix_reuse`` — cache prefilled prompt slices keyed by the
      exact prompt, so re-submitting an identical prompt skips prefill;
    * ``workloads`` — request types the engine admits: ``("lm",)`` is
      the classic text engine; adding ``"asr"`` routes ``make_engine``
      to :class:`serving.StreamingEngine`, which also accepts streaming
      audio-chunk requests (needs an encoder-decoder arch);
    * ``audio`` — :class:`AudioSpec` admission parameters; auto-filled
      with defaults when ``"asr"`` is enabled.
    """
    slots: int = 8
    ring_slack: int = 0
    packed: Optional[bool] = None
    kv_cache: str = "fp"
    prefix_reuse: bool = False
    workloads: Tuple[str, ...] = ("lm",)
    audio: Optional[AudioSpec] = None

    def __post_init__(self):
        _check(self.slots >= 1,
               f"ServingSpec.slots must be >= 1, got {self.slots}")
        _check(self.ring_slack >= 0,
               f"ServingSpec.ring_slack must be >= 0, "
               f"got {self.ring_slack}")
        _check(self.kv_cache in KV_CACHE_MODES,
               f"ServingSpec.kv_cache must be one of {KV_CACHE_MODES}, "
               f"got {self.kv_cache!r}")
        _check(self.packed is None or isinstance(self.packed, bool),
               f"ServingSpec.packed must be None or a bool, "
               f"got {self.packed!r}")
        # JSON round-trip coercion: lists arrive from from_json, dicts
        # from the nested-spec loader (RunSpec.from_dict only constructs
        # the top-level parts)
        if isinstance(self.workloads, list):
            object.__setattr__(self, "workloads", tuple(self.workloads))
        if isinstance(self.audio, dict):
            known = {f.name for f in dataclasses.fields(AudioSpec)}
            unknown = set(self.audio) - known
            _check(not unknown,
                   f"unknown AudioSpec fields: {sorted(unknown)}")
            object.__setattr__(self, "audio", AudioSpec(**self.audio))
        _check(len(self.workloads) >= 1,
               "ServingSpec.workloads must name at least one workload")
        bad = [w for w in self.workloads if w not in SERVING_WORKLOADS]
        _check(not bad,
               f"ServingSpec.workloads must be drawn from "
               f"{SERVING_WORKLOADS}, got {bad}")
        _check(len(set(self.workloads)) == len(self.workloads),
               f"duplicate ServingSpec.workloads: {self.workloads}")
        _check(self.audio is None or "asr" in self.workloads,
               "ServingSpec.audio is set but 'asr' is not in workloads")
        if "asr" in self.workloads and self.audio is None:
            object.__setattr__(self, "audio", AudioSpec())

    def resolved_packed(self, precision: PrecisionSpec) -> bool:
        """The concrete packed-weight flag (``None`` follows
        ``PrecisionSpec.packed_serving``)."""
        return (precision.packed_serving if self.packed is None
                else self.packed)


def _default_train() -> TrainConfig:
    # the launcher's classic training hyperparameters (launch.train)
    return TrainConfig(steps=20, lr=1e-3, beta0=1e-9, beta1=1e-7)


def _default_data() -> DataSpec:
    # vocab=0 resolves to the architecture's vocab at build time
    return DataSpec(kind="lm", batch=4, seq=32, vocab=0, seed=0)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One run, fully specified: arch + mesh + precision + compression +
    train/data config + seed + optional per-layer width plan.  See the
    module docstring."""
    arch: str = "qwen2-0.5b"
    full: bool = False
    seed: int = 0
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    precision: PrecisionSpec = dataclasses.field(
        default_factory=PrecisionSpec)
    compression: CompressionSpec = dataclasses.field(
        default_factory=CompressionSpec)
    train: TrainConfig = dataclasses.field(default_factory=_default_train)
    data: DataSpec = dataclasses.field(default_factory=_default_data)
    serving: ServingSpec = dataclasses.field(default_factory=ServingSpec)
    # learned per-layer precision (core.plan.PrecisionPlan): wire widths
    # for the compressed gradient collective + pack widths for serving.
    # build() resolves None and any uniform-int8 plan to None: the
    # uniform int8 path.
    plan: Optional[PrecisionPlan] = None

    # ------------------------- serialization --------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunSpec":
        parts = {"mesh": MeshSpec, "precision": PrecisionSpec,
                 "compression": CompressionSpec, "train": TrainConfig,
                 "data": DataSpec, "serving": ServingSpec}
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        _check(not unknown, f"unknown RunSpec fields: {sorted(unknown)}")
        for name, sub in parts.items():
            if isinstance(d.get(name), dict):
                sub_known = {f.name for f in dataclasses.fields(sub)}
                sub_unknown = set(d[name]) - sub_known
                _check(not sub_unknown,
                       f"unknown {sub.__name__} fields: "
                       f"{sorted(sub_unknown)}")
                d[name] = sub(**d[name])
        if isinstance(d.get("plan"), dict):
            # PrecisionPlan has its own strict loader (rejects unknown
            # fields, validates widths) — reuse it
            d["plan"] = PrecisionPlan.from_dict(d["plan"])
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "RunSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_file(cls, path: str) -> "RunSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    # ----------------------------- CLI --------------------------------

    @classmethod
    def parser(cls, **kwargs) -> argparse.ArgumentParser:
        """The shared launcher argument parser: ``--spec run.json`` plus
        the classic flags as overrides (every flag maps to one spec
        field; see the README migration table)."""
        ap = argparse.ArgumentParser(**kwargs)
        ap.add_argument("--spec", default=None, metavar="RUN_JSON",
                        help="RunSpec JSON file; other flags override "
                             "individual fields of it")
        ap.add_argument("--arch", default=None)
        ap.add_argument("--full", action="store_true", default=None,
                        help="use the full (published) config, not smoke")
        ap.add_argument("--steps", type=int, default=None)
        ap.add_argument("--batch", type=int, default=None)
        ap.add_argument("--seq", type=int, default=None)
        ap.add_argument("--seed", type=int, default=None,
                        help="PRNG seed for init AND the data pipeline")
        ap.add_argument("--production-mesh", action="store_true",
                        default=None)
        ap.add_argument("--multi-pod", action="store_true", default=None)
        ap.add_argument("--mesh", default=None,
                        help="host mesh DATAxMODEL (e.g. 4x1: four data "
                             "ranks on the one device)")
        ap.add_argument("--ckpt-dir", default=None)
        ap.add_argument("--ckpt-every", type=int, default=None,
                        help="checkpoint every N steps (makes the "
                             "EF-residual resume path drivable in short "
                             "runs)")
        ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                        help="PrecisionPlan JSON file (core.plan): "
                             "per-layer wire + pack widths learned from a "
                             "trained HGQ run; omitted = uniform int8")
        ap.add_argument("--compute-dtype", default=None,
                        choices=["none", "bfloat16", "float32"],
                        help="matmul compute dtype "
                             "(PrecisionSpec.compute_dtype)")
        ap.add_argument("--kv-cache", default=None,
                        choices=list(KV_CACHE_MODES),
                        help="serving KV ring-buffer storage "
                             "(ServingSpec.kv_cache): fp keeps the bf16 "
                             "cache; int8/plan store 2^-f "
                             "quantized mantissas at 8 / plan bits")
        ap.add_argument("--slots", type=int, default=None,
                        help="continuous-batching slot count "
                             "(ServingSpec.slots)")
        ap.add_argument("--grad-compression",
                        choices=list(GRAD_COMPRESSION_KINDS), default=None,
                        help="bf16/int8 quantize the synchronized "
                             "gradient (post-reduce); int8-wire "
                             "compresses inside the reduction — int8 "
                             "bytes on the wire via dist.collectives; "
                             "int8-wire-2d additionally slices the "
                             "exchange over the model (TP) axis — "
                             "auto-selected for int8-wire when the mesh "
                             "has M>1 (single-device runs fall back to "
                             "the post-reduce int8 path)")
        return ap

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None,
                  **parser_kwargs) -> "RunSpec":
        """Parse CLI flags into a spec: ``--spec`` loads a JSON file,
        explicit flags override its fields, and with no ``--spec`` the
        flags override the defaults (classic launcher behavior)."""
        args = cls.parser(**parser_kwargs).parse_args(argv)
        return cls.from_parsed(args)

    @classmethod
    def from_parsed(cls, args: argparse.Namespace,
                    base: Optional["RunSpec"] = None) -> "RunSpec":
        """Apply explicitly-passed flags as overrides on ``--spec``'s
        file, or on ``base`` (an entry point's own defaults — e.g. the
        examples ship different default arch/steps than the launcher),
        or on the class defaults."""
        spec = (cls.from_file(args.spec) if getattr(args, "spec", None)
                else (base if base is not None else cls()))
        rep: Dict[str, Any] = {}
        if args.arch is not None:
            rep["arch"] = args.arch
        if args.full:
            rep["full"] = True
        if args.seed is not None:
            rep["seed"] = args.seed
        if args.production_mesh or args.multi_pod:
            rep["mesh"] = MeshSpec.production(
                multi_pod=bool(args.multi_pod))
        elif args.mesh is not None:
            d, m = (int(v) for v in args.mesh.lower().split("x"))
            rep["mesh"] = MeshSpec.host(d, m)
        if getattr(args, "plan", None) is not None:
            rep["plan"] = PrecisionPlan.from_file(args.plan)
        if args.compute_dtype is not None:
            rep["precision"] = dataclasses.replace(
                spec.precision,
                compute_dtype=(None if args.compute_dtype == "none"
                               else args.compute_dtype))
        if args.grad_compression is not None:
            rep["compression"] = dataclasses.replace(
                spec.compression, kind=args.grad_compression)
        sv: Dict[str, Any] = {}
        if getattr(args, "kv_cache", None) is not None:
            sv["kv_cache"] = args.kv_cache
        if getattr(args, "slots", None) is not None:
            sv["slots"] = args.slots
        if sv:
            rep["serving"] = dataclasses.replace(spec.serving, **sv)
        tr: Dict[str, Any] = {}
        if args.steps is not None:
            tr["steps"] = args.steps
        if args.ckpt_dir is not None:
            tr["ckpt_dir"] = args.ckpt_dir
        if args.ckpt_every is not None:
            tr["ckpt_every"] = args.ckpt_every
        if tr:
            rep["train"] = dataclasses.replace(spec.train, **tr)
        da: Dict[str, Any] = {}
        if args.batch is not None:
            da["batch"] = args.batch
        if args.seq is not None:
            da["seq"] = args.seq
        if args.seed is not None:
            da["seed"] = args.seed
        if da:
            rep["data"] = dataclasses.replace(spec.data, **da)
        return dataclasses.replace(spec, **rep) if rep else spec


def emit_pareto_specs(front, base: RunSpec, out_dir: str) -> List[str]:
    """Turn a trained run's Pareto front into ready-to-run spec files.

    For every front point carrying a :class:`core.plan.PrecisionPlan`
    payload (the sweep's per-point width tables), writes
    ``out_dir/pareto_<i>_step<step>.json`` — ``base`` with that plan
    embedded — plus ``out_dir/front.json`` (the serialized front, metric
    vs EBOPs per point).  Each emitted spec is directly loadable with
    ``--spec`` (or the plan alone with ``--plan`` after extracting it);
    points without a plan payload are skipped.  Returns the spec paths,
    cheapest point first."""
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    for i, p in enumerate(front.points):
        if not isinstance(p.payload, PrecisionPlan):
            continue
        spec = dataclasses.replace(base, plan=p.payload)
        path = os.path.join(out_dir, f"pareto_{i:02d}_step{p.step}.json")
        spec.save(path)
        paths.append(path)
    with open(os.path.join(out_dir, "front.json"), "w") as f:
        f.write(front.to_json())
    return paths
