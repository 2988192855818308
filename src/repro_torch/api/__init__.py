"""``repro_torch.api``: the declarative run-configuration surface
(counterpart of ``repro/api``).

One frozen, JSON-serializable :class:`RunSpec` (mesh, precision,
compression, serving, train and data config, seed, plan), and
:func:`build`, which turns it into a :class:`RunContext` that makes the
mesh, the axis registry, the train step and the serving engine from the
spec alone, on the card unless given another device::

    from repro_torch.api import RunSpec, build
    spec = RunSpec.from_file("examples/specs/host_1x1.json")
    ctx = build(spec)                  # build(spec, device="cpu") on a CPU
    setup = ctx.init_training()
    metrics = setup.step(0)
"""
from ..core.plan import LayerPlan, PrecisionPlan  # noqa: F401
from .spec import (AudioSpec, CompressionSpec,  # noqa: F401
                   GRAD_COMPRESSION_KINDS, KV_CACHE_MODES, MeshSpec,
                   PrecisionSpec, RunSpec, SERVING_WORKLOADS, ServingSpec,
                   emit_pareto_specs)
from .context import (GradCompression, RunContext,  # noqa: F401
                      TrainSetup, build, build_mesh)
