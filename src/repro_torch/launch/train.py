"""LM training launcher (counterpart of ``repro/launch/train.py``): a thin
shell over ``repro_torch.api``.  CLI flags, or a ``--spec run.json`` file
(``examples/specs/``) with flags as overrides, parse into one
:class:`repro_torch.api.RunSpec`; :func:`repro_torch.api.build` makes the
mesh, the train step and the checkpoint / resume flow from it.  Prints
what the reference's launcher prints.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --spec examples/specs/host_1x1.json [--steps 2] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --mesh 4x1 \\
        --grad-compression int8-wire --ckpt-dir /tmp/ckpt --ckpt-every 2

``--device`` is not a spec field: it picks where the run goes, the CUDA
card by default (no card: it raises; ``--device cpu`` runs the plain
PyTorch path).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

from ..api import RunSpec, TrainSetup, build


def main(argv: Optional[Sequence[str]] = None) -> TrainSetup:
    """Train the spec's run; returns its :class:`TrainSetup` (the final
    params, qstate, AdamW and EF state)."""
    ap = RunSpec.parser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the card by default)")
    args = ap.parse_args(argv)
    spec = RunSpec.from_parsed(args)
    ctx = build(spec, device=args.device)
    comp = ctx.grad_compression()
    if (spec.compression.kind == "int8-wire" and comp.wire
            and comp.wire_layout == "2d"):
        print(f"mesh has model axis of size {ctx.n_model}: upgrading "
              f"int8-wire to the 2D-sliced exchange (int8-wire-2d)")
    setup = ctx.init_training()
    tcfg = spec.train
    if tcfg.ckpt_dir and setup.maybe_resume():
        print(f"resumed from step {setup.start_step}")
    start = setup.start_step
    t0 = time.time()
    for step in range(start, tcfg.steps):
        m = setup.step(step)
        if step % max(tcfg.steps // 10, 1) == 0:
            print(f"step {step}: loss={float(m['loss']):.4f} "
                  f"ebops={float(m['ebops']):.3g}")
        if tcfg.ckpt_dir and step and step % tcfg.ckpt_every == 0:
            # label = steps applied = next step to run; labelling with
            # `step` would replay an already-applied batch
            setup.checkpoint(step + 1)
    print(f"done: {tcfg.steps - start} steps in {time.time()-t0:.1f}s")
    return setup


if __name__ == "__main__":
    main()
