"""HGQ quantization-aware training of a dense LM in the PyTorch port: the
twin of ``examples/train_lm.py``.

Configuration is one ``repro_torch.api.RunSpec`` (the surface
``python -m repro_torch.launch.train`` parses): CLI flags are overrides on
this example's defaults, ``--spec run.json`` loads a spec whole.  The
defaults are the launcher's (``RunSpec()``: qwen2-0.5b SMOKE, 20 steps,
lr 1e-3, beta 1e-9 -> 1e-7, batch 4, seq 32) with a log line each step;
``--full`` takes the arch's published widths.  ``build(spec)`` makes the
seeded init and the ``lm`` pipeline (a Markov-ish synthetic token
stream); ``TransformerLM.forward`` (the chunked no-cache forward, each
layer rematerialized in its backward), ``lm_loss`` and ``Trainer`` run
the steps under the spec's context.  Prints each step's loss and ~EBOPs,
then the final loss, ~EBOPs, tokens per second and the wall time.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] \\
        [--arch qwen2-0.5b] [--full] [--steps 20] [--batch 4] [--seq 32]

It runs on the CUDA card unless ``--device cpu`` is given.
"""
import dataclasses
import time

import torch

from repro_torch.api import RunSpec, build
from repro_torch.train import Trainer, lm_loss


def main(argv=None):
    ap = RunSpec.parser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the card by default)")
    args = ap.parse_args(argv)
    base = dataclasses.replace(
        RunSpec(), train=dataclasses.replace(RunSpec().train, log_every=1))
    spec = RunSpec.from_parsed(args, base=base)
    ctx = build(spec, device=args.device)
    cfg = ctx.cfg
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"(active {cfg.n_active_params() / 1e6:.1f}M) on {ctx.device}")
    params, qstate = ctx.init_state()
    tr = Trainer(ctx.wrap(ctx.forward),
                 lambda out, b: lm_loss(out, b["tokens"]), spec.train,
                 params, qstate, pipeline=ctx.make_pipeline())
    if spec.train.ckpt_dir and tr.maybe_resume():
        print(f"resumed from step {tr.start_step}")
    t0 = time.perf_counter()
    res = tr.run()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = (spec.train.steps - tr.start_step) * spec.data.batch \
        * spec.data.seq
    print(f"final loss={res['metrics']['loss']:.4f} "
          f"ebops={res['metrics']['ebops']:.3g} "
          f"tokens/s={tokens / wall:.1f} wall={wall:.1f}s")


if __name__ == "__main__":
    main()
