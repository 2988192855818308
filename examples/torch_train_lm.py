"""HGQ quantization-aware training of a dense LM in the PyTorch port: the
twin of ``examples/train_lm.py`` (whose ``RunSpec`` surface is not ported;
the flags here are its training and data fields).

``TransformerLM.forward`` (the chunked no-cache forward, each layer
rematerialized in its backward), ``lm_loss`` and ``Trainer`` on the
``lm`` data kind (a Markov-ish synthetic token stream).  The defaults are
the launcher's (``src/repro/api/spec.py``): 20 steps, lr 1e-3, beta 1e-9
-> 1e-7.  Prints each step's loss and ~EBOPs, then the final loss, ~EBOPs,
tokens per second and the wall time.

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen2-0.5b \\
        [--smoke] [--device cpu] [--steps 20] [--batch 4] [--seq 32]

It runs on the CUDA card unless ``--device cpu`` is given; ``--smoke``
takes the arch's reduced configuration (2 layers, d 56, vocab 256).
"""
import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.data import DataSpec, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.models import model_for
from repro_torch.train import TrainConfig, Trainer, lm_loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced configuration")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the card by default)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get(args.arch, smoke=args.smoke)
    M = model_for(cfg)
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"(active {cfg.n_active_params() / 1e6:.1f}M) on {dev}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, qstate = M.init(gen, cfg, device=dev)
    pipe = make_pipeline(DataSpec(kind="lm", batch=args.batch, seq=args.seq,
                                  vocab=cfg.vocab, seed=0),
                         device=dev)
    tcfg = TrainConfig(steps=args.steps, lr=1e-3, beta0=1e-9, beta1=1e-7,
                       log_every=1)
    tr = Trainer(lambda p, q, b, mode: M.forward(p, q, b, cfg, mode),
                 lambda out, b: lm_loss(out, b["tokens"]), tcfg, params,
                 qstate, pipeline=pipe)
    t0 = time.perf_counter()
    res = tr.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = args.steps * args.batch * args.seq
    print(f"final loss={res['metrics']['loss']:.4f} "
          f"ebops={res['metrics']['ebops']:.3g} "
          f"tokens/s={tokens / wall:.1f} wall={wall:.1f}s")


if __name__ == "__main__":
    main()
