"""The quickstart over a data-parallel mesh with the compressed gradient
wire, in the PyTorch port.

The jet tagger of ``examples/quickstart.py`` (same configuration and
schedule, batch 1024) trains over ``LocalMesh(4)``: four data ranks on one
device, each taking a 256-sample slice, the gradients mean-reduced by the
two-phase int8 / nibble wire with error feedback (``reduce="compressed"``,
1D, fused; ``mixed_low_plan(params, 4)`` puts the four kernels' ``w`` and
``f`` on 4-bit nibbles).  The same code then trains uncompressed from the
same init, and both are calibrated on a held-out batch.  Prints one JSON
object: accuracy, CALIB ~EBOPs and layer-0 bits of both runs and their
gaps.

    PYTHONPATH=src python examples/torch_dp_quickstart.py [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse
import json
import time

import torch

from repro_torch.core import hgq
from repro_torch.core.plan import mixed_low_plan
from repro_torch.data import DataSpec, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.dist import EFState, LocalMesh, ef_wire_init
from repro_torch.models import JetTagger
from repro_torch.nn import HGQConfig
from repro_torch.optim import adamw_init
from repro_torch.train import (TrainConfig, accuracy, make_train_step,
                               softmax_xent)


def train(params, qstate, pipe, tcfg, mesh=None, plan=None):
    fwd = lambda p, q, batch, mode: JetTagger.forward(p, q, batch, mode)
    loss = lambda out, b: softmax_xent(out, b["y"])
    opt = adamw_init(params)
    if mesh is None:
        step = make_train_step(fwd, loss, tcfg)
    else:
        step = make_train_step(fwd, loss, tcfg, reduce="compressed",
                               mesh=mesh, wire_widths=plan)
        ef = EFState(residual=ef_wire_init(params, mesh.size))
    for s in range(tcfg.steps):
        if mesh is None:
            params, qstate, opt, m = step(params, qstate, opt, pipe(s), s)
        else:
            params, qstate, opt, m, ef = step(params, qstate, opt, pipe(s),
                                              s, ef)
        if s % tcfg.log_every == 0:
            print(f"step {s}: loss={float(m['loss']):.4f} "
                  f"ebops={float(m['ebops']):.3g}", flush=True)
    with torch.no_grad():
        batch = pipe(10 ** 6)                       # held out
        logits, _, aux = JetTagger.forward(params, qstate, batch,
                                           mode=hgq.CALIB)
    f0 = params["d0"]["kernel"]["f"]
    return {"accuracy": float(accuracy(logits, batch["y"])),
            "calib_ebops": float(aux.ebops),
            "layer0_f_mean": float(f0.mean()),
            "final_loss": float(m["loss"])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--seed", type=int, default=20241016)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    qcfg = HGQConfig(weight_gran="per_parameter", act_gran="per_parameter",
                     init_weight_f=2.0, init_act_f=2.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params, qstate = JetTagger.init(gen, qcfg, device=dev)
    pipe = make_pipeline(DataSpec(kind="jet", batch=1024), device=dev)
    tcfg = TrainConfig(steps=300, lr=3e-3, beta0=1e-6, beta1=1e-3,
                       gamma=2e-6, log_every=50)
    t0 = time.perf_counter()
    comp = train(params, qstate, pipe, tcfg, LocalMesh(args.shards, dev),
                 mixed_low_plan(params, 4))
    t1 = time.perf_counter()
    full = train(params, qstate, pipe, tcfg)
    t2 = time.perf_counter()
    print(json.dumps({
        "device": str(dev), "shards": args.shards,
        "compressed": dict(comp, wall_s=t1 - t0),
        "uncompressed": dict(full, wall_s=t2 - t1),
        "gaps": {"accuracy": abs(comp["accuracy"] - full["accuracy"]),
                 "calib_ebops_rel": abs(comp["calib_ebops"]
                                        - full["calib_ebops"])
                 / full["calib_ebops"],
                 "layer0_f_mean": abs(comp["layer0_f_mean"]
                                      - full["layer0_f_mean"])}}))


if __name__ == "__main__":
    main()
