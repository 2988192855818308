"""Dry run: the count of work of every (arch x shape) cell at full width,
with no weight allocated (counterpart of ``repro/launch/dryrun.py``,
which compiles each cell on 512 placeholder TPU devices).

Each cell's model is built on ``torch.device("meta")`` (shapes and
dtypes, no storage; for the ``opt`` variant's decode cells the packed
serving tree and the int8 KV cache), and one train step, prefill or
decode tick runs under ``analysis.trace.ProgramTrace``, which counts its
FLOPs and bytes the same way whatever implements the port's kernel ops
(``launch.roofline``).  The cell's JSON has the reference's keys where
they have a meaning: ``compile_s`` is ``trace_s``, ``memory_analysis``
is the bytes of the params, AdamW moments and caches counted from the
meta tensors, ``raw_cost_analysis`` is gone.

``--chips N`` (default 1, one H100) divides the global count evenly over
N cards (the JSON says so under ``partition``); no exchange across cards
is modelled, so ``t_collective_s`` is null with its reason.  A cell that
cannot be traced on ``meta`` (a data-dependent size, a value read on the
host) is reported ``FAILED`` with its error, never skipped.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--chips 8] [--variant opt] [--out DIR]

Prints one ``[dryrun] <tag>: ok bottleneck=... t=(compute, memory)s
trace=...s`` line (or ``FAILED: <error>``) a cell and writes
``<out>/<tag>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

from ..api import MeshSpec, PrecisionSpec, RunSpec, build
from ..configs import ARCHS, SHAPES, ShapeSpec, get
from ..core import hgq
from ..models import ModelConfig
from ..optim import adamw_init
from ..tree import tree_leaves
from .analytic import analytic_flops_total, hbm_bytes_per_chip
from .roofline import RooflineTerms, mfu

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device
                ) -> Dict[str, torch.Tensor]:
    """The cell's model inputs (zeros; on ``meta`` no storage)."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    fdt = cfg.np_dtype
    specs = {"tokens": torch.zeros((B, S), dtype=torch.int64,
                                   device=device)}
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model),
                                            dtype=fdt, device=device)
    if cfg.family == "audio" and shape.kind != "decode":
        specs["frame_embeds"] = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                            dtype=fdt, device=device)
    return specs


def cell_spec(arch: str, kind: str, variant: str, plan=None,
              smoke: bool = False) -> RunSpec:
    """The declarative config of one dry-run cell, on the RunSpec surface
    the launcher parses; ``variant="opt"`` turns on the beyond-paper
    knobs: bf16 compute, and for decode the packed int8 weights (through
    ``qmatmul``) and the int8 KV cache."""
    return RunSpec(
        arch=arch, full=not smoke, plan=plan, mesh=MeshSpec.host(1, 1),
        precision=PrecisionSpec(
            compute_dtype="bfloat16" if variant == "opt" else None,
            packed_serving=(variant == "opt" and kind == "decode")))


def _bytes(xs) -> int:
    return sum(t.numel() * t.element_size() for t in xs)


def cell_program(arch: str, shape: ShapeSpec, variant: str = "base",
                 device: Union[str, torch.device] = "meta", plan=None,
                 smoke: bool = False, seed: int = 0
                 ) -> Tuple[Callable[[], Any], Dict[str, Any]]:
    """``(run, facts)``: ``run()`` runs the cell's program once (a train
    step, a prefill, a decode tick) on ``device``; ``facts`` holds its
    context, config and the bytes of its state."""
    spec = cell_spec(arch, shape.kind, variant, plan, smoke)
    ctx = build(spec, device=device)
    cfg = ctx.cfg
    if shape.kind != "train":
        cfg = dataclasses.replace(cfg, dtype="bfloat16", remat=False)
    model = ctx.model
    # a meta tensor draws from a CPU generator (there is no meta one)
    gen = torch.Generator(device="cpu" if ctx.device.type == "meta"
                          else ctx.device)
    gen.manual_seed(seed)
    with ctx.activate():
        params, qstate = model.init(gen, cfg, device=ctx.device)
    batch = input_specs(cfg, shape, ctx.device)
    mem = {"params_bytes": _bytes(tree_leaves(params))}
    if shape.kind == "train":
        opt = adamw_init(params)
        mem["moments_bytes"] = _bytes(tree_leaves((opt.mu, opt.nu)))
        step = ctx.make_train_step(donate=(0, 2))
        box = {"state": (params, qstate, opt), "i": 0}

        def run():
            p, q, o = box["state"]
            p, q, o, metrics = step(p, q, o, batch, box["i"])
            box["state"], box["i"] = (p, q, o), box["i"] + 1
            return metrics
    elif shape.kind == "prefill":
        def run():
            with torch.no_grad(), ctx.activate():
                return model.forward(params, qstate, batch, cfg,
                                     mode=hgq.EVAL)[0]
    else:
        kv_bits = 8 if (variant == "opt" and cfg.family != "ssm") else None
        if spec.precision.packed_serving:
            from ..serving.packed import pack_for_serving
            with ctx.activate():
                params, qstate = pack_for_serving(params, qstate, ctx.plan)
            mem["params_bytes"] = _bytes(tree_leaves(params))
        caches = model.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  kv_bits=kv_bits, device=ctx.device)
        mem["cache_bytes"] = _bytes(c for c in caches if c is not None)
        pos = np.zeros(shape.global_batch, np.int64)

        def run():
            with torch.no_grad(), ctx.activate():
                return model.decode_step(params, qstate, caches,
                                         batch["tokens"], pos, cfg,
                                         kv_bits=kv_bits)[0]
    mem["total"] = sum(mem.values())
    return run, {"ctx": ctx, "cfg": cfg, "memory": mem}


def build_cell(arch: str, shape: Union[str, ShapeSpec],
               variant: str = "base", chips: int = 1, plan=None,
               device: Union[str, torch.device] = "meta",
               smoke: bool = False) -> Dict[str, Any]:
    """Trace one cell and return its JSON record (see the module
    docstring)."""
    from ..analysis.trace import ProgramTrace
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    if sp.name == "long_500k" and not get(arch).sub_quadratic:
        return {"arch": arch, "shape": sp.name, "status": "skipped",
                "reason": "full quadratic attention at 524288 tokens "
                          "(see DESIGN.md SS4 Arch-applicability)"}
    t0 = time.time()
    run, facts = cell_program(arch, sp, variant, device, plan, smoke)
    cfg = facts["cfg"]
    with ProgramTrace() as tr:
        run()
    trace_s = time.time() - t0
    opt_decode = variant == "opt" and sp.kind == "decode"
    mem_model = hbm_bytes_per_chip(
        cfg, sp, chips, tp=min(16, chips),
        weight_bits=8.0 if opt_decode else 16.0,
        cache_bytes=1.0 if opt_decode else 2.0)
    terms = RooflineTerms(
        flops=tr.flops / chips, hbm_bytes=mem_model["total"],
        coll_bytes=None, coll_breakdown={}, chips=chips,
        flops_by_dtype={d: f / chips for d, f in tr.flops_by_dtype.items()},
        coll_reason="no exchange across cards is modelled: the count is "
                    "the global work split evenly")
    n_act = cfg.n_active_params()
    tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1)
    model_flops = (6.0 if sp.kind == "train" else 2.0) * n_act * tokens
    return {
        "arch": arch, "shape": sp.name, "variant": variant,
        "mesh": f"{chips} x H100", "status": "ok",
        "trace_s": round(trace_s, 1), "kind": sp.kind,
        "device": str(torch.device(device)),
        "partition": f"even over {chips} card(s): per-chip FLOPs = the "
                     f"traced global count / {chips}; the memory term is "
                     f"the analytic model with tp = {min(16, chips)}",
        **terms.as_dict(),
        "flops_total": tr.flops,
        "counted_bytes_total": tr.bytes,
        "kernel_ops": dict(tr.kernel_ops),
        "hbm_model_breakdown": mem_model,
        "analytic_flops_total": analytic_flops_total(cfg, sp),
        "memory_analysis": facts["memory"],
        "model_flops_total": model_flops,
        "useful_flops_ratio": (model_flops / tr.flops) if tr.flops else 0.0,
        "roofline_fraction": mfu(model_flops, terms),
        "plan_widths": facts["ctx"].plan_summary(),
    }


def run_cells(archs, shapes, out_dir: str, variant: str = "base",
              chips: int = 1) -> Dict[str, Dict]:
    os.makedirs(out_dir, exist_ok=True)
    done = {}
    for arch in archs:
        for shape in shapes:
            vtag = "" if variant == "base" else f"_{variant}"
            tag = f"{arch}_{shape}_{chips}xH100{vtag}"
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                res = build_cell(arch, shape, variant=variant, chips=chips)
            except Exception as e:            # reported, never skipped
                res = {"arch": arch, "shape": shape, "status": "FAILED",
                       "mesh": f"{chips} x H100",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1, default=str)
            stat = res["status"]
            extra = ""
            if stat == "ok":
                extra = (f" bottleneck={res['bottleneck']}"
                         f" t=({res['t_compute_s']:.2e},"
                         f"{res['t_memory_s']:.2e})s"
                         f" trace={res['trace_s']}s")
            elif stat == "FAILED":
                extra = f": {res['error'][:200]}"
            print(f"[dryrun] {tag}: {stat}{extra}", flush=True)
            done[tag] = res
    return done


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--chips", type=int, default=1,
                    help="H100 cards the global work is divided over")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    args = ap.parse_args(argv)
    if args.chips < 1:
        ap.error("--chips must be at least 1")
    archs = ARCHS if args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    run_cells(archs, shapes, args.out, variant=args.variant,
              chips=args.chips)


if __name__ == "__main__":
    main()
