#!/usr/bin/env python3
"""How far float32 noise moves Whisper's "continuous" logits, the reading
``chip_smoke.py`` holds the card to against the CPU.  Run from the
repository root:

    python3 torch_whisper_ties.py [--device cpu] [--init-layers N ...]
                                  [--fp-cache] [--out build/ties.json]

``chip_smoke.whisper_serving`` reads the card's logits against the CPU's
at whisper-large-v3's full width and 2 + 2 layers, after a 1500-frame
audio appended in chunks of 250, without the activation quantizers but
with the probabilities' 2^-f grid (``probs_f``).  The encoder's 250 x 250
attention puts many probabilities on that grid's rounding ties, where an
ulp of a sum decides the step.  This script takes the same reading on
one device (``--device``, the CPU by default) with one fault: the
encoder attention's queries scaled by 1 + 2^-22 (two ulps), with the
probabilities' grid and without it, in both serving configurations of
the part ((a) int8 with ``kv_bits`` 8, (b) the MLP in nibbles with
``kv_bits`` 4).  A reading with the grid far above the one without it
says the card-vs-CPU gap comes from the grid's ties.

``--init-layers N`` draws the weights as a model of N + N layers and
takes its first 2 + 2 (``chip_smoke.whisper_first_layers``, as the
script cuts its served model), one reading per N; without it the model
is drawn at 2 + 2.  With ``--device cuda`` the weights are the card's
draw and each reading is also the card's logits against the CPU's
(``gap``, the script's continuous reading) with the grid and without it:
a gap far above its reading without the grid is the grid's ties.
``--fp-cache`` adds both readings with a float32 cache and memory
(``kv_bits`` None, float32 in place of the float cache's bfloat16) in
place of the quantized ring's 2^-f rows, the other grid of the reading.  Prints one JSON line and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def _queries_two_ulps():
    """The encoder attention's queries (the no-cache chunked attention)
    scaled by 1 + 2^-22."""
    import repro_torch.nn.attention as att

    def scaled(real):
        return lambda qh, *a: real(qh * (1.0 + 2.0 ** -22), *a)

    with cs._patched(att, "_chunked_attention", scaled):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--init-layers", type=int, nargs="+", default=[None])
    ap.add_argument("--fp-cache", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from repro_torch.configs import get
    from repro_torch.core.plan import LayerPlan, PrecisionPlan
    from repro_torch.models import WhisperModel
    from repro_torch.serving import split_audio
    from repro_torch.serving.packed import pack_for_serving

    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    n, C, T = cs.WHISPER_LOGITS_LAYERS, cs.WHISPER["chunk"], cs.WHISPER["T"]
    frames = torch.from_numpy(np.stack(
        [cs._whisper_frames(T, cs.SEED + 20 + i) for i in range(2)]))
    plan = PrecisionPlan(layers={k: LayerPlan(wire_bits=4, pack_bits=4)
                                 for k in cs.WHISPER_MLP})
    readings = {}
    for init in args.init_layers:
        cfg = get("whisper-large-v3")
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED)
        if init is None:
            cfg = dataclasses.replace(cfg, n_layers=n, enc_layers=n)
            params, qstate = WhisperModel.init(gen, cfg, device=dev)
        else:
            big = dataclasses.replace(cfg, n_layers=init, enc_layers=init)
            params, qstate, cfg = cs.whisper_first_layers(
                *WhisperModel.init(gen, big, device=dev), big, n)

        def prepare(c, dv, pp, qq, kv_bits, cfg=cfg):
            for blk in split_audio(frames.to(dv), C):
                c = WhisperModel.append_cross(pp, qq, c, blk, cfg,
                                              kv_bits=kv_bits)
            return c

        out = {}
        for tag, pl, kv_bits in (("a", None, 8), ("b", plan, 4)):
            pp, qq = pack_for_serving(params, qstate, pl)
            bare = cs._without_probs_grid(pp)
            out[tag] = {}
            for grid, tree, kvb in (
                    ("with_probs_grid", pp, kv_bits),
                    ("without_probs_grid", bare, kv_bits),
                    ("with_probs_grid_fp_cache", pp, None),
                    ("without_probs_grid_fp_cache", bare, None)):
                if kvb is None and not args.fp_cache:
                    continue
                with (cs._float32_cache() if kvb is None
                      else contextlib.nullcontext()):
                    r = cs._logits_vs_plain(
                        tree, qq, cfg, kvb, dev,
                        lambda pc: {"queries_two_ulps": (
                            pc, _queries_two_ulps)},
                        model=WhisperModel, prepare=prepare)["continuous"]
                out[tag][grid] = {
                    "gap": r["rel_l2"],
                    "queries_two_ulps": r["controls"]["queries_two_ulps"]}
        readings[n if init is None else init] = out
        del params, qstate
    name = (torch.cuda.get_device_name(0) if dev.type == "cuda"
            else str(dev))
    line = json.dumps({"device": name, "layers": n,
                       "rel_l2_by_init_layers": readings})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
