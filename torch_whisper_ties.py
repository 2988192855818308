#!/usr/bin/env python3
"""How far float32 noise moves Whisper's "continuous" logits, the reading
``chip_smoke.py`` holds the card to against the CPU.  Run from the
repository root:

    python3 torch_whisper_ties.py [--device cpu] [--out build/ties.json]

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
says the card-vs-CPU gap comes from the grid's ties.  Prints one JSON
line and writes it to ``--out``.
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


def _without_probs_grid(tree):
    if isinstance(tree, dict):
        return {k: _without_probs_grid(v) for k, v in tree.items()
                if k != "probs_f"}
    if isinstance(tree, list):
        return [_without_probs_grid(v) for v in tree]
    return tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from repro_torch.configs import get
    from repro_torch.core.plan import LayerPlan, PrecisionPlan
    from repro_torch.models import WhisperModel
    from repro_torch.serving import split_audio
    from repro_torch.serving.packed import pack_for_serving

    dev = torch.device(args.device)
    n, C, T = cs.WHISPER_LOGITS_LAYERS, cs.WHISPER["chunk"], cs.WHISPER["T"]
    cfg = dataclasses.replace(get("whisper-large-v3"), n_layers=n,
                              enc_layers=n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    params, qstate = WhisperModel.init(gen, cfg, device=dev)
    frames = torch.from_numpy(np.stack(
        [cs._whisper_frames(T, cs.SEED + 20 + i) for i in range(2)]))

    def prepare(c, dv, pp, qq, kv_bits):
        for blk in split_audio(frames.to(dv), C):
            c = WhisperModel.append_cross(pp, qq, c, blk, cfg,
                                          kv_bits=kv_bits)
        return c

    plan = PrecisionPlan(layers={k: LayerPlan(wire_bits=4, pack_bits=4)
                                 for k in cs.WHISPER_MLP})
    out = {}
    for tag, pl, kv_bits in (("a", None, 8), ("b", plan, 4)):
        pp, qq = pack_for_serving(params, qstate, pl)
        out[tag] = {}
        for grid, tree in (("with_probs_grid", pp),
                           ("without_probs_grid", _without_probs_grid(pp))):
            r = cs._logits_vs_plain(
                tree, qq, cfg, kv_bits, dev,
                lambda pc: {"queries_two_ulps": (pc, _queries_two_ulps)},
                model=WhisperModel, prepare=prepare)
            out[tag][grid] = r["continuous"]["controls"]["queries_two_ulps"]
    line = json.dumps({"device": str(dev), "layers": n,
                       "rel_l2_of_the_fault": out})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
