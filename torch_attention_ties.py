#!/usr/bin/env python3
"""How often ``kv_attention_rows`` parts from its plain version on the
ragged ring of ``chip_smoke.kv_attention_case`` at recurrentgemma-2b's
shape (B 8, S 1, 10 heads over 1 kv head of 256, 2064 slots, the
probabilities on a 2^-6 grid), over many input draws, int8 and nibble,
without and with a window of 8.

For each draw: the share of outputs more than 1e-5 off, the head rows
holding them (one probability tie flipped by a one-ulp ``exp`` moves a
whole head row: 1 of 80 rows is 1.25% of the outputs; the kernel phase's
check allows 1% of the outputs or one head row), and whether every
output lies within one probability step of the plain version.  Needs the card and ``nvcc``:

    python3 torch_attention_ties.py [--draws 40] [--out FILE]
"""
import argparse
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attention_ties: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.kv_dequant import kv_attention_rows, kv_unpack
    from repro_torch.kernels.kv_dequant.ref import (kv_attention_ref,
                                                    kv_dequant_ref)
    _build.build_all()
    dev = torch.device("cuda")
    Gf = cs.GRIFFIN
    B, S, H, KV, hd, W, pf = 8, 1, Gf["H"], Gf["KV"], Gf["hd"], Gf["W"], 6.0
    pft = torch.tensor([pf], device=dev)
    step = 2.0 ** -math.floor(pf + 0.5)
    rows = []
    for nibble in (False, True):
        for seed in range(args.draws):
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            for window in (None, 8):
                a = cs._attention_inputs(B, S, H, KV, hd, W, nibble, dev, g,
                                         ragged=True)
                out = kv_attention_rows(*a, window=window, n_kv=KV,
                                        probs_f=pft)
                ref = kv_attention_ref(
                    a[0].reshape(B, S, KV, H // KV, hd), *a[1:],
                    window=window, probs_f=pft).reshape(a[0].shape)
                v = kv_dequant_ref(kv_unpack(a[3], hd) if nibble else a[3],
                                   a[4])
                err = (out - ref).abs()
                off = err > 1e-5
                lim = step * (float(v.abs().max()) + ref.abs()) + 1e-5
                rows.append({"nibble": nibble, "seed": seed,
                             "window": window,
                             "share_off": float(off.float().mean()),
                             "head_rows_off": int(off.any(dim=-1).sum()),
                             "within_one_step": bool((err <= lim).all())})
    line = json.dumps({
        "device": torch.cuda.get_device_name(0), "draws": len(rows),
        "head_rows": B * S * H,
        "share_off_above_1pct": sum(r["share_off"] > 0.01 for r in rows),
        "beyond_one_step": sum(not r["within_one_step"] for r in rows),
        "head_rows_off_max": max(r["head_rows_off"] for r in rows),
        "worst": sorted(rows, key=lambda r: -r["share_off"])[:3]})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
