"""Continuous-batching serving in the PyTorch port: ragged per-slot decode,
HGQ int8-packed weights and the plan-width quantized KV ring -- the twin of
``examples/serve_llm.py`` over ``repro_torch.api``.

Each serving mode is a ``RunSpec`` (its ``ServingSpec``: slots, kv_cache,
packing), and the engines come from coexisting ``RunContext``s in one
process: each engine keeps the configuration of the context that built
it.  A reduced llama3.2-3b (SMOKE; ``--full`` takes the published widths)
serves a ragged workload, prompts of different lengths joining and
leaving mid-run:

* ``fp``      -- float32 weights, the bf16 KV cache;
* ``packed``  -- the projections on the ``qmatmul`` kernel over int8
  mantissas and per-channel 2^-f scales;
* ``kv_plan`` -- the KV ring stored at the plan's widths (4 bits: two
  mantissas a byte), written by ``kv_quantize_store`` and read by
  ``kv_attention_rows``.

The fp engine is driven through the handle surface (``submit`` ->
``RequestHandle``, the incremental ``tokens(handle)`` reader); the other
modes through ``run()``.

    PYTHONPATH=src python examples/torch_serve_llm.py [--device cpu] [--full]

It runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.api import (LayerPlan, PrecisionPlan, PrecisionSpec,
                             RunSpec, ServingSpec, build)
from repro_torch.serving import (Request, SamplingConfig, generate,
                                 kv_bytes_per_token)
from repro_torch.serving.packed import pack_tree, packed_nbytes


def make_requests(vocab):
    rng = np.random.default_rng(7)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, vocab, n)],
                    max_new=8) for n in (3, 9, 2, 7, 12, 5)]
    # one sampled request in the same batch as the greedy ones
    reqs[-1].sampling = SamplingConfig(temperature=0.8, top_k=16)
    return reqs


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def serve(tag, ctx, params, qstate):
    eng = ctx.make_engine(params, qstate, max_len=64, prefill_chunk=8)
    reqs = make_requests(ctx.cfg.vocab)
    t0 = time.perf_counter()
    eng.run(reqs)
    _sync(ctx)
    dt = time.perf_counter() - t0
    new_tokens = sum(len(r.out) for r in reqs)
    print(f"[{tag}] {len(reqs)} requests, {new_tokens} new tokens "
          f"in {dt:.2f}s ({new_tokens / dt:.1f} tok/s)")
    return reqs


def serve_streaming(ctx, params, qstate):
    """The handle surface: admit what fits, stream tokens as they land,
    backfill freed slots -- the same engine ``run()`` wraps."""
    eng = ctx.make_engine(params, qstate, max_len=64, prefill_chunk=8)
    reqs = make_requests(ctx.cfg.vocab)
    pending, handles = list(reqs), []
    t0 = time.perf_counter()
    while pending and (h := eng.submit(pending[0])):
        handles.append(h)
        pending.pop(0)
    while handles:
        h = handles.pop(0)
        for _ in eng.tokens(h):           # incremental reader
            while pending and (h2 := eng.submit(pending[0])):
                handles.append(h2)
                pending.pop(0)
    _sync(ctx)
    dt = time.perf_counter() - t0
    new_tokens = sum(len(r.out) for r in reqs)
    print(f"[fp/stream] {len(reqs)} requests, {new_tokens} new tokens "
          f"in {dt:.2f}s ({new_tokens / dt:.1f} tok/s)")
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the card by default)")
    ap.add_argument("--full", action="store_true",
                    help="llama3.2-3b at its published widths")
    args = ap.parse_args(argv)
    spec = RunSpec(arch="llama3.2-3b", full=args.full,
                   serving=ServingSpec(slots=4))
    packed_spec = dataclasses.replace(
        spec, precision=PrecisionSpec(packed_serving=True))
    kv_spec = dataclasses.replace(
        spec, plan=PrecisionPlan(default=LayerPlan(kv_bits=4)),
        serving=dataclasses.replace(spec.serving, kv_cache="plan"))

    # three contexts, one process: each engine keeps its own spec's
    # configuration
    ctx, packed_ctx, kv_ctx = (build(s, device=args.device)
                               for s in (spec, packed_spec, kv_spec))
    params, qstate = ctx.init_state()
    print(f"arch={ctx.cfg.name} params={ctx.cfg.n_params() / 1e6:.1f}M "
          f"on {ctx.device}")

    # ---- fp engine, handle surface: streaming ragged batching --------
    reqs = serve_streaming(ctx, params, qstate)
    for i, r in enumerate(reqs):
        print(f"  request {i}: prompt[{len(r.prompt)}] -> {r.out}")

    # ---- packed engine: int8 weights on the decode path --------------
    packed_reqs = serve("packed", packed_ctx, params, qstate)
    greedy = [i for i, r in enumerate(reqs) if r.sampling is None]
    agree = sum(reqs[i].out == packed_reqs[i].out for i in greedy)
    print(f"  greedy packed-vs-fp request agreement: {agree}/{len(greedy)}")
    fp_b, q_b = packed_nbytes(params), packed_nbytes(pack_tree(params))
    print(f"  weight bytes {fp_b} -> {q_b} ({fp_b / q_b:.2f}x fewer bytes "
          f"a decode step streams)")

    # ---- quantized-KV engine: nibble ring buffer ---------------------
    kv_reqs = serve("kv_plan", kv_ctx, params, qstate)
    agree = sum(reqs[i].out == kv_reqs[i].out for i in greedy)
    print(f"  greedy kv_plan-vs-fp request agreement: {agree}/{len(greedy)}")
    cfg = ctx.cfg
    fp_kv = kv_bytes_per_token(cfg.n_kv, cfg.hd, cfg.n_layers, None)
    q_kv = kv_bytes_per_token(cfg.n_kv, cfg.hd, cfg.n_layers, 4)
    print(f"  KV bytes/token {fp_kv} -> {q_kv} ({fp_kv / q_kv:.2f}x fewer "
          f"cache bytes a token)")

    # ---- per-request greedy reference (what the tests assert) --------
    r = reqs[0]
    ref = generate(ctx.model, params, qstate, ctx.cfg, [r.prompt],
                   r.max_new, cache_len=64, device=ctx.device)
    print(f"  engine == generate() for request 0: "
          f"{ref[0].tolist() == r.out}")


if __name__ == "__main__":
    main()
