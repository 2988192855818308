#!/usr/bin/env python3
"""Drive the PyTorch port of HGQ (serving, training, data-parallel
training over the compressed gradient wire, the ``api`` surface and the
launcher) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and the CUDA toolkit (``nvcc``), and imports
only the port under ``src/repro_torch``, never JAX.  In order it

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. kernel phase: holds every kernel against its plain PyTorch version at
   the shapes its main path gives it, under the stated tolerances, checks
   that two launches give the same bits where the kernel promises it, and
   that a row's result does not depend on the batch it rides in
   (``qmatmul`` at M = 1, 8 and 16, ``kv_attention_rows`` alone and in a
   batch of 8), and times the kernel, the plain version and a one-call
   library yardstick (where one exists) with CUDA events, beside the least
   time the card could take; holds ``qmatmul``'s exact products against
   a control that drops the lowest bf16 term, and ``kv_attention_rows``
   on rings longer than serving's (up to 32768 slots); holds
   ``wire_pack_rows`` on views 0-15 bytes past a 16-byte boundary, and
   the ``hgq_quantize`` backward on an unaligned view against an aligned
   copy (the same bits); holds the grouped ``hgq_quantize`` forward
   against per-member launches and the plain group (mixed layouts and
   dtypes, unaligned views), and the fused KV store ``kv_quantize_store``
   against its plain version on int8 and nibble rings, S = 1 and 16, a
   windowed ring, a chunk longer than the ring, bfloat16 rows and views
   1-15 bytes into their buffers; holds the fused reduce's bucket kernels
   ``wire_quantize_bucket`` and ``wire_dequant_bucket`` against their
   plain versions at every rank index on int8 and nibble buckets, odd C,
   ragged T, stacked and bfloat16 leaves, leaves and residuals off a
   16-byte boundary, -0.0 and subnormal residuals, and a bucket of 65
   members (two launches of each); times ``kv_dequant_rows`` at one
   qwen2-0.5b layer's ring, one slot's and all 24 layers' (R = 16384,
   2048, 393216, hd 64) beside the empty kernel on the same grid (the
   launch floor), and holds it on its edges (any hd, rows off alignment,
   ragged R, -128 mantissas at every exponent); holds and times the
   serving kernels at granite-moe-3b-a800m's shapes too (``qmatmul`` at
   N 40 and 49155, attention and the store at 8 kv heads) and at
   recurrentgemma-2b's (``qmatmul`` at K 2560 and 7680, N 256 to 256000;
   ``kv_attention_rows`` at head dim 256, 10 heads over 1 kv head, on its
   wrapped 2064-slot ring with a window of 2048, int8 and nibble, a tick
   and a prefill chunk, rings up to 32768 slots, and rings read without
   16-byte loads, which give the aligned ring's bits; ``kv_quantize_store``
   at hd 256 on a windowed ring) and at whisper-large-v3's (``qmatmul`` at
   M 8 and 250 for 1280 x 1280 and 1280 <-> 5120, int8 and nibbles;
   ``kv_attention_rows`` at 20 heads over 20 kv heads on the 448-slot
   ring and the 1500-slot memory, a tick and a prompt chunk, and on rows
   that see no slot, which read exact zeros; ``kv_quantize_store`` into
   the self ring and a chunk's cross rows of all 32 layers in one
   launch); holds and
   times the ``hgq_quantize`` shapes of the SVHN and muon models (4-D
   per-parameter conv kernels, per-tensor activations up to 1.84 M
   values, their grouped forwards) and of the qwen2-0.5b training step
   (the 151936 x 896 table per channel, a 29.4 M-value chunk pair of
   attention probabilities, the activations, one layer's grouped forward
   of 10 weights and biases) and of granite-moe-3b-a800m's (the expert
   stacks [40, 1536, 512] and [40, 512, 1536] per expert channel and per
   expert tensor, each expert's bits those of its own launch; the untied
   table and head; one layer's grouped forward of 8 weights with the
   router and the three stacks), with the per-expert layouts' edges (E =
   1, K = 1, K not a multiple of a block's rows, N not a multiple of 32,
   bfloat16, just past the one-cluster line);
4. slice phase: serves qwen2-0.5b at full width and 4 of its 24 layers
   (``QWEN_SERVE_LAYERS``, cut from the full init; all 24 in earlier
   runs; random weights from a seed) through the port's ``Engine`` in two
   configurations, holds the
   tokens against ``generate()`` and the logits against the CPU's plain
   path (a limit that two faulty controls must exceed), checks that every
   serving kernel's launch counter moved and that configuration (a), whose
   MLP is stored in nibbles, unpacks none, and tallies one full tick's
   launches by shape (one ``kv_quantize_store`` a layer); only after every
   timed run is one full tick per configuration traced with
   ``torch.profiler``, whose trace also gives the blocks each
   ``kv_attention_rows`` launch ran (at least 128) and must hold no
   ``stack``, ``index_put`` or ``bitwise`` operation (the KV store is one
   kernel); then serves granite-moe-3b-a800m (the MoE family: 40 experts,
   top 8) at its published widths and 2 of its 32 layers the same way
   (``granite_serving``; all 32 were held in earlier runs):
   (a) packed int8 with ``kv_bits`` 8, (b) the expert stacks in nibbles
   with ``kv_bits`` 4; every request finishes, each equals itself served
   alone by an engine of the same geometry, card vs CPU logits at its 2
   layers within the dense limits that two MoE faults (gates not
   renormalized, the capacity one slot short) exceed, one full tick's
   launches by shape exact (11 ``qmatmul``, 2 ``kv_quantize_store``,
   2 ``kv_attention_rows``; the expert nibbles unpacked, no ``qmatmul``
   weight), and one tick of each profiled last; then serves
   recurrentgemma-2b (the Griffin family: RG-LRU blocks and local
   attention with head dim 256) at its published widths and 5 of its 26
   layers (1 of its 8 units and its 2 remainder layers; all 26 were held
   in earlier runs) the same way (``griffin_serving``, ``max_len`` 4096,
   so its ring is the window and a chunk, 2064 slots): (a) packed int8,
   ``kv_bits`` 8, with one more request of a 2100-token prompt that wraps
   its ring past the window; (b) every MLP kernel in nibbles, ``kv_bits``
   4; every request equal alone, card vs CPU at 5 layers within the
   dense limits that two Griffin faults (the RG-LRU without its input
   normalization, the conv state not carried) exceed, one full tick's
   launches by shape exact (40 ``qmatmul``, 1 ``kv_quantize_store`` and
   1 ``kv_attention_rows`` at hd 256), and one tick of each profiled
   last; then serves rwkv6-1.6b (the RWKV-6 family: time mix and
   channel mix, no KV cache) at its published widths and 2 of its 24
   layers (all 24 were held in earlier runs) the same way
   (``rwkv_serving``, ``max_len`` 2048, the constants of the reference's
   init redrawn from the seed): (a) packed int8 with one more request of
   a 1024-token prompt (64 chunks of state carried through one slot);
   (b) every channel-mix kernel in nibbles; every request equal alone,
   card vs CPU at 2 layers within the dense limits that three RWKV faults
   (the WKV state not carried, the token shift taken from the residual
   stream, the per-head norm left out) exceed, one full tick's launches
   by shape exact (17 ``qmatmul``, no KV kernel), and one tick of each
   profiled last; then serves whisper-large-v3 at its published widths
   and the first 2 of its 32 encoder and 2 of its 32 decoder layers
   (``WHISPER_SERVE_LAYERS``; all 32 + 32 were held in earlier runs)
   through ``StreamingEngine`` (``whisper_serving``, 8
   slots, ``max_len`` 448, audio chunks of 250 frames): 6 audio requests
   of 300-1500 frames beside 4 LM requests, (a) packed int8, ``kv_bits``
   8, (b) every MLP kernel in nibbles, ``kv_bits`` 4; each audio request
   equal to ``generate_asr``, each LM request to a plain ``Engine``; one
   full tick's launches by shape exact (32 ``qmatmul``, 4 stores, 8
   ``kv_attention_rows``) and one 250-frame append's (32 ``qmatmul`` at
   M 250, one store for the four layers); the cross memory's bytes the byte
   model's; every LM row of a mixed tick reading exact zeros from the
   memory; card vs CPU at 2 + 2 layers after a 1500-frame audio within
   the dense limits that three Whisper faults (the memory not appended,
   each chunk encoded at offset 0, the decoder's positions dropped)
   exceed, as served and sound (a float32 cache and memory, no
   probabilities' grid: the served reading keeps two grids' ties, which
   move it with the draw); then the api part (``api_serving``): the shipped serving specs
   at full width through ``build(spec).make_engine``, each loaded with
   ``RunSpec.from_args(["--spec", path, "--full"])``: llama3.2-3b from
   ``serving_packed.json`` (d 3072, packed int8, fp cache, 8 slots,
   ``max_len`` 1024; checked at its 28 layers, served at the first
   ``API_SERVE_LAYERS``) serving qwen2's traffic shape, its packed tree
   equal to ``pack_params_for_serving`` by hand, every request equal to
   itself served alone, one full tick's launches by shape exact (29
   ``qmatmul`` at 4 layers, no KV kernel), card vs CPU at 2 of its layers
   within the dense limits that the dense controls exceed; and
   qwen2-0.5b from ``serving_kv_plan.json`` (4 slots, nibble MLP,
   ``kv_bits`` 4, at ``API_SERVE_LAYERS`` of its 24 layers), its tokens
   equal to an ``Engine`` built by hand;
   qwen2's (a) and (b) engines and Whisper's are built through
   ``build(RunSpec).make_engine`` too; one tick of each family, one
   append of Whisper's (a) and one llama tick profiled last (the four
   families through one ``_serve_family``);
5. train phase: trains the paper's jet tagger at its full width with
   ``examples/quickstart.py``'s configuration through the port's
   ``Trainer.run`` (300 steps, batch 1024), calibrates it on a held-out
   batch and checks accuracy, ~EBOPs, layer-0 bits and the fixed-point
   proxy; tallies one step's ``hgq_quantize`` launches by shape (exactly
   one grouped forward of the 8 weights and biases, 4 single forwards,
   12 backward); runs 20
   steps on the card and on the CPU from one init (a limit that two faulty
   controls must exceed) and twice on the card (bit-identical); then
   traces one step with ``torch.profiler``, whose trace must hold five
   ``hgq_fwd_group`` kernels and one ``hgq_bwd`` kernel for each
   per-channel and per-tensor backward (a trace is read only whole, with
   a device kernel for every kernel launch of the step, which runs after
   512 marker kernels, and the step runs again, up to three times, until
   one is); then the paper's SVHN (Table II, batch 128, 120 steps) and
   muon (Table III, batch 1024, 500 steps) models at
   ``benchmarks/paper_tables.py``'s configurations through
   ``Trainer.run``: each calibrated on a held-out batch and its metric
   (accuracy, RMS resolution) and CALIB ~EBOPs held to the JAX package's
   CPU run of the same configuration within stated margins, ~EBOPs seen
   to fall (muon from step 0, SVHN from the peak its growing activation
   ranges first raise), one step's ``hgq_quantize`` launches tallied by
   shape as exact counts (6 single forwards, one grouped forward of the
   12 weights and biases, 18 backward), 20 card steps against 20 CPU
   steps (a limit that two faulty controls exceed: the conv in TF32 and
   the backward without ``ln2 * delta`` for SVHN, that backward and
   ``floor(f)`` rounding for muon), two card runs bit-identical, and one
   step of each traced last as the jet's is (one ``hgq_bwd`` kernel a
   reducing backward, two past the one-cluster line); then qwen2-0.5b at
   its published width (``configs/qwen2_0_5b.py`` FULL, random weights
   from the seed, the ``lm`` data kind, batch 2, seq 2048, chunks of 1024,
   each layer rematerialized) through ``Trainer.run`` for 5 steps at the
   launcher's settings: step 0's loss near ln(vocab), every loss finite,
   ~EBOPs reported, step ms, tokens/s, peak memory and
   ``lm_train_mfu_fp32``; a step's ``hgq_quantize`` launches tallied by
   shape as exact counts (579 single forwards, 48 grouped, 531 backward);
   its first 3 steps run again from the same init (the same bits); the
   same code at full width and 2 layers (seq 256, chunks of 128) 5 steps
   on the card against the CPU (step 0's loss and every step's ~EBOPs,
   a limit that three faulty controls exceed: TF32 matmuls, the
   probabilities quantized after one softmax over all keys, the backward
   without ``ln2 * delta``);
   ``TransformerLM.forward`` in EVAL against ``decode_step`` token by
   token on the fp cache and the 8-bit ring, as served and without
   activation quantizers; then granite-moe-3b-a800m at its published
   width (40 experts of d_ff 512, top 8) and 4 of its 32 layers (all 32
   held in earlier runs; batch 2, seq 1024, remat; the params and AdamW
   state updated in place, the card holding one such model) through
   ``Trainer.run`` for 10 steps: step 0's loss
   near ln(vocab) + 1/2 (the untied head's logit variance), step ms,
   tokens/s, peak memory, MFU over the active parameters; a step's
   ``hgq_quantize`` launches by shape exact (131 single forwards, 16
   grouped of 8 members with the router and the expert stacks, 131
   backward); one step traced; its first 3 steps again from the same
   init (the same bits: the dispatch backward and the per-expert
   reductions in a fixed order); the same code at full width and 2
   layers (seq 128, chunks of 64) on the card against the CPU, without
   activation quantizers (one step) and as trained (5 steps): step 0's
   loss, every step's ~EBOPs and every leaf's first AdamW moment, each
   reading under its limit, which three faulty controls exceed (gates
   not renormalized, capacity one slot short, an expert stack's df summed
   over its experts); then the api part (``api_training``):
   ``launch.train.main`` on ``examples/specs/host_1x1.json --full
   --steps 4 --batch 2 --seq 256 --ckpt-every 2`` (qwen2-0.5b at full
   width through ``build(spec).init_training()``): a step's
   ``hgq_quantize`` launches by shape exact (435 single forwards, 48
   grouped, 459 backward), the state after 4 steps equal bit for bit to
   a hand-wired ``Trainer``, the same call again resumed from step 3 to
   the same bits, and at SMOKE ``--mesh 4x1 --grad-compression int8-wire
   --plan plan_mixed_w4w8.json`` launching the fused wire kernels over a
   ``LocalMesh(4)``; then the family part (``family_training``):
   recurrentgemma-2b (5 of 26 layers: one unit and the 2-layer
   remainder), rwkv6-1.6b (2 of 24) and whisper-large-v3 (2 + 2 of 32 +
   32, the ``asr`` data kind) at their published widths, one at a time,
   each 5 steps through ``build(spec).init_training()`` (batch 2, seq
   2048, Whisper 1500 frames and 448 tokens): step 0's loss near
   ln(vocab) (+ 1/2 for the untied heads), every loss finite, the
   qstate's leaf paths after every step the init's, a step's
   ``hgq_quantize`` launches by shape, the quantizer's plain versions
   raising on the card, one step traced, step 0 run twice from the same
   init (the same bits; the second counted by ``analysis.ProgramTrace``:
   the FLOPs' share of the float32 peak), the quantizer's new shapes held
   and timed as in the kernel phase; then step 0 on the card against the
   CPU at seq 64 / 128 / 256 (Whisper 250 frames) without activation
   quantizers and probabilities' grids: the card's launches by shape equal to the CPU's
   quantizer calls, the loss's and the gradient tree's relative gaps
   under limits that two faulty controls exceed, one of which changes
   only the backward (the scan's ``a``, the WKV's ``w``, the cross
   memory detached); the other models' steps traced last;
6. wire phase: (a) trains the same jet tagger data-parallel over
   ``dist.LocalMesh(4)`` (four ranks as threads on the one card: NCCL
   refuses two ranks on one GPU) with ``reduce="compressed"`` (1D, fused,
   ``mixed_low_plan(params, 4)``: a nibble bucket and an int8 bucket),
   300 steps at batch 1024, calibrates it and holds accuracy, ~EBOPs and
   layer-0 bits against the same code's uncompressed run from one init;
   runs 20 compressed steps on the card and on the CPU from one init (a
   limit that two faulty wires must exceed) and twice on the card
   (bit-identical), and traces one step as the train phase does, which
   must hold no ``aten::constant_pad_nd`` (the bucket kernels build the
   chunk layout; one launch of each a bucket a rank, none of the
   per-position kernels); (b)
   reduces qwen2-0.5b's full-width gradient tree
   (4 shards of seeded values) over the wire, uniform int8 and
   ``plan_mixed_w4w8``, and holds the fused path, the per-leaf path and
   ``simulate_wire_pmean`` equal bit for bit, the card equal to the CPU
   on two leaves, the recorded bytes equal to the byte model, reads the
   fused reduce's own peak memory (its timed calls alone) beside the
   phase's, and traces one mixed reduce (no ``aten::constant_pad_nd``;
   its events counted by name), the layer stacks cut to their first 4 of
   24 (``QWEN_REDUCE_LAYERS``; all 24 in earlier runs); (c) trains
   qwen2-0.5b at full width and its first 2 of 24 layers
   (``QWEN_2D_LAYERS``; all 24 in earlier runs) from
   ``examples/specs/host_2x4_int8wire2d.json --full`` through
   ``build(spec).init_training()`` over ``dist.LocalMesh(2, model=4)``
   (8 ranks as threads: each data shard's forward and backward whole on
   the card, the ``model`` axis slicing the 2D compressed exchange and
   its residual), batch 4, seq 32, 2 steps
   (launches by shape exact: the per-position kernels, one phase-1
   quantize a leaf a rank, one decode a leaf on rank 0, whose tree the
   mesh returns), then puts one step's full
   gradient tree and the run's residual through the 2D exchange, uniform
   int8 and ``plan_mixed_w4w8``: fused == per-leaf ==
   ``simulate_wire_pmean_2d`` bit for bit, the card equal to the CPU on two
   leaves (under the mixed plan: one at 8 bits, one at 4), the recorded
   bytes the sum of ``wire2d_leaf_bytes``, 1.0 byte an
   element against the 1D exchange's 4.0 with its model-axis float32
   gather; the pure tensor-parallel ``LocalMesh(1, model=4)`` records no
   data exchange; the jet tagger's 2D compressed step over
   ``LocalMesh(2, model=4)``: 20 steps on the card against the CPU (a
   limit two faulty controls exceed: the phase-2 remainder dropped, every
   rank quantizing model slice 0), twice on the card, and 8 steps against
   the post-reduce int8 path (the loss curve tracked); then holds every
   ``wire_pack`` kernel shape those paths launched against its plain
   version and times it (the jet's 2D shapes, a few KB each, held only);
7. analysis phase: runs every program rule of ``repro_torch.analysis``
   and its census over four programs built on the card at full width
   (the packed decode ticks of ``serving_packed.json`` -- llama3.2-3b at
   ``API_SERVE_LAYERS`` of its layers -- and of ``serving_kv_plan.json``
   -- qwen2-0.5b, the same depth --, the launcher's train step on
   ``host_1x1.json --full`` and the 2D step of
   ``host_2x4_int8wire2d.json --full``): no rule violated; four faulty
   controls injected on the card each flagged (an f32 wire payload and
   the in-place update dropped, on the two train specs' SMOKE programs,
   a float64 parameter and the weights served unpacked on the full-width
   decode ticks); then counts the work of the train phase's LM step
   (qwen2-0.5b FULL, batch 2, seq 2048) and of a packed qwen2-0.5b decode
   tick of 8 slots on the card (``launch.dryrun``'s cell builder, times
   the median of ``WORK_TIMED`` runs) and holds both FLOP counts equal,
   exactly, to the dry run's on ``meta`` (run in a child process started
   at the script's start, on the CPU), printing the roofline terms, the
   roofline fraction and the measured share of the peak;
8. prints one JSON line with every kernel's numbers, its times per unit
   of its main path (a full decode tick -- an RWKV and a llama3.2-3b
   tick beside qwen2's, granite's, Griffin's and Whisper's for
   ``qmatmul``, and a Whisper
   250-frame append for ``qmatmul`` and the store --, a training step --
   the jet's,
   with an svhn, a muon, an LM, a granite, a launcher, a Griffin, an
   RWKV and a Whisper step beside it --, a compressed
   data-parallel step, a qwen2 gradient reduce, a 2D step) weighted by
   those tallies (a granite step among the training units), the TPU kernels
   still to port, then, last, ``{"ok": true,
   "device": {...}}``.

Kernel groups: ``SERVING`` (``qmatmul``, ``kv_quantize_store``,
``kv_attention_rows``), ``TRAINING`` (``hgq_quantize`` forward, single
and grouped, and backward), ``WIRE`` (``wire_quantize_rows`` on the 1D
per-leaf path, ``wire_quantize_bucket``, ``wire_pack_rows`` and
``wire_dequant_bucket`` on the 1D fused path, ``wire_quantize_sflat``,
``wire_pack_rows`` and ``wire_dequant_rows`` on the 2D exchange);
``kv_dequant_rows`` and ``kv_quantize_rows`` are on no main path (the
entry points of the ops ``kv_dequant`` and ``kv_quantize``; the serving
store runs ``kv_quantize_rows``' body as ``kv_quantize_store``) and are
held and timed in the kernel phase only.

Any failure raises and exits non-zero before the last line.
``--phase kernels`` stops after step 3 (a short check of a changed
kernel) and leaves the per-unit fields null; ``--phase serve`` runs steps
1-4, ``--phase train`` steps 1-3 and 5, ``--phase families`` steps 1-3
and step 5's family part alone, ``--phase wire`` steps 1-3 and 6,
``--phase analysis`` steps 1-3 and 7.  The peaks and bounds are
``repro_torch.launch.roofline``'s (the H100 SXM data sheet).
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
from typing import Optional
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 20241016

L2_BYTES = 50 * 2 ** 20

# every pallas_call of the JAX package: (name, file:line of the function)
TPU_KERNELS = [
    ("hgq_quantize_2d", "src/repro/kernels/hgq_quantize/kernel.py:59"),
    ("qmatmul", "src/repro/kernels/qmatmul/kernel.py:40"),
    ("kv_quantize_rows", "src/repro/kernels/kv_dequant/kernel.py:104"),
    ("kv_dequant_rows", "src/repro/kernels/kv_dequant/kernel.py:132"),
    ("kv_attention_rows", "src/repro/kernels/kv_dequant/kernel.py:154"),
    ("wire_quantize_rows", "src/repro/kernels/wire_pack/kernel.py:88"),
    ("wire_quantize_sflat", "src/repro/kernels/wire_pack/kernel.py:117"),
    ("wire_pack_rows", "src/repro/kernels/wire_pack/kernel.py:141"),
    ("wire_dequant_rows", "src/repro/kernels/wire_pack/kernel.py:161"),
]
_CSRC = "src/repro_torch/kernels/csrc/"
# every kernel wrapper of the port: (source, the TPU kernel it replaces)
KERNELS = {
    "qmatmul": (_CSRC + "qmatmul.cu", "qmatmul"),
    "kv_quantize_rows": (_CSRC + "kv_dequant.cu", "kv_quantize_rows"),
    "kv_quantize_store": (_CSRC + "kv_dequant.cu", "kv_quantize_rows"),
    "kv_dequant_rows": (_CSRC + "kv_dequant.cu", "kv_dequant_rows"),
    "kv_attention_rows": (_CSRC + "kv_dequant.cu", "kv_attention_rows"),
    "hgq_quantize_fwd": (_CSRC + "hgq_quantize.cu", "hgq_quantize_2d"),
    "hgq_quantize_fwd_group": (_CSRC + "hgq_quantize.cu", "hgq_quantize_2d"),
    "hgq_quantize_bwd": (_CSRC + "hgq_quantize.cu", "hgq_quantize_2d"),
    "wire_quantize_rows": (_CSRC + "wire_pack.cu", "wire_quantize_rows"),
    "wire_quantize_sflat": (_CSRC + "wire_pack.cu", "wire_quantize_sflat"),
    "wire_pack_rows": (_CSRC + "wire_pack.cu", "wire_pack_rows"),
    "wire_dequant_rows": (_CSRC + "wire_pack.cu", "wire_dequant_rows"),
    "wire_quantize_bucket": (_CSRC + "wire_pack.cu", "wire_quantize_sflat"),
    "wire_dequant_bucket": (_CSRC + "wire_pack.cu", "wire_dequant_rows"),
}
SERVING = ("qmatmul", "kv_quantize_store", "kv_attention_rows")
TRAINING = ("hgq_quantize_fwd", "hgq_quantize_fwd_group", "hgq_quantize_bwd")
# the compressed gradient reduce: the 1D fused path launches FUSED_WIRE,
# the 1D per-leaf path and the simulator wire_quantize_rows, and never the
# per-position kernels (PER_POSITION_WIRE), which the 2D exchange launches
# (with wire_pack_rows for its nibble leaves)
WIRE = ("wire_quantize_rows", "wire_quantize_sflat", "wire_pack_rows",
        "wire_dequant_rows", "wire_quantize_bucket", "wire_dequant_bucket")
FUSED_WIRE = ("wire_quantize_bucket", "wire_pack_rows", "wire_dequant_bucket")
PER_POSITION_WIRE = ("wire_quantize_sflat", "wire_dequant_rows")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def peak_rate(dtype: str = "float32") -> float:
    """The card's peak rate for ``dtype`` (``launch.roofline.PEAK_FLOPS``:
    the NVIDIA H100 SXM data sheet; "float32" outside the tensor cores,
    "bfloat16" the dense tensor-core rate ``qmatmul`` runs at)."""
    from repro_torch.launch.roofline import PEAK_FLOPS
    return PEAK_FLOPS[dtype]


def bound(nbytes: float, flops: float, rate: Optional[float] = None):
    """(least ms on the card, what bounds it) for moving ``nbytes`` and
    doing ``flops`` operations of a type whose peak rate is ``rate``
    (float32's by default): ``launch.roofline.bound``."""
    from repro_torch.launch import roofline
    return roofline.bound(nbytes, flops, rate or peak_rate("float32"))


def n_copies(nbytes: int) -> int:
    """Distinct argument sets a timed loop cycles through, so that it
    streams twice the L2 cache from device memory, as a decode tick
    streams every layer's weights and cache once.  At most 1024; where
    1024 copies would fit in L2, its reads are warm however many there
    are, and 64 copies (one timed batch) save the host the rest."""
    if 1024 * nbytes <= L2_BYTES:
        return 64
    return max(1, min(1024, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


# calls timed behind one sleep kernel: a stream holds about a thousand
# pending launches, and a host that blocks on a full queue while the device
# sleeps would be timed again
TIME_BATCH = 64
# host seconds spent in timing loops, by kind; the script's start
TIMED_S = collections.Counter()
T0 = [time.perf_counter()]


def time_ms(fn, arg_sets, min_calls: int = 64,
            kind: str = "kernel") -> float:
    """Device milliseconds per call of ``fn`` over ``arg_sets``, from CUDA
    events: the median over batches of ``TIME_BATCH`` calls.  A sleep
    kernel queued first holds the device until every call of a batch is
    enqueued, so the events time the calls back to back and not the
    host's launch rate; the median leaves out a batch whose host, slower
    than the sleep allowed for, left the device waiting."""
    t_in = time.perf_counter()
    calls = max(min_calls, len(arg_sets))
    for args in arg_sets[:3]:
        fn(*args)                                   # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(min(calls, TIME_BATCH)):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    per_call = []
    for b0 in range(0, calls, TIME_BATCH):
        torch.cuda._sleep(int(min(host_s * 1.5 + 1e-3, 2.0) * 2e9))
        start.record()
        b1 = min(calls, b0 + TIME_BATCH)
        for i in range(b0, b1):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / (b1 - b0))
    TIMED_S[kind] += time.perf_counter() - t_in
    return float(np.median(per_call))


# the plain versions and the library calls are timed over at most this many
# argument sets: a plain version launches tens of operations a call, and
# cycling one through a thousand sets of a small shape cost the host seconds
# a shape (where 64 sets fit in L2, its reads are warm, as the kernel's,
# cycled through twice L2, are not)
PLAIN_SETS = 64


def plain_ms(fn, arg_sets) -> float:
    """``time_ms`` of a plain version or a library call: at least 16 calls,
    over the first ``PLAIN_SETS`` argument sets."""
    return time_ms(fn, arg_sets[:PLAIN_SETS], 16, kind="plain")


def lap(what: str) -> None:
    """Prints the seconds since the script started, and those its timing
    loops took so far."""
    print(f"[time] {what} at {time.perf_counter() - T0[0]:.1f} s (timing "
          f"loops: kernels {TIMED_S['kernel']:.1f} s, plain versions and "
          f"library calls {TIMED_S['plain']:.1f} s)", flush=True)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def qmatmul_case(M, K, N, bits, dev, g):
    """Kernel vs plain vs ``torch.matmul(x, w.float()) * scale`` for one
    shape, the weight stored N-major as the serving packer stores it: int8
    (bits 8) or nibbles two to a byte along K (bits 4), read as they lie.
    At M = 16 also: rows 0-7 alone (M = 8) and row 3 alone (M = 1) give
    the same bits as inside the 16."""
    from repro_torch.kernels.qmatmul import (pack_nibbles, qmatmul,
                                             qmatmul_ref)
    nib = bits == 4
    qmax = 7 if nib else 127

    def make():
        x = torch.randn((M, K), generator=g, device=dev)
        m = torch.randint(-qmax, qmax + 1, (N, K), generator=g, device=dev,
                          dtype=torch.int8)
        f = torch.randint(4, 9, (N,), generator=g, device=dev)
        s = torch.pow(2.0, -f.to(torch.float32))
        w = pack_nibbles(m, axis=-1).T if nib else m.T    # N-major storage
        return x, w, s, m.T

    wbytes = K * N // 2 if nib else K * N
    sets = [make() for _ in range(n_copies(wbytes))]
    x, w, s, m = sets[0]
    y = qmatmul(x, w, s, nib=nib)
    check(torch.equal(y, qmatmul(x, w, s, nib=nib)),
          f"qmatmul {M}x{K}x{N} bits{bits}: two launches differ")
    ref = qmatmul_ref(x, w, s, nib=nib)
    check(torch.equal(ref, qmatmul_ref(x, m, s)),
          f"qmatmul_ref {M}x{K}x{N}: nibble storage != its mantissas")
    tol = 1e-5 * qmatmul_ref(x.abs(), m.abs(), s) + 1e-30
    err = (y - ref).abs()
    check(bool(torch.isfinite(y).all()), f"qmatmul {M}x{K}x{N}: not finite")
    check(bool((err <= tol).all()),
          f"qmatmul {M}x{K}x{N} bits{bits}: max err {float(err.max())} over "
          f"1e-5 * (|x| @ |w|) * scale")
    if M == 16:
        check(torch.equal(qmatmul(x[:8].contiguous(), w, s, nib=nib), y[:8])
              and torch.equal(qmatmul(x[3:4].contiguous(), w, s, nib=nib),
                              y[3:4]),
              f"qmatmul K{K} N{N} bits{bits}: rows differ at M = 1, 8, 16")
    precision = _qmatmul_precision(x, w, s, m, nib, g, f"qmatmul {M}x{K}x{N} "
                                   f"bits{bits}")
    nbytes = M * K * 4 + wbytes + N * 4 + M * N * 4
    # three bf16 terms of x through the tensor cores
    flops = 3 * 2.0 * M * K * N
    b_ms, b_by = bound(nbytes, flops, peak_rate("bfloat16"))

    def kern(x, w, s, m):
        return qmatmul(x, w, s, nib=nib)

    def plain(x, w, s, m):
        return qmatmul_ref(x, w, s, nib=nib)

    def library(x, w, s, m):
        return torch.matmul(x, m.float()) * s

    return {"shape": f"M{M} K{K} N{N} {'nibble' if nib else 'int8'}",
            "max_abs_err": float(err.max()), **precision,
            "ms": time_ms(kern, sets),
            "plain_ms": plain_ms(plain, sets),
            "library_ms": plain_ms(library, sets),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, "peak": peak_rate("bfloat16")}


# The kernel splits x into three bf16 terms, so that every product is
# exact.  Two controls tell that split from one that drops the lowest term
# (x rounded to hi + mid before the launch): on a weight with one nonzero
# mantissa a channel, where y must be the one rounding of x * m * scale,
# the share of outputs off it (the kernel at most EXACT_OFF_LIMIT at every
# shape, the two-term control above it); and the largest error against the
# float64 product over (|x| @ |w|) * scale (the kernel at most
# REL_ERR_LIMIT at every shape, the two-term control above it at one shape
# at least).  Readings in PERF.md.
EXACT_OFF_LIMIT = 0.01
REL_ERR_LIMIT = 3e-7


def _qmatmul_precision(x, w, s, m, nib, g, what):
    from repro_torch.kernels.qmatmul import (bf16_split3, pack_nibbles,
                                             qmatmul)
    hi, mid, _ = bf16_split3(x)
    x2 = hi.float() + mid.float()                   # exact: 16 bits
    y64 = x.double() @ m.double() * s.double()
    den = x.abs().double() @ m.abs().double() * s.double() + 1e-300

    def rel(y):
        return float(((y.double() - y64).abs() / den).max())

    rel1, rel2 = rel(qmatmul(x, w, s, nib=nib)), rel(qmatmul(x2, w, s,
                                                             nib=nib))
    # one nonzero mantissa a channel, at a random k
    K, N = m.shape
    qmax = 7 if nib else 127
    k = torch.randint(0, K, (N,), generator=g, device=x.device)
    v = torch.randint(1, qmax + 1, (N,), generator=g, device=x.device) * \
        (2 * torch.randint(0, 2, (N,), generator=g, device=x.device) - 1)
    ms = torch.zeros((N, K), dtype=torch.int8, device=x.device)
    ms[torch.arange(N, device=x.device), k] = v.to(torch.int8)
    ws = pack_nibbles(ms, axis=-1).T if nib else ms.T
    want = x[:, k] * (v.float() * s)                # one rounding
    off1 = float((qmatmul(x, ws, s, nib=nib) != want).float().mean())
    off2 = float((qmatmul(x2, ws, s, nib=nib) != want).float().mean())
    check(off1 <= EXACT_OFF_LIMIT < off2,
          f"{what}: exact-product control: kernel {off1:.4f} of outputs off "
          f"the one rounding of x * m * scale, two-term split {off2:.4f} "
          f"(limit {EXACT_OFF_LIMIT})")
    return {"rel_err": rel1, "rel_err_two_term": rel2,
            "exact_off": off1, "exact_off_two_term": off2}


def _dequant_lib():
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load("kv_dequant")
    ci, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.kv_dequant_grid.argtypes = [ci, ci, pi, pi, pi]
    lib.kv_dequant_grid.restype = None
    lib.kv_empty_launch.argtypes = [ci, ci, ctypes.c_void_p]
    lib.kv_empty_launch.restype = ci
    return lib


def dequant_grid(R, hd):
    """(blocks, threads, 16-byte pieces a lane) ``kv_dequant_rows``
    launches for [R, hd] on its 16-byte path."""
    import ctypes
    out = [ctypes.c_int() for _ in range(3)]
    _dequant_lib().kv_dequant_grid(R, hd, *(ctypes.byref(c) for c in out))
    return tuple(c.value for c in out)


# kv_dequant_rows is timed over more batches than the default: its calls are
# a few microseconds, and the median of four batches steadies the reading
DEQUANT_CALLS = 256


def launch_floor_ms(R, hd, dev):
    """The empty kernel of ``csrc/kv_dequant.cu`` on the grid
    ``kv_dequant_rows`` launches for [R, hd] (16-byte path), timed as
    ``time_ms`` times a kernel: the launch floor beside its time."""
    from repro_torch.kernels import _build
    lib = _dequant_lib()
    blocks, threads, _ = dequant_grid(R, hd)
    stream = _build.stream_ptr(dev)

    def empty():
        _build.check(lib.kv_empty_launch(blocks, threads, stream),
                     "empty kernel")

    return time_ms(empty, [()], DEQUANT_CALLS)


def kv_dequant_case(R, hd, dev, g):
    """Kernel vs plain, bit-exact, two launches identical, vs
    ``torch.ldexp(q, -f)`` (the negated exponents made outside the timed
    call) as yardstick, beside the empty kernel on its grid."""
    from repro_torch.kernels.kv_dequant import kv_dequant_rows
    from repro_torch.kernels.kv_dequant.ref import kv_dequant_ref

    def make():
        q = torch.randint(-128, 128, (R, hd), generator=g, device=dev,
                          dtype=torch.int8)
        f = torch.randint(-3, 12, (R,), generator=g, device=dev,
                          dtype=torch.int8)
        return q, f

    sets = [make() for _ in range(n_copies(5 * R * hd))]
    q, f = sets[0]
    out = kv_dequant_rows(q, f)
    ref = kv_dequant_ref(q, f)
    check(torch.equal(out, ref) and torch.equal(kv_dequant_rows(q, f), out),
          f"kv_dequant_rows R{R} hd{hd}: not bit-exact or not repeatable")
    lib_sets = [(q, (-f)[:, None]) for q, f in sets]
    nbytes = 5 * R * hd + R
    b_ms, b_by = bound(nbytes, 0.0)
    blocks, threads, vecs = dequant_grid(R, hd)
    return {"shape": f"R{R} hd{hd}", "max_abs_err": 0.0,
            "ms": time_ms(kv_dequant_rows, sets, DEQUANT_CALLS),
            "launch_floor_ms": launch_floor_ms(R, hd, dev),
            "grid": {"blocks": blocks, "threads": threads,
                     "pieces_a_lane": vecs},
            "plain_ms": plain_ms(kv_dequant_ref, sets),
            "library_ms": plain_ms(torch.ldexp, lib_sets),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": 0.0}


# kv_dequant_rows' edges: (R, hd, byte offset of q into its buffer, f over
# the whole int8 range with -128 mantissas): any hd (one value at a time off
# multiples of 16), rows off a 16-byte boundary, R ragged against a thread's
# pieces and a block, products that overflow to -inf (the card-only tests of
# tests/test_torch_package.py hold the same)
DEQUANT_EDGES = ((393217, 64, 0, False), (1, 64, 0, False), (3, 16, 0, False),
                 (1001, 48, 0, False), (257, 80, 0, False),
                 (33, 256, 0, False), (7, 17, 0, False), (999, 64, 1, False),
                 (64, 64, 15, False), (256, 64, 0, True), (129, 16, 0, True))


def _dequant_edge_checks(dev, g):
    from repro_torch.kernels.kv_dequant import kv_dequant_rows
    from repro_torch.kernels.kv_dequant.ref import kv_dequant_ref
    for R, hd, off, extreme in DEQUANT_EDGES:
        buf = torch.randint(-128, 128, (R * hd + off,), generator=g,
                            device=dev, dtype=torch.int8)
        q = buf[off:].view(R, hd)
        if extreme:
            f = (torch.arange(R, device=dev) % 256 - 128).to(torch.int8)
            q[::2] = -128
        else:
            f = torch.randint(-3, 12, (R,), generator=g, device=dev,
                              dtype=torch.int8)
        out = kv_dequant_rows(q, f)
        check(_same_bits(out, kv_dequant_ref(q, f))
              and _same_bits(out, kv_dequant_rows(q, f)),
              f"kv_dequant_rows R{R} hd{hd} offset {off} extreme {extreme}: "
              f"not bit-exact or not repeatable")


def kv_quantize_case(R, hd, bits, dev, g):
    """Kernel vs plain, bit-exact, on rows that include zero rows and
    products that land exactly on .5 (they pin half-to-even)."""
    from repro_torch.kernels.kv_dequant import kv_quantize_rows
    from repro_torch.kernels.kv_dequant.ref import kv_quantize_ref

    def make():
        x = torch.randn((R, hd), generator=g, device=dev) * 3.0
        x[0] = 0.0
        # row 1: amax 127/64 (f = 6 at 8 bits), entries k/128 give x*2^f
        # exactly on k/2
        x[1] = torch.arange(hd, device=dev, dtype=torch.float32) / 128.0
        x[1, 0] = 127.0 / 64.0
        return (x, bits)

    sets = [make() for _ in range(n_copies(R * hd * 4))]
    x = sets[0][0]
    q, f = kv_quantize_rows(x, bits)
    qr, fr = kv_quantize_ref(x, bits)
    check(torch.equal(q, qr) and torch.equal(f, fr),
          f"kv_quantize_rows R{R} bits{bits}: not bit-exact")
    nbytes = R * hd * 4 + R * hd + R
    b_ms, b_by = bound(nbytes, 0.0)
    return {"shape": f"R{R} hd{hd} bits{bits}", "max_abs_err": 0.0,
            "ms": time_ms(kv_quantize_rows, sets),
            "plain_ms": plain_ms(kv_quantize_ref, sets),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": 0.0}


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def kv_store_case(key, window, dev, g, off=0, xoff=0, timed=True):
    """The fused store ``kv_quantize_store`` against its plain version on
    one ring, keyed as the wrapper keys its tallies (B, S, KV, hd, W, hdm,
    bits, dtype): the four ring buffers bit for bit (the slots the chunk
    does not reach keep their bytes), two launches the same.  The k/v rows
    lie ``xoff`` elements and the ring views ``off`` bytes into their
    buffers; a windowed ring keeps a chunk's newest W rows and drops the
    rest (slot W), an unwindowed one takes the positions."""
    from repro_torch.kernels.kv_dequant import kv_quantize_store
    from repro_torch.kernels.kv_dequant.ref import kv_quantize_store_ref
    B, S, KV, hd, W, hdm, bits, dt = key
    dtype = _DTYPES[dt]
    n = B * S * KV * hd

    def make():
        rows = (torch.randn(2 * n + 4, generator=g, device=dev) * 3
                ).to(dtype)
        kh = rows[xoff:xoff + n].view(B, S, KV, hd)
        vh = rows[n + xoff:2 * n + xoff].view(B, S, KV, hd)
        cp = torch.randint(0, 3 * W if window else W - S + 1, (B,),
                           generator=g, device=dev)
        qpos = cp[:, None] + torch.arange(S, device=dev)
        if window:
            last = cp + S - 1
            slot = torch.where(qpos > last[:, None] - W, qpos % W,
                               torch.full_like(qpos, W))
        else:
            slot = qpos

        def ring(shape):
            m = math.prod(shape)
            buf = torch.randint(-128, 128, (m + 16,), generator=g,
                                device=dev, dtype=torch.int8)
            return buf[off:off + m].view(shape)

        return (kh, vh, slot, ring((B, W, KV, hdm)), ring((B, W, KV, hdm)),
                ring((B, W, KV)), ring((B, W, KV)), bits)

    item = torch.finfo(dtype).bits // 8
    nbytes = 2 * n * item + 2 * B * W * KV * (hdm + 1)
    sets = [make() for _ in range(n_copies(nbytes) if timed else 1)]
    args = sets[0]
    want = [b.clone() for b in args[3:7]]
    kv_quantize_store_ref(*args[:3], *want, bits)
    kv_quantize_store(*args)
    shape = (f"B{B} S{S} KV{KV} hd{hd} W{W} {'nibble' if hdm != hd else 'int8'}"
             f" bits{bits} {dt}{' windowed' if window else ''}"
             f"{f' rows+{xoff}' if xoff else ''}{f' ring+{off}B' if off else ''}")
    check(all(torch.equal(a, b) for a, b in zip(args[3:7], want)),
          f"kv_quantize_store {shape}: not bit-exact against the plain "
          f"version")
    kv_quantize_store(*args)
    check(all(torch.equal(a, b) for a, b in zip(args[3:7], want)),
          f"kv_quantize_store {shape}: not repeatable")
    kept = int((args[2] < W).sum())
    dropped = B * S - kept
    # rows read once, the slots read, the kept rows' mantissas and exponents
    # written
    nbytes = 2 * n * item + B * S * 8 + 2 * kept * KV * (hdm + 1)
    b_ms, b_by = bound(nbytes, 0.0)
    case = {"shape": shape, "max_abs_err": 0.0, "dropped_rows": dropped,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": 0.0}
    if timed:
        case["ms"] = time_ms(kv_quantize_store, sets)
        case["plain_ms"] = plain_ms(kv_quantize_store_ref, sets)
    return case


# the fused store at serving's shapes (a decode tick of 8 slots and a
# prefill chunk of 16, qwen2-0.5b's 2 and granite's 8 kv heads of 64, the
# 1024-slot ring; int8 and nibble rings), timed; then checks only: a windowed ring, a
# chunk longer than its ring (rows dropped), bfloat16 rows, and views 1-15
# bytes into their buffers
STORE_TIMED = [(B, S, KV, 64, 1024, hdm, bits, "float32")
               for KV in (2, 8)            # qwen2-0.5b's, granite's kv heads
               for B, S in ((8, 1), (1, 16))
               for hdm, bits in ((64, 8), (32, 4))]
# recurrentgemma-2b's: one kv head of 256, its 2064-slot ring, windowed (the
# slots wrap), int8 and nibble
GRIFFIN_STORE = [(B, S, 1, 256, 2064, hdm, bits, "float32")
                 for B, S in ((8, 1), (1, 16))
                 for hdm, bits in ((256, 8), (128, 4))]
# whisper-large-v3's: a decode tick's store into the 448-slot self ring (8
# slots, 20 kv heads), and one 250-frame chunk's cross rows of all 32
# decoder layers in one launch (the [L * 1, 1500, 20, hdm] view of a slot's
# memory), int8 and nibble, timed; the chunk's power-of-two tails checked
WHISPER_STORE = [(B, S, 20, 64, W, hdm, bits, "float32")
                 for B, S, W in ((8, 1, 448), (32, 250, 1500))
                 for hdm, bits in ((64, 8), (32, 4))]
WHISPER_STORE_TAILS = [((32, S, 20, 64, 1500, hdm, bits, "float32"), False,
                        0, 0) for S in (32, 1) for hdm, bits in ((64, 8),
                                                                 (32, 4))]
STORE_CHECKS = ([((4, 1, 2, 64, 64, 64, 8, "float32"), True, 0, 0),
                 ((2, 16, 2, 64, 8, 64, 8, "float32"), True, 0, 0),
                 ((2, 16, 2, 64, 8, 32, 4, "float32"), True, 0, 0),
                 ((8, 1, 2, 64, 1024, 64, 8, "bfloat16"), False, 0, 0),
                 ((2, 16, 2, 64, 64, 32, 4, "bfloat16"), True, 0, 0)]
                + [((2, 3, 2, 64, 32, 32 if off % 2 else 64,
                     4 if off % 2 else 8, "float32"), True, off, off % 4)
                   for off in range(1, 16)])


def kv_store_checks(dev, g):
    for key, window, off, xoff in STORE_CHECKS + WHISPER_STORE_TAILS:
        c = kv_store_case(key, window, dev, g, off=off, xoff=xoff,
                          timed=False)
        print(f"[kernels] kv_quantize_store {c['shape']}: bit-exact "
              f"({c['dropped_rows']} rows dropped)", flush=True)


def _attention_inputs(B, S, H, KV, hd, W, nibble, dev, g, ragged=False,
                      wrapped=False):
    from repro_torch.kernels.kv_dequant import kv_pack
    qmax = 7 if nibble else 127
    qh = torch.randn((B, S, H, hd), generator=g, device=dev)
    km = torch.randint(-qmax, qmax + 1, (B, W, KV, hd), generator=g,
                       device=dev, dtype=torch.int8)
    vm = torch.randint(-qmax, qmax + 1, (B, W, KV, hd), generator=g,
                       device=dev, dtype=torch.int8)
    lo = 0 if nibble else 4
    kf = torch.randint(lo, lo + 4, (B, W, KV), generator=g, device=dev,
                       dtype=torch.int8)
    vf = torch.randint(lo, lo + 4, (B, W, KV), generator=g, device=dev,
                       dtype=torch.int8)
    if nibble:
        km, vm = kv_pack(km), kv_pack(vm)
    if ragged:
        # per-row fill levels, some slots never written
        last = torch.randint(S, W, (B,), generator=g, device=dev)
        qpos = last[:, None] - S + 1 + torch.arange(S, device=dev)
        tpos = torch.arange(W, device=dev).expand(B, W).clone()
        tpos[tpos > last[:, None]] = -1
    elif wrapped:
        # a ring that has wrapped twice: slot s holds position last - ((last
        # - s) % W), the queries the newest S positions
        last = 3 * W + 5
        qpos = (last - S + 1 + torch.arange(S, device=dev)).expand(B, S)
        spos = torch.arange(W, device=dev)
        tpos = (last - torch.remainder(last - spos, W)).expand(B, W)
    else:
        # a full ring: every slot visible to every query row
        qpos = (W - S + torch.arange(S, device=dev)).expand(B, S)
        tpos = torch.arange(W, device=dev).expand(B, W)
    return (qh, km, kf, vm, vf, qpos.to(torch.int32).contiguous(),
            tpos.to(torch.int32))


def _attention_check(out, ref, vmax, pf, what):
    """No probs grid: within 1e-5.  With one: at most 1% of outputs, or
    the outputs of one head row, may differ by more, each by at most one
    probs step times (max|v| + |o|) -- a one-ulp exp can move one
    probability across a grid point, which moves its head row's outputs
    by step * (v - o) / l, l >= 1: on a shape of fewer than 100 head rows
    one such flip is more than 1% of the outputs."""
    err = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), f"{what}: not finite")
    if pf is None:
        check(bool((err <= 1e-5).all()),
              f"{what}: max err {float(err.max())} > 1e-5")
        return float(err.max())
    step = 2.0 ** -math.floor(pf + 0.5)
    off = err > 1e-5
    frac = float(off.float().mean())
    rows = int(off.reshape(-1, off.shape[-1]).any(dim=-1).sum())
    check(frac <= 0.01 or rows <= 1,
          f"{what}: {frac:.4f} of outputs, in {rows} head rows, off by "
          f"more than 1e-5")
    lim = step * (vmax + ref.abs()) + 1e-5
    check(bool((err <= lim).all()),
          f"{what}: max err {float(err.max())} beyond one probs step")
    return float(err.max())


def kv_attention_case(B, S, W, nibble, pf, dev, g, H=14, KV=2, hd=64,
                      yardsticks=True, window=None):
    """Kernel vs plain (and a ragged, windowed, partly empty ring for
    correctness only) vs SDPA over the dequantized cache as yardstick.
    Without ``yardsticks`` only the kernel is timed.  With ``window`` the
    timed ring has wrapped and the queries see its newest ``window``
    positions (serving's local attention)."""
    from repro_torch.kernels.kv_dequant import kv_attention_rows, kv_unpack
    from repro_torch.kernels.kv_dequant.ref import (attention_mask,
                                                    kv_attention_ref,
                                                    kv_dequant_ref)
    pft = torch.tensor([pf], dtype=torch.float32, device=dev)
    hdm = hd // 2 if nibble else hd
    what = (f"kv_attention_rows B{B} S{S} W{W} hd{hd} "
            f"{'nibble' if nibble else 'int8'}")

    def kern(qh, km, kf, vm, vf, qpos, tpos, window=None):
        return kv_attention_rows(qh, km, kf, vm, vf, qpos, tpos,
                                 window=window, n_kv=KV, probs_f=pft)

    def plain(qh, km, kf, vm, vf, qpos, tpos, window=None):
        qg = qh.reshape(B, S, KV, H // KV, hd)
        return kv_attention_ref(qg, km, kf, vm, vf, qpos, tpos,
                                window=window, probs_f=pft).reshape(qh.shape)

    def vmax_of(vm, vf):
        v = kv_dequant_ref(kv_unpack(vm, hd) if nibble else vm, vf)
        return float(v.abs().max())

    for rw in (None, 8):
        args = _attention_inputs(B, S, H, KV, hd, W, nibble, dev, g,
                                 ragged=True)
        _attention_check(kern(*args, window=rw), plain(*args, window=rw),
                         vmax_of(args[3], args[4]), pf,
                         f"{what} ragged window={rw}")
    cache_bytes = 2 * B * W * KV * hdm + 2 * B * W * KV
    sets = [_attention_inputs(B, S, H, KV, hd, W, nibble, dev, g,
                              wrapped=window is not None)
            for _ in range(n_copies(cache_bytes))]
    args = sets[0]
    out = kern(*args, window=window)
    err = _attention_check(out, plain(*args, window=window),
                           vmax_of(args[3], args[4]), pf, what)
    check(torch.equal(kern(*args, window=window), out),
          f"{what}: two launches differ")
    # a request's rows have the same bits alone as in the batch
    for b in sorted({0, B - 1}):
        one = [a[b:b + 1] for a in args]
        one[0], one[5] = one[0].contiguous(), one[5].contiguous()
        check(torch.equal(kern(*one, window=window), out[b:b + 1]),
              f"{what}: batch row {b} differs alone")
    shape = (f"B{B} S{S} H{H} KV{KV} hd{hd} W{W} "
             f"{'nibble' if nibble else 'int8'} probs_f{pf}"
             f"{f' window{window}' if window else ''}")
    if window is not None:
        sets = [a + (window,) for a in sets]
    if not yardsticks:
        return {"shape": shape, "max_abs_err": err, "ms": time_ms(kern, sets)}

    # yardstick: SDPA over the dequantized cache (dequantized outside the
    # timed call), heads grouped as the port groups them
    def sdpa_args(qh, km, kf, vm, vf, qpos, tpos, window=None):
        G = H // KV
        k = kv_dequant_ref(kv_unpack(km, hd) if nibble else km, kf)
        v = kv_dequant_ref(kv_unpack(vm, hd) if nibble else vm, vf)
        k = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
        v = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
        mask = attention_mask(qpos, tpos, window)[:, None]
        return (qh.permute(0, 2, 1, 3).contiguous(), k, v, mask)

    lib_sets = [sdpa_args(*a) for a in sets[:max(1, len(sets) // 4)]]
    nbytes = (2 * B * S * H * hd * 4 + cache_bytes + B * S * 4 + B * W * 4)
    flops = 4.0 * B * S * H * W * hd
    b_ms, b_by = bound(nbytes, flops)
    return {"shape": shape, "max_abs_err": err,
            "ms": time_ms(kern, sets),
            "plain_ms": plain_ms(plain, sets),
            "library_ms": plain_ms(
                lambda q, k, v, m: torch.nn.functional
                .scaled_dot_product_attention(q, k, v, attn_mask=m),
                lib_sets),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}


# Rings longer than the serving slice's 1024 slots, held to the plain
# version in the kernel phase (not on the main path, not in the kernels
# line): (B, S, W, hd).  B = 8, S = 1 runs RT = 8 query rows a block, B =
# 2, S = 16 RT = 16; W = 1500 leaves the last block of a cluster ragged;
# W = 2048 gives a block two staging rounds; W = 16384 at RT = 16 and W =
# 32768 at RT = 8 (qwen2-0.5b's published context) do not fit a block's
# scores in shared memory, so pass 2 recomputes them; hd = 40 stages rows
# without 16-byte loads.
LONG_RINGS = ((8, 1, 1500, 64), (2, 16, 1500, 64), (8, 1, 2048, 64),
              (2, 16, 2048, 64), (8, 1, 16384, 64), (2, 16, 16384, 64),
              (8, 1, 32768, 64), (8, 1, 1500, 40), (2, 16, 1500, 40))


# The same at recurrentgemma-2b's head dim 256 (10 heads over 1 kv head, the
# SPLIT = 2 instance): (B, S, W, window).  W = 2064 a tick and a prefill chunk
# on a wrapped ring whose window (2048) masks its oldest slots; W = 4100 gives
# a block five staging rounds with its scores kept; W = 16384 at S = 16 and W =
# 32768 at a tick recompute them in pass 2.
GRIFFIN_LONG_RINGS = ((8, 1, 2064, 2048), (1, 16, 4100, 2048),
                      (1, 16, 16384, None), (8, 1, 32768, None))


def long_ring_checks(dev, g):
    rings = [(B, S, W, hd, 14, 2, None) for B, S, W, hd in LONG_RINGS] + [
        (B, S, W, GRIFFIN["hd"], GRIFFIN["H"], GRIFFIN["KV"], window)
        for B, S, W, window in GRIFFIN_LONG_RINGS]
    for B, S, W, hd, H, KV, window in rings:
        for nibble in (False, True):
            c = kv_attention_case(B, S, W, nibble, 6.0, dev, g, H=H, KV=KV,
                                  hd=hd, yardsticks=False, window=window)
            print(f"[kernels] kv_attention_rows {c['shape']}: max err "
                  f"{c['max_abs_err']:.3g}, {c['ms']:.4f} ms", flush=True)


def unaligned_attention_checks(dev, g):
    """``kv_attention_rows`` at hd 256 on rings read without 16-byte loads:
    the mantissa and exponent views 5 bytes into their buffers, and rows
    padded to hdm + 1 bytes (strides off 16): the plain version's result,
    and the bits of the same ring aligned."""
    from repro_torch.kernels.kv_dequant import kv_attention_rows, kv_unpack
    from repro_torch.kernels.kv_dequant.ref import (kv_attention_ref,
                                                    kv_dequant_ref)
    B, S, H, KV, hd, W = 2, 16, GRIFFIN["H"], GRIFFIN["KV"], GRIFFIN["hd"], 300
    pft = torch.tensor([6.0], dtype=torch.float32, device=dev)
    for nibble in (False, True):
        qh, km, kf, vm, vf, qpos, tpos = _attention_inputs(
            B, S, H, KV, hd, W, nibble, dev, g, wrapped=True)

        def kern(km, kf, vm, vf):
            return kv_attention_rows(qh, km, kf, vm, vf, qpos, tpos,
                                     window=256, n_kv=KV, probs_f=pft)

        want = kern(km, kf, vm, vf)
        ref = kv_attention_ref(qh.reshape(B, S, KV, H // KV, hd), km, kf, vm,
                               vf, qpos, tpos, window=256, probs_f=pft
                               ).reshape(qh.shape)
        vmax = float(kv_dequant_ref(kv_unpack(vm, hd) if nibble else vm,
                                    vf).abs().max())
        _attention_check(want, ref, vmax, 6.0,
                         f"kv_attention_rows hd{hd} aligned")

        def offset(t, off=5):
            buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=dev)
            v = buf[off:off + t.numel()].view(t.shape)
            v.copy_(t)
            return v

        def padded(t):
            buf = torch.zeros(t.shape[:-1] + (t.shape[-1] + 1,),
                              dtype=t.dtype, device=dev)
            v = buf[..., :t.shape[-1]]
            v.copy_(t)
            return v

        for how, ring in (("views +5 B", offset), ("rows padded 1 B",
                                                   padded)):
            got = kern(ring(km), ring(kf), ring(vm), ring(vf))
            check(torch.equal(got, want),
                  f"kv_attention_rows hd{hd} {'nibble' if nibble else 'int8'}"
                  f" {how}: not the aligned ring's bits")
            print(f"[kernels] kv_attention_rows hd{hd} "
                  f"{'nibble' if nibble else 'int8'} {how}: the aligned "
                  f"ring's bits", flush=True)


def empty_rows_attention_checks(dev, g):
    """``kv_attention_rows`` as Whisper's cross read sees it in a mixed
    tick (20 heads over 20 kv heads, the 1500-slot memory, every query row
    at position W): rows 0-3 see no slot (every ``tpos`` -1, LM traffic's
    ``mem_len`` 0) and must read exact zeros, rows 4-7 are filled to 1,
    2, 750 and 1500 slots; int8 and nibble, a tick (S 1) and a prompt
    chunk (S 16), against the plain version."""
    from repro_torch.kernels.kv_dequant import kv_attention_rows, kv_unpack
    from repro_torch.kernels.kv_dequant.ref import (kv_attention_ref,
                                                    kv_dequant_ref)
    H = KV = WHISPER["KV"]
    hd, W = WHISPER["hd"], WHISPER["T"]
    pft = torch.tensor([6.0], dtype=torch.float32, device=dev)
    fill = torch.tensor([0, 0, 0, 0, 1, 2, 750, W], device=dev)
    for S in (1, 16):
        for nibble in (False, True):
            qh, km, kf, vm, vf, _, _ = _attention_inputs(
                8, S, H, KV, hd, W, nibble, dev, g)
            ar = torch.arange(W, device=dev)
            tpos = torch.where(ar[None] < fill[:, None], ar[None],
                               torch.full_like(ar[None], -1)).to(torch.int32)
            qpos = torch.full((8, S), W, dtype=torch.int32, device=dev)
            out = kv_attention_rows(qh, km, kf, vm, vf, qpos, tpos,
                                    window=None, n_kv=KV, probs_f=pft)
            ref = kv_attention_ref(qh.reshape(8, S, KV, 1, hd), km, kf, vm,
                                   vf, qpos, tpos, window=None, probs_f=pft
                                   ).reshape(qh.shape)
            what = (f"kv_attention_rows S{S} W{W} H{H} KV{KV} "
                    f"{'nibble' if nibble else 'int8'}, rows that see no slot")
            vmax = float(kv_dequant_ref(kv_unpack(vm, hd) if nibble else vm,
                                        vf).abs().max())
            err = _attention_check(out, ref, vmax, 6.0, what)
            check(torch.equal(out[:4], torch.zeros_like(out[:4])),
                  f"{what}: rows 0-3 are not exact zeros")
            check(bool((out[4:] != 0).any(dim=-1).all()),
                  f"{what}: a filled row reads zero")
            print(f"[kernels] {what}: exact zeros, the filled rows within "
                  f"{err:.3g} of the plain version", flush=True)


# the quantizer's shapes: the training slice's own (the jet tagger's input
# quantizer per channel, weights and biases per parameter, outputs per
# tensor, batch 1024), a qwen2-0.5b layer (the MLP weight per channel, a
# prefill's activations per tensor) in float32 and bfloat16, and the MLP
# weight per parameter
HGQ_SHAPES = (
    [((1024, 16), (16,), torch.float32)]
    + [(s, s, torch.float32) for s in ((16, 64), (64, 32), (32, 32), (32, 5),
                                       (64,), (32,), (5,))]
    + [((1024, 64), (), torch.float32), ((1024, 32), (), torch.float32)]
    + [(s, f, dt) for dt in (torch.float32, torch.bfloat16)
       for s, f in (((896, 4864), (1, 4864)), ((8192, 896), ()))]
    + [((896, 4864), (896, 4864), torch.float32)])
# edge shapes of the backward's cluster geometry (csrc/hgq_quantize.cu,
# ``hgq_quantize.ops.bwd_plan``): rows not a multiple of a block's rows, a
# single row, columns not a multiple of 32 (and of a 16-byte vector: values
# loaded one by one), bfloat16 at the training shapes, and one shape of each
# reduction just past the one-cluster line (a second pass)
HGQ_EDGE = (
    [((1001, 16), (16,), torch.float32), ((1, 16), (16,), torch.float32),
     ((1, 64), (), torch.float32), ((1024, 33), (33,), torch.float32),
     ((1001, 33), (), torch.float32), ((300, 5), (5,), torch.bfloat16),
     ((1024, 16), (16,), torch.bfloat16), ((1024, 64), (), torch.bfloat16),
     ((2049, 16), (16,), torch.float32), ((256, 257), (), torch.float32)]
    # the per-expert layouts (an MoE layer's expert stacks [E, K, N], f per
    # expert), each expert's rows a group of its own: E = 1 (per expert
    # tensor: E = 1 per expert channel is per channel), K = 1 (per expert
    # tensor: K = 1 per expert channel is per parameter), K not a multiple
    # of a block's rows, N not a multiple of 32 (nor of a vector: values one
    # by one), bfloat16 (a group not whole vectors), and one shape of each
    # reduction just past the one-cluster line (2049 rows, 65792 elements an
    # expert: each expert's clusters and second pass)
    + [((1, 48, 16), (1, 1, 1), torch.float32),
       ((40, 1, 512), (40, 1, 1), torch.float32),
       ((3, 1001, 16), (3, 1, 16), torch.float32),
       ((4, 300, 33), (4, 1, 33), torch.float32),
       ((6, 300, 40), (6, 1, 40), torch.bfloat16),
       ((5, 37, 33), (5, 1, 1), torch.bfloat16),
       ((3, 2049, 16), (3, 1, 16), torch.float32),
       ((3, 257, 256), (3, 1, 1), torch.float32)])


# the paper's SVHN (Table II, batch 128) and muon (Table III, batch 1024)
# models: their weights and biases per parameter (the members of each model's
# grouped forward, in order; conv kernels 4-D, HWIO) and their activations per
# tensor (the SVHN input and first conv output, 1.84 M values, take the
# backward's clusters, scratch and second pass)
SVHN_GROUP = [(s, s, torch.float32) for s in
              ((3, 3, 3, 16), (16,), (3, 3, 16, 16), (16,), (3, 3, 16, 24),
               (24,), (96, 42), (42,), (42, 64), (64,), (64, 10), (10,))]
MUON_GROUP = [(s, s, torch.float32) for s in
              ((150, 32), (32,), (150, 32), (32,), (150, 32), (32,),
               (96, 64), (64,), (64, 32), (32,), (32, 1), (1,))]
PAPER_ACTS = {"svhn": [(128, 32, 32, 3), (128, 30, 30, 16), (128, 13, 13, 16),
                       (128, 4, 4, 24), (128, 42), (128, 64)],
              "muon": [(1024, 3, 150), (1024, 32), (1024, 32), (1024, 32),
                       (1024, 64), (1024, 32)]}
PAPER_SHAPES = [m for m in dict.fromkeys(
    [(s, (), torch.float32) for acts in PAPER_ACTS.values() for s in acts]
    + SVHN_GROUP + MUON_GROUP) if m not in HGQ_SHAPES]


# qwen2-0.5b at its published width (configs/qwen2_0_5b.py FULL) and the
# LM training cell's batch: the model's dimensions, checked against the
# config where the cell runs
QWEN = dict(L=24, d=896, H=14, KV=2, hd=64, ff=4864, V=151936, chunk=1024)
# granite-moe-3b-a800m at its published width (configs FULL): 40 experts of
# d_ff 512, top 8, an untied 49155-token head
GRANITE = dict(L=32, d=1536, H=24, KV=8, hd=64, ff=512, E=40, k=8, V=49155)
# recurrentgemma-2b (configs/recurrentgemma_2b.py FULL) and its serving ring:
# max_len 4096 gives W = window + the prefill chunk = 2064 slots
GRIFFIN = dict(L=26, units=8, rem=2, d=2560, H=10, KV=1, hd=256, ff=7680,
               V=256000, window=2048, W=2064)
RWKV = dict(L=24, d=2048, ff=7168, V=65536, norm="ln")
# whisper-large-v3 (configs/whisper_large_v3.py FULL): 32 encoder and 32
# decoder layers, full MHA of 20 heads of 64, a 1500-frame encoder memory;
# its serving ring is the decoder's published context of 448 tokens, its
# audio chunk 250 frames (5 s at 20 ms a frame)
WHISPER = dict(L=32, enc=32, d=1280, H=20, KV=20, hd=64, ff=5120, V=51866,
               T=1500, W=448, chunk=250)
# llama3.2-3b (configs/llama3_2_3b.py FULL; hf:meta-llama, Llama 3.2): 28
# layers, d 3072, 24 heads and 8 kv heads of 128, d_ff 8192, vocab 128256,
# the head tied to the table; served from examples/specs/serving_packed.json
LLAMA = dict(L=28, d=3072, H=24, KV=8, hd=128, ff=8192, V=128256)
LM_BATCH, LM_SEQ = 2, 2048
# the launcher's run of examples/specs/host_1x1.json at full width
API_TRAIN_SEQ = 256
# granite's training cell: batch 2, seq 1024 (one chunk pair a layer),
# C = 256 slots an expert a row
GRANITE_BATCH, GRANITE_SEQ = 2, 1024


def _lm_layer_members(Q=QWEN):
    """One layer's weights and biases in the order of its grouped forward
    (``models.lm._layer_weights``): q, k, v kernels per channel with their
    biases per parameter, o, gate, up, down: (layout, shape) each."""
    d, qd, kvd, ff = Q["d"], Q["H"] * Q["hd"], Q["KV"] * Q["hd"], Q["ff"]
    return [("per_channel", (d, qd)), ("per_parameter", (qd,)),
            ("per_channel", (d, kvd)), ("per_parameter", (kvd,)),
            ("per_channel", (d, kvd)), ("per_parameter", (kvd,)),
            ("per_channel", (qd, d)), ("per_channel", (d, ff)),
            ("per_channel", (d, ff)), ("per_channel", (ff, d))]


def _lm_layer_acts(B, S, chunk, Q=QWEN):
    """One layer's activation quantizers, all per tensor, in launch order:
    ln1, q, k, v, the probabilities of each (query chunk, key chunk) pair
    [B, KV, G, cq, ck], the attention output, ln2, gate, up."""
    c = min(chunk, S)
    pairs = (-(-S // c)) ** 2
    G = Q["H"] // Q["KV"]
    return ([(B, S, Q["d"]), (B, S, Q["H"] * Q["hd"]),
             (B, S, Q["KV"] * Q["hd"]), (B, S, Q["KV"] * Q["hd"])]
            + [(B, Q["KV"], G, c, c)] * pairs
            + [(B, S, Q["H"] * Q["hd"]), (B, S, Q["d"]), (B, S, Q["ff"]),
               (B, S, Q["ff"])])


def _granite_layer_members(G=None):
    """One granite layer's weights in the order of its grouped forward
    (``models.lm._layer_weights``): the q, k, v, o kernels and the router
    per channel, the gate, up and down stacks per expert channel: (shape,
    f shape) each."""
    G = G or GRANITE
    d, kvd, E, ff = G["d"], G["KV"] * G["hd"], G["E"], G["ff"]
    return [((d, d), (1, d)), ((d, kvd), (1, kvd)), ((d, kvd), (1, kvd)),
            ((d, d), (1, d)), ((d, E), (1, E)), ((E, d, ff), (E, 1, ff)),
            ((E, d, ff), (E, 1, ff)), ((E, ff, d), (E, 1, d))]


def _granite_layer_acts(B, S, G=None):
    """One granite layer's activation quantizers, all per tensor: the
    dense layer's up to the second norm (one chunk pair at S <= 1024),
    then the expert hidden activation [E, B C, d_ff], empty slots
    included."""
    G = G or GRANITE
    C = max(1, math.ceil(S * G["k"] / G["E"] * 1.25))
    return _lm_layer_acts(B, S, 1024, G)[:-2] + [(G["E"], B * C, G["ff"])]


# the LM step's quantizer shapes: the tied 151936 x 896 table per channel
# (the embedding and the head, 136 M values, the backward's clusters and
# second pass over 151936 rows a column), the activations per tensor (a
# [2, 2, 7, 1024, 1024] chunk pair of probabilities, 29.4 M values), one
# layer's 10 weights and biases in one grouped forward
LM_TABLE = ((QWEN["V"], QWEN["d"]), (1, QWEN["d"]), torch.float32)
LM_GROUP = [(s, (1, s[-1]) if lay == "per_channel" else s, torch.float32)
            for lay, s in _lm_layer_members()]
LM_SHAPES = [m for m in dict.fromkeys(
    [LM_TABLE]
    + [(s, (), torch.float32) for s in _lm_layer_acts(LM_BATCH, LM_SEQ,
                                                      QWEN["chunk"])]
    + LM_GROUP) if m not in HGQ_SHAPES]
# granite's step: the untied 49155 x 1536 table and 1536 x 49155 head per
# channel, the activations per tensor (a [2, 8, 3, 1024, 1024] chunk pair
# of probabilities, the [40, 512, 512] expert hidden activation), one
# layer's 8 weights in one grouped forward: the expert stacks [40, 1536,
# 512] and [40, 512, 1536] per expert channel (126 MB each); beside them
# the stack per expert tensor
# the launcher's step (batch 2, seq 256, one chunk pair a layer): its
# activations per tensor, the table and the layer group as the LM step's
API_LM_SHAPES = [m for m in dict.fromkeys(
    (s, (), torch.float32) for s in _lm_layer_acts(LM_BATCH, API_TRAIN_SEQ,
                                                   QWEN["chunk"]))
    if m not in HGQ_SHAPES + LM_SHAPES]
GRANITE_TABLE = ((GRANITE["V"], GRANITE["d"]), (1, GRANITE["d"]),
                 torch.float32)
GRANITE_HEAD = ((GRANITE["d"], GRANITE["V"]), (1, GRANITE["V"]),
                torch.float32)
GRANITE_GROUP = [(s, f, torch.float32) for s, f in _granite_layer_members()]
GRANITE_SHAPES = [m for m in dict.fromkeys(
    [GRANITE_TABLE, GRANITE_HEAD]
    + [(s, (), torch.float32) for s in _granite_layer_acts(GRANITE_BATCH,
                                                           GRANITE_SEQ)]
    + GRANITE_GROUP
    + [((GRANITE["E"], GRANITE["d"], GRANITE["ff"]), (GRANITE["E"], 1, 1),
        torch.float32)])
    if m not in HGQ_SHAPES + LM_SHAPES + API_LM_SHAPES]


def _bits_of(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def hgq_quantize_case(shape, fshape, dtype, dev, g):
    """Forward and backward kernels vs their plain versions on one shape:
    the forward bit for bit; df bit for bit per parameter, and for the
    per-channel and per-tensor sums within 1e-5 of the sum of |terms| (a
    float32 sum taken in another order); two launches give the same bits.
    Some x sit exactly on rounding ties (k + 1/2) * 2^-fi.  Per expert,
    each expert's output and df are also the bits of its own per-channel
    or per-tensor launch on that expert alone (the same plan a group)."""
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_bwd,
                                                  hgq_quantize_fwd,
                                                  hgq_quantize_grad_ref,
                                                  hgq_quantize_ref, layout_of)
    from repro_torch.kernels.hgq_quantize.ref import LN2
    lay = layout_of(shape, fshape)
    n = math.prod(shape)
    fn = math.prod(fshape)
    item = torch.finfo(dtype).bits // 8
    what = f"hgq_quantize {lay} {tuple(shape)} {str(dtype)[6:]}"

    def make():
        x = torch.randn(shape, generator=g, device=dev) * 4
        f = torch.rand(fshape, generator=g, device=dev) * 8 - 1
        fi = torch.floor(torch.broadcast_to(f, shape) + 0.5).reshape(-1)
        ties = min(n, 256)
        k = torch.arange(ties, device=dev, dtype=torch.float32) - ties // 2
        x.view(-1)[:ties] = (k + 0.5) * torch.pow(2.0, -fi[:ties])
        gy = torch.randn(shape, generator=g, device=dev)
        return x.to(dtype), f, gy.to(dtype)

    fwd_bytes = 2 * n * item + fn * 4
    bwd_bytes = 2 * n * item + 2 * fn * 4
    sets = [make() for _ in range(n_copies(bwd_bytes))]
    x, f, gy = sets[0]
    out = hgq_quantize_fwd(x, f)
    ref = hgq_quantize_ref(x, f)
    check(torch.equal(_bits_of(out), _bits_of(ref)),
          f"{what}: forward not bit-exact")
    check(torch.equal(_bits_of(out), _bits_of(hgq_quantize_fwd(x, f))),
          f"{what}: forward not repeatable")
    df = hgq_quantize_bwd(gy, x, f)
    dref = hgq_quantize_grad_ref(gy, x, f)
    check(torch.equal(_bits_of(df), _bits_of(hgq_quantize_bwd(gy, x, f))),
          f"{what}: backward not repeatable")
    err = float((df - dref).abs().max())
    if lay == "per_parameter":
        check(torch.equal(_bits_of(df), _bits_of(dref)),
              f"{what}: df not bit-exact")
    else:
        terms = (gy.float() * LN2 * (x.float() - ref.float())).abs()
        lim = 1e-5 * terms.sum_to_size(fshape)
        check(bool(((df - dref).abs() <= lim).all()),
              f"{what}: df off by {err} beyond 1e-5 * sum |terms|")
    if lay in ("per_expert_channel", "per_expert_tensor"):
        per = (lambda fe: fe.reshape(-1)) if lay == "per_expert_channel" \
            else (lambda fe: fe.reshape(()))
        alone = [(hgq_quantize_fwd(x[e], per(f[e])),
                  hgq_quantize_bwd(gy[e], x[e], per(f[e])))
                 for e in range(shape[0])]
        check(torch.equal(_bits_of(out), _bits_of(torch.stack(
                  [a for a, _ in alone]))) and torch.equal(
                  _bits_of(df.reshape(shape[0], -1)),
                  _bits_of(torch.stack([b.reshape(-1) for _, b in alone]))),
              f"{what}: an expert's output or df is not that of its own "
              f"launch")
    base = {"shape": f"{lay} {tuple(shape)} {str(dtype)[6:]}",
            "library_ms": None}
    key = (lay, tuple(shape), str(dtype)[6:])
    fb_ms, fb_by = bound(fwd_bytes, 5.0 * n)
    bb_ms, bb_by = bound(bwd_bytes, 9.0 * n)
    fwd = dict(base, max_abs_err=0.0,
               ms=time_ms(hgq_quantize_fwd, [a[:2] for a in sets]),
               plain_ms=plain_ms(hgq_quantize_ref, [a[:2] for a in sets]),
               bound_ms=fb_ms, bound_by=fb_by, bytes=fwd_bytes,
               flops=5.0 * n)
    bsets = [(gg, xx, ff) for xx, ff, gg in sets]
    bwd = dict(base, max_abs_err=err,
               ms=time_ms(hgq_quantize_bwd, bsets),
               plain_ms=plain_ms(hgq_quantize_grad_ref, bsets),
               bound_ms=bb_ms, bound_by=bb_by, bytes=bwd_bytes,
               flops=9.0 * n)
    return key, fwd, bwd


# the jet tagger's weights and biases, per parameter, float32: the members
# of a training step's one grouped forward launch, in the model's order
JET_GROUP = [(s, s, torch.float32) for s in
             ((16, 64), (64,), (64, 32), (32,), (32, 32), (32,), (32, 5),
              (5,))]
# a grouped forward of mixed members, checked at aligned and unaligned views:
# every layout, float32 and bfloat16, rows that are not whole vectors, two
# qwen2-0.5b layer shapes, and expert stacks per expert channel and tensor
GROUP_MIXED = [((16, 64), (16, 64), torch.float32),
               ((1024, 16), (16,), torch.float32),
               ((300, 5), (5,), torch.bfloat16),
               ((1001, 33), (), torch.float32),
               ((37,), (37,), torch.bfloat16),
               ((1024, 40), (1, 40), torch.bfloat16),
               ((896, 4864), (1, 4864), torch.float32),
               ((8192, 896), (), torch.bfloat16),
               ((5, 37, 33), (5, 1, 33), torch.bfloat16),
               ((6, 300, 40), (6, 1, 1), torch.float32)]


def _hgq_members(members, dev, g, offset=0):
    """(xs, fs) of a group, each a view ``offset`` elements into a buffer
    of its own."""
    xs, fs = [], []
    for shape, fshape, dtype in members:
        n, nf = math.prod(shape), math.prod(fshape)
        xb = (torch.randn(n + offset, generator=g, device=dev) * 4
              ).to(dtype)
        fb = torch.rand(nf + offset, generator=g, device=dev) * 8 - 1
        xs.append(xb[offset:].view(shape))
        fs.append(fb[offset:].view(fshape))
    return xs, fs


def hgq_group_case(members, dev, g):
    """The grouped forward against per-member launches and the plain group,
    bit for bit, twice the same; timed beside the per-member launches
    (``per_member_launches_ms``).  Keyed as the wrapper keys its tallies."""
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_fwd,
                                                  hgq_quantize_fwd_group,
                                                  hgq_quantize_group_ref,
                                                  layout_of)
    key = tuple((layout_of(s, fs), tuple(s), str(dt)[6:])
                for s, fs, dt in members)
    nbytes = sum(2 * math.prod(s) * (torch.finfo(dt).bits // 8)
                 + 4 * math.prod(fs) for s, fs, dt in members)
    n = sum(math.prod(s) for s, _, _ in members)
    sets = [_hgq_members(members, dev, g) for _ in range(n_copies(nbytes))]
    xs, fs = sets[0]
    outs = hgq_quantize_fwd_group(xs, fs)
    same = lambda a, b: all(torch.equal(_bits_of(u), _bits_of(v))
                            for u, v in zip(a, b))
    check(same(outs, hgq_quantize_group_ref(xs, fs)),
          f"hgq_quantize_fwd_group {key}: not bit-exact against the plain "
          f"group")
    check(same(outs, [hgq_quantize_fwd(x, f) for x, f in zip(xs, fs)]),
          f"hgq_quantize_fwd_group {key}: not the per-member launches' bits")
    check(same(outs, hgq_quantize_fwd_group(xs, fs)),
          f"hgq_quantize_fwd_group {key}: not repeatable")

    def singles(xs, fs):
        return [hgq_quantize_fwd(x, f) for x, f in zip(xs, fs)]

    b_ms, b_by = bound(nbytes, 5.0 * n)
    return key, {"shape": f"{len(members)} members: " + ", ".join(
        f"{lay} {s} {dt}" for lay, s, dt in key),
        "max_abs_err": 0.0, "ms": time_ms(hgq_quantize_fwd_group, sets),
        "plain_ms": plain_ms(hgq_quantize_group_ref, sets),
        "per_member_launches_ms": plain_ms(singles, sets),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": 5.0 * n}


def _hgq_group_checks(dev):
    """A group of mixed members, at aligned views and one element past a
    16-byte boundary (values one by one): every member the bits of its own
    launch and of the plain version."""
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_fwd,
                                                  hgq_quantize_fwd_group,
                                                  hgq_quantize_ref)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    for offset in (0, 1):
        xs, fs = _hgq_members(GROUP_MIXED, dev, g, offset)
        for x, f, out in zip(xs, fs, hgq_quantize_fwd_group(xs, fs)):
            check(torch.equal(_bits_of(out), _bits_of(hgq_quantize_ref(x, f)))
                  and torch.equal(_bits_of(out),
                                  _bits_of(hgq_quantize_fwd(x, f))),
                  f"hgq_quantize_fwd_group {tuple(x.shape)} f "
                  f"{tuple(f.shape)} {x.dtype} at offset {offset}: not the "
                  f"bits of its own launch and of the plain version")


def _wbits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _bucket_members(members, bits, dev, g, offset=0):
    """(leaves, steps) of a bucket's members ((shape, L, dtype), ...): seeded
    normal values, a scale a member and per grid row (1e-3 .. 10), each leaf
    a view ``offset`` elements into a buffer of its own; the steps are
    ``grid_scale`` of each row's amax at ``bits``, as the reduce makes them."""
    from repro_torch.kernels import wire_pack as wp
    leaves, steps = [], []
    for k, (shape, L, dt) in enumerate(members):
        T = math.prod(shape)
        buf = torch.randn((T + offset,), generator=g, device=dev)
        rows = buf[offset:].view(L, -1)
        rows *= 10.0 ** (-3 + k % 4)
        rows *= torch.logspace(-1, 1, L, device=dev)[:, None]
        buf = buf.to(_DTYPES[dt])
        leaves.append(buf[offset:].view(shape))
        amax = buf[offset:].view(L, -1).float().abs().amax(dim=1) \
            if T else torch.zeros((L,), device=dev)
        steps.append(wp.grid_scale(amax, bits))
    return leaves, steps


def _bucket_cols(members, n, nibble):
    """Per member T, and the bucket's width W (``wire_pack.bucket_layout``
    from the shapes alone)."""
    Ts = [math.prod(shape) for shape, _, _ in members]
    Cs = [-(-T // n) for T in Ts]
    return Ts, sum(C + (C & 1) if nibble else C for C in Cs)


def _bucket_text(n, what, nibble, members):
    return (f"n{n} {what}{' nibble' if nibble else ''} {len(members)} "
            f"members: " + ", ".join(f"{tuple(s)}/{L}/{dt}"
                                     for s, L, dt in members))


def _wire_spec(name, key, dev, g):
    """(make, kernel, plain, bytes, float32 operations, shape text) of one
    wire kernel at one tally key (the wrappers' keys)."""
    from repro_torch.kernels import wire_pack as wp
    if name == "wire_quantize_rows":
        L, P, bits = key
        qmax = 2 ** (bits - 1) - 1

        def make():
            # rows of different scales, a zero row, and the last row on
            # rounding ties (k + 1/2) * 2^-3 (its grid is 2^-3 from 3 bits)
            rows = torch.randn((L, P), generator=g, device=dev)
            rows *= torch.logspace(-4, 1, L, device=dev)[:, None]
            if L > 1:
                rows[0] = 0.0
            k = torch.arange(P, device=dev) % (2 * qmax) - qmax
            rows[-1] = (k + 0.5) * 0.125
            return rows, rows.abs().amax(dim=1), bits

        return (make, wp.wire_quantize_rows, wp.quantize_leaf_ref,
                L * P * 9 + L * 8, 6.0 * L * P, f"L{L} P{P} bits{bits}")
    if name == "wire_quantize_sflat":
        (R, C), bits = key

        def make():
            e = torch.randn((R, C), generator=g, device=dev)
            s = wp.grid_scale(torch.rand((R * C,), generator=g, device=dev)
                              * 4 + 1e-3, bits).reshape(R, C)
            return e, s, bits

        return (make, wp.wire_quantize_sflat, wp.quantize_chunks_ref,
                R * C * 13, 6.0 * R * C, f"R{R} C{C} bits{bits}")
    if name == "wire_pack_rows":
        R, C = key

        def make():
            return (torch.randint(-7, 8, (R, C), generator=g, device=dev,
                                  dtype=torch.int8),)

        # integer operations only: bound by bytes
        return (make, wp.wire_pack_rows, wp.pack_chunks_ref,
                R * C + R * ((C + 1) // 2), 0.0, f"R{R} C{C}")
    if name == "wire_quantize_bucket":
        n, bits, nibble, members = key
        Ts, W = _bucket_cols(members, n, nibble)

        def make():
            leaves, steps = _bucket_members(members, bits, dev, g)
            return leaves, steps, n, bits, nibble

        # the leaf read, the payload and the float32 residual written
        nbytes = sum(T * (torch.finfo(_DTYPES[dt]).bits // 8 + 4) + 4 * L
                     for T, (_, L, dt) in zip(Ts, members)) + n * W
        return (make, wp.wire_quantize_bucket, wp.quantize_bucket_ref,
                nbytes, 6.0 * sum(Ts),
                _bucket_text(n, f"bits{bits}", nibble, members))
    if name == "wire_dequant_bucket":
        n, shift, nibble, members = key
        Ts, W = _bucket_cols(members, n, nibble)

        def make():
            leaves, steps = _bucket_members(members, 4 if nibble else 8, dev,
                                            g)
            qmax = 7 if nibble else 127
            q = torch.randint(-qmax, qmax + 1, (n, W), generator=g,
                              device=dev, dtype=torch.int8)
            if nibble:
                q = wp.pack_chunks_ref(q)
            err = torch.randint(-2 ** shift, 2 ** shift + 1, (W,),
                                generator=g, device=dev).float()
            res = [torch.randn(e.shape, generator=g, device=dev) * s.min()
                   for e, s in zip(leaves, steps)]
            for r in res:
                r.view(-1)[::7] = -0.0           # +0.0 off the own chunk
            return q, err, res, leaves, steps, n, 0, shift, nibble

        # the payload and err read, the residual read and written, the
        # delivered written
        nbytes = (n * W // (2 if nibble else 1) + 4 * W
                  + sum(T * (4 + 2 * torch.finfo(_DTYPES[dt]).bits // 8)
                        + 4 * L for T, (_, L, dt) in zip(Ts, members)))
        return (make, wp.wire_dequant_bucket, wp.dequant_bucket_ref, nbytes,
                5.0 * sum(Ts),
                _bucket_text(n, f"shift{shift}", nibble, members))
    R, C, shift, n, row = key

    def make():
        q = torch.randint(-127, 128, (R, C), generator=g, device=dev,
                          dtype=torch.int8)
        s = wp.grid_scale(torch.rand((C if row else R * C,), generator=g,
                                     device=dev) + 0.1)
        return q, s if row else s.reshape(R, C), shift, n

    # the mantissas read, the float32 mean written, the scales read: one
    # row every row shares (the 2D decode of a model block) or one a value
    return (make, wp.wire_dequant_rows, wp.dequant_sum_ref,
            R * C * 5 + 4 * (C if row else R * C), 3.0 * R * C,
            f"R{R} C{C} shift{shift} n{n}" + (" one scale row" if row
                                               else ""))


def _tensors(x):
    """Every tensor of a result, in order (tuples and lists flattened)."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _tensors(v)] \
        if isinstance(x, (list, tuple)) else []


def _fresh(args):
    """The arguments with every tensor cloned: ``wire_dequant_bucket``
    updates a float32 residual in place."""
    if isinstance(args, torch.Tensor):
        return args.clone()
    if isinstance(args, (list, tuple)):
        return type(args)(_fresh(a) for a in args)
    return args


def _same_bits(a, b):
    a, b = _tensors(a), _tensors(b)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(_wbits(x), _wbits(y)) for x, y in zip(a, b))


def wire_case(name, key, dev, g, timed=True):
    """One wire kernel at one shape against its plain version, bit for bit
    (every output, signed zeros included; the bucket decode at every rank
    index; the per-position decode with scales of the payload's shape and
    as one row), twice identical, and timed (``timed=False``: held only,
    returns None)."""
    make, kern, plain, nbytes, flops, shape = _wire_spec(name, key, dev, g)
    sets = [make() for _ in range(n_copies(nbytes) if timed else 1)]
    checks = [sets[0]]
    if name == "wire_dequant_bucket":
        checks = [sets[0][:6] + (i,) + sets[0][7:] for i in range(key[0])]
    if name == "wire_dequant_rows":
        # the other scale layout too: one row, or that row at every row
        q, sc, shift, n = sets[0]
        checks.append((q, sc.expand(q.shape).contiguous() if key[4]
                       else sc[0].contiguous(), shift, n))
    for args in checks:
        ref = plain(*args)
        out = kern(*_fresh(args))
        check(_same_bits(out, ref),
              f"{name} {shape}: not bit-exact against the plain version")
        check(_same_bits(out, kern(*_fresh(args))),
              f"{name} {shape}: not repeatable")
    del checks, ref, out
    if not timed:
        return None
    b_ms, b_by = bound(nbytes, flops)
    case = {"shape": shape, "max_abs_err": 0.0,
            "ms": time_ms(kern, sets), "plain_ms": plain_ms(plain, sets),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}
    del sets
    return case


# buckets of the fused reduce beside its main paths': a stacked leaf (L =
# 3) with odd C, ragged T (not a multiple of n) and a scalar; bfloat16 and
# float32 leaves in a nibble bucket at n = 3 (a true division); one member
# of 2^22 + 3 values
BUCKET_EDGE = [
    (4, 8, False, (((3, 40, 7), 3, "float32"), ((1001,), 1, "float32"),
                   ((), 1, "float32"))),
    (3, 4, True, (((1001,), 1, "bfloat16"), ((33,), 1, "float32"),
                  ((3, 8, 5), 3, "bfloat16"), ((24, 1000), 1, "float32"))),
    (4, 8, False, (((2 ** 22 + 3,), 1, "float32"),)),
]
# edge shapes of the wire kernels, beside the shapes the wire phase takes
# from its main paths: stacked rows at every width, odd tails, a qwen2 MLP
# leaf (24 layers) and the embedding, n = 3 (a true division) and 4; packs
# of even C around the 16- and 32-byte vectors (16 packed bytes from 32);
# the per-position decode with a scale a value and with one scale row
WIRE_EDGE = {
    "wire_quantize_rows": [(1, 1, 8), (3, 40, 2), (4, 129, 5), (7, 257, 7),
                           (24, 1000, 3), (24, 896 * 4864, 4),
                           (1, 151936 * 896, 8)],
    "wire_quantize_sflat": [((4, 33), 8), ((4, 1001), 4), ((4, 2 ** 20), 8)],
    "wire_pack_rows": [(1, 1), (3, 7), (4, 1001), (1, 2 ** 20), (1, 14),
                       (3, 16), (1, 18), (3, 30), (1, 32), (3, 34), (2, 62),
                       (1, 64), (2, 66), (3, 2 ** 20 + 2)],
    "wire_dequant_rows": [(3, 1001, 2, 3, False), (4, 1001, 2, 4, False),
                          (4, 2 ** 20, 2, 4, False),
                          (4, 2 ** 20, 2, 4, True)],
    "wire_quantize_bucket": [(n, 4 if nib else 8, nib, m)
                             for n, _, nib, m in BUCKET_EDGE],
    "wire_dequant_bucket": [(n, (n - 1).bit_length(), nib, m)
                            for n, _, nib, m in BUCKET_EDGE],
}


def _bucket_edge_checks(dev):
    """The bucket kernels against their plain versions, bit for bit, where
    the timed keys cannot reach: leaves 1-7 elements past a 16-byte
    boundary (bfloat16 2-14 bytes, float32 4-28), residuals handed to the
    decode off the leaves' group grid (element by element), -0.0 and
    subnormal residuals on and off the own chunk (-0.0 + 0.0 is +0.0), every
    rank index, n = 3 and 4, int8 and nibble; and a bucket of 65 members,
    two launches of each kernel, equal to the plain bucket."""
    from repro_torch.kernels import wire_pack as wp
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    mixed = (((3, 8, 5), 3, "float32"), ((17,), 1, "bfloat16"),
             ((), 1, "float32"), ((2, 3, 7), 1, "float32"),
             ((5,), 1, "bfloat16"), ((4099,), 1, "float32"))
    many = tuple(((k % 37 + 1,), 1, "bfloat16" if k % 3 == 0 else "float32")
                 for k in range(65))
    cases = [(mixed, n, nib, off) for n in (3, 4) for nib in (False, True)
             for off in range(8)] + [(many, 4, False, 0), (many, 3, True, 5)]
    for members, n, nib, off in cases:
        bits = 4 if nib else 8
        what = (f"{_bucket_text(n, f'bits{bits}', nib, members)[:60]} at "
                f"offset {off}")
        leaves, steps = _bucket_members(members, bits, dev, g, off)
        launches = [wp.wire_quantize_bucket.launches,
                    wp.wire_dequant_bucket.launches]
        q, res = wp.wire_quantize_bucket(leaves, steps, n, bits, nib)
        check(_same_bits((q, res), wp.quantize_bucket_ref(leaves, steps, n,
                                                          bits, nib)),
              f"wire_quantize_bucket {what}: not the plain version's bits")
        _, W = _bucket_cols(members, n, nib)
        gath = torch.randint(-7, 8, (n, W), generator=g, device=dev,
                             dtype=torch.int8)
        if nib:
            gath = wp.pack_chunks_ref(gath)
        err = torch.randint(-8, 9, (W,), generator=g, device=dev).float()
        for r in res:
            r.view(-1)[::3] = -0.0
            r.view(-1)[1::5] = 1e-40
        # copies of the residuals 0, 1 and 3 elements past a 16-byte
        # boundary (the decode's outputs follow them; the float32 residual
        # is updated in place, so each call takes new copies)
        for k in (0, 1, 3):
            for idx in range(n):
                rs = []
                for r in res:
                    buf = torch.empty((r.numel() + k,), device=dev)
                    rs.append(buf[k:].view(r.shape).copy_(r))
                args = (gath, err, rs, leaves, steps, n, idx,
                        (n - 1).bit_length(), nib)
                want = wp.dequant_bucket_ref(*args)
                check(_same_bits(wp.wire_dequant_bucket(*args), want),
                      f"wire_dequant_bucket {what}, rank {idx}, residual "
                      f"{k} past a boundary: not the plain version's bits")
        moved = [wp.wire_quantize_bucket.launches - launches[0],
                 wp.wire_dequant_bucket.launches - launches[1]]
        want = [-(-len(members) // 64), -(-len(members) // 64) * 3 * n]
        check(moved == want, f"bucket launches {moved}, not {want}: {what}")


def _hgq_alignment_check(dev):
    """The backward's sums do not depend on where g and x lie: views one
    element past a 16-byte boundary (values loaded one by one) give the bits
    of aligned copies (16-byte loads)."""
    from repro_torch.kernels.hgq_quantize import hgq_quantize_bwd
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    for shape, fshape, dtype in (((1024, 16), (16,), torch.float32),
                                 ((1024, 64), (), torch.float32),
                                 ((1024, 16), (16,), torch.bfloat16),
                                 ((512, 257), (), torch.bfloat16)):
        n = math.prod(shape)
        buf = (torch.randn(2 * n + 1, generator=g, device=dev) * 4).to(dtype)
        x, gy = buf[1:n + 1].view(shape), buf[n + 1:].view(shape)
        f = torch.rand(fshape, generator=g, device=dev) * 8 - 1
        a = hgq_quantize_bwd(gy, x, f)
        b = hgq_quantize_bwd(gy.clone(), x.clone(), f)
        check(torch.equal(_bits_of(a), _bits_of(b)),
              f"hgq_quantize_bwd {tuple(shape)} {dtype}: an unaligned view "
              f"sums differently from an aligned copy")


def _pack_offset_check(dev):
    """``wire_pack_rows`` on contiguous views whose base sits 0-15 bytes past
    a 16-byte boundary (a slice of a larger tensor): bit-exact against the
    plain version and repeatable, at even C (the 16-byte path, an input
    misaligned against its output) and odd C."""
    from repro_torch.kernels import wire_pack as wp
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 6)
    for R, C in ((4, 2 * 16 * 1000 + 34), (1, 70), (3, 1001)):
        buf = torch.randint(-7, 8, (R * C + 16,), generator=g, device=dev,
                            dtype=torch.int8)
        for off in range(16):
            q = buf[off:off + R * C].view(R, C)
            out = wp.wire_pack_rows(q)
            check(torch.equal(out, wp.pack_chunks_ref(q))
                  and torch.equal(out, wp.wire_pack_rows(q)),
                  f"wire_pack_rows R{R} C{C} at byte offset {off}: not "
                  f"bit-exact or not repeatable")


def _subnormal_check(dev):
    """``[1e-38]`` at 2 bits: the residual is the subnormal input itself
    (no flush to zero), as the plain version computes."""
    from repro_torch.kernels import wire_pack as wp
    x = torch.tensor([[1e-38]], device=dev)
    q, s, r = wp.wire_quantize_rows(x, x[:, 0], 2)
    check(int(q[0, 0]) == 0 and torch.equal(_wbits(r), _wbits(x)),
          f"wire_quantize_rows flushed a subnormal residual: {float(r)}")


def _division_check(dev):
    """The plain versions divide by a tensor (``wire_pack.ref.true_div``):
    on the card that must be IEEE division, the CPU's, where PyTorch
    divides a float32 tensor by a Python number as a multiply by its
    reciprocal.  Prints how many values that multiply moves."""
    from repro_torch.kernels.wire_pack import true_div
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    x = torch.randn(1 << 20, generator=g, device=dev)
    check(torch.equal(true_div(x, 3).cpu(), x.cpu() / 3.0),
          "true_div on the card is not IEEE division")
    moved = int((x / 3.0 != true_div(x, 3)).sum())
    print(f"[kernels] on the card x / 3 differs from IEEE division "
          f"(true_div) in {moved} of {x.numel()} values", flush=True)


def print_cases(cases, names=None):
    for name, by_shape in cases.items():
        if names is not None and name not in names:
            continue
        print(f"[kernels] {name}: max err "
              f"{max(c['max_abs_err'] for c in by_shape.values()):.3g}",
              flush=True)
        for c in by_shape.values():
            lib = "-" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
            print(f"    {c['shape']:<44} {c['ms']:.4f} ms  plain "
                  f"{c['plain_ms']:.4f}  library {lib}  bound "
                  f"{c['bound_ms']:.4f} ({c['bound_by']})", flush=True)
            if "rel_err" in c:
                print(f"    {'':<44} err / (|x|@|w|*s) {c['rel_err']:.3g} "
                      f"(two-term {c['rel_err_two_term']:.3g}); off the one "
                      f"rounding {c['exact_off']:.4f} (two-term "
                      f"{c['exact_off_two_term']:.4f})", flush=True)


def kernel_phase(dev):
    """Every kernel at its main path's shapes: {kernel: {shape key:
    case}}, keyed as the wrappers key their launch tallies."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    H, KV, hd, W = 14, 2, 64, 1024
    cases = {name: {} for name in KERNELS}
    d, Gkv, E, V = (GRANITE[k] for k in ("d", "KV", "E", "V"))
    gd, gff, gV = GRIFFIN["d"], GRIFFIN["ff"], GRIFFIN["V"]
    ghd = GRIFFIN["KV"] * GRIFFIN["hd"]
    rd, rff, rV = RWKV["d"], RWKV["ff"], RWKV["V"]
    for M in (8, 16):
        # qwen2-0.5b: int8: q, o; k, v; gate, up; down; the tied head.
        # nibbles: gate, up; down (configuration (a)'s MLP).  granite: int8
        # q, o; k, v; the router (N 40, under one block of 128 columns);
        # the untied head (N 49155, odd); nibbles at N 512 and 1536.
        # recurrentgemma-2b: int8 2560 -> 2560 (the recurrent blocks' five,
        # q and o), -> 256 (k, v), the MLP, the head (N 256000); the MLP
        # in nibbles (configuration (b)).  rwkv6-1.6b: int8 2048 -> 2048
        # (the time mix's five, the channel mix's r), the channel mix's
        # 2048 <-> 7168, the head (N 65536); the channel mix in nibbles
        for K, N, bits in ((896, 896, 8), (896, 128, 8), (896, 4864, 8),
                           (4864, 896, 8), (896, 151936, 8),
                           (896, 4864, 4), (4864, 896, 4),
                           (d, d, 8), (d, Gkv * hd, 8), (d, E, 8), (d, V, 8),
                           (d, Gkv * hd, 4), (d, d, 4),
                           (gd, gd, 8), (gd, ghd, 8), (gd, gff, 8),
                           (gff, gd, 8), (gd, gV, 8), (gd, gff, 4),
                           (gff, gd, 4),
                           (rd, rd, 8), (rd, rff, 8), (rff, rd, 8),
                           (rd, rV, 8), (rd, rd, 4), (rd, rff, 4),
                           (rff, rd, 4)):
            cases["qmatmul"][M, K, N, bits] = qmatmul_case(M, K, N, bits,
                                                           dev, g)
    # whisper-large-v3: a decode tick (M 8) and a 250-frame chunk through
    # the encoder and the cross k / v (M 250): q, k, v, o at 1280 x 1280,
    # the MLP 1280 <-> 5120, int8 and, configuration (b)'s MLP, nibbles
    Wd, Wff = WHISPER["d"], WHISPER["ff"]
    for M in (8, WHISPER["chunk"]):
        for K, N in ((Wd, Wd), (Wd, Wff), (Wff, Wd)):
            for bits in (8, 4):
                cases["qmatmul"][M, K, N, bits] = qmatmul_case(M, K, N, bits,
                                                               dev, g)
    rel = [c["rel_err"] for c in cases["qmatmul"].values()]
    rel2 = [c["rel_err_two_term"] for c in cases["qmatmul"].values()]
    check(max(rel) <= REL_ERR_LIMIT < max(rel2),
          f"qmatmul: largest error over (|x|@|w|)*scale {max(rel):.3g}, "
          f"two-term control {max(rel2):.3g}, limit {REL_ERR_LIMIT}")
    lap("kernels: qmatmul")
    for R in (16, 32, 64):
        for bits in (8, 4):
            cases["kv_quantize_rows"][R, hd, bits] = kv_quantize_case(
                R, hd, bits, dev, g)
    for key in STORE_TIMED:
        cases["kv_quantize_store"][key] = kv_store_case(key, False, dev, g)
    for key in GRIFFIN_STORE:
        cases["kv_quantize_store"][key] = kv_store_case(key, True, dev, g)
    for key in WHISPER_STORE:
        cases["kv_quantize_store"][key] = kv_store_case(key, False, dev, g)
    kv_store_checks(dev, g)
    # one qwen2-0.5b layer's full ring (8 slots x 1024 x 2 kv heads), one
    # slot's, and all 24 layers' rings
    for R in (8 * W * KV, W * KV, 24 * 8 * W * KV):
        cases["kv_dequant_rows"][R, hd] = kv_dequant_case(R, hd, dev, g)
    _dequant_edge_checks(dev, g)
    # qwen2-0.5b's 14 heads over 2 kv heads, granite's 24 over 8
    for h, kv in ((H, KV), (GRANITE["H"], GRANITE["KV"])):
        for B, S in ((8, 1), (1, 16)):
            for nibble in (False, True):
                key = (B, S, h, kv, hd, W, hd // 2 if nibble else hd)
                cases["kv_attention_rows"][key] = kv_attention_case(
                    B, S, W, nibble, 6.0, dev, g, H=h, KV=kv, hd=hd)
    # recurrentgemma-2b's 10 heads over 1 kv head of 256 on its wrapped
    # 2064-slot ring, the window of 2048 masking the oldest slots
    Gf = GRIFFIN
    for B, S in ((8, 1), (1, 16)):
        for nibble in (False, True):
            key = (B, S, Gf["H"], Gf["KV"], Gf["hd"], Gf["W"],
                   Gf["hd"] // 2 if nibble else Gf["hd"])
            cases["kv_attention_rows"][key] = kv_attention_case(
                B, S, Gf["W"], nibble, 6.0, dev, g, H=Gf["H"], KV=Gf["KV"],
                hd=Gf["hd"], window=Gf["window"])
    # whisper-large-v3's 20 heads over 20 kv heads (G = 1): a tick over the
    # 448-slot self ring and the 1500-slot cross memory, a prompt chunk of
    # 16 over the memory
    Wh = WHISPER
    for B, S, W in ((8, 1, Wh["W"]), (8, 1, Wh["T"]), (1, 16, Wh["T"])):
        for nibble in (False, True):
            key = (B, S, Wh["H"], Wh["KV"], Wh["hd"], W,
                   Wh["hd"] // 2 if nibble else Wh["hd"])
            cases["kv_attention_rows"][key] = kv_attention_case(
                B, S, W, nibble, 6.0, dev, g, H=Wh["H"], KV=Wh["KV"],
                hd=Wh["hd"])
    empty_rows_attention_checks(dev, g)
    long_ring_checks(dev, g)
    unaligned_attention_checks(dev, g)
    lap("kernels: the KV kernels")
    for shape, fshape, dtype in HGQ_SHAPES + HGQ_EDGE + PAPER_SHAPES \
            + LM_SHAPES + GRANITE_SHAPES:
        key, fwd, bwd = hgq_quantize_case(shape, fshape, dtype, dev, g)
        cases["hgq_quantize_fwd"][key] = fwd
        cases["hgq_quantize_bwd"][key] = bwd
    for members in (JET_GROUP, SVHN_GROUP, MUON_GROUP, LM_GROUP,
                    GRANITE_GROUP):
        key, case = hgq_group_case(members, dev, g)
        cases["hgq_quantize_fwd_group"][key] = case
    _hgq_group_checks(dev)
    lap("kernels: the quantizer")
    _hgq_alignment_check(dev)
    _pack_offset_check(dev)
    _bucket_edge_checks(dev)
    _subnormal_check(dev)
    _division_check(dev)
    for name, keys in WIRE_EDGE.items():
        for key in keys:
            cases[name][key] = wire_case(name, key, dev, g)
    # the shapes of the api part and of Whisper's served depth:
    # llama3.2-3b's qmatmul (int8 q, o; k, v; gate, up; down; the tied
    # head), the launcher step's hgq_quantize activations (seq 256), and
    # the store of a 250-frame append's cross rows for WHISPER_SERVE_LAYERS
    # layers
    for hdm, bits in ((64, 8), (32, 4)):
        key = (WHISPER_SERVE_LAYERS, WHISPER["chunk"], WHISPER["KV"],
               WHISPER["hd"], WHISPER["T"], hdm, bits, "float32")
        cases["kv_quantize_store"][key] = kv_store_case(key, False, dev, g)
    ld, lkv, lff = LLAMA["d"], LLAMA["KV"] * LLAMA["hd"], LLAMA["ff"]
    llama = []
    for M in (8, 16):
        for K, N in ((ld, ld), (ld, lkv), (ld, lff), (lff, ld),
                     (ld, LLAMA["V"])):
            case = cases["qmatmul"][M, K, N, 8] = qmatmul_case(M, K, N, 8,
                                                               dev, g)
            llama.append(case)
    check(max(c["rel_err"] for c in llama) <= REL_ERR_LIMIT
          < max(c["rel_err_two_term"] for c in llama),
          f"qmatmul at llama3.2-3b's shapes: largest error over "
          f"(|x|@|w|)*scale {max(c['rel_err'] for c in llama):.3g}, "
          f"two-term control "
          f"{max(c['rel_err_two_term'] for c in llama):.3g}, limit "
          f"{REL_ERR_LIMIT}")
    for shape, fshape, dtype in API_LM_SHAPES:
        key, fwd, bwd = hgq_quantize_case(shape, fshape, dtype, dev, g)
        cases["hgq_quantize_fwd"][key] = fwd
        cases["hgq_quantize_bwd"][key] = bwd
    print_cases(cases)
    return cases


def _per_unit(name, by_shape, unit, per):
    """One unit's numbers for a kernel: per-call times weighted by the
    calls of each shape the main path launched in that unit."""
    missing = [k for k in unit if k not in by_shape]
    check(not missing, f"{name}: the main path launched shapes the "
                       f"kernel phase did not time: {missing}")
    check(sum(unit.values()) > 0, f"{name}: not in the unit")
    out = {key: sum(n * by_shape[k][key] for k, n in unit.items())
           for key in ("ms", "plain_ms")}
    out["library_ms"] = (sum(n * by_shape[k]["library_ms"]
                             for k, n in unit.items())
                         if all(by_shape[k]["library_ms"] is not None
                                for k in unit) else None)
    out["bound_ms"], out["bound_by"] = bound(
        sum(n * by_shape[k]["bytes"] for k, n in unit.items()),
        sum(n * by_shape[k]["flops"] for k, n in unit.items()),
        next(iter(by_shape.values())).get("peak", peak_rate("float32")))
    out["per"] = per
    out["calls_per_unit"] = {by_shape[k]["shape"]: n
                             for k, n in unit.items()}
    print(f"[kernels] {name}: {per}: {sum(unit.values())} calls, "
          f"{out['ms']:.4f} ms (plain {out['plain_ms']:.4f}, bound "
          f"{out['bound_ms']:.4f})", flush=True)
    return out


def kernels_line(cases, tallies):
    """The ``kernels`` entries.  ``tallies`` maps a kernel to a list of
    (its launches by shape in one unit of a main path -- a full decode
    tick of serving configuration (a), a training step, a compressed
    data-parallel step, a qwen2 gradient reduce -- as the wrappers counted
    them, a description of that unit).  The entry's times are the first
    unit's, per-call times weighted by those counts (every counted shape
    must have been timed); further units go under ``other_units``.  A
    kernel without a tally (the kernel phase alone) has null per-unit
    fields."""
    out = []
    for name, by_shape in cases.items():
        source, tpu = KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": dict(TPU_KERNELS)[tpu], "launches": 0,
                 "max_abs_err": max(c["max_abs_err"]
                                    for c in by_shape.values()),
                 "ms": None, "plain_ms": None, "bound_ms": None,
                 "bound_by": None, "library_ms": None,
                 "per": None, "calls_per_unit": None}
        if name == "hgq_quantize_bwd":
            entry["note"] = ("the backward of the kernel's op, the custom_vjp "
                             "at src/repro/kernels/hgq_quantize/ops.py:73; "
                             "per channel and per tensor one launch of a "
                             "thread block cluster (partials summed in rank "
                             "order in rank 0's shared memory, no scratch) up "
                             "to 8 blocks of two batches a thread (65536 "
                             "float32 elements, 2048 rows per channel), "
                             "clusters of 8 and a second pass beyond; per "
                             "expert (an expert stack's f [E, 1, N] or "
                             "[E, 1, 1]) the same plan for each expert's "
                             "rows, the experts along a grid axis, one "
                             "launch for all")
        if name == "hgq_quantize_fwd_group":
            entry["note"] = ("the forward of the same TPU kernel over a group "
                             "of tensors in one launch (a training step's "
                             "weight and bias quantizers: 8 of the jet "
                             "tagger, 12 of the SVHN and the muon models, "
                             "10 a layer of qwen2-0.5b, 8 a layer of "
                             "granite-moe-3b-a800m with its router and "
                             "three expert stacks per expert channel); "
                             "library_ms null: "
                             "torch.fake_quantize_per_channel_affine rounds "
                             "half to even, Eq. 4 half up")
        if name == "kv_quantize_store":
            entry["note"] = ("the kv_quantize_rows body with the serving "
                             "ring write fused in (quantize, nibble pack, "
                             "store at the slots, out-of-ring rows dropped); "
                             "library_ms null: no single PyTorch call "
                             "computes this function")
        if name == "kv_quantize_rows":
            entry["note"] = ("no main path launches it (the entry point of "
                             "the op kv_quantize); the serving store runs its "
                             "body as kv_quantize_store")
        if name in WIRE:
            entry["note"] = ("library_ms null: no single PyTorch call "
                             "computes this function")
        if name in PER_POSITION_WIRE:
            entry["note"] += ("; the 2D exchange launches it, one launch a "
                              "leaf a rank (the 1D reduce runs its bucket "
                              "form)")
        if name in ("wire_quantize_bucket", "wire_dequant_bucket"):
            entry["note"] += ("; one launch a bucket a rank, the members read "
                              "and written where they lie (a member table in "
                              "the kernel's parameter space, the chunk "
                              "layout as index arithmetic)")
        if name == "wire_pack_rows":
            entry["note"] += ("; even C packs the flat bytes in 16-byte "
                              "vectors (two 16-byte loads, prmt, one 16-byte "
                              "store), odd C a row at a time")
        if name == "qmatmul":
            entry["note"] = ("tensor cores (mma.sync bf16, x in three exact "
                             "terms); bound: bytes, or 3 x 2MKN operations "
                             "at the bf16 tensor rate; library_ms on nibble "
                             "shapes multiplies the unpacked int8 mantissas")
        if name == "kv_dequant_rows":
            entry["note"] = ("no main path of either package launches it "
                             "(the entry point of the op kv_dequant), so its "
                             "launches are 0 and its per-unit fields null; "
                             "per-call numbers under shapes, each beside "
                             "launch_floor_ms, the empty kernel on the "
                             "same grid")
        units = [_per_unit(name, by_shape, u, per)
                 for u, per in tallies.get(name, [])]
        if units:
            entry.update(units[0])
        if units[1:]:
            entry["other_units"] = units[1:]
        entry["shapes"] = list(by_shape.values())
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels.hgq_quantize import (hgq_quantize_bwd,
                                                  hgq_quantize_fwd,
                                                  hgq_quantize_fwd_group)
    from repro_torch.kernels.kv_dequant import (kv_attention_rows,
                                                kv_dequant_rows,
                                                kv_quantize_rows,
                                                kv_quantize_store)
    from repro_torch.kernels.qmatmul import qmatmul
    from repro_torch.kernels import wire_pack as wp
    return {"qmatmul": qmatmul, "kv_quantize_rows": kv_quantize_rows,
            "kv_quantize_store": kv_quantize_store,
            "kv_dequant_rows": kv_dequant_rows,
            "kv_attention_rows": kv_attention_rows,
            "hgq_quantize_fwd": hgq_quantize_fwd,
            "hgq_quantize_fwd_group": hgq_quantize_fwd_group,
            "hgq_quantize_bwd": hgq_quantize_bwd,
            **{name: getattr(wp, name) for name in WIRE}}


def _counts(names):
    return {k: fn.launches for k, fn in _counters().items() if k in names}


def _shapes(names):
    return {k: collections.Counter(fn.shapes)
            for k, fn in _counters().items() if k in names}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0
        fn.shapes.clear()


# The profiler's settling time, its markers, and the runs it may take to
# get a whole trace.  The trace can lack the device records of the first
# kernels launched after the profiler starts, though every launch was made
# (readings in PERF.md): one profiled step in 30 lost its first 22 device
# operations when it began as the profiler started; after the serving
# phase the profiled step lost its first launch (an ``aten::fill_``) in
# every run, a settling time or not, and the compressed step its first 8
# behind a marker kernel.  So the profiled function runs after the
# settling time and ``PROFILE_MARKERS`` marker kernels, which nothing
# reads, and a trace is only used whole: every kernel launch of the
# function has its device kernel, else the function is profiled again.
PROFILE_SETTLE_S = 0.05
# the device operations a profiled training step lists by time
PROFILE_TOP = 12
PROFILE_MARKERS = 512
PROFILE_ATTEMPTS = 3
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
MARKER = "spin_kernel"                   # torch.cuda._sleep's kernel


def _all_threads_config():
    """The profiler option that records host operations on every thread (a
    LocalMesh's ranks are threads; by default only the profiling thread's
    are recorded), or None where this PyTorch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _trace_once(fn, args, settle=PROFILE_SETTLE_S, n_markers=PROFILE_MARKERS,
                all_threads=False):
    """``fn(*args)`` under ``torch.profiler``, after ``settle`` seconds and
    ``n_markers`` marker kernels: (the profiler, its exported chrome trace's
    events as its ``trace_events``; the chrome trace's device
    kernels but the markers', where the launches of ``fn`` whose device
    kernel the trace lacks were made, the launches of ``fn``, the markers'
    device kernels the trace kept).  ``all_threads``: host operations of
    every thread recorded, where the profiler can."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    config = _all_threads_config() if all_threads else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **({} if config is None else
                    {"experimental_config": config})) as prof:
        time.sleep(settle)
        for _ in range(n_markers):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        fn(*args)
        torch.cuda.synchronize()
        time.sleep(settle)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    calls = sorted((e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and e.get("name", "").startswith(LAUNCH_CALLS)),
                   key=lambda e: e["ts"])
    check(len(calls) > n_markers, "the profiled function launched no kernel")
    ahead = {e["args"]["correlation"] for e in calls[:n_markers]}
    prof.trace_events = events
    markers = [e for e in events if e.get("cat") == "kernel"
               and MARKER in e.get("name", "")]
    check(all(e["args"]["correlation"] in ahead for e in markers),
          "a marker kernel is not among the first launches of the trace")
    kernels = [e for e in events if e.get("cat") == "kernel"
               and MARKER not in e.get("name", "")]
    have = {e["args"]["correlation"] for e in kernels}
    calls = calls[n_markers:]
    lost = [_launch_site(events, calls, i) for i, e in enumerate(calls)
            if e["args"]["correlation"] not in have]
    return prof, kernels, lost, calls, len(markers)


def _launch_site(events, calls, i):
    """Launch i of ``calls`` as the host made it: the call, the innermost
    host operator around it, its place among the launches."""
    c = calls[i]
    around = [e for e in events
              if e.get("cat") in ("cpu_op", "user_annotation")
              and e.get("tid") == c.get("tid")
              and e["ts"] <= c["ts"] <= e["ts"] + e.get("dur", 0)]
    op = max(around, key=lambda e: e["ts"])["name"] if around else "no op"
    return f"{c['name']} in {op} (launch {i + 1} of {len(calls)})"


# the chrome trace's device operations (what torch.profiler's events list
# as on the device): kernels, copies, fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _profiled(fn, grids_of=None, prepare=None, all_threads=False,
              device_ms=None):
    """``fn()`` (or ``fn(prepare())``, ``prepare`` run before the profiler
    starts) under ``torch.profiler``: (device operations, ms the device
    was busy, the launch grids of the device kernels whose name holds
    ``grids_of``, as CUPTI recorded them, and the names of every event,
    device kernels and host operators -- of every thread with
    ``all_threads``, where the profiler can -- counted; an operator
    nested in one of its own name counts twice), the markers left out,
    all read from the exported chrome trace.  Only a whole trace is
    read: one with a device kernel for every kernel launch of ``fn``.
    ``device_ms``, a dict, receives the device milliseconds of each device
    operation's name."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        args = () if prepare is None else (prepare(),)
        prof, kernels, lost, launched, marked = _trace_once(
            fn, args, all_threads=all_threads)
        if marked < PROFILE_MARKERS:
            print(f"[profile] the trace kept {marked} of the "
                  f"{PROFILE_MARKERS} marker kernels", flush=True)
        if not lost:
            break
        print(f"[profile] run {attempt}: the trace lacks the device kernel "
              f"of {len(lost)} of {len(launched)} kernel launches: "
              f"{'; '.join(lost[:4])}", flush=True)
    check(not lost, f"no whole trace in {PROFILE_ATTEMPTS} runs")
    grids = [] if grids_of is None else [
        tuple(e["args"]["grid"]) for e in kernels
        if grids_of in e.get("name", "")]
    events = [e for e in prof.trace_events if e.get("ph") == "X"
              and MARKER not in e.get("name", "")]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if device_ms is not None:
        for e in dev:
            device_ms[e["name"]] = device_ms.get(e["name"], 0.0) \
                + e["dur"] / 1e3
    return (len(dev), sum(e["dur"] for e in dev) / 1e3, grids,
            collections.Counter(e["name"] for e in events))


def _serve(eng, reqs, unpacks=None):
    """Continuous batching through the public surface, each tick timed
    to its end on the card.  The first tick with every slot busy also
    has its launches tallied by shape and, given the counter of
    ``_counting_unpacks``, its ``unpack_nibbles`` calls counted: (tick
    ms, that tick's launches by shape, its unpack calls or None)."""
    pending = list(reqs)
    tick_ms, tick_shapes, tick_unpacks = [], None, None
    while pending or not all(r.done for r in reqs):
        while pending and eng.submit(pending[0]) is not None:
            pending.pop(0)
        torch.cuda.synchronize()
        full = tick_shapes is None and all(r is not None
                                           for r in eng.slot_req)
        if full:
            before = _shapes(SERVING)
            unpacked = None if unpacks is None else unpacks[0]
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if full:
            after = _shapes(SERVING)
            tick_shapes = {k: after[k] - before[k] for k in after}
            if unpacks is not None:
                tick_unpacks = unpacks[0] - unpacked
    return tick_ms, tick_shapes, tick_unpacks


def _profile_full_tick(Engine, Request, model, params, qstate, cfg, pl,
                       kv_bits, prompts, dev, unpacks=None, device_ms=None,
                       max_len=1024):
    """Device operations, busy ms and the attention kernel's launch grids
    of one decode tick with all 8 slots busy (B = 8, the ring ``max_len``
    slots, or the window and a chunk's), on an engine of its own
    (``Engine``, the class or a factory taking its arguments; a new one
    for each profiler run), after every timed run: the profiler
    slows the host, and may go on doing so once it is stopped.  The
    attention kernel reads the whole ring whatever its fill, so short
    prompts give the same device work as the timed run's.  ``unpacks``,
    the counter of an enclosing ``_counting_unpacks``, is set to the
    profiled tick's ``unpack_nibbles`` calls; ``device_ms`` receives the
    device milliseconds by operation name (``_profiled``)."""
    def engine():
        eng = Engine(model, params, qstate, cfg, batch_slots=8,
                     max_len=max_len, prefill_chunk=16, packed=True, plan=pl,
                     kv_bits=kv_bits, seed=SEED, device=dev)
        for i in range(8):
            pr = prompts[i % len(prompts)]
            check(eng.submit(Request(prompt=list(pr[:16]), max_new=4))
                  is not None, "profile pass: no free slot")
        check(all(r is not None for r in eng.slot_req),
              "profile pass: idle slot")
        return eng

    def step(eng):
        if unpacks is not None:
            unpacks[0] = 0
        eng.step()

    return _profiled(step, "kv_attention_kernel", prepare=engine,
                     device_ms=device_ms)


# what a KV store outside the fused kernel would run, by the names of host
# operators and device kernels: the stack of k and v, the nibble pack's and /
# or, the scatter writes into the ring.  (A left shift is no sign: every
# activation quantizer builds its 2^f in the exponent field with one.)
STORE_OPS = ("aten::stack", "index_put", "bitwise_and", "bitwise_or",
             "aten::__and__", "aten::__or__")


def _store_ops(names):
    return {k: n for k, n in names.items() if any(o in k for o in STORE_OPS)}


@contextlib.contextmanager
def _counting_unpacks(calls):
    """Count in ``calls[0]`` every ``unpack_nibbles`` call of the port
    (each module that bound the function by name)."""
    from repro_torch.kernels.qmatmul import ref
    real = ref.unpack_nibbles
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("repro_torch")
            and getattr(m, "unpack_nibbles", None) is real]

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    for m in mods:
        m.unpack_nibbles = counted
    try:
        yield
    finally:
        for m in mods:
            m.unpack_nibbles = real


@contextlib.contextmanager
def _bf16_activations_into_qmatmul():
    """Control: every packed matmul takes its activations rounded to
    bfloat16, a subtly wrong product."""
    import repro_torch.models.lm as lm
    import repro_torch.nn.basic as basic
    real = basic.qmatmul_any

    def rounded(x, w, s, **kw):
        return real(x.to(torch.bfloat16).to(x.dtype), w, s, **kw)

    basic.qmatmul_any = lm.qmatmul_any = rounded
    try:
        yield
    finally:
        basic.qmatmul_any = lm.qmatmul_any = real


def _without_act_quantizers(tree):
    """The tree without its activation quantizers (every ``out_f``,
    ``attnout_f`` and an MoE's ``h_f``, in dicts and in lists of layers
    such as Griffin's ``rem``): packed weights, the cache's grids and the
    probabilities' grid stay."""
    if isinstance(tree, dict):
        return {k: _without_act_quantizers(v) for k, v in tree.items()
                if k not in ("out_f", "attnout_f", "h_f")}
    if isinstance(tree, list):
        return [_without_act_quantizers(v) for v in tree]
    return tree


# Card logits against the CPU's plain path.  With the activation
# quantizers on, a one-ulp difference in a sum decides a rounding tie
# somewhere in 24 layers and the logits drift by a few percent: that
# reading only bounds gross faults (LOGITS_REL_GROSS).  Without them the
# function is continuous, and LOGITS_REL_LIMIT lies between the sound
# reading and those of two faulty controls, which the check must catch
# (readings in PERF.md).
LOGITS_REL_GROSS = 0.1
LOGITS_REL_LIMIT = 0.005


def _logits_vs_plain(p, q, cfg, kv_bits, dev, controls, model=None,
                     prepare=None, full=True):
    """Teacher-forced logits of the card (kernels) against the CPU (plain
    versions) on one prefill chunk and two decode ticks of 2 rows, with
    the activation quantizers on ("full") and off ("continuous"), where
    the ``controls`` -- the card path with one subtle fault each, {name:
    (the fault's tree without activation quantizers, a context manager
    that puts the fault in the code)} -- are read too: {witness:
    {"rel_l2", "argmax_agree", "controls"?}}.  ``model``: the decoder
    (``TransformerLM`` by default); ``prepare(caches, device, params,
    qstate, kv_bits)``, if given, fills the fresh caches first (an
    encoder-decoder's memory) and returns them.  ``full=False`` reads the
    continuous witness alone ({"continuous": ...})."""
    from repro_torch.models import TransformerLM
    from repro_torch.tree import tree_map
    M = model or TransformerLM
    g = np.random.default_rng(SEED)
    toks = torch.as_tensor(g.integers(0, cfg.vocab, (2, 16)))
    cpu = torch.device("cpu")

    def run(d, pp, qq):
        c = M.init_cache(cfg, 2, 64, kv_bits=kv_bits, device=d)
        if prepare is not None:
            c = prepare(c, d, pp, qq, kv_bits)
        lg, c = M.decode_step(pp, qq, c, toks.to(d), 0, cfg, kv_bits=kv_bits)
        seq = [lg[:, -1]]
        nxt = toks[:, -1:]
        for t in range(2):
            lg, c = M.decode_step(pp, qq, c, nxt.to(d),
                                  np.array([16 + t, 16 + t]), cfg,
                                  kv_bits=kv_bits)
            seq.append(lg[:, -1])
            nxt = (nxt + 1) % cfg.vocab
        out = torch.stack(seq).cpu()
        check(bool(torch.isfinite(out).all()), f"logits on {d} not finite")
        return out

    def rel(x, y):
        return float((x - y).norm() / y.norm())

    def compare(pp):
        a = run(dev, pp, q)
        b = run(cpu, tree_map(lambda t: t.to(cpu), pp),
                tree_map(lambda t: t.to(cpu), q))
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        return b, {"rel_l2": rel(a, b), "argmax_agree": agree}

    out = {"full": compare(p)[1]} if full else {}
    pc = _without_act_quantizers(p)
    b, cont = compare(pc)
    cont["controls"] = {}
    for name, (tree, fault) in controls(pc).items():
        with fault():
            cont["controls"][name] = rel(run(dev, tree, q), b)
    return {**out, "continuous": cont}


def _dense_controls(pc):
    """Probabilities on a grid one step finer in every layer; activations
    rounded to bfloat16 into every packed matmul."""
    attn = dict(pc["layers"]["attn"],
                probs_f=pc["layers"]["attn"]["probs_f"] + 1)
    return {"probs_grid_one_step_finer": (
                {**pc, "layers": {**pc["layers"], "attn": attn}},
                contextlib.nullcontext),
            "bf16_activations_into_qmatmul": (
                pc, _bf16_activations_into_qmatmul)}


@contextlib.contextmanager
def _patched(module, name, fn):
    """``module.name`` replaced by ``fn(the real one)`` inside."""
    real = getattr(module, name)
    setattr(module, name, fn(real))
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _patched_static(cls, name, fn):
    """The static method ``cls.name`` replaced by ``fn(the real one)``
    inside (calls through the class see the replacement)."""
    real = cls.__dict__[name]
    setattr(cls, name, staticmethod(fn(real.__func__)))
    try:
        yield
    finally:
        setattr(cls, name, real)


def _moe_controls(pc):
    """The MoE's gates not renormalized over the top k; every expert's
    capacity one slot short wherever it has more than one (a decode
    tick's C = 1 stays)."""
    import repro_torch.nn.moe as moe
    return {"gates_not_renormalized": (
                pc, lambda: _patched(moe, "renormalize",
                                     lambda real: lambda g: g)),
            "capacity_one_slot_short": (
                pc, lambda: _patched(moe, "capacity",
                                     lambda real: lambda S, c: max(
                                         1, real(S, c) - 1)))}


# qwen2-0.5b is served at its published widths and the first this many of
# its 24 layers, cut from the full model's init (all 24 were held in
# earlier runs, PERF.md §4): the cut pays for the wire phase's 2D part
# and the script's time; its tallies scale with the layers
QWEN_SERVE_LAYERS = 4


def lm_first_layers(params, qstate, cfg, n):
    """The first ``n`` layers of a ``TransformerLM`` tree (``params``,
    ``qstate``, copied) and ``cfg`` at that depth."""
    from repro_torch.tree import tree_map
    cut = [{**t, "layers": tree_map(lambda a: a[:n].clone(), t["layers"])}
           for t in (params, qstate)]
    return (*cut, dataclasses.replace(cfg, n_layers=n))


def slice_phase(dev, cases):
    from repro_torch.configs import get
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import TransformerLM
    from repro_torch.serving import (Engine, Request, generate,
                                     kv_bytes_per_token, packed_nbytes)
    from repro_torch.serving.packed import pack_for_serving

    cfg = get("qwen2-0.5b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
           cfg.vocab) == (24, 896, 14, 2, 4864, 151936), "not qwen2-0.5b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params, qstate, cfg = lm_first_layers(
        *TransformerLM.init(gen, cfg, device=dev), cfg, QWEN_SERVE_LAYERS)
    torch.cuda.synchronize()
    print(f"[slice] qwen2-0.5b FULL init on the card, cut to "
          f"{cfg.n_layers} of 24 layers: {time.perf_counter() - t0:.2f} s",
          flush=True)
    plan = PrecisionPlan.from_file(
        str(ROOT / "examples" / "specs" / "plan_mixed_w4w8.json"))
    rng = np.random.default_rng(SEED)
    lens = [16, 256] + [int(n) for n in rng.integers(16, 257, 8)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in lens]
    max_new, max_len = 32, 1024
    configs = (("a", "packed plan_mixed_w4w8 (w4 MLP nibbles), kv_bits 8",
                plan, 8),
               ("b", "packed uniform int8, kv_bits 4", None, 4))
    total = {k: 0 for k in SERVING}
    report, tick_shapes_a = {}, None
    for tag, desc, pl, kv_bits in configs:
        torch.cuda.reset_peak_memory_stats()
        eng = api_engine(serving_spec("qwen2-0.5b", pl, kv_bits), params,
                         qstate, dev, max_len, kv_bits, cfg=cfg)
        check(eng.slots == 8, f"({tag}) {eng.slots} slots")
        reqs = [Request(prompt=list(pr), max_new=max_new) for pr in prompts]
        torch.cuda.synchronize()
        unpacks = [0]
        _reset_counts()                       # the main path starts here
        t0 = time.perf_counter()
        with _counting_unpacks(unpacks):
            tick_ms, tick_shapes, _ = _serve(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(SERVING)             # ... and ends here
        if tag == "a":
            # the MLP's nibbles stream into qmatmul as they are stored
            check(unpacks[0] == 0, f"(a) {unpacks[0]} unpack_nibbles calls "
                                   f"while serving")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for k in total:
            total[k] += counts[k]
        check(all(c > 0 for c in counts.values()),
              f"({tag}) a kernel was never launched: {counts}")
        check(tick_shapes is not None, f"({tag}) no tick had every slot busy")
        per_tick = {k: sum(c.values()) for k, c in tick_shapes.items()}
        check(all(n > 0 for n in per_tick.values()),
              f"({tag}) a kernel was not launched in a full tick: {per_tick}")
        # the store: one launch a layer, and no separate quantize launch
        rows_launches = _counts(("kv_quantize_rows",))["kv_quantize_rows"]
        check(per_tick["kv_quantize_store"] == cfg.n_layers
              and rows_launches == 0,
              f"({tag}) {per_tick['kv_quantize_store']} kv_quantize_store "
              f"launches in a full tick for {cfg.n_layers} layers, "
              f"{rows_launches} kv_quantize_rows launches while serving")
        if tag == "a":
            tick_shapes_a = tick_shapes
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 8)
        for key in tick_shapes["kv_quantize_store"]:
            if key not in cases["kv_quantize_store"]:
                cases["kv_quantize_store"][key] = kv_store_case(
                    key, cfg.window is not None, dev, g)
        check(all(r.done and len(r.out) == max_new for r in reqs),
              f"({tag}) not every request finished")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
              f"({tag}) token out of range")
        for i in (0, len(reqs) - 1):           # first admitted, last joiner
            ref = generate(TransformerLM, params, qstate, cfg, [prompts[i]],
                           max_new, cache_len=max_len, packed=True, plan=pl,
                           kv_bits=kv_bits, device=dev)
            check(ref[0].tolist() == reqs[i].out,
                  f"({tag}) Engine != generate() for request {i}")
        pp, qq = pack_for_serving(params, qstate, pl)
        logits = _logits_vs_plain(pp, qq, cfg, kv_bits, dev,
                                  _dense_controls)
        full, cont = logits["full"], logits["continuous"]
        print(f"[slice] ({tag}) card vs CPU logits: {json.dumps(logits)} "
              f"(limits: full {LOGITS_REL_GROSS}, continuous "
              f"{LOGITS_REL_LIMIT})", flush=True)
        check(full["rel_l2"] <= LOGITS_REL_GROSS,
              f"({tag}) card vs CPU logits rel L2 {full['rel_l2']}")
        check(cont["rel_l2"] <= LOGITS_REL_LIMIT,
              f"({tag}) card vs CPU logits without activation quantizers: "
              f"rel L2 {cont['rel_l2']}")
        check(cont["argmax_agree"] == 1.0,
              f"({tag}) card vs CPU argmax without activation quantizers: "
              f"{cont['argmax_agree']}")
        check(all(c > LOGITS_REL_LIMIT for c in cont["controls"].values()),
              f"({tag}) the logits check misses a control: {cont}")
        toks = sum(len(r.out) for r in reqs)
        med = float(np.median(tick_ms))
        report[tag] = {
            "config": desc, "requests": len(reqs),
            "prompt_tokens": sum(lens), "new_tokens": toks,
            "decode_tick_ms_median": med, "ticks": len(tick_ms),
            "tokens_per_s": toks / wall, "wall_s": wall,
            "peak_mem_gib": peak, "packed_weight_bytes": packed_nbytes(eng.p),
            "kv_bytes_per_token": kv_bytes_per_token(cfg.n_kv, cfg.hd,
                                                     cfg.n_layers, kv_bits),
            "launches": counts, "launches_per_full_tick": per_tick,
            "unpack_nibbles_calls": unpacks[0],
            "logits_vs_cpu": logits}
        print(f"[slice] ({tag}) {desc}: {len(reqs)} requests, prompts "
              f"{min(lens)}-{max(lens)} tokens, {toks} new tokens in "
              f"{wall:.2f} s = {toks / wall:.1f} tok/s; decode tick median "
              f"{med:.2f} ms over {len(tick_ms)} ticks; peak memory "
              f"{peak:.2f} GiB; packed weights "
              f"{report[tag]['packed_weight_bytes'] / 1e6:.1f} MB; KV "
              f"{report[tag]['kv_bytes_per_token']} B/token; launches "
              f"{counts}; per full tick {per_tick}; Engine == generate() "
              f"on requests 0 and {len(reqs) - 1}", flush=True)
        del eng
    lap("serve: qwen2-0.5b")
    granite_total, report["granite"], granite_ticks, granite_profile = \
        granite_serving(dev, cases)
    griffin_total, report["griffin"], griffin_ticks, griffin_profile = \
        griffin_serving(dev, cases)
    rwkv_total, report["rwkv"], rwkv_ticks, rwkv_profile = \
        rwkv_serving(dev, cases)
    (whisper_total, report["whisper"], whisper_ticks, whisper_profile,
     whisper_append) = whisper_serving(dev, cases)
    api_total, report["api"], llama_ticks, api_profile = api_serving(dev)
    lap("serve: every family served")
    for k in total:
        total[k] += granite_total[k] + griffin_total[k] + rwkv_total[k] \
            + whisper_total[k] + api_total[k]
    # profiled only now, after every timed run
    for tag, desc, pl, kv_bits in configs:
        _read_profiled_tick(tag, cfg, report[tag], _profile_full_tick(
            Engine, Request, TransformerLM, params, qstate, cfg, pl, kv_bits,
            prompts, dev))
    granite_profile()
    griffin_profile()
    rwkv_profile()
    whisper_profile()
    api_profile()
    return (total, report, tick_shapes_a, granite_ticks, griffin_ticks,
            rwkv_ticks, whisper_ticks, whisper_append, llama_ticks)


def _read_profiled_tick(tag, cfg, entry, profiled, unpacks=0, n_attn=None,
                        min_blocks=128):
    """Check one profiled full tick and record it in ``entry``: every
    attention layer's (``n_attn``, every layer by default)
    ``kv_attention_rows`` launch ran at least ``min_blocks`` blocks, and the
    tick holds no operation of a KV store outside its kernel (a stack, an
    ``index_put``, a bitwise and / or) but the one ``aten::stack`` each of
    the tick's ``unpacks`` (``unpack_nibbles`` calls) makes."""
    ops, busy, grids, names = profiled
    stray = _store_ops(names)
    stacks = stray.pop("aten::stack", 0)
    check(not stray and stacks == unpacks,
          f"({tag}) the profiled tick holds operations of a KV store outside "
          f"its kernel: {stray}, {stacks} aten::stack for {unpacks} "
          f"unpack_nibbles calls")
    med = entry["decode_tick_ms_median"]
    blocks = sorted({math.prod(gr) for gr in grids})
    n_attn = cfg.n_layers if n_attn is None else n_attn
    check(len(grids) == n_attn and all(b >= min_blocks for b in blocks),
          f"({tag}) the profiled tick's kv_attention_rows launches: "
          f"{len(grids)} of {n_attn}, blocks {blocks}, fewer than "
          f"{min_blocks}")
    entry["profiled_full_tick"] = {
        "device_ops": ops, "device_busy_ms": busy,
        "idle_share_of_median_tick": 1.0 - busy / med,
        "attention_grids": sorted(set(grids)),
        "kv_store_kernels": sum(n for k, n in names.items()
                                if "kv_store_kernel" in k),
        "stack_index_put_bitwise_ops": stray, "unpack_stacks": stacks}
    print(f"[slice] ({tag}) {cfg.name} profiled full tick: {ops} device "
          f"operations, device busy {busy:.2f} ms, idle "
          f"{1.0 - busy / med:.1%} of the median tick; kv_attention_rows "
          f"grids {sorted(set(grids))}", flush=True)


def _kv_tick(H, KV, hd, W, kv_bits, n):
    """One full tick's KV launches by shape: ``n`` attention layers, each
    one ``kv_quantize_store`` and one ``kv_attention_rows`` over a ring of
    ``W`` slots (float32 activations, 8 slots)."""
    hdm = hd // 2 if kv_bits == 4 else hd
    return {"kv_quantize_store": {(8, 1, KV, hd, W, hdm, kv_bits,
                                   "float32"): n},
            "kv_attention_rows": {(8, 1, H, KV, hd, W, hdm): n}}


def _serve_family(name, model, params, qstate, cfg, dev, cases, configs,
                  want, controls, logits_cut, *, max_len, long_prompt=0,
                  unpacks_per_tick=lambda pl: 0, ring=None, n_attn=None,
                  min_blocks=128, store_window=False, engine=None,
                  lm_lens=None, audio=None, alone=None, after=None,
                  prepare=None, kv_layers=None, ring_field="k",
                  sound=None):
    """Serve one family through ``Engine`` as the qwen2 part serves it (8
    slots, chunks of 16, 10 greedy requests of 16-256 prompt tokens and 32
    new ones, and in configuration (a) one more of ``long_prompt`` tokens
    if given), in each of ``configs`` ((tag, description, plan,
    kv_bits)).  Checks: every request finishes with tokens in range; each
    equals itself served alone by an engine of the same geometry over the
    same packed tree (``generate()`` prefills a whole prompt at once);
    one full tick's launches by shape equal ``want(plan, kv_bits)`` ({kernel
    of ``SERVING``: {shape: launches}}), and a kernel is launched while
    serving if and only if it is wanted; no ``kv_quantize_rows`` launch;
    ``unpacks_per_tick(plan)`` ``unpack_nibbles`` calls in the full tick
    (none at all while serving if that is 0); card vs CPU logits on
    ``logits_cut(packed params, packed qstate)`` (its params, qstate and
    config) within the dense limits, which every one of ``controls``
    exceeds.  ``ring``: the KV ring's slots (the caches' field
    ``ring_field``), checked; ``store_window``: whether the store's timed
    cases are windowed (``kv_store_case``); ``n_attn``, ``min_blocks``:
    the profiled tick's attention launches (``_read_profiled_tick``);
    ``kv_layers``: the layers of the self ring (``n_attn`` by default).

    An encoder-decoder widens it: ``engine`` (the engine class or a
    factory taking its arguments; ``Engine`` by default), ``lm_lens`` (the
    LM prompts' lengths, 10 of 16-256 by default), ``audio(tag)`` (fresh
    audio requests served beside the LM ones, interleaved with them),
    ``alone(packed params, packed qstate, kv_bits, request)`` (a request's
    tokens served alone; the LM ones default to a plain ``Engine``),
    ``after(tag, engine, requests, plan, kv_bits)`` (checks of the served
    engine, returning report fields), ``prepare`` (``_logits_vs_plain``'s),
    ``sound(packed params, packed qstate, config, kv_bits)`` (the card vs
    CPU reading without the grids whose ties the continuous reading keeps,
    ``_logits_vs_plain``'s continuous witness, gated beside it: under
    ``LOGITS_REL_LIMIT`` with every control above it).
    Returns (launch counts, report, configuration (a)'s full tick by
    shape, a function that profiles one full tick of each configuration,
    to be called after every timed run)."""
    from repro_torch.serving import (Engine, Request, kv_bytes_per_token,
                                     packed_nbytes)
    from repro_torch.serving.packed import pack_for_serving

    make_engine = engine or Engine
    rng = np.random.default_rng(SEED)
    lens = [16, 256] + [int(n) for n in rng.integers(16, 257, 8)] \
        if lm_lens is None else list(lm_lens)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in lens]
    extra = [[int(t) for t in rng.integers(0, cfg.vocab, long_prompt)]] \
        if long_prompt else []
    max_new = 32
    n_kv = cfg.n_layers if n_attn is None else n_attn
    kv_layers = n_kv if kv_layers is None else kv_layers
    t_part = time.perf_counter()
    total = {k: 0 for k in SERVING}
    report, tick_shapes_a = {}, None
    for tag, desc, pl, kv_bits in configs:
        wanted = want(pl, kv_bits)
        want_unpacks = unpacks_per_tick(pl)
        tprompts = prompts + (extra if tag == "a" else [])
        torch.cuda.reset_peak_memory_stats()
        eng = make_engine(model, params, qstate, cfg, batch_slots=8,
                          max_len=max_len, prefill_chunk=16, packed=True,
                          plan=pl, kv_bits=kv_bits, seed=SEED, device=dev)
        if ring is not None:
            W = getattr(eng.caches, ring_field).shape[2]
            check(W == ring, f"({name} {tag}) a ring of {W} slots, not "
                             f"{ring}")
        lm = [Request(prompt=list(pr), max_new=max_new) for pr in tprompts]
        aud = audio(tag) if audio is not None else []
        # audio requests first, each beside an LM request, then the rest
        reqs = [r for pair in zip(aud, lm) for r in pair] \
            + aud[len(lm):] + lm[len(aud):]
        torch.cuda.synchronize()
        unpacks = [0]
        _reset_counts()                       # the main path starts here
        t0 = time.perf_counter()
        with _counting_unpacks(unpacks):
            tick_ms, tick_shapes, tick_unpacks = _serve(eng, reqs, unpacks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(SERVING)             # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        nbytes = packed_nbytes(eng.p)
        cache_bytes = sum(c.numel() * c.element_size() for c in eng.caches
                          if c is not None)
        extra_report = {} if after is None else after(tag, eng, reqs, pl,
                                                      kv_bits)
        del eng
        for k in total:
            total[k] += counts[k]
        check(all((counts[k] > 0) == bool(wanted[k]) for k in SERVING),
              f"({name} {tag}) launches while serving: {counts}, want "
              f"{sorted(k for k in SERVING if wanted[k])} and no other")
        check(tick_shapes is not None,
              f"({name} {tag}) no tick had every slot busy")
        per_tick = {k: sum(c.values()) for k, c in tick_shapes.items()}
        rows_launches = _counts(("kv_quantize_rows",))["kv_quantize_rows"]
        check(all(dict(tick_shapes[k]) == wanted[k] for k in SERVING)
              and rows_launches == 0,
              f"({name} {tag}) one full tick's launches by shape: "
              f"{ {k: dict(c) for k, c in tick_shapes.items()} }, want "
              f"{wanted}, {rows_launches} kv_quantize_rows launches while "
              f"serving")
        check(tick_unpacks == want_unpacks
              and (want_unpacks > 0 or unpacks[0] == 0),
              f"({name} {tag}) {tick_unpacks} unpack_nibbles calls in a "
              f"full tick (want {want_unpacks}), {unpacks[0]} while serving")
        if tag == "a":
            tick_shapes_a = tick_shapes
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 8)
        for key in tick_shapes["kv_quantize_store"]:
            if key not in cases["kv_quantize_store"]:
                cases["kv_quantize_store"][key] = kv_store_case(
                    key, store_window, dev, g)
        check(all(r.done and len(r.out) == r.max_new for r in reqs),
              f"({name} {tag}) not every request finished")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
              f"({name} {tag}) token out of range")
        # each request alone, on an engine of the same geometry over the
        # same packed tree
        pp, qq = pack_for_serving(params, qstate, pl)
        t0 = time.perf_counter()
        apart = []
        for i, r in enumerate(reqs):
            if isinstance(r, Request):
                one = Request(prompt=list(r.prompt), max_new=r.max_new)
                Engine(model, pp, qq, cfg, batch_slots=8, max_len=max_len,
                       prefill_chunk=16, kv_bits=kv_bits, seed=SEED,
                       device=dev).run([one])
                out = one.out
            else:
                out = alone(pp, qq, kv_bits, r)
            if out != r.out:
                apart.append(i)
        alone_s = time.perf_counter() - t0
        check(not apart, f"({name} {tag}) requests {apart} served alone "
                         f"give other tokens than in the batch")
        t0 = time.perf_counter()
        pc, qc, cfg_cut = logits_cut(pp, qq)
        logits = _logits_vs_plain(pc, qc, cfg_cut, kv_bits, dev, controls,
                                  model=model, prepare=prepare)
        if sound is not None:
            logits["sound"] = sound(pc, qc, cfg_cut, kv_bits)
        logits_s = time.perf_counter() - t0
        del pp, qq, pc, qc
        full, cont = logits["full"], logits["continuous"]
        print(f"[{name}] ({tag}) card vs CPU logits at {cfg_cut.n_layers} "
              f"layers: {json.dumps(logits)} (limits: full "
              f"{LOGITS_REL_GROSS}, continuous {LOGITS_REL_LIMIT})",
              flush=True)
        check(full["rel_l2"] <= LOGITS_REL_GROSS,
              f"({name} {tag}) card vs CPU logits rel L2 {full['rel_l2']}")
        check(cont["rel_l2"] <= LOGITS_REL_LIMIT
              and cont["argmax_agree"] == 1.0,
              f"({name} {tag}) card vs CPU logits without activation "
              f"quantizers: {cont}")
        check(all(c > LOGITS_REL_LIMIT for c in cont["controls"].values()),
              f"({name} {tag}) the logits check misses a control: {cont}")
        if sound is not None:
            snd = logits["sound"]
            check(snd["rel_l2"] <= LOGITS_REL_LIMIT
                  and snd["argmax_agree"] == 1.0,
                  f"({name} {tag}) card vs CPU logits without the grids' "
                  f"ties: {snd}")
            check(all(c > LOGITS_REL_LIMIT
                      for c in snd["controls"].values()),
                  f"({name} {tag}) the sound logits check misses a "
                  f"control: {snd}")
        toks = sum(len(r.out) for r in reqs)
        med = float(np.median(tick_ms))
        plens = [len(r.prompt) for r in reqs]
        report[tag] = {
            "config": desc, "requests": len(reqs),
            "prompt_tokens": sum(plens), "new_tokens": toks,
            "decode_tick_ms_median": med, "ticks": len(tick_ms),
            "tokens_per_s": toks / wall, "wall_s": wall,
            "peak_mem_gib": peak, "packed_weight_bytes": nbytes,
            "cache_bytes": cache_bytes, "launches": counts,
            "launches_per_full_tick": per_tick,
            "unpack_nibbles_per_full_tick": tick_unpacks,
            "alone_runs_s": alone_s, "logits_s": logits_s,
            "logits_vs_cpu": logits, **extra_report}
        if kv_layers:
            report[tag]["kv_bytes_per_token"] = kv_bytes_per_token(
                cfg.n_kv, cfg.hd, kv_layers, kv_bits)
        print(f"[{name}] ({tag}) {desc}: {len(reqs)} requests, prompts "
              f"{min(plens)}-{max(plens)} tokens, {toks} new tokens in "
              f"{wall:.2f} s = {toks / wall:.1f} tok/s; decode tick median "
              f"{med:.2f} ms over {len(tick_ms)} ticks; peak memory "
              f"{peak:.2f} GiB; packed weights {nbytes / 1e6:.1f} MB; "
              f"caches {cache_bytes / 1e6:.1f} MB; launches {counts}; per "
              f"full tick {per_tick}, {tick_unpacks} unpack_nibbles calls; "
              f"every request equal alone ({alone_s:.1f} s); card vs CPU "
              f"in {logits_s:.1f} s", flush=True)

    part_s = time.perf_counter() - t_part
    report["part_s"] = part_s
    print(f"[{name}] served, checked alone and against the CPU in "
          f"{part_s:.1f} s", flush=True)

    def profile():
        t0 = time.perf_counter()
        for tag, desc, pl, kv_bits in configs:
            unpacks, by_name = [0], {}
            with _counting_unpacks(unpacks):
                profiled = _profile_full_tick(
                    make_engine, Request, model, params, qstate, cfg, pl,
                    kv_bits, prompts, dev, unpacks=unpacks,
                    device_ms=by_name, max_len=max_len)
            _read_profiled_tick(f"{name} {tag}", cfg, report[tag], profiled,
                                unpacks=unpacks[0], n_attn=n_attn,
                                min_blocks=min_blocks)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
            report[tag]["profiled_full_tick"]["top_device_ms"] = top
            print(f"[{name}] ({tag}) the profiled tick's device ms by "
                  f"operation: " + "; ".join(f"{n[:60]} {ms:.3f}"
                                             for n, ms in top), flush=True)
        print(f"[{name}] profiled in {time.perf_counter() - t0:.1f} s",
              flush=True)

    return total, report, tick_shapes_a, profile


def _first_layers(pp, qq, cfg, key, n, n_layers):
    """A ``logits_cut`` of ``_serve_family``: the first ``n`` entries of
    the stacked subtree ``key`` of the packed tree (``pp``, ``qq``), and
    ``cfg`` at ``n_layers`` layers."""
    from repro_torch.tree import tree_map
    return ({**pp, key: tree_map(lambda a: a[:n], pp[key])},
            {**qq, key: tree_map(lambda a: a[:n], qq[key])},
            dataclasses.replace(cfg, n_layers=n_layers))


# Card logits against the CPU at granite's full width and this many of its
# layers (the first ones of the served tree): the CPU side then takes a
# few seconds a run.  The limits are the dense model's (readings in
# PERF.md); its controls are MoE faults (``_moe_controls``).
GRANITE_LOGITS_LAYERS = 2
# granite is served at this many of its 32 layers, at its published widths
# (earlier runs held all 32, PERF.md §4): the cut pays for the Griffin part
# within the script's time; its tallies scale with the layers
GRANITE_SERVE_LAYERS = 2
GRANITE_EXPERTS = ("layers/moe/gate", "layers/moe/up", "layers/moe/down")


def granite_serving(dev, cases):
    """granite-moe-3b-a800m at its published widths and
    ``GRANITE_SERVE_LAYERS`` of its 32 layers (random weights from the
    seed) through ``_serve_family``, a 1024-slot ring, in two
    configurations: (a) packed uniform int8, ``kv_bits`` 8; (b) a plan
    with the expert stacks in nibbles (4 bits), the rest int8, ``kv_bits``
    4.  One full tick: 5 ``qmatmul`` a layer (q, k, v, o and the router)
    and the head, one ``kv_quantize_store`` and one ``kv_attention_rows``
    a layer, and the three expert stacks' ``unpack_nibbles`` calls a
    layer in (b), none in (a) (no ``qmatmul`` weight is unpacked).  Card
    vs CPU at ``GRANITE_LOGITS_LAYERS`` layers, against the two MoE
    controls."""
    from repro_torch.configs import get
    from repro_torch.core.plan import LayerPlan, PrecisionPlan
    from repro_torch.models import TransformerLM, model_for

    G = GRANITE
    cfg = get("granite-moe-3b-a800m")
    check(model_for(cfg) is TransformerLM
          and (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
               cfg.d_ff, cfg.moe_experts, cfg.moe_top_k, cfg.vocab)
          == tuple(G[k] for k in ("L", "d", "H", "KV", "hd", "ff", "E", "k",
                                  "V")), "not granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, n_layers=GRANITE_SERVE_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params, qstate = TransformerLM.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"[granite] granite-moe-3b-a800m init on the card at "
          f"{cfg.n_layers} of its {G['L']} layers: "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{cfg.n_params() / 1e9:.2f} B parameters", flush=True)
    plan = PrecisionPlan(layers={k: LayerPlan(wire_bits=4, pack_bits=4)
                                 for k in GRANITE_EXPERTS})
    L, max_len, d = cfg.n_layers, 1024, G["d"]

    def want(pl, kv_bits):
        return {"qmatmul": {(8, d, d, 8): 2 * L,                 # q, o
                            (8, d, G["KV"] * G["hd"], 8): 2 * L,  # k, v
                            (8, d, G["E"], 8): L,                 # router
                            (8, d, G["V"], 8): 1},                # the head
                **_kv_tick(G["H"], G["KV"], G["hd"], max_len, kv_bits, L)}

    cut = GRANITE_LOGITS_LAYERS
    return _serve_family(
        "granite", TransformerLM, params, qstate, cfg, dev, cases,
        (("a", "packed uniform int8, kv_bits 8", None, 8),
         ("b", "packed plan: layers/moe/{gate,up,down} in nibbles (4 bits), "
               "the rest int8; kv_bits 4", plan, 4)),
        want, _moe_controls,
        lambda pp, qq: _first_layers(pp, qq, cfg, "layers", cut, cut),
        max_len=max_len, unpacks_per_tick=lambda pl: 0 if pl is None
        else 3 * L)


# Card logits against the CPU at recurrentgemma-2b's full width and 5 of its
# layers (the first unit and the 2 remainder layers of the served tree), within
# the dense limits, which two Griffin faults (``_griffin_controls``) exceed.
GRIFFIN_LOGITS_UNITS = 1
GRIFFIN_MLP = ("units/rec1/mlp", "units/rec2/mlp", "units/att/mlp",
               "rem/0/mlp", "rem/1/mlp")
# configuration (a)'s extra request: a prompt longer than the 2064-slot ring,
# so that its decode reads a ring that has wrapped past the window
GRIFFIN_LONG_PROMPT = 2100
GRIFFIN_MAX_LEN = 4096
# recurrentgemma-2b is served at this many of its 8 (rec, rec, att) units
# and its 2 remainder layers (5 of 26 layers, those card vs CPU reads), at
# its published widths (earlier runs held all 26, PERF.md §4): the cut pays
# for the RWKV and Whisper parts within the script's time; its tallies
# scale with the layers
GRIFFIN_SERVE_UNITS = 1


def _griffin_controls(pc):
    """The RG-LRU without its ``sqrt(1 - a^2)`` input normalization; the
    conv's history not carried from one call to the next (zeros)."""
    import repro_torch.nn.recurrent as rec
    return {"rglru_without_input_norm": (
                pc, lambda: _patched(rec, "input_norm",
                                     lambda real: lambda la:
                                     torch.ones_like(la))),
            "conv_state_not_carried": (
                pc, lambda: _patched(rec, "conv_history",
                                     lambda real: lambda st, x, cw:
                                     real(None, x, cw)))}


def griffin_serving(dev, cases):
    """recurrentgemma-2b at its published widths and
    ``GRIFFIN_SERVE_UNITS`` of its units with its 2 remainder layers
    (random weights from the seed) through ``_serve_family``, ``max_len``
    4096 (a ring of window + chunk = 2064 slots), in two configurations:
    (a) packed uniform int8, ``kv_bits`` 8, and one more request of a
    2100-token prompt, whose decode reads a ring wrapped past the window;
    (b) every MLP kernel in nibbles, the rest int8, ``kv_bits`` 4 (a
    nibble ring at hd 256).  One full tick at 1 unit: 40 ``qmatmul``, 1
    ``kv_quantize_store`` and 1 ``kv_attention_rows`` at hd 256, and no
    ``unpack_nibbles`` call.  Card vs CPU at 5 layers, against the two
    Griffin controls."""
    from repro_torch.configs import get
    from repro_torch.core.plan import LayerPlan, PrecisionPlan
    from repro_torch.models import GriffinLM, model_for

    Gf = GRIFFIN
    cfg = get("recurrentgemma-2b")
    check(model_for(cfg) is GriffinLM
          and (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
               cfg.d_ff, cfg.vocab, cfg.window)
          == tuple(Gf[k] for k in ("L", "d", "H", "KV", "hd", "ff", "V",
                                   "window")), "not recurrentgemma-2b")
    units = GRIFFIN_SERVE_UNITS
    cfg = dataclasses.replace(cfg, n_layers=3 * units + Gf["rem"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params, qstate = GriffinLM.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"[griffin] recurrentgemma-2b init on the card at {units} of its "
          f"{Gf['units']} units and its {Gf['rem']} remainder layers "
          f"({cfg.n_layers} of {Gf['L']} layers): "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{cfg.n_params() / 1e9:.2f} B parameters", flush=True)
    plan = PrecisionPlan(layers={k: LayerPlan(wire_bits=4, pack_bits=4)
                                 for k in GRIFFIN_MLP})
    n_rec, n_att = 2 * units + Gf["rem"], units
    hd, d, ff = Gf["hd"], Gf["d"], Gf["ff"]

    def want(pl, kv_bits):
        mlp_bits = 8 if pl is None else 4
        return {"qmatmul": {(8, d, d, 8): 5 * n_rec + 2 * n_att,
                            (8, d, Gf["KV"] * hd, 8): 2 * n_att,
                            (8, d, ff, mlp_bits): 2 * cfg.n_layers,
                            (8, ff, d, mlp_bits): cfg.n_layers,
                            (8, d, Gf["V"], 8): 1},
                **_kv_tick(Gf["H"], Gf["KV"], hd, Gf["W"], kv_bits, n_att)}

    cut = GRIFFIN_LOGITS_UNITS
    return _serve_family(
        "griffin", GriffinLM, params, qstate, cfg, dev, cases,
        (("a", "packed uniform int8, kv_bits 8, and one request of a "
               f"{GRIFFIN_LONG_PROMPT}-token prompt", None, 8),
         ("b", "packed plan: every MLP kernel in nibbles (4 bits), the rest "
               "int8; kv_bits 4", plan, 4)),
        want, _griffin_controls,
        lambda pp, qq: _first_layers(pp, qq, cfg, "units", cut,
                                     3 * cut + Gf["rem"]),
        max_len=GRIFFIN_MAX_LEN, long_prompt=GRIFFIN_LONG_PROMPT,
        ring=Gf["W"], n_attn=n_att, store_window=True,
        # one cluster of 8 blocks a batch row: B = 8 rows of KV = 1
        min_blocks=64)


# Card logits against the CPU at rwkv6-1.6b's full width and this many of its
# layers (the first ones of the served tree), within the dense limits, which
# three RWKV faults (``_rwkv_controls``) exceed.
RWKV_LOGITS_LAYERS = 2
RWKV_FFN = ("layers/ffn",)
# configuration (a)'s extra request: 64 prefill chunks of state carried
# through one slot
RWKV_LONG_PROMPT = 1024
RWKV_MAX_LEN = 2048
# rwkv6-1.6b is served at this many of its 24 layers (those card vs CPU
# reads), at its published widths (earlier runs held all 24, PERF.md §4;
# 4 in PRs 23-25): the cut pays for the Whisper part and the script's
# time; its tallies scale with the layers
RWKV_SERVE_LAYERS = 2


def rwkv_constants(params, gen):
    """Redraw in place the leaves the reference's init leaves constant
    (``mu`` 0.5, ``bonus_u`` 0, ``decay_w0`` -4, ``ln_scale`` 1), which
    would hide a swapped row or a missing term: ``mu`` in [0, 1],
    ``bonus_u`` ~ N(0, 0.5), ``decay_w0`` in [-6, -1], ``ln_scale`` in
    [0.5, 1.5], from ``gen``."""
    att, ffn = params["layers"]["att"], params["layers"]["ffn"]
    att["mu"].uniform_(0.0, 1.0, generator=gen)
    ffn["mu"].uniform_(0.0, 1.0, generator=gen)
    att["bonus_u"].normal_(0.0, 0.5, generator=gen)
    att["decay_w0"].uniform_(-6.0, -1.0, generator=gen)
    att["ln_scale"].uniform_(0.5, 1.5, generator=gen)


@contextlib.contextmanager
def _shift_from_residual():
    """Control: each layer carries the last row of its residual stream (the
    input of ``ln1``) as its time-mix token shift, not the last row of the
    normed input the time mix read."""
    import repro_torch.models.rwkv as rw
    ln, tm = rw.LayerNorm, rw.RWKVTimeMix
    seen = {}

    class LayerNorm:
        @staticmethod
        def apply(p, q, x, **kw):
            seen["x"] = x
            return ln.apply(p, q, x, **kw)

    class RWKVTimeMix:
        @staticmethod
        def apply(p, q, x, state, **kw):
            out, nq, (_, wkv) = tm.apply(p, q, x, state, **kw)
            return out, nq, (seen["x"][:, -1], wkv)

    with _patched(rw, "LayerNorm", lambda real: LayerNorm), \
            _patched(rw, "RWKVTimeMix", lambda real: RWKVTimeMix):
        yield


def _rwkv_controls(pc):
    """The WKV state not carried from one call to the next (zeros); the
    token shift taken from the residual stream; the per-head norm left
    out."""
    import repro_torch.nn.recurrent as rec
    return {"wkv_state_not_carried": (
                pc, lambda: _patched(rec, "_wkv_chunked",
                                     lambda real: lambda r, k, v, w, u, s, c:
                                     real(r, k, v, w, u, torch.zeros_like(s),
                                          c))),
            "token_shift_from_residual": (pc, _shift_from_residual),
            "head_norm_left_out": (
                pc, lambda: _patched(rec, "head_norm",
                                     lambda real: lambda y: y))}


def rwkv_serving(dev, cases):
    """rwkv6-1.6b at its published widths and ``RWKV_SERVE_LAYERS`` of its
    24 layers (random weights from the seed, the constants of the
    reference's init redrawn: ``rwkv_constants``) through
    ``_serve_family``, ``max_len`` 2048, in two configurations: (a)
    packed uniform int8 and one more request of a 1024-token prompt (64
    chunks of state carried through one slot); (b) every channel-mix
    kernel in nibbles, the rest int8 (``kv_bits`` None: the model holds no
    KV).  One full tick at 2 layers: 17 ``qmatmul`` (12 of 2048 x 2048, 2
    each way between 2048 and 7168, the head), no ``kv_quantize_store`` or
    ``kv_attention_rows`` launch and no ``unpack_nibbles`` call.  Card vs
    CPU at ``RWKV_LOGITS_LAYERS`` layers, against the three RWKV
    controls."""
    from repro_torch.configs import get
    from repro_torch.core.plan import LayerPlan, PrecisionPlan
    from repro_torch.models import RWKVLM, model_for

    R = RWKV
    cfg = get("rwkv6-1.6b")
    check(model_for(cfg) is RWKVLM
          and (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab, cfg.norm)
          == tuple(R[k] for k in ("L", "d", "ff", "V", "norm")),
          "not rwkv6-1.6b")
    cfg = dataclasses.replace(cfg, n_layers=RWKV_SERVE_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params, qstate = RWKVLM.init(gen, cfg, device=dev)
    rwkv_constants(params, gen)
    torch.cuda.synchronize()
    print(f"[rwkv] rwkv6-1.6b init on the card at {cfg.n_layers} of its "
          f"{R['L']} layers: {time.perf_counter() - t0:.2f} s, "
          f"{cfg.n_params() / 1e9:.3f} B parameters", flush=True)
    plan = PrecisionPlan(layers={k: LayerPlan(wire_bits=4, pack_bits=4)
                                 for k in RWKV_FFN})
    L, d, ff, V = cfg.n_layers, R["d"], R["ff"], R["V"]

    def want(pl, kv_bits):
        fb = 8 if pl is None else 4
        # time mix r, k, v, g, o and the channel mix's r; its k and v; the
        # head (the decay LoRA is a float64 matmul, no qmatmul)
        w = {(8, d, d, 8): 5 * L + (L if fb == 8 else 0),
             (8, d, ff, fb): L, (8, ff, d, fb): L, (8, d, V, 8): 1}
        if fb == 4:
            w[8, d, d, 4] = L
        return {"qmatmul": w, "kv_quantize_store": {},
                "kv_attention_rows": {}}

    cut = RWKV_LOGITS_LAYERS
    return _serve_family(
        "rwkv", RWKVLM, params, qstate, cfg, dev, cases,
        (("a", "packed uniform int8, and one request of a "
               f"{RWKV_LONG_PROMPT}-token prompt", None, None),
         ("b", "packed plan: every channel-mix kernel (layers/ffn) in "
               "nibbles (4 bits), the rest int8", plan, None)),
        want, _rwkv_controls,
        lambda pp, qq: _first_layers(pp, qq, cfg, "layers", cut, cut),
        max_len=RWKV_MAX_LEN, long_prompt=RWKV_LONG_PROMPT, n_attn=0)


# Card logits against the CPU at whisper-large-v3's full width and this many
# of its encoder and of its decoder layers (the first ones of the served
# tree), after a 1500-frame audio appended in chunks of 250, within the
# dense limits, which three Whisper faults (``_whisper_controls``) exceed.
WHISPER_LOGITS_LAYERS = 2
# whisper-large-v3 is served at the first this many of its 32 encoder and
# of its 32 decoder layers, at its published widths (all 32 + 32 were held
# in earlier runs, PERF.md §4): the cut pays for the api part and (2, 4
# before) the analysis phase within the script's time; its tallies scale
# with the layers.  The layers are cut
# from the full model's init (``whisper_first_layers``)
WHISPER_SERVE_LAYERS = 2
WHISPER_MLP = ("enc_layers/mlp", "dec_layers/mlp")
# the audio requests' frames (1037 leaves power-of-two tails of 32, 4 and
# 1), each with a decoder prompt of 4 tokens; the LM requests' prompts
WHISPER_AUDIO = (1500, 1500, 1200, 1037, 750, 300)
WHISPER_PROMPT = 4
WHISPER_LM = 4


def _whisper_frames(n, seed):
    """Frame embeddings [n, d] from the seed, N(0, 1) x 0.3 as the
    reference's tests scale them."""
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((n, WHISPER["d"]))).astype(np.float32)


@contextlib.contextmanager
def _float32_cache():
    """Whisper's float cache and memory kept in float32 (bfloat16 by
    default, a grid of its own)."""
    from repro_torch.models import WhisperModel

    def f32(real):
        return lambda *a, **k: real(*a, **{**k, "dtype": torch.float32})

    with _patched_static(WhisperModel, "init_cache", f32):
        yield


def _without_probs_grid(tree):
    """The tree without the attention probabilities' grid (``probs_f``)."""
    if isinstance(tree, dict):
        return {k: _without_probs_grid(v) for k, v in tree.items()
                if k != "probs_f"}
    if isinstance(tree, list):
        return [_without_probs_grid(v) for v in tree]
    return tree


def _whisper_controls(pc):
    """The cross memory not appended (every row reads zero from it); each
    chunk encoded at offset 0 (its absolute positions dropped); the
    decoder's learned positions dropped."""
    import repro_torch.models.whisper as wh
    M = wh.WhisperModel

    def zeros(table, pos):
        return torch.zeros(tuple(pos.shape) + (table.shape[1],),
                           dtype=table.dtype, device=table.device)

    return {"cross_memory_not_appended": (
                pc, lambda: _patched_static(M, "append_cross",
                                            lambda real: lambda p, q, c, *a,
                                            **k: c)),
            "chunks_encoded_at_offset_0": (
                pc, lambda: _patched_static(M, "encode",
                                            lambda real: lambda *a, offset=0,
                                            **k: real(*a, **k))),
            "decoder_positions_dropped": (
                pc, lambda: _patched(wh, "decoder_positions",
                                     lambda real: zeros))}


def _cross_reads_zero(eng, frames, prompts):
    """On a served ``StreamingEngine``: 2 audio requests (``frames``) and 6
    LM requests (``prompts``) admitted, ticked until every slot decodes,
    then one mixed tick whose cross reads (``kv_attention_decode`` over the
    ``enc_seq``-slot memory) are recorded: every LM row (``mem_len`` 0)
    must read exact zeros in every decoder layer, every audio row not.
    Returns (layers read, LM rows, audio rows)."""
    import repro_torch.models.whisper as wh
    from repro_torch.serving import AudioRequest, Request
    reqs = [AudioRequest(frames=fr, prompt=list(range(1, WHISPER_PROMPT + 1)),
                         max_new=8) for fr in frames] + \
        [Request(prompt=list(pr[:16]), max_new=8) for pr in prompts]
    for r in reqs:
        check(eng.submit(r) is not None, "cross reads: no free slot")
    while any(r is None for r in eng.slot_req):
        eng.step()
    mem = eng.caches.mem_len[0].clone()
    seen = []

    def recording(real):
        def read(qh, km, *a, **k):
            out = real(qh, km, *a, **k)
            if km.shape[1] == eng.cfg.enc_seq:
                seen.append(out)
            return out
        return read

    with _patched(wh, "kv_attention_decode", recording):
        eng.step()
    lm_rows, audio_rows = mem == 0, mem > 0
    check(len(seen) == eng.cfg.n_layers,
          f"cross reads: {len(seen)} in a tick of {eng.cfg.n_layers} layers")
    check(int(lm_rows.sum()) == len(prompts)
          and int(audio_rows.sum()) == len(frames),
          f"cross reads: mem_len {mem.tolist()}")
    for i, out in enumerate(seen):
        check(torch.equal(out[lm_rows], torch.zeros_like(out[lm_rows])),
              f"cross reads: layer {i}: an LM row does not read exact zeros")
        check(bool((out[audio_rows] != 0).any(dim=-1).all()),
              f"cross reads: layer {i}: an audio row reads zero")
    return len(seen), int(lm_rows.sum()), int(audio_rows.sum())


def whisper_first_layers(params, qstate, cfg, n):
    """The first ``n`` encoder and ``n`` decoder layers of a Whisper tree
    (``params``, ``qstate``, as ``WhisperModel.init`` made them, copied)
    and ``cfg`` at that depth."""
    from repro_torch.tree import tree_map
    cut = [{**t, **{k: tree_map(lambda a: a[:n].clone(), t[k])
                    for k in ("enc_layers", "dec_layers")}}
           for t in (params, qstate)]
    return (*cut, dataclasses.replace(cfg, n_layers=n, enc_layers=n))


def whisper_serving(dev, cases):
    """whisper-large-v3 at its published widths and
    ``WHISPER_SERVE_LAYERS`` of its 32 encoder and of its 32 decoder layers
    (random weights from the seed) through ``StreamingEngine`` and
    ``_serve_family``: 8 slots, ``max_len`` 448, prompt chunks of 16,
    audio chunks of 250 frames; 6 audio requests (``WHISPER_AUDIO`` frames,
    4-token prompts) beside 4 LM requests of 16-64 prompt tokens, 32 new
    tokens each, greedy; in two configurations: (a) packed uniform int8,
    ``kv_bits`` 8; (b) every encoder and decoder MLP kernel in nibbles,
    the rest int8, ``kv_bits`` 4 (a nibble self ring and cross memory).
    Checks, besides ``_serve_family``'s: each audio request equals the
    port's ``generate_asr`` on the card (the same chunks and
    ``cache_len``), each LM request a plain ``Engine``; one full tick: 8
    ``qmatmul`` a decoder layer (self q, k, v, o, cross q, o, fc1, fc2; the
    head is a plain matmul over the dequantized table), one self-ring
    store, two ``kv_attention_rows`` (the 448-slot ring, the 1500-slot
    memory); one 250-frame append: 6 ``qmatmul`` an encoder layer and the
    cross k, v of every decoder layer at M 250, one ``kv_quantize_store``
    for all decoder layers' rows; no ``unpack_nibbles`` call; the cross memory's
    bytes the byte model's; in a mixed tick every LM row reads exact zeros
    from the memory; card vs CPU at 2 + 2 layers against the three Whisper
    controls, as served (the probabilities' and the cache rows' grids, whose
    ties move the reading with the draw) and sound (a float32 cache and
    memory, no probabilities' grid), each under ``LOGITS_REL_LIMIT`` with
    every control above it.  Returns ``_serve_family``'s four values and configuration
    (a)'s append by shape; its profile function profiles one full tick of
    each configuration and one append of configuration (a)."""
    from repro_torch.configs import get
    from repro_torch.core.plan import LayerPlan, PrecisionPlan
    from repro_torch.models import WhisperModel, model_for
    from repro_torch.serving import (AudioRequest, StreamingEngine,
                                     generate_asr,
                                     kv_cross_bytes_per_request, split_audio)
    from repro_torch.tree import tree_map

    Wh = WHISPER
    cfg = get("whisper-large-v3")
    check(model_for(cfg) is WhisperModel
          and (cfg.n_layers, cfg.enc_layers, cfg.d_model, cfg.n_heads,
               cfg.n_kv, cfg.hd, cfg.d_ff, cfg.vocab, cfg.enc_seq)
          == tuple(Wh[k] for k in ("L", "enc", "d", "H", "KV", "hd", "ff",
                                   "V", "T")), "not whisper-large-v3")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params, qstate, cfg = whisper_first_layers(
        *WhisperModel.init(gen, cfg, device=dev), cfg, WHISPER_SERVE_LAYERS)
    torch.cuda.synchronize()
    print(f"[whisper] whisper-large-v3 at its published widths and "
          f"{cfg.enc_layers} + {cfg.n_layers} of its {Wh['enc']} + "
          f"{Wh['L']} layers, init on the card: "
          f"{time.perf_counter() - t0:.2f} s, {cfg.n_params() / 1e9:.3f} B "
          f"parameters", flush=True)
    plan = PrecisionPlan(layers={k: LayerPlan(wire_bits=4, pack_bits=4)
                                 for k in WHISPER_MLP})
    L, Le, d, ff, C = cfg.n_layers, cfg.enc_layers, Wh["d"], Wh["ff"], \
        Wh["chunk"]
    H, KV, hd, T, max_len = Wh["H"], Wh["KV"], Wh["hd"], Wh["T"], Wh["W"]
    rng = np.random.default_rng(SEED + 1)
    frames = [_whisper_frames(n, SEED + 10 + i)
              for i, n in enumerate(WHISPER_AUDIO)]
    audio_prompts = [[int(t) for t in rng.integers(0, cfg.vocab,
                                                   WHISPER_PROMPT)]
                     for _ in frames]
    lm_lens = [int(n) for n in rng.integers(16, 65, WHISPER_LM)]

    def hdm_of(kv_bits):
        return hd // 2 if kv_bits == 4 else hd

    def want(pl, kv_bits):
        mb, hdm = 8 if pl is None else 4, hdm_of(kv_bits)
        return {"qmatmul": {(8, d, d, 8): 6 * L, (8, d, ff, mb): L,
                            (8, ff, d, mb): L},
                "kv_quantize_store": {(8, 1, KV, hd, max_len, hdm, kv_bits,
                                       "float32"): L},
                "kv_attention_rows": {(8, 1, H, KV, hd, max_len, hdm): L,
                                      (8, 1, H, KV, hd, T, hdm): L}}

    def want_append(pl, kv_bits):
        mb = 8 if pl is None else 4
        return {"qmatmul": {(C, d, d, 8): 4 * Le + 2 * L, (C, d, ff, mb): Le,
                            (C, ff, d, mb): Le},
                "kv_quantize_store": {(L, C, KV, hd, T, hdm_of(kv_bits),
                                       kv_bits, "float32"): 1},
                "kv_attention_rows": {}}

    def engine(model, params, qstate, cfg_, *, plan, kv_bits, max_len, **_):
        """The ``StreamingEngine`` of ``build(serving_spec(...))
        .make_engine`` (``plan``, ``kv_bits``, audio chunks of ``C``), which
        tallies its first append of a whole chunk by shape
        (``append_shapes``)."""
        eng = api_engine(serving_spec("whisper-large-v3", plan, kv_bits,
                                      audio_chunk=C), params, qstate, dev,
                         max_len, kv_bits, cfg=cfg_)
        check(isinstance(eng, StreamingEngine) and eng.audio_chunk == C
              and eng.slots == 8, "whisper: make_engine did not give "
                                  "the StreamingEngine of the spec")
        eng.append_shapes = None
        real = eng._append_cross

        def counted(cs, fr):
            first = eng.append_shapes is None and fr.shape[1] == C
            before = _shapes(SERVING) if first else None
            out = real(cs, fr)
            if first:
                now = _shapes(SERVING)
                eng.append_shapes = {n: now[n] - before[n] for n in now}
            return out

        eng._append_cross = counted
        return eng

    def audio(tag):
        return [AudioRequest(frames=fr, prompt=list(pr), max_new=32)
                for fr, pr in zip(frames, audio_prompts)]

    def alone(pp, qq, kv_bits, r):
        return generate_asr(WhisperModel, pp, qq, cfg, r.frames, r.prompt,
                            r.max_new, chunk=C, cache_len=max_len,
                            kv_bits=kv_bits, device=dev)[0].tolist()

    appends = {}

    def after(tag, eng, reqs, pl, kv_bits):
        aud = [r for r in reqs if isinstance(r, AudioRequest)]
        sizes = [[b.shape[1] for b in split_audio(torch.as_tensor(r.frames),
                                                  C)] for r in aud]
        check(all(len(r.t_chunks) == len(n) and r.ttft_s is not None
                  for r, n in zip(aud, sizes)),
              f"(whisper {tag}) chunk latencies not recorded")
        whole = [t * 1e3 for r, n in zip(aud, sizes)
                 for t, m in zip(r.t_chunks, n) if m == C]
        every = [t * 1e3 for r in aud for t in r.t_chunks]
        ttft = [r.ttft_s * 1e3 for r in aud]
        c = eng.caches
        nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
        self_b = nb(c.self_k, c.self_v, c.self_kf, c.self_vf)
        cross_b = nb(c.cross_k, c.cross_v, c.cross_kf, c.cross_vf)
        want_b = kv_cross_bytes_per_request(KV, hd, L, T, kv_bits) * 8
        check(cross_b == want_b, f"(whisper {tag}) cross memory {cross_b} B, "
                                 f"the byte model {want_b} B for 8 slots")
        got = {n: dict(v) for n, v in (eng.append_shapes or {}).items()}
        check(got == want_append(pl, kv_bits),
              f"(whisper {tag}) one {C}-frame append's launches by shape: "
              f"{got}, want {want_append(pl, kv_bits)}")
        appends[tag] = eng.append_shapes
        reads = _cross_reads_zero(
            eng, [_whisper_frames(300, SEED + 30 + i) for i in range(2)],
            [[int(t) for t in rng.integers(0, cfg.vocab, 16)]
             for _ in range(6)])
        out = {"append_ms_median": float(np.median(whole)),
               "append_ms_median_all_blocks": float(np.median(every)),
               "appends": len(every), "ttft_ms_median": float(np.median(ttft)),
               "self_ring_bytes": self_b, "cross_memory_bytes": cross_b,
               "cross_bytes_per_request": want_b // 8,
               "launches_per_append": {n: sum(v.values())
                                       for n, v in got.items()},
               "cross_reads_zero": dict(zip(("layers", "lm_rows",
                                             "audio_rows"), reads))}
        print(f"[whisper] ({tag}) {len(aud)} audio requests, {len(every)} "
              f"appends: {C}-frame append median {out['append_ms_median']:.2f}"
              f" ms (all blocks {out['append_ms_median_all_blocks']:.2f}); "
              f"TTFT median {out['ttft_ms_median']:.2f} ms; self ring "
              f"{self_b / 1e6:.1f} MB, cross memory {cross_b / 1e6:.1f} MB "
              f"(= {want_b // 8} B a request x 8); one append "
              f"{out['launches_per_append']}; a mixed tick's {reads[0]} cross "
              f"reads: {reads[1]} LM rows exact zeros, {reads[2]} audio rows "
              f"not", flush=True)
        return out

    n = WHISPER_LOGITS_LAYERS
    cfg_cut = dataclasses.replace(cfg, n_layers=n, enc_layers=n)
    logit_frames = torch.from_numpy(np.stack(
        [_whisper_frames(T, SEED + 20 + i) for i in range(2)]))

    def cut(pp, qq):
        def first(t):
            return {**t, **{k: tree_map(lambda a: a[:n], t[k])
                            for k in ("enc_layers", "dec_layers")}}
        return first(pp), first(qq), cfg_cut

    def prepare(c, dv, pp, qq, kv_bits):
        for blk in split_audio(logit_frames.to(dv), C):
            c = WhisperModel.append_cross(pp, qq, c, blk, cfg_cut,
                                          kv_bits=kv_bits)
        return c

    def sound(pc, qc, cfg_, kv_bits):
        """The continuous reading without its two grids (the attention
        probabilities' 2^-f and the quantized cache rows' 2^-f): a float32
        cache and memory, no ``probs_f``; the three Whisper controls."""
        with _float32_cache():
            return _logits_vs_plain(_without_probs_grid(pc), qc, cfg_, None,
                                    dev, _whisper_controls,
                                    model=WhisperModel, prepare=prepare,
                                    full=False)["continuous"]

    configs = (("a", "packed uniform int8, kv_bits 8", None, 8),
               ("b", "packed plan: every encoder and decoder MLP kernel "
                     "(enc_layers/mlp, dec_layers/mlp) in nibbles (4 bits), "
                     "the rest int8; kv_bits 4", plan, 4))
    total, report, ticks, tick_profile = _serve_family(
        "whisper", WhisperModel, params, qstate, cfg, dev, cases, configs,
        want, _whisper_controls, cut, max_len=max_len, ring=max_len,
        n_attn=2 * L, kv_layers=L, ring_field="self_k", engine=engine,
        lm_lens=lm_lens,
        audio=audio, alone=alone, after=after, prepare=prepare, sound=sound)

    def profile():
        tick_profile()
        t0 = time.perf_counter()
        for tag, desc, pl, kv_bits in configs[:1]:
            eng = StreamingEngine(WhisperModel, params, qstate, cfg,
                                  batch_slots=8, max_len=max_len,
                                  prefill_chunk=16, packed=True, plan=pl,
                                  kv_bits=kv_bits, seed=SEED, device=dev,
                                  audio_chunk=C)
            fr = torch.from_numpy(frames[0][:C]).to(dev)[None]
            by_name = {}
            ops, busy, _, _ = _profiled(
                lambda cs: eng._append_cross(cs, fr), prepare=eng._new_slot,
                device_ms=by_name)
            med = report[tag]["append_ms_median"]
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
            report[tag]["profiled_append"] = {
                "device_ops": ops, "device_busy_ms": busy,
                "idle_share_of_median_append": 1.0 - busy / med,
                "top_device_ms": top}
            print(f"[whisper] ({tag}) profiled {C}-frame append: {ops} device "
                  f"operations, device busy {busy:.2f} ms, idle "
                  f"{1.0 - busy / med:.1%} of the median append; by "
                  f"operation: " + "; ".join(f"{nm[:60]} {ms:.3f}"
                                             for nm, ms in top), flush=True)
            del eng
        print(f"[whisper] appends profiled in {time.perf_counter() - t0:.1f} "
              f"s", flush=True)

    return total, report, ticks, profile, appends["a"]


# ---------------------------------------------------------------------------
# the api part: the launcher and engines built from RunSpec values
# ---------------------------------------------------------------------------

SPECS = ROOT / "examples" / "specs"
# the specs' models are served at their published widths and this many of
# their layers (llama3.2-3b's 28, qwen2-0.5b's 24; all were held in earlier
# runs, PERF.md §4): the context's configuration is cut after the spec is
# checked at full width, so that the context inits, packs and serves the
# cut model; the cut pays for the script's time and the tallies scale with
# the layers
API_SERVE_LAYERS = 4
# llama3.2-3b from serving_packed.json: one full tick's qmatmul launches by
# shape (8 slots; q, o; k, v; gate, up; down a layer; the tied head)
LLAMA_TICK = {(8, LLAMA["d"], LLAMA["d"], 8): 2 * API_SERVE_LAYERS,
              (8, LLAMA["d"], LLAMA["KV"] * LLAMA["hd"], 8):
                  2 * API_SERVE_LAYERS,
              (8, LLAMA["d"], LLAMA["ff"], 8): 2 * API_SERVE_LAYERS,
              (8, LLAMA["ff"], LLAMA["d"], 8): API_SERVE_LAYERS,
              (8, LLAMA["d"], LLAMA["V"], 8): 1}
LLAMA_LOGITS_LAYERS = 2
API_KV_PLAN_REQUESTS = 4


def _with_kv_bits(plan, kv_bits):
    """``plan`` (None: uniform int8) with every entry's KV width
    ``kv_bits``; pack and wire widths as they were."""
    from repro_torch.core.plan import PrecisionPlan
    plan = plan or PrecisionPlan()
    kv = lambda e: dataclasses.replace(e, kv_bits=kv_bits)
    return PrecisionPlan(default=kv(plan.default),
                         layers={k: kv(e) for k, e in plan.layers.items()})


def serving_spec(arch, plan, kv_bits, audio_chunk=None):
    """The ``RunSpec`` of a served configuration: ``arch`` at full width,
    8 slots, packed weights at ``plan``'s pack widths (None: int8), the KV
    ring at ``kv_bits`` (``kv_cache`` "int8" at 8, else "plan" with every
    entry's KV width ``kv_bits``), audio chunks of ``audio_chunk`` frames
    beside LM traffic where it is given."""
    from repro_torch.api import AudioSpec, PrecisionSpec, RunSpec, ServingSpec
    sv = dict(kv_cache="int8" if kv_bits == 8 else "plan")
    if audio_chunk is not None:
        sv.update(workloads=("lm", "asr"),
                  audio=AudioSpec(chunk_frames=audio_chunk))
    return RunSpec(arch=arch, full=True,
                   precision=PrecisionSpec(packed_serving=True),
                   serving=ServingSpec(**sv),
                   plan=plan if kv_bits == 8 else _with_kv_bits(plan,
                                                                kv_bits))


def api_engine(spec, params, qstate, dev, max_len, kv_bits, cfg=None):
    """``build(spec).make_engine(...)`` on the card (chunks of 16, the
    sampling seed ``SEED``), checked to serve packed weights at
    ``kv_bits``.  ``cfg``: the spec's config at fewer layers, for a part
    whose depth is cut (a spec names the published config, so the cut is
    applied to the built context)."""
    from repro_torch.api import build
    ctx = build(spec, device=dev)
    if cfg is not None:
        check(dataclasses.replace(ctx.cfg, n_layers=cfg.n_layers,
                                  enc_layers=cfg.enc_layers) == cfg,
              f"{spec.arch}: {cfg} is not the spec's config at fewer layers")
        ctx.cfg = cfg
    eng = ctx.make_engine(params, qstate, max_len=max_len, prefill_chunk=16,
                          seed=SEED)
    check(eng.packed and eng.kv_bits == kv_bits,
          f"{spec.arch}: make_engine gave packed={eng.packed}, kv_bits="
          f"{eng.kv_bits}, not packed at {kv_bits}")
    return eng


def _same_tree(a, b):
    from repro_torch.tree import tree_flatten_with_path
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(fa, fb))


def _served_requests(vocab, n, seed):
    """qwen2's traffic shape: ``n`` greedy requests, prompts of 16 and 256
    tokens and the rest uniform in 16-256, 32 new tokens each."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    lens = ([16, 256] + [int(k) for k in rng.integers(16, 257, n)])[:n]
    return [Request(prompt=[int(t) for t in rng.integers(0, vocab, k)],
                    max_new=32) for k in lens]


def api_serving(dev):
    """The shipped serving specs at full width through ``build(spec)
    .make_engine``, each loaded with ``RunSpec.from_args(["--spec", path,
    "--full"])``: (b) llama3.2-3b from ``serving_packed.json`` (packed
    int8, fp cache, 8 slots), checked at full width and served at
    ``API_SERVE_LAYERS`` of its 28 layers, 8 requests of qwen2's traffic
    shape; its packed tree equal to ``pack_params_for_serving`` by hand,
    every request equal to itself served alone, one full tick's
    ``qmatmul`` by shape (``LLAMA_TICK``) and no KV kernel, card vs CPU
    at 2 of its layers within the dense limits, which the dense controls
    exceed; (c) qwen2-0.5b from ``serving_kv_plan.json`` (4 slots,
    ``API_SERVE_LAYERS`` of its 24 layers, attention at
    ``kv_bits`` 4, the MLP in nibbles): its tokens equal an ``Engine``
    built by hand with the same plan and ``kv_bits=4``, a full tick
    running int8 and nibble ``qmatmul``, the store and the attention
    read.  Returns (launches, report, llama's full tick by shape, a
    function profiling one llama tick, to be called after every timed
    run)."""
    from repro_torch.api import RunSpec, build
    from repro_torch.dist.perf import pack_params_for_serving
    from repro_torch.models import TransformerLM
    from repro_torch.serving import Engine, Request, packed_nbytes
    from repro_torch.tree import tree_leaves

    t_part = time.perf_counter()
    total = collections.Counter()
    report = {}
    # (b) llama3.2-3b
    spec = RunSpec.from_args(["--spec", str(SPECS / "serving_packed.json"),
                              "--full"])
    ctx = build(spec, device=dev)
    cfg = ctx.cfg
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
           cfg.d_ff, cfg.vocab, cfg.tie_embeddings) == tuple(
               LLAMA[k] for k in ("L", "d", "H", "KV", "hd", "ff", "V"))
          + (True,) and ctx.model is TransformerLM
          and spec.precision.packed_serving and spec.serving.slots == 8
          and spec.serving.kv_cache == "fp", "not serving_packed.json's "
          "llama3.2-3b at full width")
    cfg = ctx.cfg = dataclasses.replace(cfg, n_layers=API_SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, qstate = ctx.init_state()
    eng = ctx.make_engine(params, qstate, max_len=1024, prefill_chunk=16)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    check(eng.packed and eng.kv_bits is None and eng.slots == 8,
          f"llama engine: packed {eng.packed}, kv_bits {eng.kv_bits}, "
          f"{eng.slots} slots")
    same_pack = _same_tree(eng.p, pack_params_for_serving(params, None))
    check(same_pack, "llama: the engine's packed tree is not "
                     "pack_params_for_serving's")
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    reqs = _served_requests(cfg.vocab, 8, SEED + 5)
    torch.cuda.synchronize()
    _reset_counts()                           # the main path starts here
    t0 = time.perf_counter()
    tick_ms, tick_shapes, _ = _serve(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(SERVING)                 # ... and ends here
    total.update(counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(r.done and len(r.out) == r.max_new for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          "llama: not every request finished in range")
    check(tick_shapes is not None, "llama: no tick had every slot busy")
    got = {k: dict(v) for k, v in tick_shapes.items()}
    check(got == {"qmatmul": LLAMA_TICK, "kv_quantize_store": {},
                  "kv_attention_rows": {}}
          and counts["kv_quantize_store"] == counts["kv_attention_rows"] == 0,
          f"llama: one full tick's launches by shape {got}, want "
          f"{LLAMA_TICK} and no KV kernel; while serving {counts}")
    t0 = time.perf_counter()
    apart = []
    for i, r in enumerate(reqs):
        one = Request(prompt=list(r.prompt), max_new=r.max_new)
        ctx.make_engine(eng.p, qstate, max_len=1024,
                        prefill_chunk=16).run([one])
        if one.out != r.out:
            apart.append(i)
    alone_s = time.perf_counter() - t0
    check(not apart, f"llama: requests {apart} served alone give other "
                     f"tokens than in the batch")
    t0 = time.perf_counter()
    pc, qc, cfg_cut = _first_layers(eng.p, qstate, cfg, "layers",
                                    LLAMA_LOGITS_LAYERS, LLAMA_LOGITS_LAYERS)
    logits = _logits_vs_plain(pc, qc, cfg_cut, None, dev, _dense_controls)
    logits_s = time.perf_counter() - t0
    del pc, qc
    full, cont = logits["full"], logits["continuous"]
    print(f"[api] (b) llama3.2-3b card vs CPU logits at "
          f"{LLAMA_LOGITS_LAYERS} layers: {json.dumps(logits)} (limits: "
          f"full {LOGITS_REL_GROSS}, continuous {LOGITS_REL_LIMIT})",
          flush=True)
    check(full["rel_l2"] <= LOGITS_REL_GROSS,
          f"llama: card vs CPU logits rel L2 {full['rel_l2']}")
    check(cont["rel_l2"] <= LOGITS_REL_LIMIT and cont["argmax_agree"] == 1.0,
          f"llama: card vs CPU logits without activation quantizers: {cont}")
    check(all(c > LOGITS_REL_LIMIT for c in cont["controls"].values()),
          f"llama: the logits check misses a control: {cont}")
    toks = sum(len(r.out) for r in reqs)
    med = float(np.median(tick_ms))
    report["llama"] = {
        "spec": "examples/specs/serving_packed.json --full",
        "config": "llama3.2-3b FULL (configs/llama3_2_3b.py; hf:meta-llama, "
                  f"Llama 3.2): {API_SERVE_LAYERS} of its 28 layers, d "
                  "3072, 24 heads and 8 kv heads "
                  "of 128, d_ff 8192, vocab 128256, tied head; random "
                  "weights from the spec's seed; packed int8, fp (bf16) "
                  "cache, 8 slots, max_len 1024, chunks of 16",
        "n_params": n_params, "requests": len(reqs),
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "new_tokens": toks, "decode_tick_ms_median": med,
        "ticks": len(tick_ms), "tokens_per_s": toks / wall, "wall_s": wall,
        "init_and_engine_s": built_s, "alone_s": alone_s,
        "logits_s": logits_s, "peak_mem_gib": peak,
        "packed_weight_bytes": packed_nbytes(eng.p),
        "packed_tree_equal_by_hand": same_pack, "launches": counts,
        "launches_per_full_tick": {k: sum(c.values())
                                   for k, c in tick_shapes.items()},
        "logits_vs_cpu": logits}
    print(f"[api] (b) llama3.2-3b from serving_packed.json at "
          f"{cfg.n_layers} of its 28 layers: {len(reqs)} "
          f"requests, {toks} new tokens in {wall:.2f} s = "
          f"{toks / wall:.1f} tok/s; decode tick median {med:.2f} ms over "
          f"{len(tick_ms)} ticks; peak memory {peak:.2f} GiB; packed "
          f"weights {report['llama']['packed_weight_bytes'] / 1e9:.3f} GB "
          f"(equal to pack_params_for_serving); per full tick "
          f"{report['llama']['launches_per_full_tick']}; every request "
          f"equal alone ({alone_s:.1f} s)", flush=True)
    llama_pp = eng.p
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (c) qwen2-0.5b from serving_kv_plan.json
    spec = RunSpec.from_args(["--spec", str(SPECS / "serving_kv_plan.json"),
                              "--full"])
    ctx2 = build(spec, device=dev)
    check(spec.serving.slots == 4 and spec.serving.kv_cache == "plan"
          and ctx2.plan is not None and _lm_dims(ctx2.cfg) == QWEN,
          "not serving_kv_plan.json's qwen2-0.5b at full width")
    ctx2.cfg = dataclasses.replace(ctx2.cfg, n_layers=API_SERVE_LAYERS)
    params, qstate2 = ctx2.init_state()
    reqs = _served_requests(ctx2.cfg.vocab, API_KV_PLAN_REQUESTS, SEED + 6)
    eng = ctx2.make_engine(params, qstate2, max_len=1024, prefill_chunk=16)
    check(eng.kv_bits == 4 and eng.packed,
          f"kv_plan engine: kv_bits {eng.kv_bits}, packed {eng.packed}")
    _reset_counts()                           # the main path starts here
    t0 = time.perf_counter()
    kv_ms, kv_shapes, _ = _serve(eng, reqs)
    torch.cuda.synchronize()
    kv_wall = time.perf_counter() - t0
    kv_counts = _counts(SERVING)              # ... and ends here
    total.update(kv_counts)
    del eng
    hand = Engine(TransformerLM, params, qstate2, ctx2.cfg, batch_slots=4,
                  max_len=1024, prefill_chunk=16, packed=True,
                  plan=spec.plan, kv_bits=4, device=dev)
    by_hand = [Request(prompt=list(r.prompt), max_new=r.max_new)
               for r in reqs]
    hand.run(by_hand)
    del hand, params
    check([r.out for r in reqs] == [r.out for r in by_hand],
          "kv_plan: the api-built engine's tokens are not the hand-built "
          "engine's")
    per_tick = {k: {" ".join(map(str, s)): n for s, n in c.items()}
                for k, c in (kv_shapes or {}).items()}
    bits = {s[3] for s in (kv_shapes or {}).get("qmatmul", {})}
    check(kv_shapes is not None and bits == {8, 4}
          and sum(kv_shapes["kv_quantize_store"].values())
          == API_SERVE_LAYERS
          and sum(kv_shapes["kv_attention_rows"].values())
          == API_SERVE_LAYERS,
          f"kv_plan: one full tick's launches by shape {per_tick}")
    report["kv_plan"] = {
        "spec": "examples/specs/serving_kv_plan.json --full",
        "requests": len(reqs), "decode_tick_ms_median":
            float(np.median(kv_ms)), "wall_s": kv_wall,
        "launches": kv_counts, "launches_per_full_tick": per_tick,
        "equal_to_hand_built_engine": True}
    print(f"[api] (c) qwen2-0.5b from serving_kv_plan.json at "
          f"{ctx2.cfg.n_layers} of its 24 layers: {len(reqs)} "
          f"requests equal to the hand-built engine's; one full tick "
          f"{per_tick}; tick median {report['kv_plan']['decode_tick_ms_median']:.2f} ms",
          flush=True)
    report["part_s"] = time.perf_counter() - t_part
    print(f"[api] serving part took {report['part_s']:.1f} s", flush=True)

    def profile():
        def engine(*a, **k):
            e = ctx.make_engine(llama_pp, qstate, max_len=1024,
                                prefill_chunk=16)
            return e
        by_name = {}
        ops, busy, _, names = _profile_full_tick(
            engine, Request, TransformerLM, None, None, cfg, None, None,
            [r.prompt for r in _served_requests(cfg.vocab, 8, SEED + 5)],
            dev, device_ms=by_name)
        med = report["llama"]["decode_tick_ms_median"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
        qm = sum(ms for nm, ms in by_name.items() if "qmatmul" in nm)
        report["llama"]["profiled_full_tick"] = {
            "device_ops": ops, "device_busy_ms": busy,
            "idle_share_of_median_tick": 1.0 - busy / med,
            "qmatmul_device_ms": qm, "top_device_ms": top}
        print(f"[api] (b) llama3.2-3b profiled full tick: {ops} device "
              f"operations, device busy {busy:.2f} ms (qmatmul {qm:.3f}), "
              f"idle {1.0 - busy / med:.1%} of the median tick; by "
              f"operation: " + "; ".join(f"{nm[:60]} {ms:.3f}"
                                         for nm, ms in top), flush=True)

    return total, report, tick_shapes, profile


API_TRAIN_STEPS = 4


def _launcher(argv):
    """``launch.train.main(argv)``, its printed lines kept: (its
    ``TrainSetup``, the lines)."""
    import io
    from repro_torch.launch import train as launcher
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        setup = launcher.main(argv)
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[api] launcher: {line}", flush=True)
    return setup, lines


def api_training(dev):
    """(a) ``launch.train.main`` on ``examples/specs/host_1x1.json`` with
    ``--full --steps 4 --batch 2 --seq 256 --ckpt-every 2``: qwen2-0.5b at
    its published widths, through ``build(spec).init_training()``, on the
    card.  Checks: the printed lines; a step's ``hgq_quantize`` launches
    by shape exact (``_lm_per_step`` at seq 256); the params, qstate and
    AdamW state after 4 steps equal, bit for bit, a hand-wired
    ``Trainer`` (``make_train_step``) with the same ``TrainConfig``, init
    and data; a second call on the same checkpoint directory prints
    ``resumed from step 3`` and ends in the first call's state bit for
    bit.  Then a short check at SMOKE: ``--mesh 4x1 --grad-compression
    int8-wire --plan plan_mixed_w4w8.json`` runs the fused wire kernels
    over a ``LocalMesh(4)`` (the plan's 4-bit leaves make a nibble
    bucket, which ``wire_pack_rows`` packs).
    Returns (report, a step's launches by shape)."""
    import shutil
    from repro_torch.api import RunSpec
    from repro_torch.data import make_pipeline
    from repro_torch.dist import LocalMesh
    from repro_torch.models import TransformerLM
    from repro_torch.train import Trainer, lm_loss
    from repro_torch.tree import tree_leaves

    t_part = time.perf_counter()
    ckpt = ROOT / "build" / "api_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--spec", str(SPECS / "host_1x1.json"), "--full", "--steps",
            str(API_TRAIN_STEPS), "--batch", str(LM_BATCH), "--seq",
            str(API_TRAIN_SEQ), "--ckpt-dir", str(ckpt), "--ckpt-every", "2"]
    spec = RunSpec.from_args(argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                           # the main path starts here
    t0 = time.perf_counter()
    setup, lines = _launcher(argv)
    wall = time.perf_counter() - t0
    # the params, both AdamW moments updated in place (the step donates)
    launcher_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _counts(TRAINING)                # ... and ends here
    per_step = _per_step(_shapes(TRAINING), API_TRAIN_STEPS)
    cfg = setup.ctx.cfg
    check(_lm_dims(cfg) == QWEN and spec.full and spec.data.batch == LM_BATCH
          and spec.data.seq == API_TRAIN_SEQ, "the launcher did not train "
          "qwen2-0.5b at full width, batch 2, seq 256")
    step_lines = [l for l in lines if l.startswith("step ")]
    check(len(step_lines) == API_TRAIN_STEPS
          and lines[-1].startswith(f"done: {API_TRAIN_STEPS} steps"),
          f"the launcher printed {lines}")
    losses = [float(l.split("loss=")[1].split()[0]) for l in step_lines]
    check(all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab)) <= LM_LOSS0_MARGIN,
          f"launcher losses {losses}, step 0 not within {LM_LOSS0_MARGIN} "
          f"of ln(vocab)")
    want = _lm_per_step(LM_BATCH, API_TRAIN_SEQ, cfg.n_layers, cfg.q_chunk)
    check(per_step == want and counts == {
              k: sum(c.values()) * API_TRAIN_STEPS for k, c in want.items()},
          f"the launcher's launches a step {per_step}, not {want}")
    # check 1: a hand-wired Trainer from the same init, config and data
    gen = torch.Generator(device=dev)
    gen.manual_seed(spec.seed)
    p, q = TransformerLM.init(gen, cfg, device=dev)
    tr = Trainer(lambda p, q, b, mode: TransformerLM.forward(p, q, b, cfg,
                                                             mode),
                 lambda out, b: lm_loss(out, b["tokens"]),
                 dataclasses.replace(spec.train, ckpt_dir=""), p, q,
                 pipeline=make_pipeline(dataclasses.replace(
                     spec.data, vocab=cfg.vocab), dev))
    del p, q
    tr.run(log=lambda *a: None)
    state = tree_leaves((setup.params, setup.qstate, setup.opt))
    same_hand = len(state) == len(tree_leaves((tr.params, tr.qstate,
                                               tr.opt))) and all(
        torch.equal(a, b) for a, b in zip(state, tree_leaves(
            (tr.params, tr.qstate, tr.opt))))
    del tr
    check(same_hand, "the launcher's state after 4 steps is not the "
                     "hand-wired Trainer's")
    # check 2: the same call again resumes from the checkpoint of step 2
    again, lines2 = _launcher(argv)
    same_resumed = all(torch.equal(a, b) for a, b in zip(
        state, tree_leaves((again.params, again.qstate, again.opt))))
    check(lines2[0] == "resumed from step 3" and again.start_step == 3
          and same_resumed, f"the second call: {lines2[:2]}, state equal "
                            f"{same_resumed}")
    del setup, again, state
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # the launcher over a LocalMesh(4) at SMOKE: the fused wire kernels
    before = _counts(FUSED_WIRE)
    wire, wlines = _launcher(["--spec", str(SPECS / "host_1x1.json"),
                              "--mesh", "4x1", "--grad-compression",
                              "int8-wire", "--plan",
                              str(SPECS / "plan_mixed_w4w8.json"),
                              "--steps", "2"])
    wire_counts = {k: n - before[k] for k, n in _counts(FUSED_WIRE).items()}
    check(isinstance(wire.ctx.mesh, LocalMesh) and wire.ctx.mesh.size == 4
          and all(n > 0 for n in wire_counts.values())
          and wlines[-1].startswith("done: 2 steps"),
          f"the launcher over LocalMesh(4): {wire_counts}, {wlines}")
    launches = collections.Counter(counts)
    launches.update(wire_counts)
    report = {
        "argv": argv[:-4] + ["--ckpt-dir", "D", "--ckpt-every", "2"],
        "config": "configs/qwen2_0_5b.py FULL through examples/specs/"
                  "host_1x1.json --full: batch 2, seq 256 (one chunk pair a "
                  "layer), remat, 4 steps of the spec's TrainConfig (lr "
                  "1e-3, beta 1e-9 -> 1e-7 over them), lm data from the "
                  "spec's seed",
        "losses": losses, "wall_s": wall,
        "step_ms_mean_incl_checkpoint": wall / API_TRAIN_STEPS * 1e3,
        "equal_to_hand_wired_trainer": same_hand,
        "resumed_equal": same_resumed, "launches": dict(launches),
        "launcher_peak_mem_gib": launcher_peak,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items()},
        "wire_smoke_launches": wire_counts,
        "part_s": time.perf_counter() - t_part}
    print(f"[api] (a) launcher: qwen2-0.5b FULL, 4 steps in {wall:.1f} s "
          f"(checkpoint included), losses {losses}, peak memory "
          f"{launcher_peak:.2f} GiB; equal to the hand-wired "
          f"Trainer; resumed from step 3 bit for bit; LocalMesh(4) wire "
          f"{wire_counts}; the part took {report['part_s']:.1f} s",
          flush=True)
    return report, per_step


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

QUICKSTART = dict(steps=300, lr=3e-3, beta0=1e-6, beta1=1e-3, gamma=2e-6)
# launches of one jet-tagger step: the 8 weight and bias quantizers' forward
# in one grouped launch, the 4 activation quantizers' one launch each, and
# one backward launch a quantizer
HGQ_PER_STEP = {"hgq_quantize_fwd": 4, "hgq_quantize_fwd_group": 1,
                "hgq_quantize_bwd": 12}
# the layouts each of them takes
HGQ_LAYOUTS = {"hgq_quantize_fwd": {"per_tensor", "per_channel"},
               "hgq_quantize_fwd_group": {"per_parameter"},
               "hgq_quantize_bwd": {"per_tensor", "per_channel",
                                    "per_parameter"}}


def _layouts(name, key):
    """The layouts of one tally key: a member's, or a group's members'."""
    return {m[0] for m in key} if name == "hgq_quantize_fwd_group" \
        else {key[0]}
# The card's loss and ~EBOPs against the CPU's, at every one of 20 steps.
# The forward lands on exact grids on both, so only the backward's
# summation order differs.  The limit lies between that sound reading and
# two faulty controls, which the check must catch (readings in PERF.md).
# The loss alone misses a backward that drops a partial sum: the bitwidths
# it misleads move ~EBOPs at once but cross no rounding point in 20 steps.
TRAJ_REL_LIMIT = 1e-5


def _jet():
    from repro_torch.models import JetTagger
    from repro_torch.nn import HGQConfig
    from repro_torch.train import softmax_xent
    cfg = HGQConfig(weight_gran="per_parameter", act_gran="per_parameter",
                    init_weight_f=2.0, init_act_f=2.0)
    fwd = lambda p, q, b, mode: JetTagger.forward(p, q, b, mode)
    loss = lambda out, b: softmax_xent(out, b["y"])
    return JetTagger, cfg, fwd, loss


def _quickstart(dev):
    """examples/quickstart.py's configuration through the port's
    ``Trainer.run`` on the card, then a CALIB pass on a held-out batch
    and the fixed-point proxy."""
    from repro_torch.core import hgq
    from repro_torch.core.calibrate import (assert_no_overflow,
                                            fixed_spec_from_range)
    from repro_torch.data import DataSpec, make_pipeline
    from repro_torch.train import TrainConfig, Trainer, accuracy
    JetTagger, cfg, fwd, loss = _jet()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params, qstate = JetTagger.init(gen, cfg, device=dev)
    widths = [tuple(params[f"d{i}"]["kernel"]["w"].shape) for i in range(4)]
    check(widths == [(16, 64), (64, 32), (32, 32), (32, 5)],
          f"not the JetTagger 16-64-32-32-5: {widths}")
    pipe = make_pipeline(DataSpec(kind="jet", batch=1024), device=dev)
    starts = []

    def timed_pipe(step):
        # a step runs from one batch request to the next
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return pipe(step)

    tcfg = TrainConfig(log_every=50, **QUICKSTART)
    trainer = Trainer(fwd, loss, tcfg, params, qstate, pipeline=timed_pipe)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_counts()                           # the main path starts here
    t0 = time.perf_counter()
    trainer.run(log=lambda line: print(f"[train] {line}", flush=True))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = _counts(TRAINING)                # ... and ends here
    shapes = _shapes(TRAINING)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = tcfg.steps
    step_ms = np.diff(starts + [t1]) * 1e3
    per_step = {}
    for name, by_shape in shapes.items():
        check(all(c % steps == 0 for c in by_shape.values()),
              f"{name}: launches not a multiple of the steps: {by_shape}")
        per_step[name] = collections.Counter(
            {k: c // steps for k, c in by_shape.items()})
        n = sum(per_step[name].values())
        check(n == HGQ_PER_STEP[name],
              f"{name}: {n} launches a step, not {HGQ_PER_STEP[name]}: "
              f"{dict(per_step[name])}")
        lays = set().union(*(_layouts(name, k) for k in per_step[name]))
        check(lays == HGQ_LAYOUTS[name],
              f"{name}: layouts on the path {lays}")
    with torch.no_grad():
        batch = pipe(10 ** 6)                 # held out
        logits, qcal, aux = JetTagger.forward(trainer.params, trainer.qstate,
                                              batch, mode=hgq.CALIB)
        acc = float(accuracy(logits, batch["y"]))
        ebops = float(aux.ebops)
        f0 = trainer.params["d0"]["kernel"]["f"]
        spec = fixed_spec_from_range(qcal["inp"], trainer.params["inp_f"])
        fits = bool(assert_no_overflow(batch["x"], spec,
                                       trainer.params["inp_f"]))
        o1, _, _ = JetTagger.forward(trainer.params, qcal, batch,
                                     mode=hgq.EVAL)
        o2, _, _ = JetTagger.forward(trainer.params, qcal, batch,
                                     mode=hgq.EVAL)
    ebops0 = trainer.history[0]["ebops"]
    report = {
        "config": "examples/quickstart.py: JetTagger 16-64-32-32-5, "
                  "per-parameter weights and activations, init f 2, jet "
                  "batch 1024, 300 steps, lr 3e-3, beta 1e-6 -> 1e-3, "
                  "gamma 2e-6",
        "accuracy": acc, "calib_ebops": ebops, "step0_ebops": ebops0,
        "layer0_f": {"mean": float(f0.mean()), "min": float(f0.min()),
                     "max": float(f0.max())},
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "samples_per_s": steps * 1024 / (t1 - t0), "wall_s": t1 - t0,
        "peak_mem_gib": peak, "launches": counts,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items()},
        "proxy_input_fits": fits,
        "eval_repeatable": torch.equal(o1, o2)}
    print(f"[train] quickstart on the card: {json.dumps(report)}", flush=True)
    check(acc >= 0.99, f"quickstart accuracy {acc} < 0.99")
    check(ebops <= 1000.0, f"quickstart CALIB ~EBOPs {ebops} > 1000")
    check(report["layer0_f"]["mean"] < 2.0,
          f"layer-0 mean f {report['layer0_f']['mean']} >= 2")
    check(fits, "calibration input overflows its calibrated type")
    check(report["eval_repeatable"], "two EVAL forwards differ")
    check(counts == {k: n * steps for k, n in HGQ_PER_STEP.items()},
          f"launches {counts}, not {HGQ_PER_STEP} a step over {steps} steps")
    return trainer, report, per_step


def _trajectory(dev, params, qstate, batches, fwd=None, loss=None,
                config=QUICKSTART):
    """20 steps of ``config`` (the quickstart's by default, the jet
    tagger's forward and loss) on ``dev`` from the given init and batches:
    ([(loss, ~EBOPs)] per step, final params)."""
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_map
    if fwd is None:
        _, _, fwd, loss = _jet()
    to = lambda t: t.to(dev)
    tcfg = TrainConfig(log_every=1, **dict(config, steps=len(batches)))
    tr = Trainer(fwd, loss, tcfg, tree_map(to, params), tree_map(to, qstate),
                 pipeline=lambda s: tree_map(to, batches[s]))
    tr.run(log=lambda *a: None)
    return ([(h["loss"], h["ebops"]) for h in tr.history],
            tree_map(lambda t: t.cpu(), tr.params))


@contextlib.contextmanager
def _df_without_last_block():
    """Control: the per-channel and per-tensor backward drops the rows of
    its last block (a reduction that loses a block's partial sum; per
    tensor, every row that holds one of the last block's elements)."""
    import repro_torch.kernels.hgq_quantize.ops as ops
    real = ops.hgq_quantize_bwd

    def dropped(g, x, f):
        if f.shape == x.shape:
            return real(g, x, f)
        cols = x.shape[-1]
        rows = x.numel() // cols
        lay = "per_channel" if f.ndim else "per_tensor"
        (_, _, span), _ = ops.bwd_plan(rows, cols, lay, x.dtype)
        units = rows if f.ndim else rows * cols
        start = (units - 1) // span * span       # the last block's first
        keep = start if f.ndim else start // cols
        return real(g.reshape(rows, cols)[:keep].contiguous(),
                    x.reshape(rows, cols)[:keep].contiguous(), f)

    # the wrapper counts its launches on the module's name: these land here
    dropped.launches, dropped.shapes = 0, collections.Counter()
    ops.hgq_quantize_bwd = dropped
    try:
        yield
    finally:
        ops.hgq_quantize_bwd = real


@contextlib.contextmanager
def _rounding_down():
    """Control: the forward rounds f with floor(f), not floor(f + 1/2)
    (single and grouped quantizers)."""
    import repro_torch.core.hgq as hgq_mod
    real, real_group = hgq_mod.quantize, hgq_mod.quantize_group
    hgq_mod.quantize = lambda x, f: real(x, f - 0.5)
    hgq_mod.quantize_group = lambda xs, fs: real_group(
        xs, [f - 0.5 for f in fs])
    try:
        yield
    finally:
        hgq_mod.quantize, hgq_mod.quantize_group = real, real_group


@contextlib.contextmanager
def _conv_tf32():
    """Control: the conv lets cuDNN run in TF32 (PyTorch's default for
    float32 convolutions), forward and backward."""
    import types
    from repro_torch.nn import basic
    with _patched(basic, "CUDNN_FLAGS", lambda real: types.MappingProxyType(
            {**real, "allow_tf32": True})):
        yield


@contextlib.contextmanager
def _df_without_ln2_delta():
    """Control: the backward drops its ``ln2 * delta`` term (df = 0 from
    the loss; f moves by the ~EBOPs and L1 terms alone)."""
    import repro_torch.kernels.hgq_quantize.ops as ops
    real = ops.hgq_quantize_bwd

    def zero(g, x, f):
        return torch.zeros_like(f)

    zero.launches, zero.shapes = 0, collections.Counter()
    ops.hgq_quantize_bwd = zero
    try:
        yield
    finally:
        ops.hgq_quantize_bwd = real


def _gaps(run, ref, ref_p, loss_steps=None):
    """A run's largest relative gaps to the reference in loss (over its
    first ``loss_steps`` steps, all by default) and in ~EBOPs (over all),
    each step's, and its largest |dparam| at the end."""
    from repro_torch.tree import tree_leaves
    hist, p = run
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    loss = [rel(h[0], r[0]) for h, r in zip(hist, ref)]
    ebops = [rel(h[1], r[1]) for h, r in zip(hist, ref)]
    out = {"loss_rel": max(loss[:loss_steps]), "ebops_rel": max(ebops),
           "param_abs": max(float((a - b).abs().max()) for a, b in zip(
               tree_leaves(p), tree_leaves(ref_p))),
           "loss_rel_steps": loss, "ebops_rel_steps": ebops}
    out["gap"] = max(out["loss_rel"], out["ebops_rel"])
    return out


def _card_vs_cpu(dev, what, model, batches, controls, limit, traj_kw=None,
                 loss_steps=None):
    """The 20-step trajectory on the card (kernels) and on the CPU (plain
    versions) from one init (``model``'s, on the CPU) and one set of
    batches, twice on the card, and under each faulty control: gaps in
    loss (over the first ``loss_steps`` steps, all by default) and ~EBOPs,
    largest |dparam|; the sound gap under ``limit``, every control's above
    it, the two card runs bit-identical."""
    from repro_torch.tree import tree_leaves
    traj_kw = traj_kw or {}
    cpu = torch.device("cpu")
    params, qstate = model
    ref, ref_p = _trajectory(cpu, params, qstate, batches, **traj_kw)
    card1 = _trajectory(dev, params, qstate, batches, **traj_kw)
    card2 = _trajectory(dev, params, qstate, batches, **traj_kw)
    same = card1[0] == card2[0] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(card1[1]),
                                          tree_leaves(card2[1])))
    faulty = {}
    for name, control in controls.items():
        with control():
            faulty[name] = _gaps(_trajectory(dev, params, qstate, batches,
                                             **traj_kw), ref, ref_p,
                                 loss_steps)
    out = {"sound": _gaps(card1, ref, ref_p, loss_steps),
           "repeat_bit_identical": same,
           "controls": faulty, "cpu_final_loss": ref[-1][0]}
    print(f"[train] {what}: card vs CPU, {len(batches)} steps: "
          f"{json.dumps(out)} (limit on the larger relative gap of loss and "
          f"~EBOPs: {limit})", flush=True)
    check(same, f"{what}: two card runs of the {len(batches)} steps differ")
    check(out["sound"]["gap"] <= limit,
          f"{what}: card vs CPU trajectory gap {out['sound']}")
    check(all(c["gap"] > limit for c in faulty.values()),
          f"{what}: the trajectory check misses a control: {faulty}")
    return out


def _jet_card_vs_cpu(dev):
    from repro_torch.data import jet_batch
    JetTagger, cfg, _, _ = _jet()
    cpu = torch.device("cpu")
    model = JetTagger.init(torch.Generator().manual_seed(SEED + 1), cfg,
                           device=cpu)
    batches = [jet_batch(SEED, s, 1024, device=cpu) for s in range(20)]
    return _card_vs_cpu(dev, "quickstart", model, batches,
                        {"df_drops_last_block": _df_without_last_block,
                         "forward_fi_floor_f": _rounding_down},
                        TRAJ_REL_LIMIT)


def _bwd_kernels(grids, per_step, what):
    """Every per-channel, per-tensor and per-expert backward of a profiled
    step was one device kernel, or two past the one-cluster line
    (clusters, then the second pass over their partials, every expert's
    in one of each, ``hgq_quantize.ops.bwd_plan``): the trace holds that
    many ``hgq_bwd_*`` kernels."""
    from repro_torch.kernels.hgq_quantize.ops import bwd_plan
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    calls = passes = 0
    for (lay, shape, dt), n in per_step["hgq_quantize_bwd"].items():
        if lay == "per_parameter":
            continue
        cols = shape[-1] if shape else 1
        rows = math.prod(shape) // cols
        group_rows = rows // shape[0] if lay.startswith("per_expert") \
            else rows
        calls += n
        passes += n * (1 + (bwd_plan(rows, cols, lay, dtypes[dt],
                                     group_rows)[1] > 0))
    check(len(grids) == passes,
          f"{what}: {len(grids)} hgq_bwd device kernels for {calls} "
          f"per-channel and per-tensor backward calls ({passes} expected)")
    return {"hgq_bwd_kernels": len(grids), "reducing_bwd_calls": calls,
            "hgq_bwd_grids": sorted(set(grids))}


def _profile_step(trainer, per_step, what, median_ms):
    """One step of ``trainer`` under the profiler, after every timed run:
    device operations, busy ms, idle share of the median step, and one
    grouped-forward kernel a forward launch, the backward's kernels."""
    step = trainer.tcfg.steps
    batch = trainer.pipeline(step)
    device_ms = {}
    ops, busy, grids, names = _profiled(lambda: trainer.step_fn(
        trainer.params, trainer.qstate, trainer.opt, batch, step),
        grids_of="hgq_bwd", device_ms=device_ms)
    fwd_kernels = sum(n for k, n in names.items() if "hgq_fwd_group" in k)
    fwd_launches = sum(per_step["hgq_quantize_fwd"].values()) + sum(
        per_step["hgq_quantize_fwd_group"].values())
    check(fwd_kernels == fwd_launches,
          f"{what}: profiled step: {fwd_kernels} hgq_quantize forward "
          f"kernels for {fwd_launches} launches")
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
    out = {"device_ops": ops, "device_busy_ms": busy,
           "idle_share_of_median_step": 1.0 - busy / median_ms,
           "device_ms_by_name": {k[:100]: v for k, v in top},
           "hgq_fwd_kernels": fwd_kernels,
           **_bwd_kernels(grids, per_step, f"{what}: profiled step")}
    print(f"[train] {what}: profiled step: {ops} device operations, device "
          f"busy {busy:.3f} ms, idle {out['idle_share_of_median_step']:.1%} "
          f"of the median step ({median_ms:.3f} ms); {len(grids)} hgq_bwd "
          f"kernels", flush=True)
    return out


# ---------------------------------------------------------------------------
# the paper's SVHN (Table II) and muon (Table III) models
# ---------------------------------------------------------------------------

# benchmarks/paper_tables.py's configurations (per-parameter weight f,
# per-tensor activation f, initial f 6); gamma is the Trainer's default
PAPER = {"svhn": dict(steps=120, lr=2e-3, beta0=1e-7, beta1=1e-4,
                      gamma=2e-6),
         "muon": dict(steps=500, lr=3e-3, beta0=3e-6, beta1=6e-4,
                      gamma=2e-6)}
PAPER_BATCH = {"svhn": 128, "muon": 1024}
# The JAX package at those configurations on the CPU, as
# benchmarks/paper_tables.py trains it (its own quantizer, init key 0, data
# seed 0; ``python tests/test_torch_tasks.py --reference``): SVHN accuracy
# 1.0 and CALIB ~EBOPs 367214.0, muon RMS resolution 11.471 mrad and CALIB
# ~EBOPs 89074.7.  The port draws its init and data from its own generators
# (the port on the CPU from seeds 0 and 1, ``--reference both --port``:
# accuracy 1.0 and 1.0, ~EBOPs 365280 and 363609; 12.67 and 12.14 mrad,
# ~EBOPs 95047 and 90942), so the card's run is held to margins: accuracy
# at least 1.0 - 0.02; the resolution, and each model's CALIB ~EBOPs,
# within 30% of the reference.
PAPER_REF = {"svhn": (1.0, 367214.0), "muon": (11.471, 89074.7)}
PAPER_ACC_MARGIN = 0.02
PAPER_REL_MARGIN = 0.3
# the card's 20 steps against the CPU's (readings in PERF.md)
PAPER_TRAJ_REL_LIMIT = {"svhn": 1e-5, "muon": 1e-5}


def _paper(name):
    """(model class, config, forward, loss, metric, data batch function)."""
    from repro_torch.data import muon_batch, svhn_batch
    from repro_torch.models import MuonTracker, SVHNNet
    from repro_torch.nn import HGQConfig
    from repro_torch.train import accuracy, mse, rms_resolution, softmax_xent
    cfg = HGQConfig(weight_gran="per_parameter", act_gran="per_tensor",
                    init_weight_f=6.0, init_act_f=6.0)
    if name == "svhn":
        return (SVHNNet, cfg, lambda p, q, b, mode: SVHNNet.forward(
            p, q, b, mode), lambda o, b: softmax_xent(o, b["y"]),
            lambda o, b: accuracy(o, b["y"]), svhn_batch)
    return (MuonTracker, cfg, lambda p, q, b, mode: MuonTracker.forward(
        p, q, b, mode), lambda o, b: mse(o, b["target"]) * 1e-3,
        lambda o, b: rms_resolution(o, b["target"]), muon_batch)


def _paper_per_step(name):
    """A step's ``hgq_quantize`` launches by shape, as the wrappers key
    them: each activation quantizer's forward, the 12 weights and biases
    in one grouped forward, one backward a quantizer."""
    acts = [("per_tensor", s, "float32") for s in PAPER_ACTS[name]]
    group = SVHN_GROUP if name == "svhn" else MUON_GROUP
    members = [("per_parameter", s, "float32") for s, _, _ in group]
    return {"hgq_quantize_fwd": collections.Counter(acts),
            "hgq_quantize_fwd_group": collections.Counter([tuple(members)]),
            "hgq_quantize_bwd": collections.Counter(acts + members)}


def _per_step(shapes, steps):
    """Launches by shape in one step, from a run's tallies."""
    out = {}
    for name, by_shape in shapes.items():
        check(all(c % steps == 0 for c in by_shape.values()),
              f"{name}: launches not a multiple of the steps: {by_shape}")
        out[name] = collections.Counter(
            {k: c // steps for k, c in by_shape.items()})
    return out


def _paper_run(dev, name):
    """The paper's configuration through the port's ``Trainer.run`` on the
    card, then a CALIB pass on a held-out batch, held to the JAX
    reference."""
    from repro_torch.core import hgq
    from repro_torch.data import DataSpec, make_pipeline
    from repro_torch.train import TrainConfig, Trainer
    M, cfg, fwd, loss, metric, _ = _paper(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params, qstate = M.init(gen, cfg, device=dev)
    pipe = make_pipeline(DataSpec(kind=name, batch=PAPER_BATCH[name]),
                         device=dev)
    starts = []

    def timed_pipe(step):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return pipe(step)

    tcfg = TrainConfig(log_every=10, **PAPER[name])
    trainer = Trainer(fwd, loss, tcfg, params, qstate, pipeline=timed_pipe)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_counts()                           # the main path starts here
    t0 = time.perf_counter()
    trainer.run(log=lambda line: print(f"[train] {name} {line}", flush=True))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = _counts(TRAINING)                # ... and ends here
    per_step = _per_step(_shapes(TRAINING), tcfg.steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = np.diff(starts + [t1]) * 1e3
    with torch.no_grad():
        batch = pipe(10 ** 6)                 # held out
        out, qcal, aux = M.forward(trainer.params, trainer.qstate, batch,
                                   mode=hgq.CALIB)
        value = float(metric(out, batch))
        ebops = float(aux.ebops)
        o1, _, _ = M.forward(trainer.params, qcal, batch, mode=hgq.EVAL)
        o2, _, _ = M.forward(trainer.params, qcal, batch, mode=hgq.EVAL)
    hist = {h["step"]: h["ebops"] for h in trainer.history}
    peak_step = max(hist, key=hist.get)
    last = max(hist)
    ref_value, ref_ebops = PAPER_REF[name]
    report = {
        "config": f"benchmarks/paper_tables.py {name}: batch "
                  f"{PAPER_BATCH[name]}, {PAPER[name]}, per-parameter "
                  f"weights, per-tensor activations, init f 6",
        "metric": ("accuracy" if name == "svhn" else "rms_resolution_mrad"),
        "value": value, "jax_cpu_reference": ref_value,
        "calib_ebops": ebops, "jax_cpu_calib_ebops": ref_ebops,
        "train_ebops": {"step0": hist[0], "peak": hist[peak_step],
                        "peak_step": peak_step, "last": hist[last],
                        "last_step": last},
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "samples_per_s": tcfg.steps * PAPER_BATCH[name] / (t1 - t0),
        "wall_s": t1 - t0, "peak_mem_gib": peak, "launches": counts,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items()},
        "eval_repeatable": torch.equal(o1, o2)}
    print(f"[train] {name} on the card: {json.dumps(report)}", flush=True)
    want = _paper_per_step(name)
    check(per_step == want,
          f"{name}: launches a step {per_step}, not {want}")
    check(counts == {k: sum(c.values()) * tcfg.steps
                     for k, c in want.items()},
          f"{name}: launches {counts} over {tcfg.steps} steps")
    if name == "svhn":
        check(value >= ref_value - PAPER_ACC_MARGIN,
              f"svhn accuracy {value} below the JAX reference {ref_value} "
              f"by more than {PAPER_ACC_MARGIN}")
    else:
        check(abs(value - ref_value) <= PAPER_REL_MARGIN * ref_value,
              f"muon resolution {value} mrad not within "
              f"{PAPER_REL_MARGIN:.0%} of the JAX reference {ref_value}")
    check(abs(ebops - ref_ebops) <= PAPER_REL_MARGIN * ref_ebops,
          f"{name}: CALIB ~EBOPs {ebops} not within {PAPER_REL_MARGIN:.0%} "
          f"of the JAX reference {ref_ebops}")
    # the beta ramp's pressure: ~EBOPs fall from step 0 (muon), or, where
    # the growing activation ranges first raise them (SVHN, as in the
    # reference), from their peak
    fell_from = 0 if name == "muon" else peak_step
    check(hist[last] < hist[fell_from] and peak_step < last,
          f"{name}: ~EBOPs did not fall: {report['train_ebops']}")
    check(report["eval_repeatable"], f"{name}: two EVAL forwards differ")
    return trainer, report, per_step


def _paper_card_vs_cpu(dev, name):
    M, cfg, fwd, loss, _, batch_fn = _paper(name)
    cpu = torch.device("cpu")
    model = M.init(torch.Generator().manual_seed(SEED + 1), cfg, device=cpu)
    batches = [batch_fn(SEED, s, PAPER_BATCH[name], device=cpu)
               for s in range(20)]
    controls = ({"conv_tf32": _conv_tf32,
                 "df_without_ln2_delta": _df_without_ln2_delta}
                if name == "svhn" else
                {"df_without_ln2_delta": _df_without_ln2_delta,
                 "forward_fi_floor_f": _rounding_down})
    return _card_vs_cpu(dev, name, model, batches, controls,
                        PAPER_TRAJ_REL_LIMIT[name],
                        dict(fwd=fwd, loss=loss, config=PAPER[name]))


# ---------------------------------------------------------------------------
# qwen2-0.5b: HGQ training at full width, and the no-cache prefill
# ---------------------------------------------------------------------------

# the launcher's optimizer settings (src/repro/api/spec.py: 20 steps, lr
# 1e-3, beta 1e-9 -> 1e-7; gamma the Trainer's default)
LM_TRAIN = dict(steps=20, lr=1e-3, beta0=1e-9, beta1=1e-7)
# the cell's first steps run twice on the card, compared bit for bit
LM_REPEAT_STEPS = 3
# Step 0's loss against ln(vocab) = 11.931.  The random table is U(+-0.02)
# on a 2^-6 grid (61% of its entries +-2^-6, the rest 0) and the final norm
# gives unit activations, so the logits have variance 896 * 1.49e-4 = 0.134
# whatever the depth, and the loss sits near ln(vocab) + 0.134 / 2 = 11.998
# (12.0014 on the CPU at 2 layers).  The margin is twice that excess.
LM_LOSS0_MARGIN = 0.15
# The card against the CPU: the same code at full width, 2 layers, batch
# 2, seq 256, chunks of 128 (so that they still interleave), 5 steps.
# After the first update the loss trajectories part at once: an ulp of
# another summation order moves a weight across its 2^-6 rounding point
# (AdamW's first steps move every weight by about +-lr), and a random
# model's loss answers every such flip alike (a sound gap of 2.6e-4 at
# step 1, as large as the faulty controls').  So the loss is compared at
# step 0 (one init, one batch: the forwards' rounding ties alone) and
# ~EBOPs, which follow the continuous f and the range states, at every
# step; the limit lies between the sound reading and the three faulty
# controls' (readings in PERF.md).
LM_SMALL = dict(n_layers=2, q_chunk=128, k_chunk=128)
LM_SMALL_SEQ = 256
LM_TRAJ_STEPS = 5
LM_TRAJ_REL_LIMIT = 1e-5


def _lm(cfg):
    """(forward, loss) of the LM training step at ``cfg``."""
    from repro_torch.models import TransformerLM
    from repro_torch.train import lm_loss
    return (lambda p, q, b, mode: TransformerLM.forward(p, q, b, cfg, mode),
            lambda out, b: lm_loss(out, b["tokens"]))


def _lm_small_cfg():
    from repro_torch.configs import get
    return dataclasses.replace(get("qwen2-0.5b"), **LM_SMALL)


def _lm_per_step(B, S, L, chunk, remat=True):
    """A step's ``hgq_quantize`` launches by shape, as the wrappers key
    them: the table's forward twice (the embedding, the tied head), each
    layer's activation quantizers and its one grouped forward of 10
    weights and biases (twice under remat: the backward recomputes the
    layer), the final norm's; one backward a quantizer."""
    f32 = "float32"
    table = ("per_channel", (QWEN["V"], QWEN["d"]), f32)
    acts = [("per_tensor", s, f32) for s in _lm_layer_acts(B, S, chunk)]
    members = tuple((lay, s, f32) for lay, s in _lm_layer_members())
    final = ("per_tensor", (B, S, QWEN["d"]), f32)
    passes = 2 if remat else 1
    return {"hgq_quantize_fwd": collections.Counter(
                [table] * 2 + acts * (L * passes) + [final]),
            "hgq_quantize_fwd_group": collections.Counter(
                {members: L * passes}),
            "hgq_quantize_bwd": collections.Counter(
                [table] * 2 + (acts + list(members)) * L + [final])}


def _granite_per_step(B, S, L):
    """granite's step by shape: the table's and the untied head's forward
    once each, each layer's 8 activation quantizers and its one grouped
    forward of 8 weights (the router and the three expert stacks among
    them) twice (remat), the final norm's; one backward a quantizer."""
    from repro_torch.kernels.hgq_quantize import layout_of
    f32 = "float32"
    weights = [(layout_of(s, f), s, f32) for s, f, _ in
               (GRANITE_TABLE, GRANITE_HEAD)]
    acts = [("per_tensor", s, f32) for s in _granite_layer_acts(B, S)]
    members = tuple((layout_of(s, f), s, f32)
                    for s, f in _granite_layer_members())
    final = ("per_tensor", (B, S, GRANITE["d"]), f32)
    return {"hgq_quantize_fwd": collections.Counter(
                weights + acts * (2 * L) + [final]),
            "hgq_quantize_fwd_group": collections.Counter({members: 2 * L}),
            "hgq_quantize_bwd": collections.Counter(
                weights + (acts + list(members)) * L + [final])}


# Step 0's loss of granite's cell against ln(vocab) = 10.803.  Its head is
# untied, LeCun-uniform U(+-sqrt(3 / d)): a logit over the final norm's
# unit-RMS output has variance d * (1 / d) = 1, and the loss sits at
# ln(vocab) + 1 / 2 = 11.303 whatever the depth (11.327 on the CPU at one
# layer and the cell's batch); the margin is qwen2's, LM_LOSS0_MARGIN.
GRANITE_LOSS0_EXCESS = 0.5


@dataclasses.dataclass(frozen=True)
class LMCell:
    """An LM training cell of the train phase: the config at its published
    width (``dims`` checked against it), batch, seq and steps (of
    ``LM_TRAIN``'s ramp), what step 0's loss should be near, the launches
    a step, the parameters the MFU line counts, whether the card holds
    one such model at a time (the step donates its params and AdamW
    state, the step is profiled at once and the first run freed before
    the repeat), and the layers it trains where that is fewer than the
    published depth (None: all)."""
    name: str
    arch: str
    dims: dict
    tied_and_qkv_bias: tuple
    batch: int
    seq: int
    desc: str
    steps: int
    loss0_excess: float
    per_step: object
    mfu_params: str
    one_at_a_time: bool
    layers: Optional[int] = None


def _lm_dims(cfg):
    dims = dict(L=cfg.n_layers, d=cfg.d_model, H=cfg.n_heads, KV=cfg.n_kv,
                hd=cfg.hd, ff=cfg.d_ff, V=cfg.vocab)
    if cfg.moe_experts:
        dims.update(E=cfg.moe_experts, k=cfg.moe_top_k)
    else:
        dims["chunk"] = cfg.q_chunk
    return dims


QWEN_CELL = LMCell(
    "lm", "qwen2-0.5b", QWEN, (True, True), LM_BATCH, LM_SEQ,
    "configs/qwen2_0_5b.py FULL (24 layers, d 896, 14 heads, 2 kv heads, "
    "ff 4864, vocab 151936, QKV bias, tied embeddings; arXiv:2407.10671), "
    "random weights from the seed, lm data, batch 2, seq 2048, q_chunk = "
    "k_chunk = 1024, remat; 5 steps, lr 1e-3, beta 1e-9 -> 1e-7 over "
    "them",
    5, 0.0, lambda cfg: _lm_per_step(LM_BATCH, LM_SEQ, cfg.n_layers,
                                      cfg.q_chunk),
    "n_params", False)
GRANITE_CELL = LMCell(
    "granite", "granite-moe-3b-a800m", GRANITE, (False, False),
    GRANITE_BATCH, GRANITE_SEQ,
    "configs/granite_moe_3b_a800m.py FULL (32 layers, d 1536, 24 heads over "
    "8 kv heads, 40 experts of d_ff 512, top 8, vocab 49155, untied head; "
    "hf:ibm-granite), per-channel weights (the expert stacks per expert "
    "channel), per-tensor activations, init f 6; random weights from the "
    "seed, lm data, batch 2, seq 1024 (C = 256 slots an expert a row), "
    "remat; 4 of its 32 layers (all 32 held in earlier runs, cut for the "
    "script's time); 10 steps, lr 1e-3, beta 1e-9 -> 1e-7; params and "
    "AdamW state updated in place",
    10, GRANITE_LOSS0_EXCESS,
    lambda cfg: _granite_per_step(GRANITE_BATCH, GRANITE_SEQ, cfg.n_layers),
    "n_active_params", True, layers=4)


def _lm_run(dev, cell, counted=None):
    """``cell`` through the port's ``Trainer.run`` on the card:
    ``LM_TRAIN`` at its batch and seq, random weights from ``SEED``, the
    ``lm`` data kind; steps timed, a step's launches tallied by shape;
    then the first ``LM_REPEAT_STEPS`` steps again from the same init,
    checked to give the same bits.  One model at a time: the first run's
    step is profiled and the run freed before the repeat.  Returns (the
    first run's Trainer, or None where it was freed, the report, the
    launches a step by shape).  ``counted``: the dry run's count of the
    cell's step on ``meta`` (``WORK_CELLS``), whose share of the float32
    peak and ratio to the useful FLOPs print beside ``lm_train_mfu_fp32``."""
    from repro_torch.configs import get
    from repro_torch.core.ebops import useful_model_flops_dense
    from repro_torch.data import DataSpec, make_pipeline
    from repro_torch.models import TransformerLM
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get(cell.arch)
    check(_lm_dims(cfg) == cell.dims and cfg.k_chunk == cfg.q_chunk
          and cfg.remat
          and (cfg.tie_embeddings, cfg.qkv_bias) == cell.tied_and_qkv_bias,
          f"not {cell.arch} at its published width: {_lm_dims(cfg)}")
    if cell.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=cell.layers)
    fwd, loss = _lm(cfg)
    pipe = make_pipeline(DataSpec(kind="lm", batch=cell.batch, seq=cell.seq,
                                  vocab=cfg.vocab, seed=SEED), device=dev)
    tcfg = TrainConfig(log_every=1, **dict(LM_TRAIN, steps=cell.steps))

    def init():
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        return TransformerLM.init(gen, cfg, device=dev)

    if cell.one_at_a_time:
        gc.collect()
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    params, qstate = init()
    n_tree = sum(t.numel() for t in tree_leaves(params))
    starts, snap = [], {}

    def timed_pipe(step):
        # a step runs from one batch request to the next; the state after
        # the repeated steps is copied out of step LM_REPEAT_STEPS - 1's time
        torch.cuda.synchronize()
        if step == LM_REPEAT_STEPS:
            t = time.perf_counter()
            snap["state"] = tree_map(
                lambda a: a.detach().to("cpu", copy=True),
                (trainer.params, trainer.qstate))
            snap["s"] = time.perf_counter() - t
        starts.append(time.perf_counter())
        return pipe(step)

    trainer = Trainer(fwd, loss, tcfg, params, qstate, pipeline=timed_pipe,
                      donate=cell.one_at_a_time)
    del params, qstate
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_counts()                           # the main path starts here
    t0 = time.perf_counter()
    trainer.run(log=lambda line: print(f"[train] {cell.name} {line}",
                                       flush=True))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = _counts(TRAINING)                # ... and ends here
    per_step = _per_step(_shapes(TRAINING), tcfg.steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = np.diff(starts + [t1]) * 1e3
    step_ms[LM_REPEAT_STEPS - 1] -= snap["s"] * 1e3
    med = float(np.median(step_ms))
    hist = trainer.history
    profiled = None
    if cell.one_at_a_time:
        profiled = _profile_step(trainer, per_step, cell.name, med)
        trainer = None
        gc.collect()
        torch.cuda.empty_cache()
    # the same init again, its first steps
    p2, q2 = init()
    again = Trainer(fwd, loss, tcfg, p2, q2, pipeline=pipe,
                    donate=cell.one_at_a_time)
    del p2, q2
    again.run(steps=LM_REPEAT_STEPS, log=lambda *a: None)
    same_metrics = again.history == hist[:LM_REPEAT_STEPS]
    same_state = all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves((again.params, again.qstate)),
        tree_leaves(snap.pop("state"))))
    del again
    if cell.one_at_a_time:
        gc.collect()
        torch.cuda.empty_cache()
    tokens = cell.batch * cell.seq
    n_mfu = getattr(cfg, cell.mfu_params)()
    report = {
        "config": cell.desc,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "n_params_tree": n_tree,
        "loss": [h["loss"] for h in hist], "ln_vocab": math.log(cfg.vocab),
        "loss0_expected": math.log(cfg.vocab) + cell.loss0_excess,
        "ebops": [h["ebops"] for h in hist],
        "step_ms_median": med, "step_ms_p90": float(np.percentile(step_ms,
                                                                   90)),
        "tokens_per_s": tokens / (med / 1e3), "wall_s": t1 - t0,
        "peak_mem_gib": peak, "held_before_gib": held,
        "lm_train_mfu_fp32": useful_model_flops_dense(n_mfu, tokens)
        / (med / 1e3 * peak_rate("float32")),
        "mfu_counts": f"6 * {cell.mfu_params} ({n_mfu}) * tokens",
        "counted_flops": None if counted is None
        else counted.get("flops_total"),
        "counted_flops_share_fp32": None if not counted
        else counted["flops_total"] / (med / 1e3 * peak_rate("float32")),
        "useful_flops_ratio": None if not counted
        else useful_model_flops_dense(n_mfu, tokens)
        / counted["flops_total"],
        "launches": counts,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items()},
        "repeat": {"steps": LM_REPEAT_STEPS, "metrics_equal": same_metrics,
                   "params_and_qstate_equal": same_state}}
    if profiled is not None:
        report["profiled_step"] = profiled
    print(f"[train] {cell.name} on the card: {json.dumps(report)}",
          flush=True)
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["ebops"])
              for h in hist), f"{cell.name}: a loss or ~EBOPs is not finite")
    check(abs(hist[0]["loss"] - report["loss0_expected"]) <= LM_LOSS0_MARGIN,
          f"{cell.name}: step 0 loss {hist[0]['loss']} not within "
          f"{LM_LOSS0_MARGIN} of {report['loss0_expected']} (ln(vocab) "
          f"{math.log(cfg.vocab)} + {cell.loss0_excess})")
    check(all(h["ebops"] > 0 for h in hist),
          f"{cell.name}: ~EBOPs not reported")
    want = cell.per_step(cfg)
    check(per_step == want,
          f"{cell.name}: launches a step {per_step}, not {want}")
    check(counts == {k: sum(c.values()) * tcfg.steps
                     for k, c in want.items()},
          f"{cell.name}: launches {counts} over {tcfg.steps} steps")
    check(same_metrics and same_state,
          f"{cell.name}: two card runs of the first {LM_REPEAT_STEPS} steps "
          f"differ (metrics equal: {same_metrics}, state equal: "
          f"{same_state})")
    return trainer, report, per_step


@contextlib.contextmanager
def _matmul_tf32():
    """Control: float32 matmuls in TF32 (cuBLAS's reduced-precision
    path), forward and backward."""
    real = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = real


@contextlib.contextmanager
def _probs_one_softmax():
    """Control: the attention probabilities quantized after one softmax
    over all keys (one key chunk of S) instead of per chunk pair."""
    import repro_torch.nn.attention as attn
    real = attn._chunked_attention

    def whole(qh, kh, vh, positions, cfg, probs_f, mode):
        return real(qh, kh, vh, positions,
                    dataclasses.replace(cfg, k_chunk=qh.shape[1]), probs_f,
                    mode)

    attn._chunked_attention = whole
    try:
        yield
    finally:
        attn._chunked_attention = real


def _lm_card_vs_cpu(dev):
    from repro_torch.data import lm_batch
    from repro_torch.models import TransformerLM
    cfg = _lm_small_cfg()
    fwd, loss = _lm(cfg)
    cpu = torch.device("cpu")
    model = TransformerLM.init(torch.Generator().manual_seed(SEED + 1), cfg,
                               device=cpu)
    batches = [lm_batch(SEED, s, LM_BATCH, LM_SMALL_SEQ, cfg.vocab,
                        device=cpu) for s in range(LM_TRAJ_STEPS)]
    return _card_vs_cpu(dev, "lm (2 layers, seq 256)", model, batches,
                        {"matmul_tf32": _matmul_tf32,
                         "probs_one_softmax": _probs_one_softmax,
                         "df_without_ln2_delta": _df_without_ln2_delta},
                        LM_TRAJ_REL_LIMIT,
                        dict(fwd=fwd, loss=loss, config=LM_TRAIN),
                        loss_steps=1)


# granite's card against the CPU: the same code at full width, 2 layers,
# batch 2, seq 128, chunks of 64 (C = 32 slots an expert a row), one init.
# Two readings, as the granite serving part has, each of step 0's loss,
# every step's ~EBOPs and every leaf's first AdamW moment after step 0
# (0.1 of the clipped gradient; the gap to the CPU's over the leaf's
# largest entry), relative gaps held to per-quantity limits.  Continuous
# (no activation quantizer and no probability grid, so no rounding tie
# can flip a route; ~EBOPs are then 0), one step: the fine check, every
# control 3000x over its limit from each of six inits.  As trained, 5
# steps: float32 noise puts attention probabilities on either side of a
# grid tie, routes flip downstream (``torch_granite_gaps.py
# --tie-report``), and a token's share of an expert's gradient moves; a
# range or a weight crossing a power of two moves ~EBOPs by a quantum
# (2.2e-4, 1.5e-3) after the first update.  So the as-trained limits are
# gross bounds, set over six inits (``torch_granite_gaps.py --inits 6``)
# at 1.8-3.3 times the largest sound reading: of the controls only the
# summed df lies above them from every init (moments 2.6x over); the
# other two do so from this init.  Readings in PERF.md.
GRANITE_SMALL = dict(n_layers=2, q_chunk=64, k_chunk=64)
GRANITE_SMALL_SEQ = 128
GRANITE_LIMITS = {
    "continuous": {"loss0_rel": 1e-4, "ebops_rel": 1e-4, "moment_rel": 1e-4},
    "as_trained": {"loss0_rel": 2e-4, "ebops_rel": 5e-3, "moment_rel": 1.0}}


def _granite_small_cfg():
    from repro_torch.configs import get
    return dataclasses.replace(get("granite-moe-3b-a800m"), **GRANITE_SMALL)


@contextlib.contextmanager
def _expert_df_summed():
    """Control: an expert stack's f gradient summed over all its experts
    (the per-expert backward reducing across the experts' boundary)."""
    import repro_torch.kernels.hgq_quantize.ops as ops
    real = ops.hgq_quantize_bwd

    def summed(g, x, f):
        df = real(g, x, f)
        if ops.layout_of(x.shape, f.shape) in ("per_expert_channel",
                                               "per_expert_tensor"):
            return df.sum(0, keepdim=True).expand_as(df).contiguous()
        return df

    summed.launches, summed.shapes = 0, collections.Counter()
    ops.hgq_quantize_bwd = summed
    try:
        yield
    finally:
        ops.hgq_quantize_bwd = real


def _granite_controls():
    """{name: a context manager that puts one fault in the code}."""
    return {**{name: fault for name, (_, fault) in _moe_controls(None).items()},
            "expert_df_summed": _expert_df_summed}


def _continuous(tree):
    """The tree without activation quantizers and the probabilities'
    grids (every ``probs_f``), in dicts and in lists of layers."""
    if isinstance(tree, dict):
        return {k: _continuous(v) for k, v in _without_act_quantizers(
            tree).items() if k != "probs_f"}
    if isinstance(tree, list):
        return [_continuous(v) for v in tree]
    return tree


def _granite_run(dev, params, qstate, batches, fwd, loss):
    """``len(batches)`` steps of ``LM_TRAIN`` on ``dev`` from the given
    init: ([(loss, ~EBOPs)] per step, every leaf's AdamW first moment
    after step 0, on ``dev``)."""
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves, tree_map
    to = lambda t: t.to(dev)
    first = []

    def pipe(step):
        if step == 1:
            first.extend(t.detach().clone() for t in tree_leaves(tr.opt.mu))
        return tree_map(to, batches[step])

    tcfg = TrainConfig(log_every=1, **dict(LM_TRAIN, steps=len(batches)))
    tr = Trainer(fwd, loss, tcfg, tree_map(to, params), tree_map(to, qstate),
                 pipeline=pipe)
    tr.run(log=lambda *a: None)
    if not first:
        first.extend(t.detach().clone() for t in tree_leaves(tr.opt.mu))
    return [(h["loss"], h["ebops"]) for h in tr.history], first


def _granite_gaps(run, ref, limits):
    """A run's relative gaps to the reference and, as "gap", the largest
    over its limit (above 1: a limit exceeded)."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    out = {"loss0_rel": rel(run[0][0][0], ref[0][0][0]),
           "ebops_rel_steps": [rel(h[1], r[1])
                               for h, r in zip(run[0], ref[0])],
           "moment_rel": max(float((a - b).abs().max())
                             / max(float(b.abs().max()), 1e-30)
                             for a, b in zip(run[1], ref[1]))}
    out["ebops_rel"] = max(out["ebops_rel_steps"])
    out["gap"] = max(out[k] / v for k, v in limits.items())
    return out


def _granite_readings(dev, seed, gaps=_granite_gaps):
    """Both readings from the init made from ``seed``: {reading: the
    sound gaps, each control's (``gaps(run, ref, limits)``), and whether
    two card runs gave the same bits}."""
    from repro_torch.data import lm_batch
    from repro_torch.models import TransformerLM
    cfg = _granite_small_cfg()
    fwd, loss = _lm(cfg)
    cpu = torch.device("cpu")
    params, qstate = TransformerLM.init(
        torch.Generator().manual_seed(seed), cfg, device=cpu)
    batches = [lm_batch(SEED, s, GRANITE_BATCH, GRANITE_SMALL_SEQ, cfg.vocab,
                        device=cpu) for s in range(LM_TRAJ_STEPS)]
    out = {}
    for name, tree, steps in (("continuous", _continuous(params), 1),
                              ("as_trained", params, LM_TRAJ_STEPS)):
        limits = GRANITE_LIMITS[name]
        run = lambda d: _granite_run(d, tree, qstate, batches[:steps], fwd,
                                     loss)
        # the CPU's moments compared on the card: one copy, not one a run
        ref = run(cpu)
        ref = (ref[0], [t.to(dev) for t in ref[1]])
        card, again = run(dev), run(dev)
        same = card[0] == again[0] and all(
            torch.equal(a, b) for a, b in zip(card[1], again[1]))
        faulty = {}
        for cname, fault in _granite_controls().items():
            with fault():
                faulty[cname] = gaps(run(dev), ref, limits)
        out[name] = {"steps": steps, "limits": limits,
                     "sound": gaps(card, ref, limits),
                     "repeat_bit_identical": same, "controls": faulty}
    return out


def _granite_card_vs_cpu(dev):
    """Both readings: the sound gap of each under its limit, every
    control's above it, two card runs bit-identical."""
    out = _granite_readings(dev, SEED + 1)
    for name, r in out.items():
        print(f"[train] granite (2 layers, seq {GRANITE_SMALL_SEQ}) card vs "
              f"CPU, {name}: {json.dumps(r)}", flush=True)
        check(r["repeat_bit_identical"],
              f"granite {name}: two card runs differ")
        check(r["sound"]["gap"] <= 1.0,
              f"granite {name}: card vs CPU {r['sound']} beyond "
              f"{r['limits']}")
        check(all(c["gap"] > 1.0 for c in r["controls"].values()),
              f"granite {name}: the check misses a control: "
              f"{r['controls']}")
    return out


# Prefill against decode at full width, 2 layers, S = 256 over two query
# and key chunks of 128, batch 2, teacher-forced.  As served, the
# activation quantizers' rounding ties (an ulp of another summation order
# decides them) and the bf16 or 8-bit storage of k and v move the logits
# by a few percent and flip near-tie argmaxes: only gross faults are bounded
# (LOGITS_REL_GROSS, LM_PD_AGREE_SERVED).  Without the activation
# quantizers and the probabilities' grid the function is continuous: on a
# float32 cache the two paths differ by the order of float32 operations
# (LM_PD_REL_LIMIT) and give the same greedy tokens; the 8-bit ring adds
# its rounding of k and v (LM_PD_REL_RING).  Readings in PERF.md.
LM_PD_SEQ = 256
LM_PD_AGREE_SERVED = 0.75
LM_PD_REL_LIMIT = 1e-4
LM_PD_REL_RING = 0.05


def _lm_prefill_vs_decode(dev):
    """``TransformerLM.forward`` in EVAL against ``decode_step`` token by
    token, on the fp cache and the 8-bit quantized ring (which runs
    ``kv_quantize_store`` and ``kv_attention_rows``), as served and
    continuous: {case: {"rel_l2", "max_abs", "greedy_agree"}}."""
    from repro_torch.core import hgq
    from repro_torch.data import lm_batch
    from repro_torch.models import TransformerLM
    cfg = _lm_small_cfg()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    p, q = TransformerLM.init(gen, cfg, device=dev)
    toks = lm_batch(SEED + 2, 0, LM_BATCH, LM_PD_SEQ, cfg.vocab,
                    device=dev)["tokens"]
    attn = {k: v for k, v in p["layers"]["attn"].items() if k != "probs_f"}
    pc = _without_act_quantizers({**p, "layers": {**p["layers"],
                                                  "attn": attn}})

    def run(pp, kv_bits, dtype):
        with torch.no_grad():
            full, _, _ = TransformerLM.forward(pp, q, {"tokens": toks}, cfg,
                                               mode=hgq.EVAL)
            cache = TransformerLM.init_cache(cfg, LM_BATCH, LM_PD_SEQ,
                                             dtype=dtype, kv_bits=kv_bits,
                                             device=dev)
            got = []
            for t in range(LM_PD_SEQ):
                lg, cache = TransformerLM.decode_step(
                    pp, q, cache, toks[:, t:t + 1], t, cfg, kv_bits=kv_bits)
                got.append(lg[:, 0])
            got = torch.stack(got, dim=1)
        check(bool(torch.isfinite(full).all() and torch.isfinite(got).all()),
              "lm prefill / decode logits not finite")
        return {"rel_l2": float((got - full).norm() / full.norm()),
                "max_abs": float((got - full).abs().max()),
                "greedy_agree": float((got.argmax(-1) == full.argmax(-1))
                                      .float().mean())}

    out = {"served_fp_bf16": run(p, None, torch.bfloat16),
           "served_ring_8": run(p, 8, torch.bfloat16),
           "continuous_fp_f32": run(pc, None, torch.float32),
           "continuous_ring_8": run(pc, 8, torch.bfloat16)}
    print(f"[train] lm prefill vs decode (full width, 2 layers, S "
          f"{LM_PD_SEQ}, chunks of 128): {json.dumps(out)}", flush=True)
    for case in ("served_fp_bf16", "served_ring_8"):
        check(out[case]["rel_l2"] <= LOGITS_REL_GROSS
              and out[case]["greedy_agree"] >= LM_PD_AGREE_SERVED,
              f"lm prefill vs decode, {case}: {out[case]}")
    c = out["continuous_fp_f32"]
    check(c["rel_l2"] <= LM_PD_REL_LIMIT and c["greedy_agree"] == 1.0,
          f"lm prefill vs decode, continuous, float32 cache: {c}")
    check(out["continuous_ring_8"]["rel_l2"] <= LM_PD_REL_RING,
          f"lm prefill vs decode, continuous, 8-bit ring: "
          f"{out['continuous_ring_8']}")
    return out


# ---------------------------------------------------------------------------
# HGQ training of the hybrid (Griffin), ssm (RWKV-6) and audio (Whisper)
# families at their published widths
# ---------------------------------------------------------------------------

FAMILY_STEPS = 5
FAMILY_BATCH = 2
# The card against the CPU: step 0's loss and gradient (the step's
# ``train.loop._value_and_grad``) from one init and one batch at the
# cell's width and depth, the CPU at a shorter sequence (``small_seq``:
# Griffin 64, RWKV 128, Whisper 256 and 250 frames) for its time.  The
# trees lose their activation quantizers and the probabilities' grids
# (``_continuous``): with them a one-ulp difference of another summation
# order decides a rounding tie and moves the loss and the gradient by a
# grid step, a gap that would hide a fault of a few parameters'
# gradients.  RWKV's init constants are redrawn
# (``rwkv_constants``, as its serving reading does): with ``bonus_u`` at
# 0 its gradient is 30x the embedding's and so ill-conditioned that a
# 1e-7 relative change of the weights moves the tree's gradient by 1.9e-3
# (d 512, the CPU), which is what the card read (3.8e-3).  The readings:
# the loss's relative gap and the whole gradient tree's relative L2 gap;
# each limit lies between the sound reading and those of two faulty
# controls, one of which changes only the backward (readings in PERF.md).
FAMILY_SMALL_FRAMES = 250
FAMILY_LIMITS = {"loss_rel": 1e-5, "grad_rel_l2": 1e-4}
# step 0's loss against ln(vocab): an untied LeCun-uniform head over the
# final norm's unit-RMS output gives logits of variance 1 (Griffin, RWKV:
# ln(vocab) + 1/2, as granite's); Whisper's head is its table, U(+-0.02)
# on the 2^-6 grid, variance d * 1.49e-4 = 0.191 (ln(vocab) + 0.095, as
# qwen2's); the margin is qwen2's, LM_LOSS0_MARGIN
WHISPER_LOSS0_EXCESS = 0.5 * WHISPER["d"] * 1.49e-4


# the published widths each cell checks its config against (its depth is
# the published depth, before the cut)
GRIFFIN_TRAIN_DIMS = dict(L=GRIFFIN["L"], d=GRIFFIN["d"], H=GRIFFIN["H"],
                          KV=GRIFFIN["KV"], hd=GRIFFIN["hd"],
                          ff=GRIFFIN["ff"], V=GRIFFIN["V"],
                          window=GRIFFIN["window"])
RWKV_TRAIN_DIMS = dict(L=RWKV["L"], d=RWKV["d"], H=32, KV=32, hd=64,
                       ff=RWKV["ff"], V=RWKV["V"], chunk=64)
WHISPER_TRAIN_DIMS = dict(L=WHISPER["L"], d=WHISPER["d"], H=WHISPER["H"],
                          KV=WHISPER["KV"], hd=WHISPER["hd"],
                          ff=WHISPER["ff"], V=WHISPER["V"],
                          enc=WHISPER["enc"], T=WHISPER["T"])


@dataclasses.dataclass(frozen=True)
class FamilyCell:
    """A training cell of a family the LM cells do not cover: the arch at
    its published widths (``dims``, checked against the config), the depth
    it is cut to (config fields), the data kind and sequence, what step 0's
    loss should be near, and its faulty controls (name -> (whether it
    changes the backward only, a context manager factory)); the
    card-vs-CPU reading's sequence, and what it redraws in its init
    (``redraw(params, gen)``, in place)."""
    name: str
    arch: str
    dims: dict
    depth: dict
    kind: str
    seq: int
    loss0_excess: float
    desc: str
    controls: object
    small_seq: int = 256
    redraw: object = None


def _family_dims(cfg):
    dims = dict(L=cfg.n_layers, d=cfg.d_model, H=cfg.n_heads, KV=cfg.n_kv,
                hd=cfg.hd, ff=cfg.d_ff, V=cfg.vocab)
    if cfg.family == "audio":
        dims.update(enc=cfg.enc_layers, T=cfg.enc_seq)
    if cfg.family == "hybrid":
        dims["window"] = cfg.window
    if cfg.family == "ssm":
        dims["chunk"] = cfg.rwkv_chunk
    return dims


def _griffin_train_controls():
    """The scan's decay ``a`` detached (the backward loses the
    recurrence's path into ``lambda`` and ``gate_a``; the forward is the
    same), and the RG-LRU without its input normalization (forward)."""
    import repro_torch.nn.recurrent as rec
    return {"scan_a_detached": (True, lambda: _patched(
                rec, "_linear_scan", lambda real: lambda a, b, h0:
                real(a.detach(), b, h0))),
            "rglru_without_input_norm": (
                False, _griffin_controls(None)["rglru_without_input_norm"][1])}


def _rwkv_train_controls():
    """The WKV's decay ``w`` detached (the backward loses its path into
    the decay LoRA and ``decay_w0``; the forward is the same), and the
    per-head norm left out (forward)."""
    import repro_torch.nn.recurrent as rec
    return {"wkv_w_detached": (True, lambda: _patched(
                rec, "_wkv_chunked", lambda real: lambda r, k, v, w, u, s,
                c: real(r, k, v, w.detach(), u, s, c))),
            "head_norm_left_out": (
                False, _rwkv_controls(None)["head_norm_left_out"][1])}


def _whisper_train_controls():
    """The encoder memory detached before the cross K/V (the backward
    loses every path from the decoder into the encoder; the forward is
    the same), and the decoder's learned positions dropped (forward)."""
    import repro_torch.models.whisper as wh
    from repro_torch.core.hgq import QTensor
    return {"cross_memory_detached": (True, lambda: _patched_static(
                wh.CrossAttention, "kv", lambda real: lambda p, q, m, *a:
                real(p, q, QTensor(m.q.detach(), m.bits), *a))),
            "decoder_positions_dropped": (False, _whisper_controls(None)[
                "decoder_positions_dropped"][1])}


FAMILY_CELLS = (
    FamilyCell(
        "griffin", "recurrentgemma-2b", GRIFFIN_TRAIN_DIMS, {"n_layers": 5},
        "lm", 2048, GRANITE_LOSS0_EXCESS,
        "configs/recurrentgemma_2b.py FULL (d 2560, 10 heads over 1 kv head "
        "of 256, window 2048, MLP 7680, vocab 256000, untied head; "
        "arXiv:2402.19427), random weights from the seed, lm data, batch 2, "
        "seq 2048, remat; 5 of its 26 layers (one (rec, rec, att) unit and "
        "the 2-layer recurrent remainder, as served); 5 steps of the "
        "launcher's settings (lr 1e-3, beta 1e-9 -> 1e-7 over them) through "
        "build(spec).init_training(), params and AdamW state in place",
        _griffin_train_controls, small_seq=64),
    FamilyCell(
        "rwkv", "rwkv6-1.6b", RWKV_TRAIN_DIMS, {"n_layers": 2}, "lm", 2048,
        GRANITE_LOSS0_EXCESS,
        "configs/rwkv6_1_6b.py FULL (d 2048, 32 heads of 64, channel mix "
        "7168, vocab 65536, WKV chunks of 64; arXiv:2404.05892), random "
        "weights from the seed, lm data, batch 2, seq 2048 (32 WKV chunks), "
        "remat; 2 of its 24 layers; 5 steps of the launcher's settings "
        "through build(spec).init_training(), params and AdamW state in "
        "place", _rwkv_train_controls, small_seq=128, redraw=rwkv_constants),
    FamilyCell(
        "whisper", "whisper-large-v3", WHISPER_TRAIN_DIMS,
        {"n_layers": 2, "enc_layers": 2}, "asr", 448, WHISPER_LOSS0_EXCESS,
        "configs/whisper_large_v3.py FULL (d 1280, 20 heads of 64, MLP "
        "5120, vocab 51866, 1500 frames; arXiv:2212.04356), random weights "
        "from the seed, asr data (1500 frame embeddings and 448 tokens, "
        "Whisper's text context), batch 2, remat; 2 + 2 of its 32 + 32 "
        "layers; 5 steps of the launcher's settings through "
        "build(spec).init_training(), params and AdamW state in place",
        _whisper_train_controls),
)


def _family_ctx(cell, dev, seed=SEED):
    """``build(spec)`` of the cell on ``dev``: the launcher's spec for the
    arch at full width (``--full --steps 5 --batch 2 --seq S``), the
    cell's data kind, seeds ``seed`` (init) and ``SEED`` (data); the
    config checked at its published widths, then cut to the cell's
    depth."""
    from repro_torch.api import RunSpec, build
    spec = RunSpec.from_args(["--arch", cell.arch, "--full", "--steps",
                              str(FAMILY_STEPS), "--batch",
                              str(FAMILY_BATCH), "--seq", str(cell.seq)])
    spec = dataclasses.replace(spec, seed=seed, data=dataclasses.replace(
        spec.data, kind=cell.kind, seed=SEED))
    ctx = build(spec, device=dev)
    check(_family_dims(ctx.cfg) == cell.dims and ctx.cfg.remat,
          f"{cell.name}: not {cell.arch} at its published width: "
          f"{_family_dims(ctx.cfg)}")
    ctx.cfg = dataclasses.replace(ctx.cfg, **cell.depth)
    return ctx


def _paths(tree):
    from repro_torch.tree import tree_flatten_with_path
    return [p for p, _ in tree_flatten_with_path(tree)]


@contextlib.contextmanager
def _no_plain_quantizer_on_the_card():
    """The quantizer's plain versions (``hgq_quantize.ref``) raise on a
    CUDA tensor: every TRAIN quantizer of the card's steps must launch
    the kernels."""
    import repro_torch.kernels.hgq_quantize.ref as ref

    def guard(name):
        def wrap(real):
            def plain(*args, **kw):
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                tensors += [t for a in args if isinstance(a, (list, tuple))
                            for t in a if isinstance(t, torch.Tensor)]
                if any(t.is_cuda for t in tensors):
                    raise SmokeFailure(f"{name} ran on the card")
                return real(*args, **kw)
            return plain
        return wrap

    with contextlib.ExitStack() as stack:
        for name in ("hgq_quantize_ref", "hgq_quantize_group_ref",
                     "hgq_quantize_grad_ref"):
            stack.enter_context(_patched(ref, name, guard(name)))
        yield


@contextlib.contextmanager
def _plain_quantizer_calls(tally):
    """Counts the quantizer's calls on CPU tensors made by this thread
    (a CPU graph's backward runs on the thread that asks for it) into
    ``tally`` under the kernel wrappers' keys: a single forward by
    (layout, shape, dtype), a group by its members' keys (one forward
    launch on the card), a backward by its member's key."""
    import repro_torch.kernels.hgq_quantize.ops as ops
    owner = threading.get_ident()

    def key(x, f):
        return (ops.layout_of(x.shape, f.shape), tuple(x.shape),
                str(x.dtype).replace("torch.", ""))

    def mine(x):
        return not x.is_cuda and threading.get_ident() == owner

    def fwd(real):
        def counted(x, f):
            if mine(x) and x.numel():
                tally["hgq_quantize_fwd"][key(x, f)] += 1
            return real(x, f)
        return counted

    def group(real):
        def counted(xs, fs):
            if mine(xs[0]):
                members = tuple(key(x, f) for x, f in zip(xs, fs)
                                if x.numel())
                if members:
                    tally["hgq_quantize_fwd_group"][members] += 1
            return real(xs, fs)
        return counted

    def bwd(real):
        def counted(g, x, f):
            if mine(x) and x.numel():
                tally["hgq_quantize_bwd"][key(x, f)] += 1
            return real(g, x, f)
        return counted

    with _patched(ops, "_fwd", fwd), _patched(ops, "_fwd_group", group), \
            _patched(ops, "_bwd", bwd):
        yield


def _family_batch(cell, cfg, dev):
    """The card-vs-CPU reading's batch: ``cell.small_seq`` tokens (and,
    for Whisper, ``FAMILY_SMALL_FRAMES`` frames) of the cell's data kind."""
    from repro_torch.data import asr_batch, lm_batch
    if cell.kind == "asr":
        return asr_batch(SEED, 0, FAMILY_BATCH, cell.small_seq, cfg.vocab,
                         cfg.d_model, FAMILY_SMALL_FRAMES, device=dev)
    return lm_batch(SEED, 0, FAMILY_BATCH, cell.small_seq, cfg.vocab,
                    device=dev)


def _step0_grads(ctx, params, qstate, batch):
    """(the loss, the gradient tree) of step 0: the train step's own
    ``_value_and_grad`` under the context, at step 0's beta."""
    from repro_torch.core.schedule import log_ramp
    from repro_torch.train import lm_loss
    from repro_torch.train.loop import _value_and_grad
    tc = ctx.spec.train
    beta = log_ramp(tc.beta0, tc.beta1, tc.steps)(0)
    with ctx.activate():
        _, _, _, base, grads = _value_and_grad(
            ctx.forward, lambda out, b: lm_loss(out, b["tokens"]), tc,
            params, qstate, batch, beta)
    return float(base), grads


def _grad_gap(grads, ref):
    """The whole gradient tree's relative L2 gap to ``ref`` (on one
    device), summed in float64."""
    from repro_torch.tree import tree_leaves
    num = den = 0.0
    for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
        num += float(((a.double() - b.double()) ** 2).sum())
        den += float((b.double() ** 2).sum())
    return math.sqrt(num / max(den, 1e-300))


def _family_reading_init(cell, dev):
    """The reading's init (``build(spec)`` seeded ``SEED + 1``, drawn on
    the card, ``cell.redraw`` applied, ``_continuous``) and its batch,
    copied to the CPU."""
    from repro_torch.tree import tree_map
    ctx = _family_ctx(cell, dev, seed=SEED + 1)
    params, qstate = ctx.init_state()
    if cell.redraw is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 1)
        cell.redraw(params, gen)
    trees = tree_map(lambda t: t.cpu(), (_continuous(params), qstate))
    return trees + (_family_batch(cell, ctx.cfg, torch.device("cpu")),)


def _family_cpu_step0(cell, trees):
    """The CPU's side of the cell's card-vs-CPU reading, run on a worker
    thread beside the card's work: step 0's loss and gradient of the
    reading's init and batch (``trees``) through the plain versions, and
    the quantizer's calls by key.  Every module function the card's
    faulty controls patch is one of this cell's family, and the card
    joins this reading before it patches any of its own.  The worker
    leaves two of the host's cores to the card's thread (the intra-op
    thread count is the calling thread's)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) - 2))
    t0 = time.perf_counter()
    ctx = _family_ctx(cell, torch.device("cpu"), seed=SEED + 1)
    calls = {k: collections.Counter() for k in TRAINING}
    with _plain_quantizer_calls(calls):
        loss, grads = _step0_grads(ctx, *trees)
    return {"trees": trees + (grads,), "loss": loss, "calls": calls,
            "cpu_s": time.perf_counter() - t0}


def start_family_readings(pool, dev):
    """{cell name: the future of its CPU reading}, each init drawn on the
    card now and its CPU step submitted to ``pool`` (one worker thread:
    the cells in order)."""
    return {c.name: pool.submit(_family_cpu_step0, c,
                                _family_reading_init(c, dev))
            for c in FAMILY_CELLS}


def _family_card_vs_cpu(cell, dev, cpu_future):
    """Step 0 on the card (kernels) against the CPU's (``cpu_future``,
    ``_family_cpu_step0``) from one init and one batch at the cell's width
    and depth: the gaps, the card's launches by shape against the CPU's
    quantizer calls, and each faulty control's gaps."""
    from repro_torch.tree import tree_map
    ctx_d = _family_ctx(cell, dev, seed=SEED + 1)
    cpu = cpu_future.result()
    # the CPU's gradient compared on the card: one copy
    p_d, q_d, b_d, g_ref = tree_map(lambda t: t.to(dev), cpu.pop("trees"))
    loss_c, calls = cpu["loss"], cpu["calls"]

    def reading():
        loss, grads = _step0_grads(ctx_d, p_d, q_d, b_d)
        return {"loss_rel": abs(loss - loss_c) / abs(loss_c),
                "grad_rel_l2": _grad_gap(grads, g_ref)}

    def over(r):
        return max(r[k] / v for k, v in FAMILY_LIMITS.items())

    with _no_plain_quantizer_on_the_card():
        _reset_counts()
        sound = reading()
        launches = _shapes(TRAINING)
        faulty = {}
        for name, (bwd_only, fault) in cell.controls().items():
            with fault():
                faulty[name] = dict(reading(), backward_only=bwd_only)
    out = {"seq": cell.small_seq, "cpu_loss": loss_c,
           "cpu_s": cpu["cpu_s"], "limits": FAMILY_LIMITS, "sound": sound,
           "controls": faulty, "launches_equal_cpu_calls": launches == calls}
    print(f"[train] {cell.name} card vs CPU, step 0 at seq "
          f"{cell.small_seq}: {json.dumps(out)}", flush=True)
    check(launches == calls,
          f"{cell.name}: the card's hgq_quantize launches by shape "
          f"{launches} are not the CPU's quantizer calls {calls}")
    check(over(sound) <= 1.0, f"{cell.name}: card vs CPU {sound} beyond "
                              f"{FAMILY_LIMITS}")
    check(all(over(r) > 1.0 for r in faulty.values())
          and any(r["backward_only"] for r in faulty.values()),
          f"{cell.name}: the card-vs-CPU check misses a control: {faulty}")
    del g_ref, p_d, q_d, b_d
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _hgq_case_inputs(key):
    """(x shape, f shape, dtype) of a quantizer tally key."""
    lay, shape, dt = key
    fshape = {"per_tensor": (), "per_channel": shape[-1:],
              "per_parameter": shape,
              "per_expert_channel": (shape[0],) + (1,) * (len(shape) - 2)
              + shape[-1:],
              "per_expert_tensor": (shape[0],) + (1,) * (len(shape) - 1)}[lay]
    return shape, fshape, _DTYPES[dt]


def _time_new_hgq_shapes(cases, per_step, dev):
    """Every quantizer shape a step launched that the kernel phase did not
    time, held against its plain version and timed as the kernel phase
    does, into ``cases``."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    keys = set(per_step["hgq_quantize_fwd"]) | set(
        per_step["hgq_quantize_bwd"])
    for key in sorted(keys - set(cases["hgq_quantize_fwd"])):
        k, fwd, bwd = hgq_quantize_case(*_hgq_case_inputs(key), dev, g)
        check(k == key, f"hgq_quantize: case {k} for the tally's {key}")
        cases["hgq_quantize_fwd"][key] = fwd
        cases["hgq_quantize_bwd"][key] = bwd
    for key in per_step["hgq_quantize_fwd_group"]:
        if key not in cases["hgq_quantize_fwd_group"]:
            k, case = hgq_group_case([_hgq_case_inputs(m) for m in key],
                                     dev, g)
            cases["hgq_quantize_fwd_group"][key] = case


def _family_run(cell, dev, cases, cpu_future):
    """``cell`` through ``build(spec).init_training()`` on the card: 5
    timed steps (the qstate's leaf paths after each the init's), a step's
    launches by shape, one step profiled; step 0 again from the same init
    (the same bits), counted (``analysis.ProgramTrace``); the quantizer's
    new shapes timed; step 0 on the card against the CPU.  Returns the
    report and a step's launches by shape."""
    from repro_torch.analysis import ProgramTrace
    from repro_torch.tree import tree_leaves, tree_map
    import types
    t_part = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ctx = _family_ctx(cell, dev)
    cfg = ctx.cfg
    with _no_plain_quantizer_on_the_card():
        setup = ctx.init_training()
        paths0 = _paths(setup.qstate)
        n_tree = sum(t.numel() for t in tree_leaves(setup.params))
        hist, step_ms, same_paths, snap = [], [], [], None
        torch.cuda.synchronize()
        _reset_counts()                       # the main path starts here
        for s in range(FAMILY_STEPS):
            t = time.perf_counter()
            m = setup.step(s)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            hist.append({"loss": float(m["loss"]), "ebops": float(m["ebops"])})
            same_paths.append(_paths(setup.qstate) == paths0)
            if s == 0:
                snap = tree_map(lambda a: a.detach().clone(),
                                (setup.params, setup.qstate))
        counts = _counts(TRAINING)            # ... and ends here
        per_step = _per_step(_shapes(TRAINING), FAMILY_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = float(np.median(step_ms))
        trainer = types.SimpleNamespace(
            tcfg=dataclasses.replace(ctx.spec.train, steps=FAMILY_STEPS),
            pipeline=setup.pipeline, step_fn=setup.step_fn,
            params=setup.params, qstate=setup.qstate, opt=setup.opt)
        profiled = _profile_step(trainer, per_step, cell.name, med)
        del setup, trainer
        gc.collect()
        torch.cuda.empty_cache()
        # step 0 again from the same init, counted on the way (the count's
        # dispatch mode runs every operation as it is)
        again = ctx.init_training()
        with ProgramTrace() as tr:
            m0 = again.step(0)
        torch.cuda.synchronize()
        same_bits = float(m0["loss"]) == hist[0]["loss"] and all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves((again.params, again.qstate)),
                tree_leaves(snap)))
        del again, snap
        gc.collect()
        torch.cuda.empty_cache()
    _time_new_hgq_shapes(cases, per_step, dev)
    # these families quantize each weight on its own: no grouped forward
    hgq = {k: _per_unit(k, cases[k], per_step[k], _family_unit(cell.name))
           for k in TRAINING if per_step[k]}
    tokens = FAMILY_BATCH * cell.seq
    report = {
        "config": cell.desc, "card": None,
        "n_params_tree": n_tree, "loss": [h["loss"] for h in hist],
        "ln_vocab": math.log(cfg.vocab),
        "loss0_expected": math.log(cfg.vocab) + cell.loss0_excess,
        "ebops": [h["ebops"] for h in hist], "step_ms": step_ms,
        "step_ms_median": med, "tokens_per_s": tokens / (med / 1e3),
        "peak_mem_gib": peak, "launches": counts,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items()},
        "qstate_paths_kept": same_paths, "step0_same_bits": same_bits,
        "profiled_step": profiled,
        "hgq_ms_per_step": {k: {f: v[f] for f in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")}
                            for k, v in hgq.items()},
        "counted_flops": tr.flops,
        "counted_flops_share_fp32": tr.flops / (med / 1e3
                                                * peak_rate("float32"))}
    print(f"[train] {cell.name} on the card: {json.dumps(report)}",
          flush=True)
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["ebops"])
              for h in hist), f"{cell.name}: a loss or ~EBOPs is not finite")
    check(abs(hist[0]["loss"] - report["loss0_expected"]) <= LM_LOSS0_MARGIN,
          f"{cell.name}: step 0 loss {hist[0]['loss']} not within "
          f"{LM_LOSS0_MARGIN} of {report['loss0_expected']}")
    check(all(same_paths), f"{cell.name}: a step changed the qstate's leaf "
                           f"paths: {same_paths}")
    check(same_bits, f"{cell.name}: two card runs of step 0 differ")
    check(counts["hgq_quantize_fwd"] > 0 and counts["hgq_quantize_bwd"] > 0,
          f"{cell.name}: a quantizer kernel never launched: {counts}")
    report["card_vs_cpu"] = _family_card_vs_cpu(cell, dev, cpu_future)
    report["part_s"] = time.perf_counter() - t_part
    return report, per_step


def _family_unit(name):
    cell = {c.name: c for c in FAMILY_CELLS}[name]
    return (f"one {name} step: a training step of {cell.arch} at its "
            f"published width and depth {json.dumps(cell.depth)} (batch "
            f"{FAMILY_BATCH}, seq {cell.seq}, remat), calls by shape as "
            f"counted on the main path")


def family_training(dev, cases, smi, cpu=None):
    """Each family cell in turn, one at a time on the card, the CPU's
    sides of their card-vs-CPU readings computed meanwhile on a worker
    thread (``cpu``: the futures ``start_family_readings`` gave, started
    here when None).  Returns {name: report} and {name: a step's launches
    by shape}."""
    reports, per_steps = {}, {}
    with contextlib.ExitStack() as stack:
        if cpu is None:
            pool = stack.enter_context(
                concurrent.futures.ThreadPoolExecutor(1))
            cpu = start_family_readings(pool, dev)
        try:
            _family_cells(dev, cases, smi, cpu, reports, per_steps)
        finally:
            for f in cpu.values():
                f.cancel()
    return reports, per_steps


def _family_cells(dev, cases, smi, cpu, reports, per_steps):
    """``family_training``'s cells, each run, reported and lapped; ``cpu``
    maps a cell's name to the future of its CPU reading."""
    for cell in FAMILY_CELLS:
        rep, ps = _family_run(cell, dev, cases, cpu.pop(cell.name))
        rep["card"] = smi
        reports[cell.name], per_steps[cell.name] = rep, ps
        lap(f"train: {cell.name}")
        prof, hgq = rep["profiled_step"], rep["hgq_ms_per_step"]
        print(f"[train] {cell.name} summary ({cell.arch} at its published "
              f"width, {json.dumps(cell.depth)}; {smi}): step "
              f"{rep['step_ms_median']:.1f} ms median, "
              f"{rep['tokens_per_s']:.0f} tokens/s, peak "
              f"{rep['peak_mem_gib']:.2f} GiB, profiled step busy "
              f"{prof['device_busy_ms']:.1f} ms, idle "
              f"{prof['idle_share_of_median_step']:.1%}; hgq_quantize a "
              f"step: forward {hgq['hgq_quantize_fwd']['ms']:.3f} ms (bound "
              f"{hgq['hgq_quantize_fwd']['bound_ms']:.3f}, plain "
              f"{hgq['hgq_quantize_fwd']['plain_ms']:.3f}), backward "
              f"{hgq['hgq_quantize_bwd']['ms']:.3f} ms (bound "
              f"{hgq['hgq_quantize_bwd']['bound_ms']:.3f}, plain "
              f"{hgq['hgq_quantize_bwd']['plain_ms']:.3f}); "
              f"{rep['counted_flops']:.6e} FLOPs counted a step, "
              f"{rep['counted_flops_share_fp32']:.4f} of the float32 peak; "
              f"the part took {rep['part_s']:.0f} s", flush=True)


def train_phase(dev, meta_future, cases, smi, readings):
    """The jet tagger (quickstart), then the SVHN and muon models, the LM
    cells, the launcher, and the Griffin, RWKV and Whisper cells (their
    CPU readings ``readings``, ``start_family_readings``' futures); every
    step profiled after every timed run.  Returns the report and each
    model's launches a step by shape."""
    trainer, report, per_step = _quickstart(dev)
    lap("train: quickstart")
    report["card_vs_cpu"] = _jet_card_vs_cpu(dev)
    lap("train: quickstart card vs CPU")
    runs = {"jet": (trainer, report, per_step)}
    for name in ("svhn", "muon"):
        tr, rep, ps = _paper_run(dev, name)
        lap(f"train: {name}")
        rep["card_vs_cpu"] = _paper_card_vs_cpu(dev, name)
        lap(f"train: {name} card vs CPU")
        runs[name] = (tr, rep, ps)
        report[name] = rep
    t0 = time.perf_counter()
    tr, rep, ps = _lm_run(dev, QWEN_CELL, meta_future.result()["lm_step"])
    lap("train: lm")
    rep["card_vs_cpu"] = _lm_card_vs_cpu(dev)
    lap("train: lm card vs CPU")
    rep["prefill_vs_decode"] = _lm_prefill_vs_decode(dev)
    lap("train: lm prefill vs decode")
    runs["lm"] = (tr, rep, ps)
    report["lm"] = rep
    report["lm"]["part_s"] = time.perf_counter() - t0
    # granite last: the card holds its training state alone (its step is
    # profiled inside, before the repeat run frees the first)
    t0 = time.perf_counter()
    _, rep, ps = _lm_run(dev, GRANITE_CELL)
    lap("train: granite")
    rep["card_vs_cpu"] = _granite_card_vs_cpu(dev)
    lap("train: granite card vs CPU")
    runs["granite"] = (None, rep, ps)
    report["granite"] = rep
    rep["part_s"] = time.perf_counter() - t0
    rep, ps = api_training(dev)
    lap("train: api")
    runs["api"] = (None, rep, ps)
    report["api"] = rep
    reps, pss = family_training(dev, cases, smi, readings)
    for name, rep in reps.items():
        runs[name] = (None, rep, pss[name])
        report[name] = rep
    # profiled only now, after every timed run
    for name, (tr, rep, ps) in runs.items():
        if tr is not None:
            rep["profiled_step"] = _profile_step(
                tr, ps, "quickstart" if name == "jet" else name,
                rep["step_ms_median"])
    lm = report["lm"]
    print(f"[train] lm summary (qwen2-0.5b FULL, batch {LM_BATCH}, seq "
          f"{LM_SEQ}): step {lm['step_ms_median']:.1f} ms median, "
          f"{lm['tokens_per_s']:.0f} tokens/s, peak "
          f"{lm['peak_mem_gib']:.2f} GiB, profiled step busy "
          f"{lm['profiled_step']['device_busy_ms']:.1f} ms, idle "
          f"{lm['profiled_step']['idle_share_of_median_step']:.1%}, "
          f"lm_train_mfu_fp32 {lm['lm_train_mfu_fp32']:.4f} (6 N D over "
          f"the float32 peak), the counted FLOPs' share "
          f"{lm['counted_flops_share_fp32']:.4f} "
          f"({lm['counted_flops']:.6e} FLOPs, the dry run's count), "
          f"useful_flops_ratio {lm['useful_flops_ratio']:.4f}; the LM part "
          f"took {lm['part_s']:.0f} s", flush=True)
    gr = report["granite"]
    print(f"[train] granite summary (granite-moe-3b-a800m at its published "
          f"width and {GRANITE_CELL.layers} of its {GRANITE['L']} layers, "
          f"batch {GRANITE_BATCH}, seq {GRANITE_SEQ}): step "
          f"{gr['step_ms_median']:.1f} ms median, {gr['tokens_per_s']:.0f} "
          f"tokens/s, peak {gr['peak_mem_gib']:.2f} GiB ({gr['held_before_gib']:.2f} "
          f"held before), profiled step busy "
          f"{gr['profiled_step']['device_busy_ms']:.1f} ms, idle "
          f"{gr['profiled_step']['idle_share_of_median_step']:.1%}, "
          f"lm_train_mfu_fp32 {gr['lm_train_mfu_fp32']:.4f} "
          f"({gr['mfu_counts']}); the granite part took "
          f"{gr['part_s']:.0f} s", flush=True)
    return report, {name: ps for name, (_, _, ps) in runs.items()}


# ---------------------------------------------------------------------------
# wire phase: data-parallel training over the compressed gradient wire
# ---------------------------------------------------------------------------

WIRE_N = 4                 # data shards of the LocalMesh on the one card
# The compressed quickstart (batch 1024 over 4 shards, mixed 4/8 plan)
# against the same code's uncompressed run from one init, after 300 steps
# and CALIB.  Limits from the CPU rehearsal (examples/torch_dp_quickstart.py
# --device cpu; readings in PERF.md).
DP_ACC_GAP = 0.005
DP_EBOPS_REL = 1.0
DP_F0_GAP = 0.15
# The card's 20 compressed steps against the CPU's plain path from one
# init, the larger relative gap of loss and ~EBOPs at any step.  The wire
# turns an ulp of a gradient sum that crosses a rounding point into a
# whole grid step of one element, so the gap is larger than the
# uncompressed step's; the limit lies between the sound reading and two
# faulty controls, which the check must catch (readings in PERF.md).
DP_TRAJ_REL_LIMIT = 1e-4
QWEN_PLAN = "examples/specs/plan_mixed_w4w8.json"
# (b) reduces the embedding and the first this many of qwen2-0.5b's 24
# layers (all 24 in earlier runs, PERF.md §4): (c) reduces the whole tree
# over the 2D exchange, and the cut pays for it (4, 8 before, for the
# analysis phase)
QWEN_REDUCE_LAYERS = 4
# (c): the 2D data x model mesh of examples/specs/host_2x4_int8wire2d.json,
# the steps qwen2-0.5b takes from it, the jet's 20 card-vs-CPU steps; the
# 2D exchange launches the per-position kernels (phase 1, the nibble packs,
# the decode), which the 1D paths never launch
WIRE2D_SPEC = "examples/specs/host_2x4_int8wire2d.json"
WIRE2D_STEPS = 2
# (c) trains, and reduces the tree of, the first this many of qwen2-0.5b's
# 24 layers (the spec checked at full width first; all 24 until PR 28,
# whose family training part this cut pays for): the int8 exchange still
# moves 1.000002 B an element against the 1D exchange's 3.99998
QWEN_2D_LAYERS = 2
WIRE2D = ("wire_quantize_sflat", "wire_pack_rows", "wire_dequant_rows")
# The 2D step against the post-reduce int8 path from one init, 8 steps at
# batch 256 (the reference's tests/test_wire2d.py: step 0 within 5e-3,
# every step within 0.05)
WIRE2D_TRACK = dict(steps=8, batch=256, loss0=5e-3, every=0.05)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _dp_run(dev, params, qstate, batches, *, compressed=True, plan=None,
            steps=None, on_step=None, data=WIRE_N, model=1):
    """The quickstart's configuration from the given init, over
    LocalMesh(data, model=model) with reduce="compressed" (fused; 1D, or
    2D on a model axis above 1) or the full reduce: ([(loss, ~EBOPs)] per
    step, params, qstate).  ``batches`` is a list or a step -> batch
    function."""
    from repro_torch.dist import EFState, LocalMesh, ef_wire_init
    from repro_torch.dist.collectives import ef_wire2d_init
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.tree import tree_map
    _, _, fwd, loss = _jet()
    get = batches if callable(batches) else (lambda s: batches[s])
    steps = steps or len(batches)
    to = lambda t: t.to(dev)
    p, q = tree_map(to, params), tree_map(to, qstate)
    tcfg = TrainConfig(**dict(QUICKSTART, steps=steps))
    opt = adamw_init(p)
    if compressed:
        step_fn = make_train_step(fwd, loss, tcfg, reduce="compressed",
                                  mesh=LocalMesh(data, dev, model=model),
                                  wire_widths=plan)
        ef = EFState(residual=ef_wire2d_init(p, data, model) if model > 1
                     else ef_wire_init(p, data))
    else:
        step_fn = make_train_step(fwd, loss, tcfg)
    hist = []
    for s in range(steps):
        b = tree_map(to, get(s))
        if on_step is not None:
            on_step(s)
        if compressed:
            p, q, opt, m, ef = step_fn(p, q, opt, b, s, ef)
        else:
            p, q, opt, m = step_fn(p, q, opt, b, s)
        hist.append((float(m["loss"]), float(m["ebops"])))
    _sync(dev)
    return hist, p, q


def _dp_gap(run, ref, ref_p):
    """A ``_dp_run`` against the reference run ``ref`` (its history) with
    final params ``ref_p``: the largest relative gaps of loss and ~EBOPs
    over the steps, the largest parameter gap, and ``gap``, the larger
    relative one."""
    from repro_torch.tree import tree_leaves
    hist, p, _ = run
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    out = {"loss_rel": max(rel(h[0], r[0]) for h, r in zip(hist, ref)),
           "ebops_rel": max(rel(h[1], r[1]) for h, r in zip(hist, ref)),
           "param_abs": max(float((a.cpu() - b).abs().max()) for a, b in
                            zip(tree_leaves(p), tree_leaves(ref_p)))}
    out["gap"] = max(out["loss_rel"], out["ebops_rel"])
    return out


def _calib_report(dev, params, qstate, pipe):
    """CALIB on a held-out batch: accuracy, ~EBOPs, layer-0 f."""
    from repro_torch.core import hgq
    from repro_torch.train import accuracy
    JetTagger, _, _, _ = _jet()
    with torch.no_grad():
        batch = pipe(10 ** 6)
        logits, _, aux = JetTagger.forward(params, qstate, batch,
                                           mode=hgq.CALIB)
    f0 = params["d0"]["kernel"]["f"]
    return {"accuracy": float(accuracy(logits, batch["y"])),
            "calib_ebops": float(aux.ebops),
            "layer0_f": {"mean": float(f0.mean()), "min": float(f0.min()),
                         "max": float(f0.max())}}


@contextlib.contextmanager
def _no_phase2_feedback():
    """Control: the chunk owner drops the phase-2 shift remainder instead
    of keeping it in its residual (the requantize hands on a zero
    remainder)."""
    import repro_torch.dist.collectives as coll
    real = coll._phase2_requantize

    def dropped(chunk_sum, n, kind):
        q2, err = real(chunk_sum, n, kind)
        return q2, torch.zeros_like(err)

    coll._phase2_requantize = dropped
    try:
        yield
    finally:
        coll._phase2_requantize = real


@contextlib.contextmanager
def _finer_wire_grid():
    """Control: the wire quantizes on a grid one step finer than
    ``grid_scale`` (the largest values saturate)."""
    import repro_torch.kernels.wire_pack as wp
    real = wp.grid_scale
    wp.grid_scale = lambda amax, bits=8: real(amax, bits) * 0.5
    try:
        yield
    finally:
        wp.grid_scale = real


# the fused reduce's chunk layout built in PyTorch (F.pad) -- the bucket
# kernels make it index arithmetic, and no other op of the compressed step
# or the reduce pads
PAD_OP = "aten::constant_pad_nd"


@contextlib.contextmanager
def _counting_pads(calls):
    """Count in ``calls[0]`` every ``torch.nn.functional.pad`` call, on any
    thread: the LocalMesh ranks are threads, whose host operations the
    profiler records only with its all-threads option."""
    real = torch.nn.functional.pad
    lock = threading.Lock()

    def counted(*a, **k):
        with lock:
            calls[0] += 1
        return real(*a, **k)

    torch.nn.functional.pad = counted
    try:
        yield
    finally:
        torch.nn.functional.pad = real


def _profiled_without_pads(fn, what, **kw):
    """``_profiled(fn, all_threads=True, **kw)``, checked to have run no
    ``F.pad`` call and no ``aten::constant_pad_nd`` event; also returns
    whether the trace holds the ranks' host operations."""
    pads = [0]
    with _counting_pads(pads):
        ops, busy, grids, names = _profiled(fn, all_threads=True, **kw)
    check(pads[0] == 0 and names.get(PAD_OP, 0) == 0,
          f"{what} ran {pads[0]} F.pad calls, {names.get(PAD_OP, 0)} "
          f"{PAD_OP} events")
    return ops, busy, grids, names, _all_threads_config() is not None


def _dp_jet(dev):
    """(a): the quickstart over LocalMesh(4) with the compressed wire and
    the mixed plan, against the same code uncompressed from one init;
    then 20 steps on the card against the CPU, twice on the card, and
    with two faulty controls."""
    from repro_torch.core.plan import mixed_low_plan
    from repro_torch.data import DataSpec, jet_batch, make_pipeline
    from repro_torch.tree import tree_leaves, tree_map
    JetTagger, cfg, _, _ = _jet()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params, qstate = JetTagger.init(gen, cfg, device=dev)
    plan = mixed_low_plan(params, 4)
    widths = sorted({(k, e.wire_bits) for k, e in plan.layers.items()})
    check([w for _, w in widths] == [4] * 4, f"mixed plan {widths}")
    pipe = make_pipeline(DataSpec(kind="jet", batch=1024), device=dev)
    steps = QUICKSTART["steps"]
    starts = []

    def on_step(s):
        # a step runs from one batch request to the next
        _sync(dev)
        starts.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    _reset_counts()                           # the main path starts here
    hist_c, p_c, q_c = _dp_run(dev, params, qstate, pipe, plan=plan,
                               steps=steps, on_step=on_step)
    t1 = time.perf_counter()
    counts = _counts(TRAINING + WIRE)         # ... and ends here
    shapes = _shapes(TRAINING + WIRE)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {}
    for name, by_shape in shapes.items():
        check(all(c % steps == 0 for c in by_shape.values()),
              f"{name}: launches not a multiple of the steps: {by_shape}")
        per_step[name] = collections.Counter(
            {k: c // steps for k, c in by_shape.items()})
    for name in TRAINING:
        n = sum(per_step[name].values())
        check(n == HGQ_PER_STEP[name] * WIRE_N,
              f"{name}: {n} launches a step, not "
              f"{HGQ_PER_STEP[name] * WIRE_N}")
    for name in FUSED_WIRE:
        check(counts[name] > 0, f"{name} was never launched: {counts}")
    for name in ("wire_quantize_rows",) + PER_POSITION_WIRE:
        check(counts[name] == 0, f"the fused path launched {name}: {counts}")
    # one bucket a width (4 and 8 bits) on each of the ranks, one launch of
    # each bucket kernel a bucket a rank
    for name in ("wire_quantize_bucket", "wire_dequant_bucket"):
        n = sum(per_step[name].values())
        check(n == 2 * WIRE_N, f"{name}: {n} launches a step, not "
                               f"{2 * WIRE_N}")
    step_ms = np.diff(starts + [t1]) * 1e3
    rep_c = _calib_report(dev, p_c, q_c, pipe)
    hist_u, p_u, q_u = _dp_run(dev, params, qstate, pipe, compressed=False,
                               steps=steps)
    rep_u = _calib_report(dev, p_u, q_u, pipe)
    gaps = {"accuracy": abs(rep_c["accuracy"] - rep_u["accuracy"]),
            "calib_ebops_rel": abs(rep_c["calib_ebops"] - rep_u["calib_ebops"])
            / rep_u["calib_ebops"],
            "layer0_f_mean": abs(rep_c["layer0_f"]["mean"]
                                 - rep_u["layer0_f"]["mean"])}
    report = {
        "config": f"examples/quickstart.py's jet tagger and schedule, batch "
                  f"1024 over LocalMesh({WIRE_N}) (256 a shard), "
                  f"reduce='compressed', 1D, fused, int8 wire with "
                  f"mixed_low_plan(params, 4) (the four kernels' w and f at "
                  f"4 bits, the rest at 8)",
        "compressed": {**rep_c, "final_loss": hist_c[-1][0]},
        "uncompressed": {**rep_u, "final_loss": hist_u[-1][0]},
        "gaps": gaps, "limits": {"accuracy": DP_ACC_GAP,
                                 "calib_ebops_rel": DP_EBOPS_REL,
                                 "layer0_f_mean": DP_F0_GAP},
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "samples_per_s": steps * 1024 / (t1 - starts[0]),
        "peak_mem_gib": peak, "launches": counts,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items()}}
    print(f"[wire] (a) jet tagger over the compressed wire: "
          f"{json.dumps(report)}", flush=True)
    check(rep_c["accuracy"] >= 0.99, f"compressed accuracy {rep_c}")
    check(rep_c["calib_ebops"] <= 1000.0, f"compressed ~EBOPs {rep_c}")
    check(rep_c["layer0_f"]["mean"] < 2.0, f"compressed layer-0 f {rep_c}")
    check(gaps["accuracy"] <= DP_ACC_GAP
          and gaps["calib_ebops_rel"] <= DP_EBOPS_REL
          and gaps["layer0_f_mean"] <= DP_F0_GAP,
          f"compressed vs uncompressed beyond the limits: {gaps}")

    # 20 steps: card against the CPU's plain path, twice on the card, and
    # the controls on the card
    cpu = torch.device("cpu")
    p0, q0 = JetTagger.init(torch.Generator().manual_seed(SEED + 1), cfg,
                            device=cpu)
    plan0 = mixed_low_plan(p0, 4)
    batches = [jet_batch(SEED, s, 1024, device=cpu) for s in range(20)]
    ref, ref_p, _ = _dp_run(cpu, p0, q0, batches, plan=plan0)

    gap = lambda run: _dp_gap(run, ref, ref_p)
    card1 = _dp_run(dev, p0, q0, batches, plan=plan0)
    card2 = _dp_run(dev, p0, q0, batches, plan=plan0)
    same = card1[0] == card2[0] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(card1[1]),
                                          tree_leaves(card2[1])))
    with _no_phase2_feedback():
        no_ef = _dp_run(dev, p0, q0, batches, plan=plan0)
    with _finer_wire_grid():
        finer = _dp_run(dev, p0, q0, batches, plan=plan0)
    traj = {"sound": gap(card1), "repeat_bit_identical": same,
            "controls": {"no_phase2_error_feedback": gap(no_ef),
                         "wire_grid_one_step_finer": gap(finer)},
            "cpu_final_loss": ref[-1][0]}
    print(f"[wire] (a) card vs CPU, 20 compressed steps: {json.dumps(traj)} "
          f"(limit on the larger relative gap of loss and ~EBOPs: "
          f"{DP_TRAJ_REL_LIMIT})", flush=True)
    check(same, "two card runs of the 20 compressed steps differ")
    check(traj["sound"]["gap"] <= DP_TRAJ_REL_LIMIT,
          f"card vs CPU compressed trajectory gap {traj['sound']}")
    check(all(c["gap"] > DP_TRAJ_REL_LIMIT
              for c in traj["controls"].values()),
          f"the trajectory check misses a control: {traj['controls']}")
    report["card_vs_cpu"] = traj
    report["step_breakdown"] = _step_breakdown(dev, p_c, q_c, plan,
                                               pipe(steps))
    print(f"[wire] (a) step breakdown: "
          f"{json.dumps(report['step_breakdown'])}", flush=True)
    # profiled only now, after every timed run
    b = pipe(steps)
    step_fn = _profile_step_fn(dev, p_c, q_c, plan)
    ops, busy, grids, names, threads = _profiled_without_pads(
        lambda: step_fn(b), "the profiled compressed step",
        grids_of="hgq_bwd")
    med = report["step_ms_median"]
    report["profiled_step"] = {"device_ops": ops, "device_busy_ms": busy,
                               "idle_share_of_median_step": 1.0 - busy / med,
                               **_bwd_kernels(grids, per_step,
                                              "profiled compressed step"),
                               "host_ops_of_every_thread": threads,
                               "events_by_name": dict(names.most_common())}
    print(f"[wire] (a) profiled compressed step: {ops} device operations, "
          f"device busy {busy:.3f} ms, idle {1.0 - busy / med:.1%} of the "
          f"median step ({med:.3f} ms); {len(grids)} hgq_bwd kernels, one a "
          f"reducing backward; events by name: "
          f"{json.dumps(dict(names.most_common()))}", flush=True)
    return report, counts, per_step


def _host_ms(fn, dev, k=10):
    """Median host milliseconds of ``fn()``, synchronized, after one
    warm-up call."""
    fn()
    out = []
    for _ in range(k):
        _sync(dev)
        t = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def _step_breakdown(dev, params, qstate, plan, batch):
    """Where a compressed step's time goes: the four slices' forward and
    backward, the wire reduce of their gradients on LocalMesh(4), and the
    same reduce by the collective-free simulator (the same arithmetic in
    one thread)."""
    from repro_torch.dist import LocalMesh, ef_wire_pmean, simulate_wire_pmean
    from repro_torch.train import TrainConfig
    from repro_torch.train.loop import _value_and_grad
    from repro_torch.tree import tree_map
    _, _, fwd, loss = _jet()
    tcfg = TrainConfig(**QUICKSTART)
    mesh = LocalMesh(WIRE_N, dev)
    slices = [tree_map(lambda b, i=i: b.reshape(
        (WIRE_N, -1) + tuple(b.shape[1:]))[i], batch) for i in range(WIRE_N)]
    beta = torch.tensor(1e-4)

    def grads():
        return [_value_and_grad(fwd, loss, tcfg, params, qstate, sl,
                                beta)[4] for sl in slices]

    e = tree_map(lambda *xs: torch.stack(xs), *grads())
    widths = plan.wire_bits_tree(params)
    wire = lambda: ef_wire_pmean(e, mesh, "int8", widths=widths)
    return {"slices_fwd_bwd_ms": _host_ms(grads, dev),
            "wire_reduce_ms": _host_ms(wire, dev),
            "simulate_ms": _host_ms(lambda: simulate_wire_pmean(
                e, "int8", widths=widths), dev)}


def _profile_step_fn(dev, params, qstate, plan):
    """One compressed step from the trained state (a fresh residual)."""
    from repro_torch.dist import EFState, LocalMesh, ef_wire_init
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    _, _, fwd, loss = _jet()
    step_fn = make_train_step(fwd, loss, TrainConfig(**QUICKSTART),
                              reduce="compressed",
                              mesh=LocalMesh(WIRE_N, dev), wire_widths=plan)
    opt = adamw_init(params)
    ef = EFState(residual=ef_wire_init(params, WIRE_N))
    return lambda b: step_fn(params, qstate, opt, b, QUICKSTART["steps"], ef)


def _qwen2_grads(dev, layers=QWEN_REDUCE_LAYERS):
    """Per-shard gradients of qwen2-0.5b's full-width tree: the leaves of
    ``TransformerLM.init``, the layer stacks cut to their first ``layers``,
    with a leading [4] shard axis, seeded normal values, a scale per leaf
    (1e-4 .. 1e-1) and, for stacked leaves, per layer (x 1/8 .. 8)."""
    from repro_torch.configs import get
    from repro_torch.dist import stacked_tree
    from repro_torch.models import TransformerLM
    from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                                  tree_unflatten)
    cfg = get("qwen2-0.5b")
    check((cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab)
          == (24, 896, 4864, 151936), "not qwen2-0.5b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params, _ = TransformerLM.init(gen, cfg, device=dev)
    flags = tree_leaves(stacked_tree(params))
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    leaves = []
    for i, ((path, leaf), st) in enumerate(zip(
            tree_flatten_with_path(params), flags)):
        if path[0] == "layers":
            leaf = leaf[:layers]
        x = torch.randn((WIRE_N,) + tuple(leaf.shape), generator=g,
                        device=dev)
        x *= 10.0 ** (-4 + (i * 7) % 4)
        if st and leaf.ndim >= 3:
            x *= torch.logspace(-3, 3, leaf.shape[0], base=2.0, device=dev
                                ).reshape((1, -1) + (1,) * (leaf.ndim - 1))
        leaves.append(x)
    tree = tree_unflatten(params, leaves)
    del params
    return tree


def _equal_trees(a, b):
    from repro_torch.tree import tree_leaves
    return all(torch.equal(_wbits(x), _wbits(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _dp_qwen2(dev):
    """(b): the compressed reduce of qwen2-0.5b's gradient tree (the layer
    stacks cut to ``QWEN_REDUCE_LAYERS`` of 24) over LocalMesh(4), uniform
    int8 and plan_mixed_w4w8: fused == per-leaf == simulate on the card,
    the card == the CPU on the embedding and a stacked MLP leaf, recorded
    bytes == the byte model, times, memory."""
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.dist import (LocalMesh, ef_wire_pmean,
                                  record_wire_bytes, simulate_wire_pmean)
    from repro_torch.dist import collectives as coll
    from repro_torch.tree import tree_flatten_with_path, tree_leaves
    t0 = time.perf_counter()
    tree = _qwen2_grads(dev)
    _sync(dev)
    n_elem = sum(x[0].numel() for x in tree_leaves(tree))
    print(f"[wire] (b) qwen2-0.5b gradient tree ({QWEN_REDUCE_LAYERS} of "
          f"24 layers): {len(tree_leaves(tree))} "
          f"leaves, {n_elem} elements a shard, x{WIRE_N} shards, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mesh = LocalMesh(WIRE_N, dev)
    plan = PrecisionPlan.from_file(str(ROOT / QWEN_PLAN))
    configs = (("int8", None), ("mixed_w4w8", plan.wire_bits_tree(tree)))
    report, units = {}, {}
    torch.cuda.reset_peak_memory_stats()
    phase_peak = 0                            # over the phase, in bytes
    _sync(dev)
    _reset_counts()                           # the main path starts here
    for tag, widths in configs:
        flags = coll._stacked_flags(tree, None)
        wflags = coll._width_flags(tree, widths)
        want = sum(coll.wire_bytes_model(
            x[0].numel(), WIRE_N, "int8",
            n_scale_rows=x.shape[1] if (st and x.ndim >= 4) else 1, bits=w)
            for x, st, w in zip(tree_leaves(tree), flags, wflags))
        times = []
        # the fused reduce's own peak: the timed calls alone (the tree, and
        # the previous call's outputs while the next runs)
        _sync(dev)
        phase_peak = max(phase_peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        for i in range(3):
            before = _shapes(WIRE)
            _sync(dev)
            t = time.perf_counter()
            with record_wire_bytes() as rec:
                d_f, r_f = ef_wire_pmean(tree, mesh, "int8", widths=widths)
            _sync(dev)
            times.append((time.perf_counter() - t) * 1e3)
            after = _shapes(WIRE)
            if i == 0:
                fused_unit = {k: after[k] - before[k] for k in after}
            check(abs(rec.total() - want) <= 1e-9 * want,
                  f"({tag}) recorded {rec.total()} B, model {want} B")
        fused_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        before = _shapes(WIRE)
        d_l, r_l = ef_wire_pmean(tree, mesh, "int8", widths=widths,
                                 fused=False)
        _sync(dev)
        after = _shapes(WIRE)
        leaf_unit = {k: after[k] - before[k] for k in after}
        same_leaf = _equal_trees(d_f, d_l) and _equal_trees(r_f, r_l)
        del d_l, r_l
        d_s, r_s = simulate_wire_pmean(tree, "int8", widths=widths)
        same_sim = _equal_trees(d_f, d_s) and _equal_trees(r_f, r_s)
        del d_s, r_s
        # the CPU's plain path on the embedding and a stacked MLP leaf
        keep = ("embed/table/w", "layers/mlp/down/kernel/w")
        sub = {"embed": {"table": {"w": tree["embed"]["table"]["w"].cpu()}},
               "layers": {"mlp": {"down": {"kernel": {
                   "w": tree["layers"]["mlp"]["down"]["kernel"]["w"].cpu()}}}}}
        sw = None if widths is None else plan.wire_bits_tree(sub)
        d_c, r_c = simulate_wire_pmean(sub, "int8", widths=sw)
        card = {"/".join(p): (d, r) for (p, d), (_, r) in zip(
            tree_flatten_with_path(d_f), tree_flatten_with_path(r_f))}
        cpu_same = all(
            torch.equal(_wbits(card[k][0].cpu()), _wbits(d))
            and torch.equal(_wbits(card[k][1].cpu()), _wbits(r))
            for k, (d, r) in zip(keep, zip(tree_leaves(d_c),
                                           tree_leaves(r_c))))
        # card holds the outputs too: none may outlive the next timed calls
        del d_c, r_c, sub, d_f, r_f, card
        report[tag] = {
            "reduce_ms_median": float(np.median(times)), "reduce_ms": times,
            "bytes_per_element": want / n_elem,
            "fp32_ring_bytes_per_element":
                coll.fp32_allreduce_bytes(n_elem, WIRE_N) / n_elem,
            "fused_peak_mem_gib": fused_peak,
            "fused_eq_per_leaf": same_leaf, "fused_eq_simulate": same_sim,
            "card_eq_cpu_on": list(keep) if cpu_same else [],
            "launches_fused": {k: sum(v.values())
                               for k, v in fused_unit.items()},
            "launches_per_leaf": {k: sum(v.values())
                                  for k, v in leaf_unit.items()}}
        units[tag] = (fused_unit, leaf_unit)
        print(f"[wire] (b) qwen2-0.5b reduce ({tag}): "
              f"{json.dumps(report[tag])}", flush=True)
        check(same_leaf, f"({tag}) fused != per-leaf on the card")
        check(same_sim, f"({tag}) fused != simulate on the card")
        check(cpu_same, f"({tag}) card != CPU on {keep}")
    counts = _counts(WIRE)                    # ... and ends here
    peak = max(phase_peak, torch.cuda.max_memory_allocated()) / 2 ** 30
    check(all(counts[k] > 0 for k in FUSED_WIRE + ("wire_quantize_rows",)),
          f"(b) a wire kernel was never launched: {counts}")
    check(all(counts[k] == 0 for k in PER_POSITION_WIRE),
          f"(b) a per-position wire kernel was launched: {counts}")
    report["launches"] = counts
    report["peak_mem_gib"] = peak
    report["elements_per_shard"] = n_elem
    # profiled only now, after every timed run
    widths = configs[1][1]
    ops, busy, _, names, threads = _profiled_without_pads(
        lambda: ef_wire_pmean(tree, mesh, "int8", widths=widths),
        "the profiled mixed reduce")
    med = report["mixed_w4w8"]["reduce_ms_median"]
    report["profiled_mixed_reduce"] = {
        "device_ops": ops, "device_busy_ms": busy,
        "idle_share_of_median_reduce": 1.0 - busy / med,
        "host_ops_of_every_thread": threads,
        "events_by_name": dict(names.most_common())}
    print(f"[wire] (b) peak memory {peak:.2f} GiB over the phase, of the "
          f"fused reduce's timed calls "
          f"{report['mixed_w4w8']['fused_peak_mem_gib']:.2f} (mixed_w4w8), "
          f"{report['int8']['fused_peak_mem_gib']:.2f} (int8); profiled "
          f"mixed reduce: {ops} device operations, device busy {busy:.2f} "
          f"ms, idle {1.0 - busy / med:.1%} of the median reduce "
          f"({med:.2f} ms); events by name: "
          f"{json.dumps(dict(names.most_common()))}", flush=True)
    del tree
    return report, counts, units["mixed_w4w8"]


@contextlib.contextmanager
def _every_rank_model_slice_0():
    """Control: every model rank quantizes model slice 0 of each leaf (the
    2D exchange's rank slicing reads the wrong model index)."""
    import repro_torch.dist.collectives as coll
    real = coll._wire2d_slice
    coll._wire2d_slice = lambda g, k, D, M, m, stacked: real(g, k, D, M, 0,
                                                             stacked)
    try:
        yield
    finally:
        coll._wire2d_slice = real


def _wire2d_want(params, widths, D, M):
    """Per-position wire launches of one 2D exchange of ``params``' tree
    over a LocalMesh of D x M ranks: a phase-1 quantize a leaf a rank, a
    decode a leaf (rank 0 delivers the mesh's tree), and for a nibble leaf
    one pack per exchange a rank (the model gather, and with D > 1 the
    data all_to_all and all_gather)."""
    from repro_torch.tree import tree_leaves
    n = len(tree_leaves(params))
    nib = 0 if widths is None else sum(1 for w in tree_leaves(widths)
                                       if w <= 4)
    return {"wire_quantize_sflat": n * D * M,
            "wire_dequant_rows": n,
            "wire_pack_rows": nib * D * M * ((2 if D > 1 else 0)
                                             + (1 if M > 1 else 0))}


def _dp2d_jet(dev, D, M):
    """(c), the jet tagger's 2D compressed step over LocalMesh(D,
    model=M) with the mixed plan: 20 steps on the card against the CPU's
    plain path, twice on the card, and two faulty controls (the phase-2
    remainder dropped; every rank quantizing model slice 0); launches by
    shape a step; the 2D step against the post-reduce int8 path (uniform,
    ``WIRE2D_TRACK``); one step profiled."""
    from repro_torch.core.plan import mixed_low_plan
    from repro_torch.data import DataSpec, jet_batch, make_pipeline
    from repro_torch.dist import (EFState, LocalMesh, ef_compress, ef_init)
    from repro_torch.dist.collectives import ef_wire2d_init
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    JetTagger, cfg, fwd, loss = _jet()
    cpu = torch.device("cpu")
    p0, q0 = JetTagger.init(torch.Generator().manual_seed(SEED + 1), cfg,
                            device=cpu)
    plan0 = mixed_low_plan(p0, 4)
    batches = [jet_batch(SEED, s, 1024, device=cpu) for s in range(20)]
    ref, ref_p, _ = _dp_run(cpu, p0, q0, batches, plan=plan0, data=D,
                            model=M)
    starts = []

    def on_step(s):
        _sync(dev)
        starts.append(time.perf_counter())

    _sync(dev)
    _reset_counts()                           # the main path starts here
    card1 = _dp_run(dev, p0, q0, batches, plan=plan0, data=D, model=M,
                    on_step=on_step)
    t1 = time.perf_counter()
    counts = _counts(TRAINING + WIRE)         # ... and ends here
    per_step = _per_step(_shapes(TRAINING + WIRE), 20)
    step_ms = np.diff(starts + [t1]) * 1e3
    for name in TRAINING:
        n = sum(per_step[name].values())
        check(n == HGQ_PER_STEP[name] * D,
              f"(c) jet {name}: {n} launches a step, not "
              f"{HGQ_PER_STEP[name] * D}")
    want = _wire2d_want(p0, plan0.wire_bits_tree(p0), D, M)
    got = {k: sum(per_step[k].values()) for k in WIRE}
    check(got == {**{k: 0 for k in WIRE}, **want},
          f"(c) jet: wire launches a step {got}, want {want}")
    card2 = _dp_run(dev, p0, q0, batches, plan=plan0, data=D, model=M)
    same = card1[0] == card2[0] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(card1[1]),
                                          tree_leaves(card2[1])))
    with _no_phase2_feedback():
        no_ef = _dp_run(dev, p0, q0, batches, plan=plan0, data=D, model=M)
    with _every_rank_model_slice_0():
        slice0 = _dp_run(dev, p0, q0, batches, plan=plan0, data=D, model=M)

    gap = lambda run: _dp_gap(run, ref, ref_p)
    traj = {"sound": gap(card1), "repeat_bit_identical": same,
            "controls": {"no_phase2_error_feedback": gap(no_ef),
                         "every_rank_quantizes_model_slice_0": gap(slice0)},
            "cpu_final_loss": ref[-1][0]}
    print(f"[wire] (c) jet over LocalMesh({D}, model={M}), card vs CPU, 20 "
          f"2D compressed steps: {json.dumps(traj)} (limit on the larger "
          f"relative gap of loss and ~EBOPs: {DP_TRAJ_REL_LIMIT})",
          flush=True)
    check(same, "two card runs of the 20 2D compressed steps differ")
    check(traj["sound"]["gap"] <= DP_TRAJ_REL_LIMIT,
          f"card vs CPU 2D compressed trajectory gap {traj['sound']}")
    check(all(c["gap"] > DP_TRAJ_REL_LIMIT
              for c in traj["controls"].values()),
          f"the 2D trajectory check misses a control: {traj['controls']}")

    # the 2D step tracks the post-reduce int8 path (uniform int8)
    tk = WIRE2D_TRACK
    tcfg = TrainConfig(steps=20, lr=3e-3, beta0=1e-7, beta1=1e-6)
    pipe = make_pipeline(DataSpec(kind="jet", batch=tk["batch"]), device=dev)
    to = lambda t: t.to(dev)
    p, q = tree_map(to, p0), tree_map(to, q0)
    step_c = make_train_step(fwd, loss, tcfg, reduce="compressed",
                             mesh=LocalMesh(D, dev, model=M))
    step_r = make_train_step(fwd, loss, tcfg,
                             grad_tx=lambda g, s: ef_compress(g, s,
                                                              kind="int8"))
    sc = (p, q, adamw_init(p), EFState(residual=ef_wire2d_init(p, D, M)))
    sr = (p, q, adamw_init(p), ef_init(p))
    lc, lr_ = [], []
    for s in range(tk["steps"]):
        b = pipe(s)
        pc, qc, oc, mc, ec = step_c(*sc[:3], b, s, sc[3])
        pr, qr, orr, mr, er = step_r(*sr[:3], b, s, sr[3])
        sc, sr = (pc, qc, oc, ec), (pr, qr, orr, er)
        lc.append(float(mc["loss"]))
        lr_.append(float(mr["loss"]))
    track = {"loss_2d": lc, "loss_post_reduce": lr_,
             "step0_gap": abs(lc[0] - lr_[0]),
             "max_gap": max(abs(a - b) for a, b in zip(lc, lr_))}
    print(f"[wire] (c) jet 2D step against the post-reduce int8 path: "
          f"{json.dumps(track)}", flush=True)
    check(track["step0_gap"] < tk["loss0"] and track["max_gap"] < tk["every"]
          and lc[-1] < lc[0], f"the 2D step does not track the post-reduce "
                              f"loss curve: {track}")
    # profiled only now, after every timed run
    step_fn = make_train_step(fwd, loss, TrainConfig(**QUICKSTART),
                              reduce="compressed",
                              mesh=LocalMesh(D, dev, model=M),
                              wire_widths=mixed_low_plan(card1[1], 4))
    pp, qq = card1[1], card1[2]
    opt, ef = adamw_init(pp), EFState(residual=ef_wire2d_init(pp, D, M))
    b = tree_map(to, batches[0])
    ops, busy, _, names = _profiled(lambda: step_fn(pp, qq, opt, b, 20, ef),
                                    all_threads=True)
    med = float(np.median(step_ms))
    report = {
        "config": f"examples/quickstart.py's jet tagger and schedule, batch "
                  f"1024 over LocalMesh({D}, model={M}) (512 a data shard), "
                  f"reduce='compressed', 2D (auto), fused, int8 wire with "
                  f"mixed_low_plan(params, 4)",
        "card_vs_cpu": traj, "tracks_post_reduce": track,
        "step_ms_median": med, "step_ms_p90": float(np.percentile(step_ms,
                                                                  90)),
        "launches": counts,
        "launches_per_step": {k: {" ".join(map(str, key)): n
                                  for key, n in c.items()}
                              for k, c in per_step.items() if c},
        "profiled_step": {"device_ops": ops, "device_busy_ms": busy,
                          "idle_share_of_median_step": 1.0 - busy / med,
                          "events_by_name": dict(names.most_common(40))}}
    print(f"[wire] (c) jet 2D step: median {med:.2f} ms; launches a step "
          f"{ {k: v for k, v in got.items() if v} }; profiled: {ops} device "
          f"operations, busy {busy:.3f} ms, idle {1.0 - busy / med:.1%}",
          flush=True)
    return report, counts, per_step


def _dp2d_qwen2(dev):
    """(c), qwen2-0.5b FULL from ``host_2x4_int8wire2d.json --full``:
    ``build(spec).init_training()`` over LocalMesh(2, model=4), the spec's
    batch 4 and seq 32, ``WIRE2D_STEPS`` steps (step ms, launches by shape
    a step exact, step 0's loss near ln(vocab)); then one step's full
    gradient tree and the run's residual through the 2D exchange, uniform
    int8 and plan_mixed_w4w8: fused == per-leaf == simulate on the card, the
    card == the CPU on the embedding and a stacked MLP leaf under the mixed
    plan (8 and 4 bits), the recorded bytes == the sum of
    ``wire2d_leaf_bytes``, bytes per element against
    the 1D exchange plus ``tp_replication_bytes``; the pure-TP mesh
    LocalMesh(1, model=4) on one shard (the sliced path, no data
    exchange); one step profiled; the part's peak memory."""
    from repro_torch.api import RunSpec, build
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.dist import LocalMesh, record_wire_bytes
    from repro_torch.dist import collectives as coll
    from repro_torch.train import lm_loss
    from repro_torch.train.loop import _value_and_grad
    from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                                  tree_map)
    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    spec = RunSpec.from_args(["--spec", str(ROOT / WIRE2D_SPEC), "--full"])
    ctx = build(spec, device=dev)
    cfg = ctx.cfg
    D, M = spec.mesh.data, spec.mesh.model
    comp = ctx.grad_compression()
    check(_lm_dims(cfg) == QWEN and spec.full
          and isinstance(ctx.mesh, LocalMesh)
          and ctx.mesh.axis_sizes == (D, M) == (2, 4)
          and comp.wire and comp.wire_layout == "2d",
          f"{WIRE2D_SPEC} --full is not qwen2-0.5b over the 2D wire on "
          f"LocalMesh(2, model=4): {ctx.mesh}, {comp}")
    ctx.cfg = cfg = dataclasses.replace(cfg, n_layers=QWEN_2D_LAYERS)
    setup = ctx.init_training()
    marks = {"init": time.perf_counter() - t_part}
    B, S = spec.data.batch, spec.data.seq
    starts, losses = [], []
    _sync(dev)
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                           # the main path starts here
    for s in range(WIRE2D_STEPS):
        _sync(dev)
        starts.append(time.perf_counter())
        losses.append(float(setup.step(s)["loss"]))
    _sync(dev)
    t1 = time.perf_counter()
    counts = _counts(TRAINING + WIRE)         # ... and ends here
    # the steps alone: params, moments and the residual updated in place
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = _per_step(_shapes(TRAINING + WIRE), WIRE2D_STEPS)
    step_ms = np.diff(starts + [t1]) * 1e3
    check(all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab)) <= LM_LOSS0_MARGIN,
          f"(c) qwen2 losses {losses}, step 0 not within {LM_LOSS0_MARGIN} "
          f"of ln(vocab)")
    hgq_want = {k: collections.Counter({key: D * n for key, n in c.items()})
                for k, c in _lm_per_step(B // D, S, cfg.n_layers,
                                         cfg.q_chunk).items()}
    check({k: per_step[k] for k in TRAINING} == hgq_want,
          f"(c) qwen2 hgq_quantize launches a step "
          f"{ {k: dict(per_step[k]) for k in TRAINING} }, not {hgq_want}")
    want = _wire2d_want(setup.params, None, D, M)
    got = {k: sum(per_step[k].values()) for k in WIRE}
    check(got == {**{k: 0 for k in WIRE}, **want},
          f"(c) qwen2: wire launches a step {got}, want {want}")
    step_unit = {k: per_step[k] for k in WIRE2D}
    marks["steps"] = time.perf_counter() - t_part
    print(f"[wire] (c) qwen2-0.5b FULL over LocalMesh({D}, model={M}), batch "
          f"{B}, seq {S}: losses {losses}; step ms {step_ms.tolist()}; wire "
          f"launches a step {got}", flush=True)

    # one step's gradient tree (the two data shards') and the run's residual
    batch = setup.pipeline(WIRE2D_STEPS)
    beta = torch.tensor(spec.train.beta1, device=dev)
    with ctx.activate():
        shards = [_value_and_grad(
            ctx.forward, lambda out, b: lm_loss(out, b["tokens"]),
            spec.train, setup.params, setup.qstate,
            tree_map(lambda x, i=i: x.reshape((D, -1) + x.shape[1:])[i],
                     batch), beta)[4] for i in range(D)]
    tree = tree_map(lambda *gs: torch.stack(gs), *shards)
    del shards
    res = setup.ef_state.residual
    check(any(bool(r.any()) for r in tree_leaves(res)),
          "(c) the residual is still zero after the steps")
    mesh = ctx.mesh
    marks["grads"] = time.perf_counter() - t_part
    n_elem = sum(x[0].numel() for x in tree_leaves(tree))
    plan = PrecisionPlan.from_file(str(ROOT / QWEN_PLAN))
    flags = coll._stacked_flags(tree, None)
    report, units = {}, {}
    for tag, widths in (("int8", None),
                        ("mixed_w4w8", plan.wire_bits_tree(tree))):
        wflags = coll._width_flags(tree, widths)
        shapes = [tuple(x.shape[1:]) for x in tree_leaves(tree)]
        want_b = sum(coll.wire2d_leaf_bytes(sh, D, M, "int8", st, w)
                     for sh, st, w in zip(shapes, flags, wflags))
        b1d = sum(coll.wire_bytes_model(
            math.prod(sh), D, "int8",
            n_scale_rows=sh[0] if (st and len(sh) >= 3) else 1, bits=w)
            + coll.tp_replication_bytes(sh, M)
            for sh, st, w in zip(shapes, flags, wflags))
        times = []
        for i in range(2):
            before = _shapes(WIRE)
            _sync(dev)
            t = time.perf_counter()
            with record_wire_bytes() as rec:
                d_f, r_f = coll.ef_wire_pmean_2d(tree, res, mesh, "int8",
                                                 widths=widths)
            _sync(dev)
            times.append((time.perf_counter() - t) * 1e3)
            after = _shapes(WIRE)
            if i == 0:
                units[tag] = {k: after[k] - before[k] for k in after}
            check(abs(rec.total() - want_b) <= 1e-9 * want_b,
                  f"(c) ({tag}) recorded {rec.total()} B, the sum of "
                  f"wire2d_leaf_bytes {want_b} B")
            if i < 1:
                del d_f, r_f
        d_l, r_l = coll.ef_wire_pmean_2d(tree, res, mesh, "int8",
                                         widths=widths, fused=False)
        same_leaf = _equal_trees(d_f, d_l) and _equal_trees(r_f, r_l)
        del d_l, r_l
        d_s, r_s = coll.simulate_wire_pmean_2d(tree, res, M, "int8",
                                               widths=widths)
        same_sim = _equal_trees(d_f, d_s) and _equal_trees(r_f, r_s)
        del d_s, r_s
        marks[f"{tag} on the card"] = time.perf_counter() - t_part
        # the CPU's plain path under the mixed plan: the embedding at 8
        # bits, the MLP leaf at 4 (both wire widths, both slicings)
        keep = (("embed/table/w", "layers/mlp/down/kernel/w")
                if widths is not None else ())
        pick = lambda t: {"embed": {"table": {"w": t["embed"]["table"]["w"]
                                              .cpu()}},
                          "layers": {"mlp": {"down": {"kernel": {
                              "w": t["layers"]["mlp"]["down"]["kernel"]["w"]
                              .cpu()}}}}}
        cpu_same = True
        if keep:
            sub = pick(tree)
            d_c, r_c = coll.simulate_wire_pmean_2d(
                sub, pick(res), M, "int8", widths=plan.wire_bits_tree(sub))
            card = {"/".join(p): (d, r) for (p, d), (_, r) in zip(
                tree_flatten_with_path(d_f), tree_flatten_with_path(r_f))}
            cpu_same = all(
                torch.equal(_wbits(card[k][0].cpu()), _wbits(d))
                and torch.equal(_wbits(card[k][1].cpu()), _wbits(r))
                for k, (d, r) in zip(keep, zip(tree_leaves(d_c),
                                               tree_leaves(r_c))))
            del d_c, r_c, sub, card
            marks[f"{tag} on the CPU"] = time.perf_counter() - t_part
        del d_f, r_f
        report[tag] = {
            "reduce_ms_median": float(np.median(times)), "reduce_ms": times,
            "bytes_per_element": want_b / n_elem,
            "bytes_per_element_1d_plus_tp_replication": b1d / n_elem,
            "fused_eq_per_leaf": same_leaf, "fused_eq_simulate": same_sim,
            "card_eq_cpu_on": list(keep) if cpu_same else None,
            "launches_fused": {k: sum(v.values())
                               for k, v in units[tag].items() if v}}
        print(f"[wire] (c) qwen2-0.5b gradient tree over the 2D exchange "
              f"({tag}): {json.dumps(report[tag])}", flush=True)
        check(same_leaf, f"(c) ({tag}) fused != per-leaf on the card")
        check(same_sim, f"(c) ({tag}) fused != simulate on the card")
        check(cpu_same, f"(c) ({tag}) card != CPU on {keep}")
    check(abs(report["int8"]["bytes_per_element"] - 1.0) <= 0.01
          and abs(report["int8"]["bytes_per_element_1d_plus_tp_replication"]
                  - 4.0) <= 0.01,
          f"(c) bytes per element {report['int8']}, not 1.0 against 4.0")
    # the pure tensor-parallel mesh: one data shard, four model ranks
    one = tree_map(lambda x: x[:1], tree)
    res1 = coll.ef_wire2d_init(tree_map(lambda x: x[0], tree), 1, M)
    with record_wire_bytes() as rec:
        d_t, r_t = coll.ef_wire_pmean_2d(one, res1, LocalMesh(1, dev, model=M))
    ops_tp = sorted({op for op, _ in rec.records})
    d_s, r_s = coll.simulate_wire_pmean_2d(one, res1, M)
    same_tp = _equal_trees(d_t, d_s) and _equal_trees(r_t, r_s)
    del one, res1, d_t, r_t, d_s, r_s
    check(ops_tp == ["all_gather.int8.model", "pmax.scale"] and same_tp,
          f"(c) LocalMesh(1, model={M}): records {ops_tp}, equal to "
          f"simulate {same_tp}")
    report["pure_tp_records"] = ops_tp
    del tree, res
    gc.collect()
    torch.cuda.empty_cache()
    marks["pure TP"] = time.perf_counter() - t_part
    # profiled only now, after every timed run (the ranks' host operations
    # left out: the step's device operations are all in the trace)
    ops, busy, _, names = _profiled(lambda: setup.step(WIRE2D_STEPS))
    marks["profile"] = time.perf_counter() - t_part
    med = float(np.median(step_ms))
    peak = max(init_peak, torch.cuda.max_memory_allocated()) / 2 ** 30
    report.update({
        "config": f"configs/qwen2_0_5b.py FULL from {WIRE2D_SPEC} --full "
                  f"through build(spec).init_training(), its first "
                  f"{QWEN_2D_LAYERS} of 24 layers: LocalMesh({D}, "
                  f"model={M}) on one card, batch {B} ({B // D} a data "
                  f"shard), seq {S}, the 2D fused int8 exchange, "
                  f"{WIRE2D_STEPS} steps",
        "losses": losses, "step_ms": step_ms.tolist(),
        "step_ms_median": med, "elements": n_elem,
        "launches": counts,
        "wire_launches_per_step": got,
        "profiled_step": {"device_ops": ops, "device_busy_ms": busy,
                          "idle_share_of_median_step": 1.0 - busy / med,
                          "events_by_name": dict(names.most_common(40))},
        "peak_mem_gib": peak, "steps_peak_mem_gib": step_peak,
        "part_s": time.perf_counter() - t_part,
        "part_s_at": marks})
    print(f"[wire] (c) qwen2 2D step: median {med:.1f} ms; profiled: {ops} "
          f"device operations, busy {busy:.2f} ms, idle "
          f"{1.0 - busy / med:.1%}; peak memory {peak:.2f} GiB (the steps "
          f"alone {step_peak:.2f}); bytes per "
          f"element {report['int8']['bytes_per_element']:.6f} (1D + TP "
          f"replication "
          f"{report['int8']['bytes_per_element_1d_plus_tp_replication']:.6f});"
          f" the part took {report['part_s']:.1f} s "
          f"({json.dumps({k: round(v, 1) for k, v in marks.items()})})",
          flush=True)
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    return report, counts, step_unit, units["mixed_w4w8"]


def _dp2d(dev):
    """(c): the 2D data x model exchange.  Returns the report, the launches
    of its main paths and the per-unit tallies of the per-position
    kernels."""
    t0 = time.perf_counter()
    qwen, counts_q, step_unit, mixed_unit = _dp2d_qwen2(dev)
    D, M = 2, 4
    jet, counts_j, jet_step = _dp2d_jet(dev, D, M)
    launches = collections.Counter(counts_q) + collections.Counter(counts_j)
    per_q = ("one 2D step of qwen2-0.5b FULL from " + WIRE2D_SPEC + " --full"
             f" at {QWEN_2D_LAYERS} of its 24 layers (LocalMesh(2, model=4), "
             "batch 4, seq 32, uniform int8), calls by shape as counted on "
             "the main path")
    per_m = (f"one 2D reduce of qwen2-0.5b's gradient tree ({QWEN_2D_LAYERS} "
             "of 24 layers) over "
             "LocalMesh(2, model=4) with plan_mixed_w4w8, fused, calls by "
             "shape as counted on the main path")
    per_j = ("one 2D compressed step of the jet tagger over LocalMesh(2, "
             "model=4) (batch 1024, mixed plan), calls by shape as counted on "
             "the main path")
    tallies = {k: ([(step_unit[k], per_q)] if step_unit[k] else [])
               + [(mixed_unit[k], per_m)] for k in WIRE2D}
    units = {k: [step_unit[k], mixed_unit[k]] for k in WIRE2D}
    jet["launches_per_step_of"] = per_j
    print(f"[wire] (c) done in {time.perf_counter() - t0:.1f} s", flush=True)
    return ({"qwen2": qwen, "jet": jet}, dict(launches), tallies, units,
            jet_step)


def _fshape(lay, shape):
    return {"per_tensor": (), "per_channel": shape[-1:],
            "per_parameter": shape}[lay]


def wire_phase(dev, cases):
    """(a), (b) and (c), then every wire-kernel shape their main paths
    launched held against its plain version and timed.  Returns the
    report, the launches of the main paths and the per-unit tallies."""
    t0 = time.perf_counter()
    jet, counts_a, per_step = _dp_jet(dev)
    t_a = time.perf_counter() - t0
    qwen, counts_b, (fused_unit, leaf_unit) = _dp_qwen2(dev)
    t_b = time.perf_counter() - t0
    two_d, counts_c, tallies_c, units_c, jet_2d = _dp2d(dev)
    t_c = time.perf_counter() - t0
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    for name in WIRE:
        keys = set(per_step[name]) | set(fused_unit[name]) \
            | set(leaf_unit[name])
        for unit in units_c.get(name, []):
            keys |= set(unit)
        for key in keys:
            if key not in cases[name]:
                cases[name][key] = wire_case(name, key, dev, g)
        # the jet's 2D step: its shapes (a few KB) held, not timed
        for key in jet_2d.get(name, {}):
            if key not in cases[name]:
                wire_case(name, key, dev, g, timed=False)
    # the slices' quantizer shapes (batch 256), where the train phase's
    # batch of 1024 did not time them
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for lay, shape, dt in set(per_step["hgq_quantize_fwd"]) \
            | set(per_step["hgq_quantize_bwd"]):
        key = (lay, shape, dt)
        if key in cases["hgq_quantize_fwd"] \
                and key in cases["hgq_quantize_bwd"]:
            continue
        _, fwd, bwd = hgq_quantize_case(shape, _fshape(lay, shape),
                                        dtypes[dt], dev, g)
        cases["hgq_quantize_fwd"][key] = fwd
        cases["hgq_quantize_bwd"][key] = bwd
    for key in per_step["hgq_quantize_fwd_group"]:
        if key not in cases["hgq_quantize_fwd_group"]:
            members = [(s, _fshape(lay, s), dtypes[dt]) for lay, s, dt in key]
            cases["hgq_quantize_fwd_group"][key] = hgq_group_case(
                members, dev, g)[1]
    print(f"[wire] parts done at: (a) {t_a:.1f} s, (b) {t_b:.1f}, (c) "
          f"{t_c:.1f}, the wire and quantizer shapes timed "
          f"{time.perf_counter() - t0:.1f}", flush=True)
    print_cases(cases, WIRE + TRAINING)
    launches = collections.Counter(counts_a) + collections.Counter(counts_b) \
        + collections.Counter(counts_c)
    per_a = ("one compressed data-parallel step of the jet tagger (batch "
             "1024 over 4 shards, mixed plan), calls by shape as counted on "
             "the main path")
    per_b = (f"one reduce of qwen2-0.5b's gradient tree ({QWEN_REDUCE_LAYERS}"
             f" of 24 layers) over 4 shards (plan_mixed_w4w8), {{}} path, "
             f"calls by shape as counted on the main path")
    tallies = {k: [(per_step[k], per_a + " (4 slices)")] for k in TRAINING}
    for k in FUSED_WIRE:
        tallies[k] = [(per_step[k], per_a), (fused_unit[k],
                                             per_b.format("fused"))]
    tallies["wire_quantize_rows"] = [(leaf_unit["wire_quantize_rows"],
                                      per_b.format("per-leaf"))]
    for k, units in tallies_c.items():
        tallies.setdefault(k, []).extend(units)
    return ({"jet": jet, "qwen2": qwen, "two_d": two_d}, dict(launches),
            tallies)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# analysis phase: the program rules on card programs, one count of work
# ---------------------------------------------------------------------------

# the cells whose count of work the card and the dry run on meta give
# alike: (arch, (name, seq, batch, kind) of the ShapeSpec, variant) -- the
# train phase's LM step, and a packed qwen2-0.5b decode tick of 8 slots
# over a 1024-slot int8 ring (the dry run's "opt" variant)
WORK_CELLS = {
    "lm_step": ("qwen2-0.5b", ("lm_train", LM_SEQ, LM_BATCH, "train"),
                "base"),
    "decode_tick": ("qwen2-0.5b", ("decode_8", 1024, 8, "decode"), "opt"),
}
WORK_TIMED = {"lm_step": 2, "decode_tick": 10}   # timed runs on the card
ANALYSIS_TRAIN_SEQ = API_TRAIN_SEQ               # the launcher's step


def _meta_counts(src, cells):
    """In a child process, on the CPU: each cell's count on ``meta``
    (``launch.dryrun.build_cell``); a cell the dry run cannot trace comes
    back ``FAILED`` with its error."""
    sys.path.insert(0, src)
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    out = {}
    for key, (arch, shape, variant) in cells.items():
        t0 = time.perf_counter()
        try:
            r = dryrun.build_cell(arch, ShapeSpec(*shape), variant=variant)
            out[key] = {k: r[k] for k in (
                "status", "flops_total", "flops_by_dtype",
                "counted_bytes_total", "kernel_ops", "model_flops_total",
                "useful_flops_ratio", "analytic_flops_total",
                "hbm_model_breakdown", "memory_analysis")}
        except Exception as e:                  # noqa: BLE001
            out[key] = {"status": "FAILED",
                        "error": f"{type(e).__name__}: {e}"}
        out[key]["seconds"] = time.perf_counter() - t0
    return out


def start_meta_counts():
    """(the executor, the future of ``_meta_counts(WORK_CELLS)``): one
    child process, started now, on the CPU, while the card works."""
    import concurrent.futures
    import multiprocessing
    ex = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return ex, ex.submit(_meta_counts, str(ROOT / "src"), WORK_CELLS)


def _violations(art):
    from repro_torch.analysis import run_rules
    return [str(v) for v in run_rules(art)]


def _flagged(art, rule, what):
    """Checks that the faulty control ``what`` trips ``rule``."""
    got = _violations(art)
    check(any(f"[{rule}]" in v for v in got),
          f"analysis control ({what}): {rule} not flagged, {got}")
    lap(f"analysis: control, {what}")
    return got


def _card_programs(dev):
    """The rules and the census over the four card programs, and the four
    faulty controls.  Returns the report."""
    from repro_torch import analysis
    from repro_torch.api import RunSpec, build
    from repro_torch.dist import mesh as mesh_mod
    from repro_torch.serving import Engine
    from repro_torch.tree import tree_leaves
    arts, controls, marks = [], {}, {}
    t0 = time.perf_counter()

    def lint(art):
        arts.append(art)
        v = _violations(art)
        check(not v, f"analysis: {art.name} violates {v}")
        marks[art.name] = time.perf_counter() - t0
        lap(f"analysis: {art.name} linted")
        return art

    def serving(name):
        path = f"examples/specs/{name}.json"
        spec = RunSpec.from_args(["--spec", str(ROOT / path), "--full"])
        ctx = build(spec, device=dev)
        ctx.cfg = dataclasses.replace(ctx.cfg, n_layers=API_SERVE_LAYERS)
        params, qstate = ctx.init_state()
        unpacked = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
        eng = ctx.make_engine(params, qstate, max_len=1024,
                              prefill_chunk=16)
        return path, spec, ctx, params, qstate, unpacked, eng

    # the packed llama3.2-3b tick; control: the weights served unpacked
    path, spec, ctx, params, qstate, unpacked, eng = serving("serving_packed")
    lint(analysis.decode_artifacts(spec, path, engine=eng,
                                   unpacked_param_bytes=unpacked))
    del eng
    with ctx.activate(packed=False):
        plain = Engine(ctx.model, params, qstate, ctx.cfg,
                       batch_slots=spec.serving.slots, max_len=1024,
                       packed=False, device=dev)
    controls["weights served unpacked"] = _flagged(
        analysis.decode_artifacts(spec, path, engine=plain,
                                  unpacked_param_bytes=unpacked),
        "packed-weights", "weights served unpacked")
    del plain, params, qstate, ctx
    gc.collect()
    torch.cuda.empty_cache()
    # the kv_plan qwen2 tick; control: a float64 parameter
    path, spec, ctx, params, qstate, unpacked, eng = serving(
        "serving_kv_plan")
    del params
    lint(analysis.decode_artifacts(spec, path, engine=eng,
                                   unpacked_param_bytes=unpacked))
    norm = eng.p["final_norm"]
    real = norm["scale"]
    norm["scale"] = real.to(torch.float64)       # the views share it
    controls["a float64 parameter"] = _flagged(
        analysis.decode_artifacts(spec, path, engine=eng,
                                  unpacked_param_bytes=unpacked),
        "no-f64", "a float64 parameter")
    norm["scale"] = real
    del eng, ctx, qstate
    gc.collect()
    torch.cuda.empty_cache()
    # the launcher's step; control: the in-place update dropped
    path = "examples/specs/host_1x1.json"
    spec = RunSpec.from_args(["--spec", str(ROOT / path), "--full",
                              "--batch", str(LM_BATCH), "--seq",
                              str(ANALYSIS_TRAIN_SEQ)])
    setup = build(spec, device=dev).init_training()
    lint(analysis.train_artifacts(spec, path, setup=setup))
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    # the train controls run the spec's SMOKE program on the card (one step
    # each at full width took ~5 and ~11 s)
    smoke = build(RunSpec.from_args(["--spec", str(ROOT / path)]),
                  device=dev).init_training()
    smoke.step_fn = smoke.ctx.make_train_step(donate=())
    controls["the in-place update dropped"] = _flagged(
        analysis.train_artifacts(smoke.ctx.spec, path, setup=smoke),
        "donation", "the in-place update dropped")
    # the 2D step; control: an f32 wire payload
    path = WIRE2D_SPEC
    spec = RunSpec.from_args(["--spec", str(ROOT / path), "--full"])
    setup = build(spec, device=dev).init_training()
    two_d = lint(analysis.train_artifacts(spec, path, setup=setup))
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    smoke = build(RunSpec.from_args(["--spec", str(ROOT / path)]),
                  device=dev).init_training()
    real_a2a = mesh_mod._LocalRank.all_to_all

    def f32_payload(self, x):
        return real_a2a(self, x.to(torch.float32)).to(x.dtype)

    mesh_mod._LocalRank.all_to_all = f32_payload
    try:
        controls["an f32 wire payload"] = _flagged(
            analysis.train_artifacts(smoke.ctx.spec, path, setup=smoke),
            "wire-dtype", "an f32 wire payload")
    finally:
        mesh_mod._LocalRank.all_to_all = real_a2a
    del smoke
    report = analysis.collect(arts)
    census = {name: {k: v for k, v in rep.items() if k != "violations"}
              for name, rep in report["programs"].items()}
    # the reference's primitives and axes (one of each a bucket; the
    # SMOKE tree is one bucket, as the CPU tests hold against the
    # reference's census; the full tree several)
    got = analysis.program_report(two_d)["explicit"]
    check(set(got) == {"all_gather[data]", "all_gather[model]",
                       "all_to_all[data]", "pmax[data,model]"}
          and got["pmax[data,model]"] == 1
          and len({got[k] for k in got if k.startswith("all_")}) == 1,
          f"analysis: the 2D step's collectives {got}")
    for name, c in census.items():
        print(f"[analysis] {name}: clean; census {json.dumps(c)}",
              flush=True)
    for what, v in controls.items():
        print(f"[analysis] control, {what}: flagged {v}", flush=True)
    return {"programs": census, "controls": controls,
            "part_s_at": marks}


def _count_cell(dev, key, meta, smi, median_s=None):
    """``WORK_CELLS[key]`` on the card: the median of ``WORK_TIMED[key]``
    runs (``median_s`` where an earlier part timed the same cell), then
    one run under the count, held equal to the dry run's count on
    ``meta``.  Returns the reading."""
    from repro_torch.analysis import ProgramTrace
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.analytic import hbm_bytes_per_chip
    from repro_torch.launch.roofline import RooflineTerms, mfu
    arch, shape, variant = WORK_CELLS[key]
    sp = ShapeSpec(*shape)
    run, facts = dryrun.cell_program(arch, sp, variant, dev)
    cfg = facts["cfg"]
    times = []
    for _ in range(0 if median_s else WORK_TIMED[key] + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    # the first run warms up
    med = median_s or float(np.median(times[1:]))
    with ProgramTrace() as tr:
        run()
    torch.cuda.synchronize()
    del run, facts
    gc.collect()
    torch.cuda.empty_cache()
    m = meta[key]
    on_meta = m.get("status") == "ok"
    check(on_meta, f"analysis: the dry run could not trace {key} on meta: "
                   f"{m}")
    check(tr.flops == m["flops_total"],
          f"analysis: {key} counts {tr.flops} FLOPs on the card, "
          f"{m['flops_total']} on meta")
    opt = variant == "opt" and sp.kind == "decode"
    mem = hbm_bytes_per_chip(cfg, sp, 1, tp=1,
                             weight_bits=8.0 if opt else 16.0,
                             cache_bytes=1.0 if opt else 2.0)
    terms = RooflineTerms(flops=tr.flops, hbm_bytes=mem["total"],
                          coll_bytes=None, coll_breakdown={}, chips=1,
                          flops_by_dtype=dict(tr.flops_by_dtype),
                          coll_reason="one card")
    out = {"cell": f"{arch} {sp}, variant {variant}",
           "card": smi, "flops_card": tr.flops,
           "flops_meta": m["flops_total"], "flops_equal": True,
           "flops_by_dtype": dict(tr.flops_by_dtype),
           "counted_bytes_card": tr.bytes,
           "counted_bytes_meta": m["counted_bytes_total"],
           "kernel_ops": dict(tr.kernel_ops),
           "kernel_launches": tr.kernel_launches,
           "terms": terms.as_dict(),
           "model_flops_total": m["model_flops_total"],
           "useful_flops_ratio": m["useful_flops_ratio"],
           "roofline_fraction": mfu(m["model_flops_total"], terms),
           "median_ms": med * 1e3, "ms": [t * 1e3 for t in times],
           "median_of": "this phase's runs" if times
           else "the train phase's run of the same cell",
           "measured_share_of_peak": tr.flops / (terms.peak * med),
           "peak_dtype": terms.dtype, "meta_s": m["seconds"]}
    print(f"[analysis] count of work, {key} ({out['cell']}) on {smi}: "
          f"{tr.flops:.6e} FLOPs on the card == {m['flops_total']:.6e} on "
          f"meta; terms {json.dumps(out['terms'])}; roofline fraction "
          f"{out['roofline_fraction']:.4f}; median {med * 1e3:.2f} ms, "
          f"measured share of the {terms.dtype} peak "
          f"{out['measured_share_of_peak']:.4f}; useful_flops_ratio "
          f"{out['useful_flops_ratio']:.4f}", flush=True)
    return out


def analysis_phase(dev, meta_future, smi, medians_s=None):
    """Step 7 (see the module docstring).  ``medians_s``: the median
    seconds of a ``WORK_CELLS`` cell an earlier phase timed (the train
    phase's LM step), which this phase then runs once, under the count.
    Returns the report."""
    t0 = time.perf_counter()
    report = _card_programs(dev)
    lap("analysis: rules")
    meta = meta_future.result()
    report["meta"] = meta
    report["count"] = {k: _count_cell(dev, k, meta, smi,
                                      (medians_s or {}).get(k))
                       for k in WORK_CELLS}
    report["part_s"] = time.perf_counter() - t0
    lap("analysis: count of work")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "serve", "train",
                                        "families", "wire", "analysis"),
                    default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script ({src})",
              file=sys.stderr)
        return 1
    # cuBLAS picks a deterministic workspace before its first handle, so a
    # repeated training run is bit-identical
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(smi, flush=True)
    meta = None
    if args.phase in ("all", "train", "analysis"):
        meta = start_meta_counts()          # the dry run on meta, meanwhile
    pool = concurrent.futures.ThreadPoolExecutor(1)   # the family readings
    try:
        return _main(args, smi, meta, _build, pool)
    finally:
        if meta is not None:
            meta[0].shutdown(wait=True, cancel_futures=True)
        pool.shutdown(wait=True, cancel_futures=True)


def _main(args, smi, meta, _build, pool) -> int:
    from repro_torch.device import resolve_device
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = T0[0] = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {json.dumps(built)}; all in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        print(f"[build] {name} ptxas:\n{_build.ptxas_report(name)}",
              flush=True)

    # the family cells' CPU readings on a worker thread beside the kernel
    # phase, which patches no model function, and joined before the
    # serving phase patches some
    readings = None
    if args.phase in ("all", "train", "families"):
        readings = start_family_readings(pool, dev)
    cases = kernel_phase(dev)
    lap("kernel phase done")
    if readings is not None:
        concurrent.futures.wait(list(readings.values()))
        lap("the family readings' CPU steps done")
    tallies = collections.defaultdict(list)
    launches = collections.Counter()
    slice_report = train_report = wire_report = analysis_report = None
    if args.phase in ("all", "serve"):
        (total, slice_report, tick_shapes, granite_ticks, griffin_ticks,
         rwkv_ticks, whisper_ticks, whisper_append,
         llama_ticks) = slice_phase(dev, cases)
        launches.update(total)
        per = (f"one full decode tick of qwen2-0.5b at its published widths "
               f"and {QWEN_SERVE_LAYERS} of its 24 layers, serving "
               f"configuration (a), calls by shape as counted on the main "
               f"path")
        granite_per = (f"one full decode tick of granite-moe-3b-a800m at its "
                       f"published widths and {GRANITE_SERVE_LAYERS} of its "
                       f"32 layers, configuration (a) (packed int8, kv_bits "
                       f"8), calls by shape as counted on the main path")
        griffin_per = (f"one full decode tick of recurrentgemma-2b at its "
                       f"published widths and {GRIFFIN_SERVE_UNITS} of its 8 "
                       f"units with its 2 remainder layers, configuration "
                       f"(a) (packed int8, kv_bits 8, the 2064-slot ring), "
                       f"calls by shape as counted on the main path")
        rwkv_per = (f"one full decode tick of rwkv6-1.6b at its published "
                    f"widths and {RWKV_SERVE_LAYERS} of its 24 layers, "
                    f"configuration (a) (packed int8; no KV cache, so qmatmul "
                    f"alone), calls by shape as counted on the main path")
        whisper_per = (f"one full decode tick of whisper-large-v3 at its "
                       f"published widths and {WHISPER_SERVE_LAYERS} + "
                       f"{WHISPER_SERVE_LAYERS} of its 32 + 32 layers through "
                       f"StreamingEngine, configuration (a) (packed int8, "
                       f"kv_bits 8, the 448-slot self ring and the 1500-slot "
                       f"cross memory), calls by shape as counted on the main "
                       f"path")
        append_per = (f"one {WHISPER['chunk']}-frame append of "
                      f"whisper-large-v3 at {WHISPER_SERVE_LAYERS} + "
                      f"{WHISPER_SERVE_LAYERS} of its layers (the encoder's "
                      f"layers and the cross k / v of its decoder layers, one "
                      f"store), configuration (a), calls by shape as counted "
                      f"on the main path")
        for k in SERVING:
            tallies[k].append((tick_shapes[k], per))
            tallies[k].append((granite_ticks[k], granite_per))
            tallies[k].append((griffin_ticks[k], griffin_per))
            tallies[k].append((whisper_ticks[k], whisper_per))
        tallies["qmatmul"].append((rwkv_ticks["qmatmul"], rwkv_per))
        tallies["qmatmul"].append((
            llama_ticks["qmatmul"], "one full decode tick of llama3.2-3b at "
            f"its published widths and {API_SERVE_LAYERS} of its 28 layers "
            "from examples/specs/serving_packed.json "
            "(packed int8, fp cache, 8 slots) through build(spec)"
            ".make_engine, calls by shape as counted on the main path"))
        for k in ("qmatmul", "kv_quantize_store"):
            tallies[k].append((whisper_append[k], append_per))
        lap("serving phase done")
    if args.phase == "families":
        train_report, per_step = family_training(dev, cases, smi, readings)
        for name, rep in train_report.items():
            launches.update(rep["launches"])
            for k in TRAINING:
                if per_step[name][k]:
                    tallies[k].append((per_step[name][k], _family_unit(name)))
        lap("families done")
    if args.phase in ("all", "train"):
        train_report, per_step = train_phase(dev, meta[1], cases, smi,
                                             readings)
        units = {"jet": "one training step of the quickstart jet tagger",
                 "svhn": "one svhn step: a training step of SVHNNet at the "
                         "paper's configuration (batch 128)",
                 "muon": "one muon step: a training step of MuonTracker at "
                         "the paper's configuration (batch 1024)",
                 "lm": "one LM step: a training step of qwen2-0.5b at full "
                       "width (batch 2, seq 2048, remat)",
                 "granite": "one granite step: a training step of "
                            "granite-moe-3b-a800m at its published width "
                            f"and {GRANITE_CELL.layers} of its 32 layers "
                            "(batch 2, seq 1024, remat)",
                 "api": "one launcher step of qwen2-0.5b FULL, batch 2, seq "
                        "256 (python -m repro_torch.launch.train --spec "
                        "examples/specs/host_1x1.json --full)"}
        units.update({c.name: None for c in FAMILY_CELLS})
        for name, unit in units.items():
            rep = train_report if name == "jet" else train_report[name]
            launches.update(rep["launches"])
            for k in TRAINING:
                if unit is None and per_step[name][k]:
                    tallies[k].append((per_step[name][k],
                                       _family_unit(name)))
                elif unit is not None:
                    tallies[k].append((per_step[name][k], unit + ", calls "
                                       "by shape as counted on the main "
                                       "path"))
        lap("train phase done")
    if args.phase in ("all", "wire"):
        wire_report, wire_launches, wire_tallies = wire_phase(dev, cases)
        lap("wire phase done")
        launches.update(wire_launches)
        for k, units in wire_tallies.items():
            tallies[k].extend(units)
    if args.phase in ("all", "analysis"):
        medians = None if train_report is None else {
            "lm_step": train_report["lm"]["step_ms_median"] / 1e3}
        analysis_report = analysis_phase(dev, meta[1], smi, medians)
        lap("analysis phase done")
    kernels = kernels_line(cases, tallies)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    ported = {KERNELS[k["name"]][1] for k in kernels}
    still = [{"name": n, "replaces": r} for n, r in TPU_KERNELS
             if n not in ported]
    check(not still, f"TPU kernels without a counterpart: {still}")
    print(json.dumps({
        "kernels": kernels,
        "still_to_port": still,
        "slice": slice_report, "train": train_report,
        "wire": wire_report, "analysis": analysis_report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
