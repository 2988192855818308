"""Continuous-batching serving engine (counterpart of
``repro/serving/engine.py``).

* **Slots.** The cache holds ``batch_slots`` rows; a request occupies one
  from admission to completion and finished slots are recycled at once.
* **Per-slot positions.** Every tick runs ONE ``decode_step`` over the
  whole batch with a position vector ``cache_pos [B]``.
* **Chunked prefill.** ``submit`` runs the prompt in ``prefill_chunk``
  chunks, then power-of-two tails (pad-free), into a fresh single-slot
  slice, then copies the slice into the batch cache at the slot.
* **Sampling.** Greedy / temperature / top-k per request (Gumbel-max over
  rank-filtered logits) on a seeded ``torch.Generator``.
* **Packed weights.** ``packed=True`` serves the HGQ int8 / nibble +
  per-channel 2^-f tree through the ``qmatmul`` kernel.
* **Quantized KV.** ``kv_bits=b`` stores the ring as per-row 2^-f grid
  mantissas, written by ``kv_quantize_rows`` and read by the fused
  ``kv_attention_rows`` kernel.

Mutability: unlike the JAX engine, the batch cache is updated in place
(no full-cache copy per tick).  So every prefill starts from a newly
zeroed slice (a recycled slot's mantissas AND grid exponents are
overwritten by the slice), and a prefix-reuse entry is a slice that no
later write touches: splicing copies it, never aliases it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..nn.attention import NEG_INF
from ..tree import tree_map


@dataclasses.dataclass
class SamplingConfig:
    temperature: float = 0.0      # <= 0: greedy
    top_k: int = 0                # 0: no top-k filter


GREEDY = SamplingConfig()


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int
    sampling: Optional[SamplingConfig] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class RequestHandle:
    """Admission receipt of one request; ``Engine.tokens`` reads it."""
    request: Request
    _cursor: int = 0

    @property
    def done(self) -> bool:
        return self.request.done

    @property
    def out(self) -> List[int]:
        return self.request.out


def _sample(logits: torch.Tensor, gen: torch.Generator, temp: torch.Tensor,
            topk: torch.Tensor, enable: bool = True) -> torch.Tensor:
    """Per-row sampling: logits [B, V]; temp [B] (<= 0 greedy); topk [B]
    (0 = off).  An all-greedy batch (``enable=False``) is a bare argmax."""
    greedy = torch.argmax(logits, dim=-1)
    if not enable:
        return greedy
    V = logits.shape[-1]
    k = torch.clamp(torch.where(topk > 0, topk, torch.full_like(topk, V)),
                    1, V)
    srt = torch.sort(logits, dim=-1, descending=True).values
    thresh = torch.gather(srt, -1, (k - 1)[:, None].to(torch.int64))
    filt = torch.where(logits >= thresh, logits,
                       torch.full_like(logits, NEG_INF))
    t = torch.clamp(temp, min=1e-6)[:, None]
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    sampled = torch.argmax(filt / t + g, dim=-1)
    return torch.where(temp > 0, sampled, greedy)


def _to(tree, device):
    return tree_map(lambda a: a.to(device), tree)


class Engine:
    """Continuous-batching engine over a model's KV-cache decode path:
    ``model`` gives its per-layer views (``serving_views``), its caches
    (``init_cache``, a named tuple of ``[L, B, ...]`` tensors or None)
    and its ``decode_step``."""

    def __init__(self, model, params, qstate, cfg: ModelConfig, *,
                 batch_slots: int = 8, max_len: int = 512,
                 eos_id: Optional[int] = None, packed: bool = False,
                 plan=None, prefill_chunk: int = 16, seed: int = 0,
                 kv_bits: Optional[int] = None,
                 ring_slack: Optional[int] = None,
                 prefix_reuse: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.packed = packed
        self.plan = plan
        self.kv_bits = kv_bits
        params, qstate = _to(params, self.device), _to(qstate, self.device)
        if packed:
            from .packed import pack_for_serving
            params, qstate = pack_for_serving(params, qstate, plan)
        self.p = params
        self.q = qstate
        # per-layer views, made once by the model: the tick loops over them
        self._pv = model.serving_views(params, cfg)
        self._qv = model.serving_views(qstate, cfg)
        self.slots = batch_slots
        self.max_len = max_len
        self.eos = eos_id
        W = min(max_len, cfg.window) if cfg.window else max_len
        self.prefill_chunk = max(1, min(prefill_chunk, W))
        self.ring_slack = (self.prefill_chunk if not ring_slack
                           else max(ring_slack, self.prefill_chunk))
        self.caches = model.init_cache(cfg, batch_slots, max_len,
                                       ring_slack=self.ring_slack,
                                       kv_bits=kv_bits, device=self.device)
        self.prefix_reuse = prefix_reuse
        # prompt tuple -> (prefilled slot slice, last-position logits)
        self._prefix_cache: dict = {}
        self._prefix_cap = 32
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int64)   # cache fill level
        self._next_tok = np.zeros(batch_slots, np.int64)  # next decode input
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    # ------------------------------------------------------------------
    def _decode(self, caches, tok, pos):
        return self.model.decode_step(self._pv, self._qv, caches, tok, pos,
                                      self.cfg, kv_bits=self.kv_bits)

    def _new_slot(self):
        """A zeroed single-slot cache slice [L, 1, W, ...]; a field the
        cache leaves empty (None) stays empty."""
        return type(self.caches)(*(None if c is None else torch.zeros(
            (c.shape[0], 1) + tuple(c.shape[2:]), dtype=c.dtype,
            device=c.device) for c in self.caches))

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _sampling(self, req: Request) -> SamplingConfig:
        return req.sampling or GREEDY

    def _prefill_prompt(self, prompt: List[int], cs=None):
        """Chunked prefill of one prompt into a single-slot slice at
        offset 0: (slice, last-position logits)."""
        plen = len(prompt)
        C = self.prefill_chunk
        if cs is None:
            cs = self._new_slot()
        last_logits = None
        start = 0
        # full chunks, then power-of-two tails: exact, no padding
        while start < plen:
            n = C if plen - start >= C else \
                1 << ((plen - start).bit_length() - 1)
            tok = torch.tensor([prompt[start:start + n]], dtype=torch.int64,
                               device=self.device)
            logits, cs = self._decode(cs, tok, start)
            start += n
            if start >= plen:
                last_logits = logits[:, -1]
        return cs, last_logits

    def _write_slot(self, cs, slot: int) -> None:
        for c, u in zip(self.caches, cs):
            if c is not None:
                c[:, slot].copy_(u[:, 0])

    def submit(self, req: Request) -> Optional[RequestHandle]:
        """Admit one request (prefill, splice, first token); None when no
        slot is free."""
        slot = self._free_slot()
        if slot is None:
            return None
        plen = len(req.prompt)
        if plen < 1 or req.max_new < 1 or \
                plen + req.max_new > self.max_len:
            raise ValueError(
                f"need prompt >= 1 ({plen}), max_new >= 1 ({req.max_new}), "
                f"and prompt + max_new <= max_len ({self.max_len})")
        key = tuple(req.prompt) if self.prefix_reuse else None
        if key is not None and key in self._prefix_cache:
            # the cached slice is never written again: splicing copies it
            cs, last_logits = self._prefix_cache.pop(key)
            self._prefix_cache[key] = (cs, last_logits)   # LRU refresh
        else:
            cs, last_logits = self._prefill_prompt(req.prompt)
            if key is not None:
                self._prefix_cache[key] = (cs, last_logits)
                while len(self._prefix_cache) > self._prefix_cap:
                    self._prefix_cache.pop(next(iter(self._prefix_cache)))
        self._write_slot(cs, slot)
        self._join(slot, req, self._first_token(req, last_logits))
        return RequestHandle(req)

    def _first_token(self, req: Request, last_logits: torch.Tensor) -> int:
        """Sample a request's first token from its prompt's last logits."""
        sc = self._sampling(req)
        first = _sample(
            last_logits, self._gen,
            torch.tensor([sc.temperature], dtype=torch.float32,
                         device=self.device),
            torch.tensor([sc.top_k], dtype=torch.int64, device=self.device),
            sc.temperature > 0)
        return int(first[0])

    def _join(self, slot: int, req: Request, token: int) -> None:
        """A prefilled request joins the decode batch at ``slot`` with its
        first token."""
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        self._next_tok[slot] = token
        self._record(slot, token)

    def _record(self, slot: int, token: int) -> None:
        """Append a sampled token; finish and recycle the slot on EOS or
        length."""
        req = self.slot_req[slot]
        req.out.append(token)
        if (self.eos is not None and token == self.eos) or \
                len(req.out) >= req.max_new:
            req.done = True
            self.slot_req[slot] = None

    def step(self) -> None:
        """One tick: a single ragged decode step advancing every active
        slot by one token (inactive slots ride along at their own
        positions)."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        tok = torch.as_tensor(self._next_tok[:, None], device=self.device)
        temp = torch.tensor([self._sampling(r).temperature if r else 0.0
                             for r in self.slot_req], dtype=torch.float32,
                            device=self.device)
        topk = torch.tensor([self._sampling(r).top_k if r else 0
                             for r in self.slot_req], dtype=torch.int64,
                            device=self.device)
        enable = any(self._sampling(self.slot_req[i]).temperature > 0
                     for i in active)
        logits, self.caches = self._decode(self.caches, tok,
                                           self.slot_pos.copy())
        nxt = _sample(logits[:, -1], self._gen, temp, topk, enable).cpu()
        for i in active:
            self.slot_pos[i] += 1
            self._next_tok[i] = int(nxt[i])
            self._record(i, int(nxt[i]))

    def tokens(self, handle: RequestHandle):
        """Incremental reader of one admitted request, ticking the engine
        when it has nothing new."""
        req = handle.request
        while True:
            while handle._cursor < len(req.out):
                tok = req.out[handle._cursor]
                handle._cursor += 1
                yield tok
            if req.done:
                return
            self.step()

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a workload to completion with continuous batching."""
        pending = list(requests)
        while pending or any(r is not None for r in self.slot_req):
            while pending and self._free_slot() is not None:
                self.submit(pending.pop(0))
            self.step()
        return requests


def generate(model, params, qstate, cfg: ModelConfig, prompt, max_new: int,
             *, cache_len: Optional[int] = None, packed: bool = False,
             plan=None, kv_bits: Optional[int] = None,
             device=None) -> torch.Tensor:
    """Single-batch greedy generation: the per-request reference the
    engine is held against.  The whole prompt prefills in one chunk.
    ``cache_len`` pins the cache width to the engine's; ``kv_bits`` (an
    addition over the reference's signature) serves from the quantized
    cache like the engine."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    B, S = prompt.shape
    params, qstate = _to(params, dev), _to(qstate, dev)
    if packed:
        from .packed import pack_for_serving
        params, qstate = pack_for_serving(params, qstate, plan)
    if cache_len is not None and cfg.window is None \
            and cache_len < S + max_new:
        raise ValueError(f"cache_len ({cache_len}) < prompt + max_new "
                         f"({S + max_new}) on an unwindowed model")
    caches = model.init_cache(cfg, B, cache_len or (S + max_new),
                              ring_slack=S, kv_bits=kv_bits, device=dev)
    logits, caches = model.decode_step(params, qstate, caches, prompt, 0,
                                       cfg, kv_bits=kv_bits)
    pos = S
    last = torch.argmax(logits[:, -1:], dim=-1)
    outs = [last]
    for _ in range(max_new - 1):
        logits, caches = model.decode_step(params, qstate, caches, last, pos,
                                           cfg, kv_bits=kv_bits)
        last = torch.argmax(logits[:, -1:], dim=-1)
        outs.append(last)
        pos += 1
    return torch.cat(outs, dim=1)
