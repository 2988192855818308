"""Streaming ASR serving: audio-chunk requests in the continuous-batching
engine, with bounded-latency accounting (counterpart of
``repro/serving/streaming.py``).

Audio arrives in chunks (frame embeddings ``[T, d_model]``: the conv /
mel frontend is a stub), the Whisper encoder runs a chunk at a time --
block-local self-attention at absolute frame offsets
(``WhisperModel.append_cross``) -- and the chunk's cross K/V rows are
appended into the request's own slot slice.  When the last chunk lands,
the decoder prompt prefills into that slice, the slice is copied into the
batch cache, and the request joins the ordinary ragged decode tick: ASR
and LM slots decode together in one step (LM rows carry ``mem_len == 0``
and read exactly zero from the memory).

Lifecycle: ``submit_audio`` -> slot reserved -> chunks 0..N appended, one
an engine tick -> decoder prompt prefill -> copied into the batch ->
shared decode -> done.

Latency, filled a request: ``t_chunks``, wall seconds an appended chunk
(encode, quantize, store, bounded by a synchronize of the engine's
device, as the reference blocks on each append); ``ttft_s``, from the
last chunk appended to the first token sampled.

:func:`generate_asr` is the offline greedy reference: the same chunk
decomposition (:func:`split_audio`), the prompt in one block, then greedy
decode; streaming must reproduce it token for token.

Unlike the reference, every stream appends into a zeroed slice of its
own (``Engine._new_slot``): the port's caches are written in place, so no
slice is shared.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from .engine import Engine, RequestHandle, SamplingConfig, _to


@dataclasses.dataclass
class AudioRequest:
    """One streaming transcription request: ``frames`` ``[T, d_model]``
    (or ``[1, T, d_model]``) frame embeddings; ``chunk`` the arrival
    granularity in frames (0: the engine's); ``prompt`` the decoder
    prompt.  ``t_chunks`` / ``ttft_s`` are filled as it streams."""
    frames: Any
    prompt: List[int]
    max_new: int
    chunk: int = 0
    sampling: Optional[SamplingConfig] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_chunks: List[float] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None


def split_audio(frames: torch.Tensor, chunk: int) -> List[torch.Tensor]:
    """The shared chunk decomposition: full ``chunk``-frame blocks, then
    power-of-two tails (``chunk`` 0: one block).  Streaming and the
    offline reference encode exactly these blocks."""
    if frames.ndim == 2:
        frames = frames[None]
    T = frames.shape[1]
    C = chunk if chunk > 0 else T
    blocks = []
    start = 0
    while start < T:
        n = C if T - start >= C else 1 << ((T - start).bit_length() - 1)
        blocks.append(frames[:, start:start + n])
        start += n
    return blocks


def _frames(frames, device) -> torch.Tensor:
    fr = torch.as_tensor(frames, dtype=torch.float32, device=device)
    return fr[None] if fr.ndim == 2 else fr


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class _AudioState:
    """One stream in flight: its single-slot cache slice and the blocks
    not yet arrived."""
    req: AudioRequest
    cs: Any
    blocks: List[torch.Tensor]


class StreamingEngine(Engine):
    """``Engine`` admitting :class:`AudioRequest` beside LM ``Request``
    traffic.  An audio request reserves a slot at once but joins the
    decode batch only when its audio is complete: each tick delivers one
    pending chunk a stream and appends it to the stream's slice; on the
    last chunk the prompt prefills into the slice, the slice is copied
    into the batch cache and the slot decodes in the shared step."""

    def __init__(self, *args, audio_chunk: int = 0,
                 max_frames: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.audio_chunk = audio_chunk
        self.max_frames = (self.cfg.enc_seq if not max_frames
                           else min(max_frames, self.cfg.enc_seq))
        self._audio: Dict[int, _AudioState] = {}

    def _append_cross(self, cs, frames: torch.Tensor):
        return self.model.append_cross(self._pv, self._qv, cs, frames,
                                       self.cfg, kv_bits=self.kv_bits)

    # ------------------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None and i not in self._audio:
                return i
        return None

    def submit(self, req):
        """Admit either request type."""
        if isinstance(req, AudioRequest):
            return self.submit_audio(req)
        return super().submit(req)

    def submit_audio(self, req: AudioRequest) -> Optional[RequestHandle]:
        """Reserve a slot for one audio stream (None when none is free);
        its chunks are appended on the following ticks, one a tick."""
        slot = self._free_slot()
        if slot is None:
            return None
        frames = _frames(req.frames, self.device)
        T = frames.shape[1]
        plen = len(req.prompt)
        if T < 1 or T > self.max_frames:
            raise ValueError(f"need 1 <= frames <= {self.max_frames} "
                             f"(got {T})")
        if plen < 1 or req.max_new < 1 or plen + req.max_new > self.max_len:
            raise ValueError(
                f"need prompt >= 1 ({plen}), max_new >= 1 ({req.max_new}), "
                f"and prompt + max_new <= max_len ({self.max_len})")
        self._audio[slot] = _AudioState(
            req=req, cs=self._new_slot(),
            blocks=split_audio(frames, req.chunk or self.audio_chunk))
        return RequestHandle(req)

    # ------------------------------------------------------------------
    def _finish_audio(self, slot: int, st: _AudioState) -> None:
        """Audio complete: the prompt prefills into the held slice, the
        slice is copied into the batch cache, the first token is sampled
        and the slot joins the decode tick (``ttft_s`` times exactly
        this)."""
        req = st.req
        t0 = time.perf_counter()
        cs, last_logits = self._prefill_prompt(req.prompt, cs=st.cs)
        self._write_slot(cs, slot)
        tok = self._first_token(req, last_logits)
        req.ttft_s = time.perf_counter() - t0
        del self._audio[slot]
        self._join(slot, req, tok)

    def step(self) -> None:
        """One tick: one pending chunk delivered a stream (finishing the
        streams whose audio is complete), then the decode step over every
        active slot."""
        for slot, st in list(self._audio.items()):
            t0 = time.perf_counter()
            st.cs = self._append_cross(st.cs, st.blocks.pop(0))
            _sync(self.device)
            st.req.t_chunks.append(time.perf_counter() - t0)
            if not st.blocks:
                self._finish_audio(slot, st)
        super().step()

    def run(self, requests) -> list:
        """Serve a mixed ASR + LM workload to completion."""
        pending = list(requests)
        while pending or self._audio \
                or any(r is not None for r in self.slot_req):
            while pending and self._free_slot() is not None:
                self.submit(pending.pop(0))
            self.step()
        return requests


# ----------------------------------------------------------------------
def _asr_decode_fn(model, cfg: ModelConfig, kv_bits: Optional[int]):
    def decode(p, q, c, t, pos):
        return model.decode_step(p, q, c, t, pos, cfg, kv_bits=kv_bits)
    return decode


def _asr_append_fn(model, cfg: ModelConfig, kv_bits: Optional[int]):
    def append(p, q, c, fr):
        return model.append_cross(p, q, c, fr, cfg, kv_bits=kv_bits)
    return append


def generate_asr(model, params, qstate, cfg: ModelConfig, frames,
                 prompt: List[int], max_new: int, *, chunk: int = 0,
                 cache_len: Optional[int] = None,
                 kv_bits: Optional[int] = None, device=None) -> torch.Tensor:
    """Offline greedy ASR reference: the audio encoded in the block
    decomposition streaming uses (:func:`split_audio`), the prompt
    prefilled in one block, greedy decode.  Returns ``[1, max_new]``
    token ids.  ``params`` are served as given (a packed tree too)."""
    dev = resolve_device(device)
    fr = _frames(frames, dev)
    plen = len(prompt)
    params, qstate = _to(params, dev), _to(qstate, dev)
    pv, qv = model.serving_views(params, cfg), model.serving_views(qstate,
                                                                   cfg)
    caches = model.init_cache(cfg, 1, cache_len or (plen + max_new),
                              ring_slack=plen, kv_bits=kv_bits, device=dev)
    append = _asr_append_fn(model, cfg, kv_bits)
    for blk in split_audio(fr, chunk):
        caches = append(pv, qv, caches, blk)
    decode = _asr_decode_fn(model, cfg, kv_bits)
    tok = torch.tensor([prompt], dtype=torch.int64, device=dev)
    logits, caches = decode(pv, qv, caches, tok, 0)
    pos = plen
    last = torch.argmax(logits[:, -1:], dim=-1)
    outs = [last]
    for _ in range(max_new - 1):
        logits, caches = decode(pv, qv, caches, last, pos)
        last = torch.argmax(logits[:, -1:], dim=-1)
        outs.append(last)
        pos += 1
    return torch.cat(outs, dim=1)
