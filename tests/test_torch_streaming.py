"""Streaming ASR serving in the port (``serving/streaming.py``): audio-chunk
requests in the continuous-batching engine, on whisper-large-v3 SMOKE (2
+ 2 layers, d 64, ``enc_seq`` 16, vocab 256) on the CPU.

The engine checks of ``tests/test_streaming_asr.py``, ported: audio
streamed chunk by chunk through ``StreamingEngine`` (appended into the
slot's own cache slice, then joining the shared ragged decode tick) gives
the offline ``generate_asr`` tokens exactly, on the fp and the nibble
cache, while LM requests decode in the same step; LM traffic through
``StreamingEngine`` gives the plain ``Engine``'s tokens; slots recycle
under more requests than slots; the ``submit_audio`` handle, validation
and admission; the cross memory's byte model.  Greedy tokens are held
equal, as the reference holds them.  The port-only tests use the port's
own seeded init; the JAX comparison carries one seeded JAX init across
with ``weights.from_jax`` and holds the port's ``StreamingEngine`` tokens
equal to the JAX ``StreamingEngine``'s and ``generate_asr``'s.  The
reference's spec routing (``api``) waits for the port of ``api``.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.nn imports repro.dist lazily)
    from repro import configs as jconfigs
    from repro.models import model_for as jmodel_for
    from repro.serving import AudioRequest as JAudioRequest
    from repro.serving import Request as JRequest
    from repro.serving import StreamingEngine as JStreamingEngine
    from repro.serving import generate_asr as jgenerate_asr
    from repro.serving import \
        kv_cross_bytes_per_request as j_cross_bytes

from repro_torch import configs as tconfigs
from repro_torch.models import WhisperModel, model_for
from repro_torch.serving import (AudioRequest, Engine, Request,
                                 StreamingEngine, generate_asr,
                                 kv_bytes_per_token,
                                 kv_cross_bytes_per_request, split_audio)
from repro_torch.weights import from_jax

ARCH = "whisper-large-v3"
_STATE = {}


def _whisper():
    """(cfg, model, params, qstate): the port's seeded init on the CPU."""
    if "port" not in _STATE:
        cfg = tconfigs.get(ARCH, smoke=True)
        M = model_for(cfg)
        p, q = M.init(torch.Generator().manual_seed(5), cfg, device="cpu")
        _STATE["port"] = (cfg, M, p, q)
    return _STATE["port"]


def _frames(cfg, T, seed=9):
    return (0.3 * np.random.default_rng(seed).standard_normal(
        (T, cfg.d_model))).astype(np.float32)


def _lm_reqs(vocab, lens, max_news, seed=21):
    rng = np.random.default_rng(seed)
    return [Request(prompt=[int(t) for t in rng.integers(1, vocab, n)],
                    max_new=mn) for n, mn in zip(lens, max_news)]


def _engine(M, p, q, cfg, **kw):
    return StreamingEngine(M, p, q, cfg, device="cpu", **kw)


def _offline(M, p, q, cfg, req, chunk, kv_bits):
    return generate_asr(M, p, q, cfg, req.frames, req.prompt, req.max_new,
                        chunk=chunk, cache_len=32, kv_bits=kv_bits,
                        device="cpu")[0].tolist()


def test_split_audio_blocks():
    """Full chunk-size blocks, then power-of-two tails; chunk 0 is one
    block."""
    fr = torch.zeros((16, 4))
    assert [b.shape[1] for b in split_audio(fr, 5)] == [5, 5, 5, 1]
    assert [b.shape[1] for b in split_audio(fr, 6)] == [6, 6, 4]
    assert [b.shape[1] for b in split_audio(fr, 0)] == [16]
    assert [b.shape[1] for b in split_audio(fr, 16)] == [16]
    blocks = split_audio(fr, 7)
    assert sum(b.shape[1] for b in blocks) == 16
    assert all(b.ndim == 3 for b in blocks)
    assert [b.shape[1] for b in split_audio(torch.zeros((1, 1037, 2)),
                                            250)] == [250] * 4 + [32, 4, 1]


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_streaming_matches_offline(kv_bits):
    """Chunked audio through the slot scheduler == offline generate_asr,
    token for token, with an LM request decoding in the same step."""
    cfg, M, p, q = _whisper()
    chunk, prompt, max_new = 5, [1, 2], 6
    frames = _frames(cfg, cfg.enc_seq)
    eng = _engine(M, p, q, cfg, batch_slots=2, max_len=32, kv_bits=kv_bits,
                  audio_chunk=chunk)
    req = AudioRequest(frames=frames, prompt=list(prompt), max_new=max_new)
    lm = _lm_reqs(cfg.vocab, [3], [5])[0]
    eng.run([req, lm])
    assert req.done and lm.done and len(lm.out) == 5
    assert req.out == _offline(M, p, q, cfg, req, chunk, kv_bits)
    # latency accounting: one entry a delivered chunk, ttft recorded
    assert len(req.t_chunks) == len(split_audio(torch.as_tensor(frames),
                                                chunk))
    assert all(t > 0 for t in req.t_chunks)
    assert req.ttft_s is not None and req.ttft_s > 0


def test_lm_traffic_unaffected_by_streaming_engine():
    """An LM request served by StreamingEngine (its row reads zero from
    the memory) gives the plain Engine's tokens."""
    cfg, M, p, q = _whisper()
    a = _lm_reqs(cfg.vocab, [4], [6])[0]
    b = Request(prompt=list(a.prompt), max_new=6)
    Engine(M, p, q, cfg, batch_slots=1, max_len=32, device="cpu").run([a])
    _engine(M, p, q, cfg, batch_slots=1, max_len=32, audio_chunk=5).run([b])
    assert a.done and b.done and a.out == b.out


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_mixed_workload_slot_churn(kv_bits):
    """More streams and LM requests than slots: every stream gives its
    offline tokens and every LM request a plain Engine's at the same
    ``kv_bits``, across slot recycling."""
    cfg, M, p, q = _whisper()
    chunk = 5
    auds = [AudioRequest(frames=_frames(cfg, T, seed=30 + i),
                         prompt=[1, 2 + i], max_new=4, chunk=chunk)
            for i, T in enumerate([cfg.enc_seq, 7, 11])]
    lms = _lm_reqs(cfg.vocab, [3, 5], [4, 3])
    reqs = [auds[0], lms[0], auds[1], lms[1], auds[2]]
    _engine(M, p, q, cfg, batch_slots=2, max_len=32, kv_bits=kv_bits,
            audio_chunk=chunk).run(reqs)
    assert all(r.done for r in reqs)
    for a in auds:
        assert a.out == _offline(M, p, q, cfg, a, chunk, kv_bits)
    for r in lms:
        ref = Request(prompt=list(r.prompt), max_new=r.max_new)
        Engine(M, p, q, cfg, batch_slots=1, max_len=32, kv_bits=kv_bits,
               device="cpu").run([ref])
        assert r.out == ref.out


def test_submit_audio_handle_tokens():
    """``submit_audio`` returns a handle whose ``tokens()`` yields what
    ``run()`` gives, a token at a time while chunks keep arriving."""
    cfg, M, p, q = _whisper()
    frames = _frames(cfg, cfg.enc_seq)
    ref_req = AudioRequest(frames=frames, prompt=[1, 2], max_new=5, chunk=5)
    _engine(M, p, q, cfg, batch_slots=1, max_len=32,
            audio_chunk=5).run([ref_req])
    eng = _engine(M, p, q, cfg, batch_slots=1, max_len=32, audio_chunk=5)
    h = eng.submit_audio(AudioRequest(frames=frames, prompt=[1, 2],
                                      max_new=5))
    assert h
    assert list(eng.tokens(h)) == ref_req.out
    assert h.done and h.out == ref_req.out


def test_submit_audio_validation_and_admission():
    cfg, M, p, q = _whisper()
    eng = _engine(M, p, q, cfg, batch_slots=1, max_len=16, audio_chunk=5,
                  max_frames=8)
    ok = AudioRequest(frames=_frames(cfg, 6), prompt=[1], max_new=2)
    with pytest.raises(ValueError, match="frames"):
        eng.submit_audio(AudioRequest(frames=_frames(cfg, 9), prompt=[1],
                                      max_new=2))
    with pytest.raises(ValueError, match="max_new"):
        eng.submit_audio(AudioRequest(frames=_frames(cfg, 6),
                                      prompt=[1] * 10, max_new=8))
    assert eng.submit_audio(ok)
    # slot reserved during streaming: both request types are refused
    assert eng.submit_audio(AudioRequest(frames=_frames(cfg, 6), prompt=[1],
                                         max_new=2)) is None
    assert eng.submit(Request(prompt=[1, 2], max_new=2)) is None
    eng.run([])
    assert ok.done and len(ok.out) == 2


@pytest.mark.parametrize("args", [(4, 16, 2, 16), (20, 64, 32, 1500),
                                  (20, 64, 32, 37), (1, 2, 1, 1)])
def test_cross_kv_bytes_model(args):
    """The reference's byte model, and its relation to the self ring's:
    frames x the per-token row cost, kv_bits None > 8 > 4."""
    n_kv, hd, L, frames = args
    got = [kv_cross_bytes_per_request(n_kv, hd, L, frames, b)
           for b in (None, 8, 4)]
    assert got == [j_cross_bytes(n_kv, hd, L, frames, b)
                   for b in (None, 8, 4)]
    assert got[0] > got[1] > got[2]
    assert got == [kv_bytes_per_token(n_kv, hd, L, b) * frames
                   for b in (None, 8, 4)]


def test_streaming_engine_matches_jax():
    """Two streams and an LM request through two slots (nibble caches, one
    slot recycled) in the port's and the JAX ``StreamingEngine`` from one
    JAX init: the same tokens for every request, and each stream's those
    of the JAX ``generate_asr``.  One block size (8 frames) and one prompt
    length keep the JAX side's compiles few."""
    jc = jconfigs.get(ARCH, smoke=True)
    tc = tconfigs.get(ARCH, smoke=True)
    JM = jmodel_for(jc)
    p, q = jax.jit(functools.partial(JM.init, cfg=jc))(jax.random.PRNGKey(5))
    tp, tq = from_jax(jax.tree.map(np.asarray, p),
                      jax.tree.map(np.asarray, q), device="cpu")
    chunk, kv_bits = 8, 4
    lm_prompt = [int(t) for t in np.random.default_rng(60).integers(
        1, jc.vocab, 2)]

    def make(Audio, Req):
        return [Audio(frames=_frames(tc, jc.enc_seq, seed=40), prompt=[1, 2],
                      max_new=5, chunk=chunk),
                Req(prompt=list(lm_prompt), max_new=3),
                Audio(frames=_frames(tc, 8, seed=41), prompt=[1, 3],
                      max_new=4, chunk=chunk)]

    treqs = make(AudioRequest, Request)
    StreamingEngine(WhisperModel, tp, tq, tc, batch_slots=2, max_len=32,
                    kv_bits=kv_bits, audio_chunk=chunk,
                    device="cpu").run(treqs)
    jreqs = make(JAudioRequest, JRequest)
    JStreamingEngine(JM, p, q, jc, batch_slots=2, max_len=32,
                     kv_bits=kv_bits, audio_chunk=chunk).run(jreqs)
    assert all(r.done for r in treqs + jreqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    for r in treqs:
        if isinstance(r, AudioRequest):
            ref = jgenerate_asr(JM, p, q, jc, jnp.asarray(r.frames),
                                r.prompt, r.max_new, chunk=chunk,
                                cache_len=32, kv_bits=kv_bits)
            assert r.out == [int(t) for t in np.asarray(ref)[0]]
