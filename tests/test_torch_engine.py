"""Port parity: the continuous-batching ``Engine`` of ``repro_torch`` on a
ragged workload (6 requests through 3 slots, joining and leaving
mid-run), on the qwen2-0.5b SMOKE config with a JAX init carried across.

Greedy tokens equal the port's own ``generate()`` token for token in
every mode, and the JAX ``Engine``'s: token for token on the fp cache
and on >= 95% of tokens in the packed / quantized-KV modes, the JAX
suite's own bar for argmax near-ties.  Slot recycling, prefix reuse and
sampling are checked on the port alone (sampled tokens cannot share
JAX's random stream)."""
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import repro.dist  # noqa: F401  (repro.nn imports repro.dist lazily)
    from repro.configs import get as jget
    from repro.core.plan import PrecisionPlan as JPlan
    from repro.models import model_for
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro.serving import kvcache as jkvc

from repro_torch.configs import get as tget
from repro_torch.core.plan import PrecisionPlan
from repro_torch.models import GriffinLM, TransformerLM
from repro_torch.models.lm import layer_views
from repro_torch.serving import Engine, Request, SamplingConfig, generate
from repro_torch.serving import kvcache as tkvc
from repro_torch.weights import from_jax

LENS = [3, 5, 2, 7, 6, 4]
MAX_NEWS = [4, 3, 6, 2, 5, 4]
MODES = {"fp": (False, None), "packed": (True, None), "kv8": (False, 8),
         "packed_kv4": (True, 4)}

_STATE = {}


def _setup():
    if not _STATE:
        jc = jget("qwen2-0.5b", smoke=True)
        tc = tget("qwen2-0.5b", smoke=True)
        p, q = model_for(jc).init(jax.random.PRNGKey(3), jc)
        tp, tq = from_jax(jax.tree.map(np.asarray, p),
                          jax.tree.map(np.asarray, q), device="cpu")
        _STATE.update(jc=jc, tc=tc, p=p, q=q, tp=tp, tq=tq)
    return _STATE


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lens]


def _engine(s, **kw):
    kw.setdefault("batch_slots", 3)
    kw.setdefault("max_len", 32)
    return Engine(TransformerLM, s["tp"], s["tq"], s["tc"], device="cpu",
                  **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_generate_and_jax(mode):
    packed, kv_bits = MODES[mode]
    s = _setup()
    prompts = _prompts(s["tc"].vocab, LENS)
    reqs = [Request(prompt=list(pr), max_new=mn)
            for pr, mn in zip(prompts, MAX_NEWS)]
    _engine(s, prefill_chunk=4, packed=packed, kv_bits=kv_bits).run(reqs)
    assert all(r.done and len(r.out) == mn for r, mn in zip(reqs, MAX_NEWS))
    for r in reqs:
        ref = generate(TransformerLM, s["tp"], s["tq"], s["tc"], [r.prompt],
                       r.max_new, cache_len=32, packed=packed,
                       kv_bits=kv_bits, device="cpu")
        assert ref[0].tolist() == r.out

    jreqs = [JRequest(prompt=list(pr), max_new=mn)
             for pr, mn in zip(prompts, MAX_NEWS)]
    JEngine(model_for(s["jc"]), s["p"], s["q"], s["jc"], batch_slots=3,
            max_len=32, prefill_chunk=4, packed=packed,
            kv_bits=kv_bits).run(jreqs)
    total = sum(len(r.out) for r in reqs)
    match = sum(a == b for r, jr in zip(reqs, jreqs)
                for a, b in zip(r.out, jr.out))
    if mode == "fp":
        assert match == total, f"fp token match {match}/{total}"
    else:
        assert match / total >= 0.95, f"{mode} token match {match}/{total}"


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_recycled_slot_matches_fresh_engine(kv_bits):
    """A slot recycled after a long tenant (mantissas AND grid exponents
    overwritten) decodes like a fresh engine."""
    s = _setup()
    long_p, probe = _prompts(s["tc"].vocab, [9, 4], seed=1)
    eng = _engine(s, batch_slots=1, kv_bits=kv_bits)
    eng.run([Request(prompt=long_p, max_new=14)])
    assert eng.slot_req == [None]
    recycled = Request(prompt=list(probe), max_new=6)
    eng.run([recycled])
    fresh = Request(prompt=list(probe), max_new=6)
    _engine(s, batch_slots=1, kv_bits=kv_bits).run([fresh])
    assert recycled.out == fresh.out


def test_prefix_reuse_matches_cold_prefill():
    """A prompt served from the prefix cache into a recycled slot equals
    a cold prefill, and skips the prefill; the cached slice survives
    the in-place writes of later ticks."""
    s = _setup()
    prompt, other = _prompts(s["tc"].vocab, [6, 4], seed=2)
    eng = _engine(s, batch_slots=1, prefix_reuse=True, kv_bits=8)
    calls = []
    inner = eng._prefill_prompt

    def counting(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    eng._prefill_prompt = counting
    first = Request(prompt=list(prompt), max_new=5)
    eng.run([first])
    eng.run([Request(prompt=list(other), max_new=3)])
    reused = Request(prompt=list(prompt), max_new=5)
    eng.run([reused])
    assert len(calls) == 2
    cold = Request(prompt=list(prompt), max_new=5)
    _engine(s, batch_slots=1, kv_bits=8).run([cold])
    assert reused.out == first.out == cold.out


def test_sampling_deterministic_under_seed():
    s = _setup()
    prompts = _prompts(s["tc"].vocab, [4, 3], seed=4)

    def run(seed):
        reqs = [Request(prompt=list(prompts[0]), max_new=8),
                Request(prompt=list(prompts[1]), max_new=8,
                        sampling=SamplingConfig(temperature=1.5, top_k=8))]
        _engine(s, batch_slots=2, seed=seed).run(reqs)
        return [r.out for r in reqs]

    a, b, c = run(0), run(0), run(1)
    assert a == b
    assert a[0] == c[0]                     # the greedy row ignores the seed
    assert a[1] != c[1]
    assert all(0 <= t < s["tc"].vocab for r in a for t in r)


def test_handles_and_admission():
    s = _setup()
    prompts = _prompts(s["tc"].vocab, [3, 5, 2], seed=5)
    run_reqs = [Request(prompt=list(p), max_new=4) for p in prompts]
    _engine(s).run(run_reqs)
    eng = _engine(s)
    handles = [eng.submit(Request(prompt=list(p), max_new=4))
               for p in prompts]
    assert all(handles)
    assert eng.submit(Request(prompt=[1], max_new=2)) is None   # full
    for h, r in zip(handles, run_reqs):
        assert list(eng.tokens(h)) == r.out and h.done
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=[1] * 30, max_new=8))         # > max_len


def test_engine_needs_device_choice_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    s = _setup()
    with pytest.raises(RuntimeError):
        Engine(TransformerLM, s["tp"], s["tq"], s["tc"], batch_slots=1,
               max_len=8)


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_layer_views_keep_tokens(mode):
    """The engine takes its per-layer views from the model
    (``serving_views``): the same tokens as an engine whose views are made
    from ``params["layers"]`` directly, as the engine made them before it
    stopped naming a model's keys."""
    packed, kv_bits = MODES[mode]
    s = _setup()
    prompts = _prompts(s["tc"].vocab, LENS, seed=6)

    def run(named):
        eng = _engine(s, prefill_chunk=4, packed=packed, kv_bits=kv_bits)
        if named:
            n = s["tc"].n_layers
            eng._pv = {**eng.p, "layers": layer_views(eng.p["layers"], n)}
            eng._qv = {**eng.q, "layers": layer_views(eng.q["layers"], n)}
        reqs = [Request(prompt=list(pr), max_new=mn)
                for pr, mn in zip(prompts, MAX_NEWS)]
        eng.run(reqs)
        return [r.out for r in reqs]

    assert run(False) == run(True)


def test_griffin_fp_cache_engine_slots():
    """A Griffin engine on the fp cache (``kf`` / ``vf`` None): its slot
    slices keep the empty fields empty, it admits, serves and frees
    every slot, and a slot recycled after a long tenant (recurrent state
    and ring overwritten by a fresh slice) decodes like a fresh engine."""
    cfg = tget("recurrentgemma-2b", smoke=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    p, q = GriffinLM.init(gen, cfg, device="cpu")

    def engine(slots):
        return Engine(GriffinLM, p, q, cfg, batch_slots=slots, max_len=40,
                      prefill_chunk=8, device="cpu")

    eng = engine(2)
    assert eng.caches.kf is None and eng.caches.vf is None
    cs = eng._new_slot()
    assert cs.kf is None and cs.vf is None and cs.h.shape[1] == 1
    reqs = [Request(prompt=list(pr), max_new=n) for pr, n in zip(
        _prompts(cfg.vocab, [3, 21, 9], seed=7), [12, 8, 10])]
    eng.run(reqs)
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert eng.slot_req == [None, None]
    long_p, probe = _prompts(cfg.vocab, [25, 4], seed=8)
    one = engine(1)
    one.run([Request(prompt=long_p, max_new=10)])
    recycled = Request(prompt=list(probe), max_new=6)
    one.run([recycled])
    fresh = Request(prompt=list(probe), max_new=6)
    engine(1).run([fresh])
    assert recycled.out == fresh.out


def test_kv_cache_widths_match_jax():
    plan = {"default": {"kv_bits": 8}, "layers": {
        "layers/attn": {"kv_bits": 5}, "layers/mlp": {"kv_bits": 6}}}
    for mode in tkvc.KV_CACHE_MODES:
        for p in (None, plan):
            assert tkvc.resolve_kv_bits(
                mode, None if p is None else PrecisionPlan.from_dict(p)) == \
                jkvc.resolve_kv_bits(mode,
                                     None if p is None else JPlan.from_dict(p))
    with pytest.raises(ValueError):
        tkvc.resolve_kv_bits("int4", None)
    for bits in (None, 4, 5, 8):
        assert tkvc.kv_bytes_per_token(2, 64, 24, bits) == \
            jkvc.kv_bytes_per_token(2, 64, 24, bits)
    q = tkvc.quantized_cache((2, 3, 5, 2, 8), 4, device="cpu")
    assert tuple(q.k.shape) == (2, 3, 5, 2, 4) and tuple(q.kf.shape) == \
        (2, 3, 5, 2)
