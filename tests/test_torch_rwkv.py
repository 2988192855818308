"""Port parity: the RWKV-6 family (``nn/recurrent.py``'s RWKV half and
``models/rwkv.py``) of ``repro_torch`` against the JAX package, on
rwkv6-1.6b SMOKE (2 layers, d 128, 2 heads of 64, channel mix d_ff 256,
vocab 256, WKV chunks of 8), the trees carried across with
``weights.from_jax`` from one seeded JAX init, inputs made with numpy.
The reference's init leaves ``mu`` (0.5), ``bonus_u`` (0), ``decay_w0``
(-4) and ``ln_scale`` (1) constant, which would hide a swapped row or a
missing term, so every test redraws them from the seed on the JAX tree
before it is carried across: ``mu`` in [0, 1], ``bonus_u`` ~ N(0, 0.5),
``decay_w0`` in [-6, -1], ``ln_scale`` in [0.5, 1.5].  The JAX side runs
its plain functions (jitted for the models; nothing of ``src/repro`` is
changed).

Tolerances:
- The chunk's cumulative sum (``_cumsum``, left to right) against the
  reference's ``jnp.cumsum`` on the same ``log w``: bit for bit up to 17
  positions (a prefill chunk is at most 16); ``torch.cumsum`` is not.
- ``_wkv_chunked`` against the reference: y and the final state within
  1e-6 of the largest entry for S in {1, 2, 5, 8, 16} (one chunk of 16)
  and S in {21, 24} at chunk 8 (padded and not, several chunks), each
  from a zero and from a carried state; at chunk 64 over 64 positions
  (the FULL config's chunk, where XLA's cumsum is no longer left to
  right) within 1e-5.  Not bit for bit: PyTorch's ``exp`` / ``log`` on
  the CPU are other functions than XLA's at the ulp (about 71% of the
  state's elements equal at S = 1), and the port sums the 64-wide
  contractions in float64 (rounded once).
- ``_wkv_sequential`` against the reference's: within 1e-6.  The port's
  chunked form against its own sequential form: the reference's bar
  (``tests/test_recurrent_sharding.py``, 2e-4).  The S = 1 step written
  as ``w S + k v^T`` is not the chunked form's bits (``exp(log w)`` is
  not ``w``), in the port as in the reference: the port keeps the
  chunked form on every S.
- ``RWKVTimeMix.apply`` / ``RWKVChannelMix.apply`` in EVAL, without and
  with a carried state, against the reference run eagerly (jitted, XLA
  rounds one of the projections' activation quantizer ties differently
  from its own eager run, 1.6e-4 off): output and WKV state within 1e-6
  of the largest entry, the new token shift the same bits.
- ``RWKVLM.forward``: EVAL logits within 1e-5; TRAIN logits within 1e-5,
  ~EBOPs rel 1e-6, L1 equal, every new range state within 1e-5.
- ``decode_step`` token by token over 24 positions: greedy tokens equal
  as served; logits within 1e-5 without activation quantizers (whose
  rounding ties XLA's and PyTorch's ulps decide differently).
- The port's decode against its own EVAL forward: the reference's bar
  (``tests/test_decode_consistency.py``): within 0.1, top-1 agreement
  above 0.95.
- ``Engine``: for ragged prompts through 2 slots, ``kv_bits`` None and 8
  the same tokens as served (no KV cache), and without activation
  quantizers each request's greedy tokens those of ``generate()`` (as
  served one tie parts them: one whole-prompt call and the engine's
  chunks sum in other orders); against the reference's
  ``RWKVLM.decode_step`` driven per request on the engine's schedule
  (full chunks, power-of-two tails, then single tokens) without
  activation quantizers: equal tokens.  The JAX ``Engine`` cannot serve
  RWKV (``RWKVLM.init_cache`` takes no ``kv_bits``), which one test
  pins.
- Packing: the port's packed keys are the reference's ``iter_packable``
  keys (``att/decay_a`` and ``att/decay_b`` included) and every packed
  leaf is bit-exact, uniform int8 and with every channel-mix kernel in
  nibbles.
- ``LayerNorm``: within 1e-6 of the reference, equal bit for bit to the
  float64 sums rounded once, and a row alone gives the bits it gives in
  a batch of 8.
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
    from repro.core.hgq import Aux as JAux
    from repro.core.hgq import QTensor as JQ
    from repro.core.plan import LayerPlan as JLayerPlan
    from repro.core.plan import PrecisionPlan as JPlan
    from repro.core.plan import iter_packable
    from repro.models import model_for as jmodel_for
    from repro.models.rwkv import _rwkv_cfg as j_rwkv_cfg
    from repro.nn import basic as jbasic
    from repro.nn import recurrent as jrec
    from repro.serving import Engine as JEngine
    from repro.serving.packed import pack_tree as jpack_tree

from repro_torch import configs as tconfigs
from repro_torch.core.hgq import QTensor
from repro_torch.core.plan import LayerPlan, PrecisionPlan
from repro_torch.models import RWKVCaches, RWKVLM, model_for
from repro_torch.models.rwkv import _rwkv_cfg
from repro_torch.nn import basic as tbasic
from repro_torch.nn import recurrent as trec
from repro_torch.serving import Engine, Request, generate
from repro_torch.serving.packed import pack_for_serving
from repro_torch.weights import from_jax

ARCH = "rwkv6-1.6b"
# every channel-mix kernel of the tree, the plan of chip_smoke's
# configuration (b)
FFN_KEYS = ("layers/ffn",)
_STATE = {}


def _redraw(p, seed=0):
    """The JAX tree with the constants of the reference's init redrawn
    from the seed (numpy leaves)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, p)
    att, ffn = dict(p["layers"]["att"]), dict(p["layers"]["ffn"])
    u = lambda a, lo, hi: rng.uniform(lo, hi, a.shape).astype(np.float32)
    att["mu"] = u(att["mu"], 0.0, 1.0)
    att["bonus_u"] = (0.5 * rng.standard_normal(att["bonus_u"].shape)
                      ).astype(np.float32)
    att["decay_w0"] = u(att["decay_w0"], -6.0, -1.0)
    att["ln_scale"] = u(att["ln_scale"], 0.5, 1.5)
    ffn["mu"] = u(ffn["mu"], 0.0, 1.0)
    return {**p, "layers": {**p["layers"], "att": att, "ffn": ffn}}


def _trees():
    """(JAX cfg, port cfg, JAX params, JAX qstate, port params, port
    qstate) from one seeded JAX init, its constants redrawn."""
    if not _STATE:
        jc = jconfigs.get(ARCH, smoke=True)
        tc = tconfigs.get(ARCH, smoke=True)
        p, q = jax.jit(functools.partial(jmodel_for(jc).init, cfg=jc))(
            jax.random.PRNGKey(0))
        p = _redraw(p)
        q = jax.tree.map(np.asarray, q)
        tp, tq = from_jax(p, q, device="cpu")
        p = jax.tree.map(jnp.asarray, p)
        _STATE.update(jc=jc, tc=tc, p=p, q=q, tp=tp, tq=tq)
    s = _STATE
    return s["jc"], s["tc"], s["p"], s["q"], s["tp"], s["tq"]


def _without_act_quantizers(tree):
    """The tree without its activation quantizers (every ``out_f``): both
    packages skip a quantizer whose ``out_f`` is absent."""
    if isinstance(tree, dict):
        return {k: _without_act_quantizers(v) for k, v in tree.items()
                if k != "out_f"}
    return tree


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


# ----------------------------------- WKV ------------------------------------

def _wkv_inputs(S, seed, carried=True, B=2, H=2, N=64):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6, -1, (B, S, H, N)))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)) if carried \
        else np.zeros((B, H, N, N))
    return r, k, v, w, u, s0.astype(np.float32)


def _both(fn_name, args, *extra):
    """(port, reference) outputs of one WKV function on numpy inputs."""
    t = getattr(trec, fn_name)(*map(torch.from_numpy, args), *extra)
    j = getattr(jrec, fn_name)(*map(jnp.asarray, args), *extra)
    return [a.numpy() for a in t], [np.asarray(a) for a in j]


@pytest.mark.parametrize("S", [1, 2, 5, 8, 16, 17])
def test_cumsum_bit_exact(S):
    """The chunk's left-to-right cumulative sum is the reference's
    ``jnp.cumsum`` bit for bit up to 17 positions; ``torch.cumsum``
    (a control) is not, from 16 on."""
    w = _wkv_inputs(S, 30 + S)[3].reshape(2, S, 2, 64).transpose(0, 2, 1, 3)
    logw = np.log(w)
    want = np.asarray(jnp.cumsum(jnp.asarray(logw), axis=2))
    got = trec._cumsum(torch.from_numpy(logw), 2).numpy()
    assert np.array_equal(got, want)
    if S == 16:
        assert not np.array_equal(
            torch.cumsum(torch.from_numpy(logw), 2).numpy(), want)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S,chunk", [(1, 16), (2, 16), (5, 16), (8, 16),
                                     (16, 16), (21, 8), (24, 8)])
def test_wkv_chunked_matches_jax(S, chunk, carried):
    (yt, st), (yj, sj) = _both("_wkv_chunked",
                               _wkv_inputs(S, S + 100 * carried, carried),
                               chunk)
    _close(yt, yj, 1e-6, "y")
    _close(st, sj, 1e-6, "state")


def test_wkv_chunked_at_chunk_64_matches_jax():
    """The FULL config's chunk of 64 over 64 positions: XLA's cumsum is no
    longer left to right there, so within 1e-5."""
    (yt, st), (yj, sj) = _both("_wkv_chunked", _wkv_inputs(64, 64), 64)
    _close(yt, yj, 1e-5, "y")
    _close(st, sj, 1e-5, "state")


@pytest.mark.parametrize("S", [1, 13])
def test_wkv_sequential_matches_jax(S):
    (yt, st), (yj, sj) = _both("_wkv_sequential", _wkv_inputs(S, 7 + S))
    _close(yt, yj, 1e-6, "y")
    _close(st, sj, 1e-6, "state")


def test_wkv_chunked_matches_own_sequential():
    """The reference's bar (``tests/test_recurrent_sharding.py``) on the
    port's own two forms: 37 positions, chunks of 8, a carried state."""
    a = _wkv_inputs(37, 5)
    yc, sc = trec._wkv_chunked(*map(torch.from_numpy, a), 8)
    ys, ss = trec._wkv_sequential(*map(torch.from_numpy, a))
    np.testing.assert_allclose(yc.numpy(), ys.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(sc.numpy(), ss.numpy(), rtol=2e-4, atol=2e-4)


def test_sequential_step_is_not_the_chunked_form():
    """Control: at S = 1 (a decode tick) the sequential step is another
    function than the chunked form: its y is ``r (S + u k v^T)``, not
    ``r S + A v + (r . u k) v``, and its state ``w S + k v^T``, not
    ``exp(log w) S + k v^T``; its y gives other bits, in the reference and
    in the port alike.  So a "fast" S = 1 path would compute another
    function; the port runs the chunked form."""
    a = _wkv_inputs(1, 11, B=8)
    (yt, st), (yj, sj) = _both("_wkv_chunked", a, 64)
    (yts, sts), (yjs, sjs) = _both("_wkv_sequential", a)
    assert not np.array_equal(yjs, yj)
    assert not np.array_equal(yts, yt)
    r, k, v, w, u, s0 = map(torch.from_numpy, a)
    step = w[:, 0, :, :, None] * s0 + k[:, 0, :, :, None] * v[:, 0, :, None]
    assert torch.equal(step, torch.from_numpy(sts))
    _close(yt, yj, 1e-6, "y")
    _close(st, sj, 1e-6, "state")


# ------------------------------ the two mixes -------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _tlayer0(tree):
    return RWKVLM.serving_views(tree, tconfigs.get(ARCH, smoke=True)
                                )["layers"][0]


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_jax(with_state):
    jc, tc, p, q, tp, tq = _trees()
    rc, jrc = _rwkv_cfg(tc), j_rwkv_cfg(jc)
    H, N = rc.n_heads, rc.d_model // rc.n_heads
    rng = np.random.default_rng(3)
    B, S, d = 2, 13, rc.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    st = None
    if with_state:
        st = (rng.standard_normal((B, d)).astype(np.float32),
              rng.standard_normal((B, d)).astype(np.float32),
              rng.standard_normal((B, H, N, N)).astype(np.float32))

    def jax_apply(lp, lq, x, st):
        state = None if st is None else jrec.RWKVState(*st)
        out, _, (sa, wkv) = jrec.RWKVTimeMix.apply(
            lp, lq, JQ(x, None), state, cfg=jrc, mode="eval",
            aux=JAux.zero())
        return out.q, sa, wkv

    jo, jsa, jwkv = jax_apply(_layer0(p["layers"]["att"]),
                              _layer0(q["layers"]["att"]), x, st)
    state = None if st is None else trec.RWKVState(
        *(torch.from_numpy(a) for a in st))
    lp, lq = _tlayer0(tp)["att"], _tlayer0(tq)["att"]
    to, _, (tsa, twkv) = trec.RWKVTimeMix.apply(
        lp, lq, QTensor(torch.from_numpy(x), None), state, cfg=rc,
        mode="eval", aux=None)
    _close(to.q, jo, 1e-6, "out")
    assert np.array_equal(tsa.numpy(), np.asarray(jsa))
    _close(twkv, jwkv, 1e-6, "wkv state")


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(with_state):
    jc, tc, p, q, tp, tq = _trees()
    rng = np.random.default_rng(4)
    B, S, d = 2, 13, tc.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    sh = rng.standard_normal((B, d)).astype(np.float32) if with_state \
        else None

    def jax_apply(lp, lq, x, sh):
        out, _, sf = jrec.RWKVChannelMix.apply(lp, lq, JQ(x, None), sh,
                                               mode="eval", aux=JAux.zero())
        return out.q, sf

    jo, jsf = jax_apply(_layer0(p["layers"]["ffn"]),
                        _layer0(q["layers"]["ffn"]), x, sh)
    to, _, tsf = trec.RWKVChannelMix.apply(
        _tlayer0(tp)["ffn"], _tlayer0(tq)["ffn"],
        QTensor(torch.from_numpy(x), None),
        None if sh is None else torch.from_numpy(sh), mode="eval", aux=None)
    _close(to.q, jo, 1e-6, "out")
    assert np.array_equal(tsf.numpy(), np.asarray(jsf))


# ---------------------------------- forward ---------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_jax(mode):
    """21 tokens: the chunk of 8 padded in its last chunk."""
    jc, tc, p, q, tp, tq = _trees()
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 21))

    @jax.jit
    def jf(p, q, toks):
        lg, nq, aux = jmodel_for(jc).forward(p, q, {"tokens": toks}, jc,
                                             mode=mode)
        return lg, nq, aux.as_tuple()

    lj, nqj, (ej, l1j) = jf(p, q, jnp.asarray(toks))
    lt, nqt, aux = RWKVLM.forward(tp, tq, {"tokens": torch.from_numpy(
        toks)}, tc, mode=mode)
    _close(lt.detach(), lj, 1e-5, "logits")
    np.testing.assert_allclose(float(aux.ebops), float(ej), rtol=1e-6)
    assert float(aux.l1) == float(l1j)
    jl = jax.tree.leaves(nqj)
    tl = jax.tree.leaves(jax.tree.map(
        lambda t: t.detach().numpy(), nqt,
        is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert len(jl) == len(tl) > 0
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


# ---------------------------------- decode ----------------------------------

def _decode(quantizer=True, T=24):
    """(port, JAX) logits of T single-token ticks of 2 rows."""
    jc, tc, p, q, tp, tq = _trees()
    if not quantizer:
        p, tp = _without_act_quantizers(p), _without_act_quantizers(tp)
    B = 2
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, T))
    M = jmodel_for(jc)
    jstep = jax.jit(M.decode_step, static_argnames=("cfg",))
    jcache = M.init_cache(jc, B, 64)
    tcache = RWKVLM.init_cache(tc, B, 64, device="cpu")
    out = []
    for t in range(T):
        tok = toks[:, t:t + 1]
        lj, jcache = jstep(p, q, jcache, jnp.asarray(tok), jnp.int32(t),
                           cfg=jc)
        lt, tcache = RWKVLM.decode_step(tp, tq, tcache,
                                        torch.from_numpy(tok), t, tc)
        out.append((lt.numpy(), np.asarray(lj)))
    for name, a, b in zip(RWKVCaches._fields, tcache, jcache):
        _close(a, b, 1e-5, f"cache {name}")
    return out


@pytest.mark.parametrize("quantizer", [True, False])
def test_decode_matches_jax(quantizer):
    for lt, lj in _decode(quantizer):
        assert np.array_equal(lt.argmax(-1), lj.argmax(-1))
        if not quantizer:
            np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)


def test_decode_matches_own_forward():
    jc, tc, p, q, tp, tq = _trees()
    B, S = 1, 24
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab, (B, S)))
    full, _, _ = RWKVLM.forward(tp, tq, {"tokens": toks}, tc, mode="eval")
    cache = RWKVLM.init_cache(tc, B, S, device="cpu")
    got = []
    for t in range(S):
        lg, cache = RWKVLM.decode_step(tp, tq, cache, toks[:, t:t + 1], t,
                                       tc)
        got.append(lg[:, 0])
    got = torch.stack(got, dim=1).numpy()
    full = full.numpy()
    np.testing.assert_allclose(got, full, rtol=1e-1, atol=1e-1)
    assert np.mean(got.argmax(-1) == full.argmax(-1)) > 0.95


# ---------------------------------- Engine ----------------------------------

def _requests(tc, lens, news, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(0, tc.vocab, n)] for n in lens]
    return prompts, [Request(prompt=list(pr), max_new=n)
                     for pr, n in zip(prompts, news)]


def test_engine_matches_generate():
    """Ragged prompts (3, 21, 9 tokens) through 2 slots, chunks of 8: as
    served, ``kv_bits`` 8 gives the same tokens as None (the model holds
    no KV); without activation quantizers each request's tokens are those
    of ``generate()``.  As served they are not for the 21-token prompt:
    ``generate()`` prefills it in one call (chunks 8, 8 and 5 padded), the
    engine in four (8, 8, 4, 1), whose sums part at the ulp and round one
    quantizer tie differently at its 6th token (the engine's tokens are
    the reference's on its schedule, ``test_engine_matches_jax_decode_
    schedule``)."""
    jc, tc, p, q, tp, tq = _trees()
    lens, news = [3, 21, 9], [12, 8, 10]

    def serve(tp, kv_bits):
        _, reqs = _requests(tc, lens, news)
        eng = Engine(RWKVLM, tp, tq, tc, batch_slots=2, max_len=40,
                     prefill_chunk=8, kv_bits=kv_bits, device="cpu")
        assert isinstance(eng.caches, RWKVCaches)
        eng.run(reqs)
        assert all(r.done and len(r.out) == n for r, n in zip(reqs, news))
        return reqs

    assert [r.out for r in serve(tp, None)] == [r.out for r in serve(tp, 8)]
    tp = _without_act_quantizers(tp)
    for r in serve(tp, None):
        ref = generate(RWKVLM, tp, tq, tc, [r.prompt], r.max_new,
                       cache_len=40, device="cpu")
        assert ref[0].tolist() == r.out


def _schedule(n, C):
    """The engine's prefill chunks of a prompt of n tokens: full chunks
    of C, then power-of-two tails."""
    out, start = [], 0
    while start < n:
        m = C if n - start >= C else 1 << ((n - start).bit_length() - 1)
        out.append((start, m))
        start += m
    return out


def test_engine_matches_jax_decode_schedule():
    """Three requests through 2 slots against the reference's
    ``RWKVLM.decode_step`` driven per request on the engine's schedule
    (chunks of 8, power-of-two tails, then one token a step), both
    without activation quantizers: the same tokens."""
    jc, tc, p, q, tp, tq = _trees()
    p, tp = _without_act_quantizers(p), _without_act_quantizers(tp)
    lens, news = [8, 23, 13], [12, 8, 14]
    prompts, reqs = _requests(tc, lens, news, seed=5)
    Engine(RWKVLM, tp, tq, tc, batch_slots=2, max_len=40, prefill_chunk=8,
           device="cpu").run(reqs)
    M = jmodel_for(jc)
    jstep = jax.jit(M.decode_step, static_argnames=("cfg",))
    for pr, n, r in zip(prompts, news, reqs):
        cache = M.init_cache(jc, 1, 40)
        for start, m in _schedule(len(pr), 8):
            lg, cache = jstep(p, q, cache, jnp.asarray([pr[start:start + m]]),
                              jnp.int32(start), cfg=jc)
        out = [int(jnp.argmax(lg[0, -1]))]
        while len(out) < n:
            lg, cache = jstep(p, q, cache, jnp.asarray([[out[-1]]]),
                              jnp.int32(len(pr) + len(out) - 1), cfg=jc)
            out.append(int(jnp.argmax(lg[0, -1])))
        assert r.out == out


def test_jax_engine_cannot_serve_rwkv():
    """Reference behaviour: the JAX ``Engine`` passes ``kv_bits`` to
    ``init_cache``, which ``RWKVLM.init_cache`` does not take; hence the
    schedule-driven reference above."""
    jc, tc, p, q, tp, tq = _trees()
    with pytest.raises(TypeError, match="kv_bits"):
        JEngine(jmodel_for(jc), p, q, jc, batch_slots=2, max_len=40,
                prefill_chunk=8)


# ---------------------------------- packing ---------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("use_plan", [False, True])
def test_pack_for_serving_matches_jax(use_plan):
    jc, tc, p, q, tp, tq = _trees()
    jplan = plan = None
    if use_plan:
        jplan = JPlan(layers={k: JLayerPlan(wire_bits=4, pack_bits=4)
                              for k in FFN_KEYS})
        plan = PrecisionPlan(layers={k: LayerPlan(wire_bits=4, pack_bits=4)
                                     for k in FFN_KEYS})
    keys = [k for k, _ in iter_packable(p)]
    assert sorted(keys) == sorted(
        [f"layers/att/{n}/kernel" for n in ("wr", "wk", "wv", "wg", "wo")]
        + [f"layers/ffn/{n}/kernel" for n in ("wk", "wv", "wr")]
        + ["layers/att/decay_a", "layers/att/decay_b", "lm_head/kernel"]
        + ["embed/table"])
    pp, _ = pack_for_serving(tp, tq, plan)
    flat = _flat(pp)
    packed = sorted({k.rsplit("/", 1)[0] for k in flat
                     if k.endswith(("/w_int8", "/w_nib"))})
    assert packed == sorted(keys)
    nib = {k.rsplit("/", 1)[0] for k in flat if k.endswith("/w_nib")}
    assert nib == ({k for k in keys if "/ffn/" in k} if use_plan else set())
    for k in ("layers/att/mu", "layers/att/bonus_u", "layers/att/decay_w0",
              "layers/att/ln_scale", "layers/ffn/mu"):
        assert k in flat
    want = _flat(jax.tree.map(np.asarray, jax.jit(functools.partial(
        jpack_tree, plan=jplan))(p)))
    assert flat.keys() == want.keys()
    for k in want:
        assert np.array_equal(flat[k], want[k]), k


# --------------------------------- LayerNorm --------------------------------

def test_layer_norm_float64_sums_and_rows_alone():
    rng = np.random.default_rng(9)
    d = 2048
    x = (3.0 + 2.0 * rng.standard_normal((8, d))).astype(np.float32)
    cfg = tconfigs.get(ARCH, smoke=True).hgq
    jp, jq = jbasic.LayerNorm.init(None, d, cfg)
    jp = {**jp, "scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    jp = {k: v for k, v in jp.items() if k != "out_f"}
    want = np.asarray(jbasic.LayerNorm.apply(
        jax.tree.map(jnp.asarray, jp), jq, jnp.asarray(x), mode="eval",
        aux=JAux.zero())[0].q)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    got = tbasic.LayerNorm.apply(tp, {}, torch.from_numpy(x), mode="eval",
                                 aux=None)[0].q
    _close(got, want, 1e-6, "LayerNorm")
    xd = torch.from_numpy(x).double()
    mu = xd.mean(-1, keepdim=True).float()
    c = torch.from_numpy(x) - mu
    var = (c.double() ** 2).mean(-1, keepdim=True).float()
    exp = (c * torch.rsqrt(var + 1e-5)) * tp["scale"] + tp["bias"]
    assert torch.equal(got, exp)
    alone = tbasic.LayerNorm.apply(tp, {}, torch.from_numpy(x[3:4]),
                                   mode="eval", aux=None)[0].q
    assert torch.equal(alone, got[3:4])


# ------------------------------- registry -----------------------------------

def test_model_for_ssm():
    assert model_for(tconfigs.get(ARCH)) is RWKVLM
    assert model_for(tconfigs.get(ARCH, smoke=True)) is RWKVLM
    rc = _rwkv_cfg(tconfigs.get(ARCH))
    assert (rc.n_heads, rc.d_model, rc.d_ff, rc.time_chunk) == \
        (32, 2048, 7168, 64)
