"""Port parity: the Griffin family (``nn/recurrent.py``'s RG-LRU block and
``models/griffin.py``) of ``repro_torch`` against the JAX package, on
recurrentgemma-2b SMOKE (5 layers: one (rec, rec, att) unit and 2
remainder recurrent layers; d 40, 4 heads over 1 kv head, window 16),
the trees carried across with ``weights.from_jax`` from one seeded JAX
init, inputs made with numpy.  The JAX side is jitted (its plain
references; nothing of ``src/repro`` is changed).

Tolerances:
- ``_linear_scan`` against the reference's ``_linear_scan``
  (``lax.associative_scan``) run eagerly, op by op: bit for bit (the same
  multiplies and adds in the same pairwise order); a left-to-right loop
  over 16 positions is not (it is the order the port must not use).
  Jitted, XLA on the CPU contracts a multiply and an add into one fused
  multiply-add and reads 1-4 ulps away (the port, like the eager
  reference, rounds both).
- ``RecurrentBlock.apply`` in EVAL, without and with a carried state:
  output and new state within 1e-6 of the largest entry (read: the same
  bits; XLA's and PyTorch's exp / sigmoid / matmul could part by ulps).
- ``GriffinLM.forward``: EVAL logits within 1e-5 (read 0.0); TRAIN
  logits within 1e-5, ~EBOPs rel 1e-6, L1 equal, every new range state
  within 1e-5.
- ``decode_step`` token by token past the window on the fp cache, the
  8-bit and the 4-bit ring: greedy tokens equal as served; logits within
  1e-5 (read 0.0) without the attention output quantizer, whose rounding
  ties XLA's and PyTorch's summation orders decide differently (as in
  ``tests/test_torch_moe.py``).
- The port's decode against its own EVAL forward past the window: the
  reference's own bar (``tests/test_decode_consistency.py``): within
  0.1, top-1 agreement above 0.95.
- ``Engine``: greedy tokens equal to ``generate()`` with the cache
  width pinned on the fp, 8-bit and 4-bit caches, and to the JAX
  ``Engine``'s on the 8-bit ring without the attention output quantizer
  (as served, a tie flips one token).
- Packing: the port's packed keys are the reference's ``iter_packable``
  keys (``conv_w`` and ``rem/*`` included) and every packed leaf is
  bit-exact, uniform int8 and with every MLP kernel in nibbles.
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
    from repro.models.griffin import _rg_cfg as j_rg_cfg
    from repro.nn import recurrent as jrec
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro.serving.packed import pack_tree as jpack_tree

from repro_torch import configs as tconfigs
from repro_torch.core.hgq import QTensor
from repro_torch.core.plan import LayerPlan, PrecisionPlan
from repro_torch.models import GriffinLM, model_for
from repro_torch.models.griffin import _rg_cfg
from repro_torch.nn import recurrent as trec
from repro_torch.serving import Engine, Request, generate
from repro_torch.serving.packed import pack_for_serving
from repro_torch.weights import from_jax

ARCH = "recurrentgemma-2b"
# every MLP kernel of the tree, the plan of chip_smoke's configuration (b)
MLP_KEYS = ("units/rec1/mlp", "units/rec2/mlp", "units/att/mlp",
            "rem/0/mlp", "rem/1/mlp")
_STATE = {}


def _trees():
    """(JAX cfg, port cfg, JAX params, JAX qstate, port params, port
    qstate) from one seeded JAX init."""
    if not _STATE:
        jc = jconfigs.get(ARCH, smoke=True)
        tc = tconfigs.get(ARCH, smoke=True)
        p, q = jax.jit(functools.partial(jmodel_for(jc).init, cfg=jc))(
            jax.random.PRNGKey(0))
        tp, tq = from_jax(jax.tree.map(np.asarray, p),
                          jax.tree.map(np.asarray, q), device="cpu")
        _STATE.update(jc=jc, tc=tc, p=p, q=q, tp=tp, tq=tq)
    s = _STATE
    return s["jc"], s["tc"], s["p"], s["q"], s["tp"], s["tq"]


def _without_attnout_quantizer(p):
    """The tree without the attention layers' output quantizer (both
    packages skip it when ``attnout_f`` is absent)."""
    mix = {k: v for k, v in p["units"]["att"]["mix"].items()
           if k != "attnout_f"}
    return {**p, "units": {**p["units"],
                           "att": {**p["units"]["att"], "mix": mix}}}


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


# ------------------------------- _linear_scan -------------------------------

def _jax_scan(a, b, h0):
    """The reference's scan, eagerly (one XLA call an operation)."""
    return np.asarray(jrec._linear_scan(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(h0)))


def _scan_inputs(S, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 1.0, (2, S, 24)).astype(np.float32)
    b = rng.standard_normal((2, S, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("S", [1, 2, 3, 5, 16, 17, 31])
def test_linear_scan_bit_exact(S):
    a, b, h0 = _scan_inputs(S, S)
    want = _jax_scan(a, b, h0)
    got = trec._linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(h0)).numpy()
    assert np.array_equal(got, want)


def test_sequential_scan_is_not_the_reference():
    """Over a prefill chunk of 16 a left-to-right loop gives other bits
    than the associative scan: the order is part of the function."""
    a, b, h0 = _scan_inputs(16, 16)
    want = _jax_scan(a, b, h0)
    h = torch.from_numpy(h0)
    seq = []
    for t in range(16):
        h = torch.from_numpy(a[:, t]) * h + torch.from_numpy(b[:, t])
        seq.append(h)
    seq = torch.stack(seq, dim=1).numpy()
    assert not np.array_equal(seq, want)
    np.testing.assert_allclose(seq, want, rtol=1e-5, atol=1e-5)


def test_softplus_is_logaddexp():
    x = np.concatenate([np.linspace(-30, 30, 2001, dtype=np.float32),
                        np.array([2.2, 0.0, -0.0, np.inf, -np.inf, np.nan],
                                 np.float32)])
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    got = trec.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    assert np.isnan(got[-1]) and got[-3] == np.inf and got[-2] == 0.0


# ------------------------------ RecurrentBlock ------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_recurrent_block_matches_jax(with_state):
    jc, tc, p, q, tp, tq = _trees()
    rg, jrg = _rg_cfg(tc), j_rg_cfg(jc)
    lp = jax.tree.map(lambda a: a[0], p["units"]["rec1"]["mix"])
    lq = jax.tree.map(lambda a: a[0], q["units"]["rec1"]["mix"])
    tlp = {k: v for k, v in _units0(tp)["rec1"]["mix"].items()}
    tlq = _units0(tq)["rec1"]["mix"]
    rng = np.random.default_rng(7)
    B, S, dr = 2, 16, rg.d_rnn
    x = rng.standard_normal((B, S, rg.d_model)).astype(np.float32)
    st = None
    if with_state:
        st = (rng.standard_normal((B, rg.conv_width - 1, dr))
              .astype(np.float32),
              rng.standard_normal((B, dr)).astype(np.float32))

    @jax.jit
    def jax_apply(lp, lq, x, st):
        state = None if st is None else jrec.GriffinState(*st)
        out, _, ns = jrec.RecurrentBlock.apply(
            lp, lq, JQ(x, None), state, cfg=jrg, mode="eval",
            aux=JAux.zero())
        return out.q, ns

    jo, jns = jax_apply(lp, lq, x, st)
    state = None if st is None else trec.GriffinState(
        *(torch.from_numpy(a) for a in st))
    to, _, tns = trec.RecurrentBlock.apply(
        tlp, tlq, QTensor(torch.from_numpy(x), None), state, cfg=rg,
        mode="eval", aux=None)
    _close(to.q, jo, 1e-6, "out")
    _close(tns.conv, jns.conv, 1e-6, "conv state")
    _close(tns.h, jns.h, 1e-6, "h state")


def _units0(tree):
    return GriffinLM.serving_views(tree, tconfigs.get(ARCH, smoke=True)
                                   )["units"][0]


# ---------------------------------- forward ---------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_jax(mode):
    jc, tc, p, q, tp, tq = _trees()
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 24))

    @jax.jit
    def jf(p, q, toks):
        lg, nq, aux = jmodel_for(jc).forward(p, q, {"tokens": toks}, jc,
                                             mode=mode)
        return lg, nq, aux.as_tuple()

    lj, nqj, (ej, l1j) = jf(p, q, jnp.asarray(toks))
    lt, nqt, aux = GriffinLM.forward(tp, tq, {"tokens": torch.from_numpy(
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

def _decode(kv_bits, quantizer=True):
    """(port, JAX) logits of 26 single-token ticks (positions up to 25:
    past the 16-slot window and around the 24-slot ring; one JAX compile
    a tree -- the chunked prefill is held by the forward and Engine
    tests)."""
    jc, tc, p, q, tp, tq = _trees()
    if not quantizer:
        p, tp = _without_attnout_quantizer(p), _without_attnout_quantizer(tp)
    B, T = 2, 26
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, T))
    M = jmodel_for(jc)
    jstep = jax.jit(M.decode_step, static_argnames=("cfg", "kv_bits"))
    jcache = M.init_cache(jc, B, 64, ring_slack=8, kv_bits=kv_bits)
    tcache = GriffinLM.init_cache(tc, B, 64, ring_slack=8, kv_bits=kv_bits,
                                  device="cpu")
    out = []
    for t in range(T):
        tok, pos = toks[:, t:t + 1], np.array([t] * B)
        lj, jcache = jstep(p, q, jcache, jnp.asarray(tok),
                           jnp.asarray(pos, jnp.int32), cfg=jc,
                           kv_bits=kv_bits)
        lt, tcache = GriffinLM.decode_step(tp, tq, tcache,
                                           torch.from_numpy(tok), pos, tc,
                                           kv_bits=kv_bits)
        out.append((lt.numpy(), np.asarray(lj)))
    return out


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_decode_matches_jax(kv_bits):
    for lt, lj in _decode(kv_bits, quantizer=True):
        assert np.array_equal(lt.argmax(-1), lj.argmax(-1))
    for lt, lj in _decode(kv_bits, quantizer=False):
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)


def test_decode_matches_own_forward():
    jc, tc, p, q, tp, tq = _trees()
    B, S = 1, 24                                   # past the window of 16
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab, (B, S)))
    full, _, _ = GriffinLM.forward(tp, tq, {"tokens": toks}, tc, mode="eval")
    cache = GriffinLM.init_cache(tc, B, S, device="cpu")
    got = []
    for t in range(S):
        lg, cache = GriffinLM.decode_step(tp, tq, cache, toks[:, t:t + 1], t,
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


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_engine_matches_generate(kv_bits):
    """``tests/test_serving_engine.py::test_sliding_window_per_slot_cache``
    in the port: ragged prompts through 2 slots decoding past the window
    (21 + 8 positions against 16), each request's tokens those of
    ``generate()`` with the engine's cache width."""
    jc, tc, p, q, tp, tq = _trees()
    lens, news = [3, 21, 9], [12, 8, 10]
    _, reqs = _requests(tc, lens, news)
    Engine(GriffinLM, tp, tq, tc, batch_slots=2, max_len=40, prefill_chunk=8,
           kv_bits=kv_bits, device="cpu").run(reqs)
    assert all(r.done and len(r.out) == n for r, n in zip(reqs, news))
    for r in reqs:
        ref = generate(GriffinLM, tp, tq, tc, [r.prompt], r.max_new,
                       cache_len=40, kv_bits=kv_bits, device="cpu")
        assert ref[0].tolist() == r.out


def test_engine_matches_jax_engine():
    """Three requests through 2 slots on the 8-bit ring, past the window,
    whole prefill chunks of 8 (the JAX engine compiles one prefill
    shape), both engines without the attention output quantizer (whose
    ties decide request 0's sixth token differently as served): the
    port's tokens are the JAX ``Engine``'s."""
    jc, tc, p, q, tp, tq = _trees()
    p, tp = _without_attnout_quantizer(p), _without_attnout_quantizer(tp)
    lens, news = [8, 24, 16], [12, 8, 14]
    prompts, reqs = _requests(tc, lens, news, seed=5)
    kw = dict(batch_slots=2, max_len=40, prefill_chunk=8, kv_bits=8)
    Engine(GriffinLM, tp, tq, tc, device="cpu", **kw).run(reqs)
    jreqs = [JRequest(prompt=list(pr), max_new=n)
             for pr, n in zip(prompts, news)]
    JEngine(jmodel_for(jc), p, q, jc, **kw).run(jreqs)
    assert [r.out for r in reqs] == [list(r.out) for r in jreqs]


# ---------------------------------- packing ---------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("use_plan", [False, True])
def test_pack_for_serving_matches_jax(use_plan):
    jc, tc, p, q, tp, tq = _trees()
    jplan = plan = None
    if use_plan:
        jplan = JPlan(layers={k: JLayerPlan(wire_bits=4, pack_bits=4)
                              for k in MLP_KEYS})
        plan = PrecisionPlan(layers={k: LayerPlan(wire_bits=4, pack_bits=4)
                                     for k in MLP_KEYS})
    keys = [k for k, _ in iter_packable(p)]
    assert "units/rec1/mix/conv_w" in keys and "rem/1/mix/in_rnn/kernel" \
        in keys and "rem/0/mlp/down/kernel" in keys
    pp, _ = pack_for_serving(tp, tq, plan)
    flat = _flat(pp)
    packed = sorted({k.rsplit("/", 1)[0] for k in flat
                     if k.endswith(("/w_int8", "/w_nib"))})
    assert packed == sorted(keys)
    nib = {k.rsplit("/", 1)[0] for k in flat if k.endswith("/w_nib")}
    assert nib == ({k for k in keys if "/mlp/" in k} if use_plan else set())
    want = _flat(jax.tree.map(np.asarray, jax.jit(functools.partial(
        jpack_tree, plan=jplan))(p)))
    assert flat.keys() == want.keys()
    for k in want:
        assert np.array_equal(flat[k], want[k]), k


# ------------------------------- registry -----------------------------------

def test_model_for_hybrid():
    assert model_for(tconfigs.get(ARCH)) is GriffinLM
    assert model_for(tconfigs.get(ARCH, smoke=True)) is GriffinLM
