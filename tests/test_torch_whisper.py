"""Port parity: Whisper (``nn/mlp.MLP`` and ``models/whisper.py``) of
``repro_torch`` against the JAX package, on whisper-large-v3 SMOKE (2
encoder and 2 decoder layers, d 64, 4 heads of 16, d_ff 128, ``enc_seq``
16, vocab 256), the trees carried across with ``weights.from_jax`` from
one seeded JAX init, inputs made with numpy.  The reference's init leaves
every bias at 0 and every LayerNorm at scale 1, bias 0, which would hide
a missing or swapped term, so the JAX tree's biases and norms are redrawn
from the seed before it is carried across (biases ~ N(0, 0.1), norm
scales in [0.5, 1.5], norm biases ~ N(0, 0.1)).  Frame embeddings are
N(0, 1) x 0.3, as the reference's tests scale them.  The JAX side runs
its plain functions (jitted for the model entry points; nothing of
``src/repro`` is changed).

Tolerances:
- ``MLP.apply`` (EVAL and TRAIN), ``CrossAttention.kv``: within 1e-6 of
  the largest entry; new range states equal within 1e-6.
- ``CrossAttention.apply`` and ``CrossAttention.decode`` on an fp (bf16)
  and a quantized (int8, nibble) memory with rows filled to T, part of T
  and 0: within 1e-5 of the largest entry (XLA's and PyTorch's sums and
  ``exp`` differ at the ulp; the probabilities' grid is the same).  A row
  with ``mem_len == 0`` reads exactly zero: its output is the output
  projection of a zero input, bit for bit.
- ``encode`` at offset 0 and at offset 5: within 1e-5.
- ``forward`` in EVAL and TRAIN: logits within 1e-5, ~EBOPs rel 1e-6, L1
  equal, every new range state within 1e-5 (the reference's cross K/V
  states, which it returns under ``dec_layers/xattn_kv``, compared where
  the port returns them: under ``dec_layers/xattn``, the init qstate's
  paths).
- ``init_cache``: the reference's shapes and dtypes, kv_bits None, 8, 4.
- ``append_cross`` over chunks of 5 (blocks 5, 5, 5, 1): ``mem_len``
  equal; quantized: grid exponents equal, mantissas within one grid step
  (the encoder's sums differ at the ulp), nibbles compared unpacked; fp:
  within one bf16 step.
- ``decode_step`` token by token after the append: greedy tokens equal
  as served (kv_bits None and 8); without activation quantizers (kv_bits
  8) logits within 1e-5.
- ``serving_views`` (biases quantized once): the stacked tree's bits,
  logits and caches, on the fp and the nibble cache.
- Packing: the port's packed keys are the reference's ``iter_packable``
  keys and every packed leaf is bit-exact, uniform int8 and with every
  encoder and decoder MLP kernel in nibbles.
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
    from repro.kernels.kv_dequant.ops import kv_pack as jkv_pack
    from repro.kernels.kv_dequant.ops import kv_quantize as jkv_quantize
    from repro.models import model_for as jmodel_for
    from repro.models import whisper as jwh
    from repro.nn import mlp as jmlp
    from repro.serving.packed import pack_tree as jpack_tree

from repro_torch import configs as tconfigs
from repro_torch.core.hgq import QTensor
from repro_torch.core.plan import LayerPlan, PrecisionPlan
from repro_torch.kernels.kv_dequant.ref import kv_unpack_ref
from repro_torch.models import WhisperCaches, WhisperModel, model_for
from repro_torch.models import whisper as twh
from repro_torch.models.lm import layer_views
from repro_torch.nn import mlp as tmlp
from repro_torch.nn.basic import HDense
from repro_torch.serving.packed import pack_for_serving
from repro_torch.weights import from_jax

ARCH = "whisper-large-v3"
# every MLP kernel of both stacks: the plan of chip_smoke's configuration (b)
MLP_KEYS = ("enc_layers/mlp", "dec_layers/mlp")
_STATE = {}


def _redraw(tree, rng):
    """Biases ~ N(0, 0.1) and LayerNorm scales in [0.5, 1.5] (numpy
    leaves), every other leaf as it is."""
    if not isinstance(tree, dict):
        return np.asarray(tree)
    out = {}
    for k, v in tree.items():
        if k == "bias" and isinstance(v, dict):       # an HDense bias
            w = np.asarray(v["w"])
            out[k] = {**{n: np.asarray(a) for n, a in v.items()},
                      "w": (0.1 * rng.standard_normal(w.shape)
                            ).astype(np.float32)}
        elif k == "bias" and not isinstance(v, dict):  # a LayerNorm's
            a = np.asarray(v)
            out[k] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif k == "scale" and not isinstance(v, dict):
            a = np.asarray(v)
            out[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            out[k] = _redraw(v, rng)
    return out


def _trees():
    """(JAX cfg, port cfg, JAX params, JAX qstate, port params, port
    qstate) from one seeded JAX init, biases and norms redrawn."""
    if not _STATE:
        jc = jconfigs.get(ARCH, smoke=True)
        tc = tconfigs.get(ARCH, smoke=True)
        p, q = jax.jit(functools.partial(jmodel_for(jc).init, cfg=jc))(
            jax.random.PRNGKey(0))
        p = _redraw(jax.tree.map(np.asarray, p), np.random.default_rng(0))
        q = jax.tree.map(np.asarray, q)
        tp, tq = from_jax(p, q, device="cpu")
        p = jax.tree.map(jnp.asarray, p)
        _STATE.update(jc=jc, tc=tc, p=p, q=q, tp=tp, tq=tq)
    s = _STATE
    return s["jc"], s["tc"], s["p"], s["q"], s["tp"], s["tq"]


def _frames(cfg, T, seed=9, B=1):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((B, T, cfg.d_model))
            ).astype(np.float32)


def _without_act_quantizers(tree):
    """The tree without its activation quantizers (every ``out_f`` and
    ``attnout_f``); the probabilities' grids stay."""
    if isinstance(tree, dict):
        return {k: _without_act_quantizers(v) for k, v in tree.items()
                if k not in ("out_f", "attnout_f")}
    return tree


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _flat(tree, prefix=""):
    """{path: numpy leaf}; named tuples by field name."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _xattn_kv_under_xattn(qstate):
    """The reference's new qstate with its cross K/V range states
    (``dec_layers/xattn_kv/{wk,wv}``) moved back under
    ``dec_layers/xattn``, where its init qstate and the port keep them."""
    dec = dict(qstate["dec_layers"])
    dec["xattn"] = {**dec["xattn"], **dec.pop("xattn_kv")}
    return {**qstate, "dec_layers": dec}


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _tlayer0(tree, key):
    return layer_views(tree[key], 1)[0]


# ------------------------------------ MLP -----------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
def test_mlp_matches_jax(mode):
    jc, tc, p, q, tp, tq = _trees()
    x = np.random.default_rng(1).standard_normal((2, 7, jc.d_model)
                                                 ).astype(np.float32)
    jo, jnq = jmlp.MLP.apply(_layer0(p["dec_layers"]["mlp"]),
                             _layer0(q["dec_layers"]["mlp"]),
                             JQ(jnp.asarray(x), None), mode=mode,
                             aux=JAux.zero())
    to, tnq = tmlp.MLP.apply(_tlayer0(tp, "dec_layers")["mlp"],
                             _tlayer0(tq, "dec_layers")["mlp"],
                             QTensor(torch.from_numpy(x), None), mode=mode,
                             aux=None)
    _close(to.q, jo.q, 1e-6, "MLP")
    want, got = _flat(jnq), _flat(tnq)
    assert want.keys() == got.keys()
    for k in want:
        _close(got[k], want[k], 1e-6, k)


# ------------------------------ CrossAttention ------------------------------

def _xattn(tree, tc):
    return _tlayer0(tree, "dec_layers")["xattn"]


def test_cross_attention_kv_and_apply_match_jax():
    jc, tc, p, q, tp, tq = _trees()
    rng = np.random.default_rng(2)
    mem = rng.standard_normal((2, jc.enc_seq, jc.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    jp, jq = _layer0(p["dec_layers"]["xattn"]), _layer0(q["dec_layers"]
                                                        ["xattn"])
    kj, vj, _ = jwh.CrossAttention.kv(jp, jq, JQ(jnp.asarray(mem), None), jc,
                                      "eval", JAux.zero())
    yj, _ = jwh.CrossAttention.apply(jp, jq, JQ(jnp.asarray(x), None), kj,
                                     vj, jc, "eval", JAux.zero())
    xp, xq = _xattn(tp, tc), _xattn(tq, tc)
    kt, vt, _ = twh.CrossAttention.kv(xp, xq, QTensor(torch.from_numpy(mem),
                                                      None), tc, "eval",
                                      None)
    yt, _ = twh.CrossAttention.apply(xp, xq, QTensor(torch.from_numpy(x),
                                                     None), kt, vt, tc,
                                     "eval", None)
    _close(kt, kj, 1e-6, "k")
    _close(vt, vj, 1e-6, "v")
    _close(yt.q, yj.q, 1e-5, "apply")


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_cross_attention_decode_matches_jax(kv_bits):
    """Rows filled to T, to 5 and to 0 frames; the last reads zero."""
    jc, tc, p, q, tp, tq = _trees()
    rng = np.random.default_rng(3)
    B, S, T, H, hd = 3, 2, jc.enc_seq, jc.n_heads, jc.hd
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    kv = (rng.standard_normal((2, B, T, H, hd)) * 2).astype(np.float32)
    mem = np.array([T, 5, 0], np.int32)
    jp, jq = _layer0(p["dec_layers"]["xattn"]), _layer0(q["dec_layers"]
                                                        ["xattn"])
    if kv_bits is None:
        ck, cv = (jnp.asarray(a, jnp.bfloat16) for a in kv)
        ckf = cvf = None
        tck, tcv = (torch.from_numpy(np.array(a.astype(jnp.float32))
                                     ).to(torch.bfloat16) for a in (ck, cv))
        tckf = tcvf = None
    else:
        (ck, ckf), (cv, cvf) = (jkv_quantize(jnp.asarray(a), kv_bits)
                                for a in kv)
        if kv_bits <= 4:
            ck, cv = jkv_pack(ck), jkv_pack(cv)
        tck, tcv, tckf, tcvf = (torch.from_numpy(np.array(a))
                                for a in (ck, cv, ckf, cvf))
    yj, _ = jwh.CrossAttention.decode(jp, jq, JQ(jnp.asarray(x), None), ck,
                                      cv, jnp.asarray(mem), jc, "eval",
                                      JAux.zero(), ckf=ckf, cvf=cvf)
    xp, xq = _xattn(tp, tc), _xattn(tq, tc)
    yt, _ = twh.CrossAttention.decode(xp, xq, QTensor(torch.from_numpy(x),
                                                      None), tck, tcv,
                                      torch.from_numpy(mem), tc, "eval",
                                      None, ckf=tckf, cvf=tcvf)
    _close(yt.q, yj.q, 1e-5, "decode")
    zero = HDense.apply(xp["wo"], xq["wo"], QTensor(torch.zeros(
        (1, S, H * hd)), None), mode="eval", aux=None)[0].q
    assert torch.equal(yt.q[2:], zero)
    assert not torch.equal(yt.q[1:2], zero)


# --------------------------------- encoder ----------------------------------

@pytest.mark.parametrize("offset", [0, 5])
def test_encode_matches_jax(offset):
    jc, tc, p, q, tp, tq = _trees()
    fr = _frames(jc, 6, seed=4)

    @jax.jit
    def jenc(p, q, fr):
        n, _ = jwh.WhisperModel.encode(p, q, fr, jc, "eval", JAux.zero(),
                                       offset=offset)
        return n.q

    want = jenc(p, q, jnp.asarray(fr))
    got, _ = WhisperModel.encode(tp, tq, torch.from_numpy(fr), tc, "eval",
                                 None, offset=offset)
    _close(got.q, want, 1e-5, f"encode at {offset}")
    at = WhisperModel.encode(tp, tq, torch.from_numpy(fr), tc, "eval", None,
                             offset=torch.tensor(offset, dtype=torch.int32))
    assert torch.equal(at[0].q, got.q)


# --------------------------------- forward ----------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_jax(mode):
    jc, tc, p, q, tp, tq = _trees()
    rng = np.random.default_rng(5)
    fr = _frames(jc, jc.enc_seq, seed=5, B=2)
    toks = rng.integers(0, jc.vocab, (2, 7))

    @jax.jit
    def jf(p, q, fr, toks):
        lg, nq, aux = jwh.WhisperModel.forward(
            p, q, {"frame_embeds": fr, "tokens": toks}, jc, mode=mode)
        return lg, nq, aux.as_tuple()

    lj, nqj, (ej, l1j) = jf(p, q, jnp.asarray(fr), jnp.asarray(toks))
    with torch.no_grad():
        lt, nqt, aux = WhisperModel.forward(
            tp, tq, {"frame_embeds": torch.from_numpy(fr),
                     "tokens": torch.from_numpy(toks)}, tc, mode=mode)
    _close(lt, lj, 1e-5, "logits")
    np.testing.assert_allclose(float(aux.ebops), float(ej), rtol=1e-6)
    assert float(aux.l1) == float(l1j)
    want, got = _flat(_xattn_kv_under_xattn(nqj)), _flat(nqt)
    assert want.keys() == got.keys() and want
    for k in want:
        _close(got[k], want[k], 1e-5, k)


# ------------------------------ caches, append ------------------------------

@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_init_cache_matches_jax(kv_bits):
    jc, tc, *_ = _trees()
    want = jwh.WhisperModel.init_cache(jc, 3, 24, kv_bits=kv_bits)
    got = WhisperModel.init_cache(tc, 3, 24, kv_bits=kv_bits, device="cpu")
    assert got._fields == want._fields == WhisperCaches._fields
    for name, a, b in zip(got._fields, got, want):
        if b is None:
            assert a is None, name
            continue
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), name
        assert not a.any(), name


def _append_both(kv_bits, B=1):
    """The memory after chunks 5, 5, 5, 1 of 16 frames on both sides."""
    jc, tc, p, q, tp, tq = _trees()
    fr = _frames(jc, jc.enc_seq, seed=6, B=B)
    jappend = jax.jit(functools.partial(jwh.WhisperModel.append_cross,
                                        cfg=jc, kv_bits=kv_bits))
    jc_ = jwh.WhisperModel.init_cache(jc, B, 24, kv_bits=kv_bits)
    tc_ = WhisperModel.init_cache(tc, B, 24, kv_bits=kv_bits, device="cpu")
    for a, b in ((0, 5), (5, 10), (10, 15), (15, 16)):
        jc_ = jappend(p, q, jc_, jnp.asarray(fr[:, a:b]))
        out = WhisperModel.append_cross(tp, tq, tc_, torch.from_numpy(
            fr[:, a:b]), tc, kv_bits=kv_bits)
        assert out is tc_
    return jc_, tc_


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_append_cross_matches_jax(kv_bits):
    jc, tc, *_ = _trees()
    want, got = _append_both(kv_bits, B=2)
    assert np.array_equal(got.mem_len.numpy(), np.asarray(want.mem_len))
    assert got.mem_len.tolist() == [[jc.enc_seq] * 2]
    if kv_bits is None:
        for a, b in ((got.cross_k, want.cross_k), (got.cross_v,
                                                   want.cross_v)):
            a = a.float().numpy()
            b = np.asarray(b.astype(jnp.float32))
            assert np.all(np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-30)
        return
    for a, b in ((got.cross_kf, want.cross_kf), (got.cross_vf,
                                                 want.cross_vf)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in ((got.cross_k, want.cross_k), (got.cross_v, want.cross_v)):
        a, b = a, torch.from_numpy(np.array(b))
        if kv_bits <= 4:
            a, b = kv_unpack_ref(a, jc.hd), kv_unpack_ref(b, jc.hd)
        assert int((a.int() - b.int()).abs().max()) <= 1


# --------------------------------- decode -----------------------------------

@pytest.mark.parametrize("kv_bits,quantizer", [(None, True), (8, True),
                                               (8, False)])
def test_decode_matches_jax(kv_bits, quantizer):
    """After the appended memory (2 rows, one filled to 16 frames and one
    to none: a row of LM traffic), a 3-token prompt and 10 ticks."""
    jc, tc, p, q, tp, tq = _trees()
    if not quantizer:
        p, tp = _without_act_quantizers(p), _without_act_quantizers(tp)
    fr = _frames(jc, jc.enc_seq, seed=7, B=2)
    jappend = jax.jit(functools.partial(jwh.WhisperModel.append_cross,
                                        cfg=jc, kv_bits=kv_bits))
    jstep = jax.jit(functools.partial(jwh.WhisperModel.decode_step, cfg=jc,
                                      kv_bits=kv_bits))
    jcache = jwh.WhisperModel.init_cache(jc, 2, 24, kv_bits=kv_bits)
    tcache = WhisperModel.init_cache(tc, 2, 24, kv_bits=kv_bits,
                                     device="cpu")
    for a, b in ((0, 8), (8, 16)):
        jcache = jappend(p, q, jcache, jnp.asarray(fr[:, a:b]))
        WhisperModel.append_cross(tp, tq, tcache, torch.from_numpy(
            fr[:, a:b]), tc, kv_bits=kv_bits)
    # row 1 is LM traffic: no memory
    jcache = jcache._replace(mem_len=jcache.mem_len.at[0, 1].set(0))
    tcache.mem_len[0, 1] = 0
    toks = np.random.default_rng(8).integers(0, jc.vocab, (2, 3))
    lj, jcache = jstep(p, q, jcache, jnp.asarray(toks), jnp.int32(0))
    lt, tcache = WhisperModel.decode_step(tp, tq, tcache,
                                          torch.from_numpy(toks), 0, tc,
                                          kv_bits=kv_bits)
    pos = 3
    for _ in range(10):
        assert np.array_equal(lt[:, -1].argmax(-1).numpy(),
                              np.asarray(lj[:, -1]).argmax(-1))
        if not quantizer:
            _close(lt, lj, 1e-5, "logits")
        nxt = np.asarray(lj[:, -1:]).argmax(-1)
        lj, jcache = jstep(p, q, jcache, jnp.asarray(nxt),
                           jnp.asarray([pos, pos], jnp.int32))
        lt, tcache = WhisperModel.decode_step(
            tp, tq, tcache, torch.from_numpy(nxt), np.array([pos, pos]), tc,
            kv_bits=kv_bits)
        pos += 1


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_serving_views_give_the_same_bits(kv_bits):
    """``serving_views`` (per-layer views, every bias quantized once to its
    EVAL value) append and decode the bits of the stacked tree, packed."""
    jc, tc, p, q, tp, tq = _trees()
    pp, qq = pack_for_serving(tp, tq, None)
    vp, vq = (WhisperModel.serving_views(t, tc) for t in (pp, qq))
    assert "f" not in vp["dec_layers"][0]["mlp"]["fc1"]["bias"]
    fr = torch.from_numpy(_frames(jc, jc.enc_seq, seed=12, B=2))
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, jc.vocab, (2, 3)))
    out = []
    for a, b in ((pp, qq), (vp, vq)):
        c = WhisperModel.init_cache(tc, 2, 24, kv_bits=kv_bits, device="cpu")
        WhisperModel.append_cross(a, b, c, fr[:, :8], tc, kv_bits=kv_bits)
        lg, c = WhisperModel.decode_step(a, b, c, toks, 0, tc,
                                         kv_bits=kv_bits)
        lg2, c = WhisperModel.decode_step(a, b, c, toks[:, :1],
                                          np.array([3, 3]), tc,
                                          kv_bits=kv_bits)
        out.append((lg, lg2, c))
    (a1, a2, ca), (b1, b2, cb) = out
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(ca, cb))


# --------------------------------- packing ----------------------------------

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
    attn = [f"{s}/attn/{n}/kernel" for s in ("enc_layers", "dec_layers")
            for n in ("wq", "wk", "wv", "wo")]
    assert sorted(keys) == sorted(
        attn + [f"dec_layers/xattn/{n}/kernel" for n in ("wq", "wk", "wv",
                                                          "wo")]
        + [f"{s}/mlp/{n}/kernel" for s in ("enc_layers", "dec_layers")
           for n in ("fc1", "fc2")] + ["embed/table"])
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


# -------------------------------- registry ----------------------------------

def test_model_for_audio():
    cfg = tconfigs.get(ARCH)
    assert model_for(cfg) is WhisperModel
    assert model_for(tconfigs.get(ARCH, smoke=True)) is WhisperModel
    assert (cfg.n_layers, cfg.enc_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv, cfg.hd, cfg.d_ff, cfg.vocab, cfg.enc_seq) == \
        (32, 32, 1280, 20, 20, 64, 5120, 51866, 1500)
