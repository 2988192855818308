"""Port parity: the MoE family (``nn/moe.py`` inside ``TransformerLM``)
and the VLM backbone of ``repro_torch`` against the JAX package, on trees
carried across with ``weights.from_jax`` from one seeded JAX init; inputs
are made with numpy.  The JAX side's packed ``qmatmul`` runs in interpret
mode, as in ``tests/test_torch_lm.py``.

Three MoE configs: granite-moe-3b-a800m SMOKE (E 5, top-2), moonshot
SMOKE (E 8, top-2), and a narrow granite that keeps the full model's 40
experts, top-8 and head dim 64 (2 layers, d 384, 6 heads over 2 kv heads,
d_ff 64, vocab 512): its capacity at a 16-token chunk is the full
model's (C = 4) and so are its drops.

Tolerances:
- Configs: every field equal, for all ten archs, FULL and SMOKE.
- ``MoE.apply`` in EVAL at S = 1 and 16: the chosen experts equal at
  every position, the dropped pairs equal (S = 16 drops at least one),
  the output within 1e-5 of the reference's largest entry (XLA's and
  PyTorch's float32 matmuls and softmax differ in the last ulps).
- The combine: on inputs where every product is exact and the order of a
  token's additions decides the result (1 + 2^-24 + 2^-24 is 1 one way
  and 1 + 2^-23 the other), the port's output equals JAX's bit for bit.
- Packing: bit-exact, uniform int8 and with the experts at 4 bits.
- Decode logits of a prefill chunk and two ticks (fp cache, packed
  int8, packed with the experts in nibbles, 8- and 4-bit rings), without
  the attention output quantizer: 1e-4 (read: the same bits).  As
  served, that quantizer's rounding ties (``test_torch_lm.py``'s
  ``_check_fp_cache``) show on the quantized ring too at these shapes,
  MoE or not (``test_decode_logits_match_jax``).
- ``Engine`` greedy tokens on the narrow granite (packed, ``kv_bits``
  8, no attention output quantizer): equal to the JAX ``Engine``'s token
  for token.
- Routing stability (the counterpart of
  ``tests/test_decode_consistency.py``'s MoE test, moonshot SMOKE): the
  EVAL ``forward`` against token-by-token decode, top-1 agreement above
  0.6 and the median error below 5e-2, the reference's thresholds.
- The VLM EVAL forward (pixtral-12b SMOKE), with and without
  ``patch_embeds``: logits within 1e-4.
"""
import dataclasses
import functools
import math
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
    from repro.core import plan as jplan
    from repro.core.plan import LayerPlan as JLayerPlan
    from repro.core.plan import PrecisionPlan as JPlan
    from repro.dist.perf import packed_matmul
    from repro.models import model_for as jmodel_for
    from repro.models.lm import _moe_cfg as j_moe_cfg
    from repro.nn import moe as jmoe
    from repro.nn.basic import HDense as JHDense
    from repro.nn.common import HGQConfig as JHGQConfig
    from repro.serving import Engine as JEngine
    from repro.serving import Request as JRequest
    from repro.serving.packed import pack_tree as jpack_tree

from repro_torch import configs as tconfigs
from repro_torch.core import hgq
from repro_torch.core import plan as tplan
from repro_torch.core.hgq import QTensor
from repro_torch.core.plan import LayerPlan, PrecisionPlan
from repro_torch.models import (GriffinLM, RWKVLM, TransformerLM,
                                WhisperModel, model_for)
from repro_torch.models.lm import _moe_cfg
from repro_torch.nn import moe as tmoe
from repro_torch.nn.common import HGQConfig
from repro_torch.serving import Engine, Request
from repro_torch.serving.packed import pack_for_serving, pack_tree
from repro_torch.tree import tree_map
from repro_torch.weights import from_jax


NARROW = dict(name="granite-narrow-e40", n_layers=2, d_model=384, n_heads=6,
              n_kv=2, d_ff=64, vocab=512)
CONFIGS = {"granite": ("granite-moe-3b-a800m", {}),
           "moonshot": ("moonshot-v1-16b-a3b", {}),
           "narrow": ("granite-moe-3b-a800m", NARROW)}
EXPERTS = ("layers/moe/gate", "layers/moe/up", "layers/moe/down")

_TREES = {}


def _configs(which):
    arch, over = CONFIGS[which]
    return (dataclasses.replace(jconfigs.get(arch, smoke=True), **over),
            dataclasses.replace(tconfigs.get(arch, smoke=True), **over))


def _trees(which):
    """(JAX cfg, port cfg, JAX params, JAX qstate, port params, port
    qstate), one seeded JAX init per config."""
    if which not in _TREES:
        jc, tc = _configs(which)
        p, q = _jax_init(jc, jax.random.PRNGKey(0))
        tp, tq = from_jax(jax.tree.map(np.asarray, p),
                          jax.tree.map(np.asarray, q), device="cpu")
        _TREES[which] = (jc, tc, p, q, tp, tq)
    return _TREES[which]


def _jax_init(jc, key):
    """The JAX package's seeded init, jitted (the same values, one
    compile instead of one per operation)."""
    return jax.jit(functools.partial(jmodel_for(jc).init, cfg=jc))(key)


def _jpack_tree(p, plan):
    return jax.jit(functools.partial(jpack_tree, plan=plan))(p)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _plans(use_plan):
    """(JAX plan, port plan): the experts at 4 bits, the rest int8."""
    if not use_plan:
        return None, None
    return (JPlan(layers={k: JLayerPlan(wire_bits=4, pack_bits=4)
                          for k in EXPERTS}),
            PrecisionPlan(layers={k: LayerPlan(wire_bits=4, pack_bits=4)
                                  for k in EXPERTS}))


# ---------------------------------- configs ---------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch, smoke):
    j, t = jconfigs.get(arch, smoke=smoke), tconfigs.get(arch, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()


def test_registry_and_model_for():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()
    assert all(dataclasses.asdict(tconfigs.SHAPES[k])
               == dataclasses.asdict(jconfigs.SHAPES[k])
               for k in tconfigs.SHAPES)
    assert tconfigs.cells() == jconfigs.cells()
    for arch in ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
                 "pixtral-12b", "qwen2-0.5b", "llama3.2-3b"):
        assert model_for(tconfigs.get(arch)) is TransformerLM
    assert model_for(tconfigs.get("recurrentgemma-2b")) is GriffinLM
    assert model_for(tconfigs.get("rwkv6-1.6b")) is RWKVLM
    assert model_for(tconfigs.get("whisper-large-v3")) is WhisperModel


# --------------------------------- MoE.apply --------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@functools.partial(jax.jit, static_argnames="cfg")
def _jax_routing(p, x, cfg):
    """The reference's first lines: (gates, expert ids) of ``MoE.apply``."""
    logits, _ = JHDense.apply(p["router"], {}, JQ(x, None), mode="eval",
                              aux=JAux.zero())
    probs = jax.nn.softmax(logits.q.astype(jnp.float32), axis=-1)
    gates, eidx = jax.lax.top_k(probs, cfg.top_k)
    return gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9), eidx


def _jax_dropped(eidx, cfg, S):
    """The reference's per-row dispatch in numpy: [B, S, k] True where a
    pair is past its expert's capacity."""
    E, k = cfg.n_experts, cfg.top_k
    C = max(1, math.ceil(S * k / E * cfg.capacity_factor))
    out = []
    for er in np.asarray(eidx):
        e_flat = er.reshape(-1)
        order = np.argsort(e_flat, kind="stable")
        counts = np.bincount(e_flat, minlength=E)
        starts = np.cumsum(counts) - counts
        pos = np.empty_like(order)
        pos[order] = np.arange(S * k) - starts[e_flat[order]]
        out.append((pos >= C).reshape(S, k))
    return np.stack(out)


@functools.partial(jax.jit, static_argnames=("cfg", "mode"))
def _jax_moe(p, q, x, bits, cfg, mode):
    """The reference's ``MoE.apply``, jitted: (output, ~EBOPs)."""
    aux = JAux.zero()
    y, _ = jmoe.MoE.apply(p, q, JQ(x, bits), cfg=cfg, mode=mode, aux=aux)
    return y.q, aux.ebops


@pytest.mark.parametrize("S", [1, 16])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_moe_apply_matches_jax(which, S):
    jc, tc, p, q, tp, tq = _trees(which)
    jm, tm = j_moe_cfg(jc), _moe_cfg(tc)
    lp, lq = _layer0(p["layers"]["moe"]), _layer0(q["layers"]["moe"])
    tlp = tree_map(lambda a: a[0], tp["layers"]["moe"])
    tlq = tree_map(lambda a: a[0], tq["layers"]["moe"])
    x = np.random.default_rng(S).standard_normal((2, S, jc.d_model))
    x = x.astype(np.float32)
    gj, ej = _jax_routing(lp, jnp.asarray(x), jm)
    logits, _ = tmoe.HDense.apply(tlp["router"], {},
                                  QTensor(torch.from_numpy(x), None),
                                  mode=hgq.EVAL, aux=None)
    gt, et = tmoe.route(logits.q, tm.top_k)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-6)
    dsp = tmoe.dispatch(et, tm.n_experts, tmoe.capacity(S, tm))
    dropped = _jax_dropped(ej, jm, S)
    np.testing.assert_array_equal(~dsp.valid.numpy(), dropped)
    if S == 16:
        assert dropped.any(), "the S = 16 input drops no pair"
    yj = np.asarray(_jax_moe(lp, lq, jnp.asarray(x), None, jm, "eval")[0])
    yt, _ = tmoe.MoE.apply(tlp, tlq, QTensor(torch.from_numpy(x), None),
                           cfg=tm, mode=hgq.EVAL, aux=None)
    assert yt.q.shape == yj.shape
    np.testing.assert_allclose(yt.q.numpy(), yj, rtol=0,
                               atol=1e-5 * np.abs(yj).max())


def test_moe_ebops_match_jax():
    """~EBOPs of one MoE block in TRAIN (active compute, k/E of each
    expert's multipliers) on the narrow granite: relative 1e-6."""
    jc, tc, p, q, tp, tq = _trees("narrow")
    lp, lq = _layer0(p["layers"]["moe"]), _layer0(q["layers"]["moe"])
    tlp = tree_map(lambda a: a[0], tp["layers"]["moe"])
    tlq = tree_map(lambda a: a[0], tq["layers"]["moe"])
    x = np.random.default_rng(5).standard_normal((2, 16, jc.d_model))
    x = (np.floor(x * 64 + 0.5) / 64).astype(np.float32)
    bits = np.float32(7.0)
    ej = float(_jax_moe(lp, lq, jnp.asarray(x), jnp.asarray(bits),
                        j_moe_cfg(jc), "train")[1])
    at = hgq.Aux.zero()
    tmoe.MoE.apply(tlp, tlq, QTensor(torch.from_numpy(x),
                                     torch.tensor(bits)),
                   cfg=_moe_cfg(tc), mode=hgq.TRAIN, aux=at)
    assert ej > 0
    assert abs(float(at.ebops) - ej) <= 1e-6 * ej


def _order_case():
    """A 4-of-8 MoE whose every product is exact and whose tokens' sums
    depend on their order: router zeros (every probability 1/8, experts
    0-3 by the lower-index-first rule, gates 1/4 exactly), linear
    experts, x = 1, expert e's output 4, 2^-22, 2^-22, 0 (e = 0..3) in
    every column, so a token gets 1 + 2^-24 + 2^-24 + 0."""
    cfg = dict(d_model=8, d_ff=4, n_experts=8, top_k=4, act="linear")
    down = np.zeros((8, 4, 8), np.float32)
    down[0, 0], down[1, 0], down[2, 0] = 4.0, 2.0 ** -22, 2.0 ** -22
    gate = np.zeros((8, 8, 4), np.float32)
    gate[:, 0, :] = 1.0
    p = {"router": {"kernel": {"w": np.zeros((8, 8), np.float32)}},
         "gate": {"w": gate}, "up": {"w": gate.copy()},
         "down": {"w": down}}
    x = np.ones((2, 3, 8), np.float32)
    return cfg, p, x


def test_combine_order_is_jax_bit_for_bit():
    cfg, p, x = _order_case()
    jm = jmoe.MoEConfig(**cfg)
    yj, _ = jmoe.MoE.apply(jax.tree.map(jnp.asarray, p), {"router": {}},
                           JQ(jnp.asarray(x), None), cfg=jm, mode="eval",
                           aux=JAux.zero())
    tp = tree_map(torch.from_numpy, p)
    yt, _ = tmoe.MoE.apply(tp, {"router": {}},
                           QTensor(torch.from_numpy(x), None),
                           cfg=tmoe.MoEConfig(**cfg), mode=hgq.EVAL,
                           aux=None)
    yj = np.asarray(yj.q)
    np.testing.assert_array_equal(yt.q.numpy(), yj)
    # the order decides: ascending experts give 1, the reverse 1 + 2^-23
    one, tiny = np.float32(1.0), np.float32(2.0 ** -24)
    assert yj[0, 0, 0] == (one + tiny) + tiny == np.float32(1.0)
    assert (tiny + tiny) + one == np.float32(1.0 + 2.0 ** -23)


def test_moe_config_disabled_quantizers_match():
    """Both packages build the same tree shapes with and without HGQ."""
    for enabled in (True, False):
        jq = JHGQConfig(weight_gran="per_channel", enabled=enabled)
        tq = HGQConfig(weight_gran="per_channel", enabled=enabled)
        jm = jmoe.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2)
        jp, _ = jax.jit(functools.partial(jmoe.MoE.init, cfg=jm, qcfg=jq))(
            jax.random.PRNGKey(0))
        tp, _ = tmoe.MoE.init(torch.Generator().manual_seed(0),
                              tmoe.MoEConfig(**dataclasses.asdict(jm)), tq,
                              device="cpu")
        jf, tf = _flat(jp), _flat(tp)
        assert jf.keys() == tf.keys()
        assert all(jf[k].shape == tf[k].shape for k in jf)


# ---------------------------------- packing ---------------------------------

@pytest.mark.parametrize("use_plan", [False, True])
@pytest.mark.parametrize("which", ["granite", "narrow"])
def test_pack_tree_bit_exact(which, use_plan):
    jc, tc, p, q, tp, tq = _trees(which)
    jplan, plan = _plans(use_plan)
    jf, tf = _flat(_jpack_tree(p, jplan)), _flat(pack_tree(tp, plan))
    assert jf.keys() == tf.keys()
    for k in jf:
        assert jf[k].dtype == tf[k].dtype, k
        np.testing.assert_array_equal(jf[k], tf[k], err_msg=k)
    nib = {k for k in tf if k.endswith("w_nib")}
    assert nib == ({f"/{e}/w_nib" for e in EXPERTS} if use_plan else set())


@pytest.mark.parametrize("which", ["granite", "narrow"])
def test_plans_over_expert_stacks_match_jax(which):
    """``iter_packable``, ``plan_from_params`` and ``mixed_low_plan`` on
    the ``[L, E, K, N]`` expert stacks (``f`` ``[L, E, 1, N]``): the same
    keys and the same plans as the JAX package's."""
    jc, tc, p, q, tp, tq = _trees(which)
    keys = [k for k, _ in tplan.iter_packable(tp)]
    assert keys == [k for k, _ in jplan.iter_packable(p)]
    assert set(EXPERTS) <= set(keys)
    assert tplan.plan_from_params(tp).to_dict() == \
        jplan.plan_from_params(p).to_dict()
    assert tplan.mixed_low_plan(tp).to_dict() == \
        jplan.mixed_low_plan(p).to_dict()


# ------------------------------- decode logits ------------------------------

MODES = {            # name: (packed, experts at 4 bits, kv_bits)
    "fp": (False, False, None),
    "packed_int8": (True, False, None),
    "packed_plan": (True, True, None),
    "kv8": (False, False, 8),
    "kv4": (False, False, 4),
}
# every mode on the narrow granite, the 8-bit ring on the two SMOKE configs
DECODE_CASES = [("narrow", m) for m in MODES] + [("granite", "kv8"),
                                                 ("moonshot", "kv8")]


def _without_attnout_quantizer(p):
    """The tree with every layer's attention output quantizer removed
    (both packages skip it when ``attnout_f`` is absent)."""
    attn = {k: v for k, v in p["layers"]["attn"].items() if k != "attnout_f"}
    return {**p, "layers": {**p["layers"], "attn": attn}}


def _decode_logits(which, mode):
    """(port, JAX) logits of a prefill chunk and two decode ticks, without
    the attention output quantizer."""
    packed, use_plan, kv_bits = MODES[mode]
    jc, tc, p, q, tp, tq = _trees(which)
    p, tp = _without_attnout_quantizer(p), _without_attnout_quantizer(tp)
    jplan, plan = _plans(use_plan)
    if packed:
        p = _jpack_tree(p, jplan)
        tp, tq = pack_for_serving(tp, tq, plan)
    B, S, W = 2, 5, 16
    rng = np.random.default_rng(3)
    steps = [(rng.integers(0, jc.vocab, (B, S)), np.array([0, 0])),
             (rng.integers(0, jc.vocab, (B, 1)), np.array([S, S])),
             (rng.integers(0, jc.vocab, (B, 1)), np.array([S + 1, S + 1]))]
    M = jmodel_for(jc)
    jstep = jax.jit(M.decode_step, static_argnames=("cfg", "kv_bits"))
    jcache = M.init_cache(jc, B, W, kv_bits=kv_bits)
    tcache = TransformerLM.init_cache(tc, B, W, kv_bits=kv_bits,
                                      device="cpu")
    out = []
    for tok, pos in steps:
        with packed_matmul(packed):
            lj, jcache = jstep(p, q, jcache, jnp.asarray(tok),
                               jnp.asarray(pos, jnp.int32), cfg=jc,
                               kv_bits=kv_bits)
        lt, tcache = TransformerLM.decode_step(tp, tq, tcache,
                                               torch.from_numpy(tok), pos,
                                               tc, kv_bits=kv_bits)
        out.append((lt.numpy(), np.asarray(lj)))
    return out


@pytest.mark.parametrize("which,mode", DECODE_CASES)
def test_decode_logits_match_jax(which, mode):
    """Without the attention output quantizer: 1e-4 in every mode (read:
    0.0, the same bits).  As served, that quantizer sits on rounding ties
    (``test_torch_lm._check_fp_cache``) on the quantized ring too at these
    shapes: the 8-bit ring reads up to 0.06 apart (rel L2 1e-2), and so
    does a dense model of granite SMOKE's attention shape (hd 12), whose
    logits agree to the bit once either the output quantizer or the
    probabilities' grid is taken out."""
    for lt, lj in _decode_logits(which, mode):
        assert lt.shape == lj.shape
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)


# ---------------------------------- Engine ----------------------------------

def test_engine_tokens_match_jax():
    """Six ragged requests through 3 slots, chunks of 4 (a 16-token
    prompt is four chunks; whole chunks only, so that the JAX engine
    compiles one prefill shape), packed int8 weights and an 8-bit ring,
    both
    engines without the attention output quantizer (whose ties decide
    request 0's first token differently as served, above)."""
    jc, tc, p, q, tp, tq = _trees("narrow")
    p, tp = _without_attnout_quantizer(p), _without_attnout_quantizer(tp)
    rng = np.random.default_rng(1)
    lens, news = [16, 4, 8, 12, 4, 8], [4, 6, 3, 5, 2, 4]
    prompts = [[int(t) for t in rng.integers(0, jc.vocab, n)] for n in lens]
    kw = dict(batch_slots=3, max_len=32, packed=True, prefill_chunk=4,
              kv_bits=8)
    jreqs = [JRequest(prompt=list(pr), max_new=n)
             for pr, n in zip(prompts, news)]
    JEngine(jmodel_for(jc), p, q, jc, **kw).run(jreqs)
    treqs = [Request(prompt=list(pr), max_new=n)
             for pr, n in zip(prompts, news)]
    Engine(TransformerLM, tp, tq, tc, device="cpu", **kw).run(treqs)
    assert all(r.done and len(r.out) == n for r, n in zip(treqs, news))
    assert [r.out for r in treqs] == [list(r.out) for r in jreqs]


# ----------------------------- routing stability ----------------------------

def test_moe_decode_routing_stability():
    """The port's EVAL ``forward`` against its token-by-token decode on
    moonshot SMOKE, with ``test_decode_consistency.py``'s init key,
    tokens and thresholds: logits match except where top-k routing flips
    on near-ties (or the forward's 12-token capacity drops a pair that a
    one-token step keeps)."""
    jc, tc = _configs("moonshot")
    key = jax.random.PRNGKey(3)
    p, q = _jax_init(jc, key)
    tp, tq = from_jax(jax.tree.map(np.asarray, p),
                      jax.tree.map(np.asarray, q), device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(np.asarray(
        jax.random.randint(key, (B, S), 0, tc.vocab)).astype(np.int64))
    with torch.no_grad():
        full, _, _ = TransformerLM.forward(tp, tq, {"tokens": toks}, tc,
                                           mode=hgq.EVAL)
        cache = TransformerLM.init_cache(tc, B, S + 4, device="cpu")
        got = []
        for t in range(S):
            lg, cache = TransformerLM.decode_step(tp, tq, cache,
                                                  toks[:, t:t + 1], t, tc,
                                                  mode=hgq.EVAL)
            got.append(lg[:, 0])
    got, full = torch.stack(got, dim=1).numpy(), full.numpy()
    agree = np.mean(np.argmax(got, -1) == np.argmax(full, -1))
    assert agree > 0.6, f"top-1 agreement {agree}"
    med = np.median(np.abs(got - full))
    assert med < 5e-2, f"median err {med}"


# ------------------------------------ VLM -----------------------------------

@pytest.mark.parametrize("patches", [False, True])
def test_vlm_forward_matches_jax(patches):
    """pixtral-12b SMOKE, EVAL forward over 12 tokens, the first
    ``n_patches`` (8) positions overwritten by ``patch_embeds``."""
    jc, tc = jconfigs.get("pixtral-12b", True), tconfigs.get("pixtral-12b",
                                                             True)
    p, q = _jax_init(jc, jax.random.PRNGKey(0))
    tp, tq = from_jax(jax.tree.map(np.asarray, p),
                      jax.tree.map(np.asarray, q), device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jc.vocab, (2, 12))
    batch = {"tokens": toks}
    if patches:
        batch["patch_embeds"] = rng.standard_normal(
            (2, jc.n_patches, jc.d_model)).astype(np.float32)
    fwd = jax.jit(lambda p, q, b: jmodel_for(jc).forward(p, q, b, jc,
                                                         mode="eval")[0])
    lj = fwd(p, q, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        lt, _, _ = TransformerLM.forward(
            tp, tq, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
            mode=hgq.EVAL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-4)
    if patches:
        plain, _, _ = TransformerLM.forward(
            tp, tq, {"tokens": torch.from_numpy(toks)}, tc, mode=hgq.EVAL)
        assert not torch.equal(plain[:, :jc.n_patches],
                               lt[:, :jc.n_patches])
