"""Port parity: the dense LM decode path of ``repro_torch`` against the JAX
package, on trees carried across with ``repro_torch.weights.from_jax``.

Two configs: qwen2-0.5b SMOKE (head dim 4) and a narrow qwen2 with the
full model's head dim of 64 (2 layers, d_model 128, 2 heads, 1 kv head,
vocab 512).  Logits of a prefill chunk and of two decode ticks agree
within 1e-4 on the quantized KV cache (int8 and 4-bit, plain or packed
with the mixed w4/w8 example plan); on the fp cache (fp, packed uniform
int8, packed plan) within the tie bound of ``_check_fp_cache``, and
within 1e-4 once the attention output quantizer is taken out on both
sides.  The packed tree is bit-exact."""
import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.nn imports repro.dist lazily)
    from repro.configs import get as jget
    from repro.core.plan import PrecisionPlan as JPlan
    from repro.dist.perf import packed_matmul
    from repro.models import model_for
    from repro.serving.packed import pack_for_serving as jpack
    from repro.serving.packed import pack_tree as jpack_tree

from repro_torch.configs import get as tget
from repro_torch.core.plan import PrecisionPlan
from repro_torch.models import TransformerLM
from repro_torch.serving.packed import pack_for_serving, pack_tree
from repro_torch.weights import from_jax

PLAN_FILE = Path(__file__).resolve().parents[1] / "examples" / "specs" / \
    "plan_mixed_w4w8.json"
NARROW = dict(name="qwen2-narrow-hd64", n_layers=2, d_model=128, n_heads=2,
              n_kv=1, d_ff=256, vocab=512)

MODES = {            # name: (packed, use the example plan, kv_bits)
    "fp": (False, False, None),
    "packed_int8": (True, False, None),
    "packed_plan": (True, True, None),
    "kv8": (False, False, 8),
    "kv4": (False, False, 4),
    "packed_plan_kv4": (True, True, 4),
}


def _configs(which):
    jc, tc = jget("qwen2-0.5b", smoke=True), tget("qwen2-0.5b", smoke=True)
    if which == "narrow":
        jc, tc = dataclasses.replace(jc, **NARROW), \
            dataclasses.replace(tc, **NARROW)
    return jc, tc


_TREES = {}


def _trees(which):
    """(JAX cfg, port cfg, JAX params, JAX qstate, port params, port
    qstate), one seeded JAX init per config."""
    if which not in _TREES:
        jc, tc = _configs(which)
        p, q = model_for(jc).init(jax.random.PRNGKey(0), jc)
        tp, tq = from_jax(jax.tree.map(np.asarray, p),
                          jax.tree.map(np.asarray, q), device="cpu")
        _TREES[which] = (jc, tc, p, q, tp, tq)
    return _TREES[which]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree)}


def test_from_jax_keeps_keys_and_values():
    jc, tc, p, q, tp, tq = _trees("smoke")
    jf, tf = _flat(p), _flat({k: v for k, v in tp.items()})
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_array_equal(jf[k], tf[k], err_msg=k)
    assert _flat(q).keys() == _flat(tq).keys()
    assert type(tq["layers"]["ln1"]["out"]).__name__ == "ActState"


@pytest.mark.parametrize("which", ["smoke", "narrow"])
@pytest.mark.parametrize("use_plan", [False, True])
def test_pack_tree_bit_exact(which, use_plan):
    jc, tc, p, q, tp, tq = _trees(which)
    jplan = JPlan.from_file(str(PLAN_FILE)) if use_plan else None
    plan = PrecisionPlan.from_file(str(PLAN_FILE)) if use_plan else None
    jf, tf = _flat(jpack_tree(p, jplan)), _flat(pack_tree(tp, plan))
    assert jf.keys() == tf.keys()
    for k in jf:
        assert jf[k].dtype == tf[k].dtype, k
        np.testing.assert_array_equal(jf[k], tf[k], err_msg=k)
    if use_plan:
        assert any(k.endswith("w_nib") for k in tf)


def _without_attnout_quantizer(p):
    """The tree with every layer's attention output quantizer removed
    (both packages skip it when ``attnout_f`` is absent)."""
    attn = {k: v for k, v in p["layers"]["attn"].items() if k != "attnout_f"}
    return {**p, "layers": {**p["layers"], "attn": attn}}


def _decode_logits(which, mode, drop_attnout=False):
    """(port, JAX) logits of a prefill chunk and two decode ticks."""
    packed, use_plan, kv_bits = MODES[mode]
    jc, tc, p, q, tp, tq = _trees(which)
    if drop_attnout:
        p, tp = _without_attnout_quantizer(p), _without_attnout_quantizer(tp)
    jplan = JPlan.from_file(str(PLAN_FILE)) if use_plan else None
    plan = PrecisionPlan.from_file(str(PLAN_FILE)) if use_plan else None
    if packed:
        p, q = jpack(p, q, jplan)
        tp, tq = pack_for_serving(tp, tq, plan)
    B, S, W = 2, 5, 16
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab, (B, S))
    steps = [(toks, np.array([0, 0])),
             (rng.integers(0, jc.vocab, (B, 1)), np.array([S, S])),
             (rng.integers(0, jc.vocab, (B, 1)), np.array([S + 1, S + 1]))]
    M = model_for(jc)
    jcache = M.init_cache(jc, B, W, kv_bits=kv_bits)
    tcache = TransformerLM.init_cache(tc, B, W, kv_bits=kv_bits,
                                      device="cpu")
    out = []
    for tok, pos in steps:
        with packed_matmul(packed):
            lj, jcache = M.decode_step(p, q, jcache, jnp.asarray(tok),
                                       jnp.asarray(pos, jnp.int32), jc,
                                       kv_bits=kv_bits)
        lt, tcache = TransformerLM.decode_step(tp, tq, tcache,
                                               torch.from_numpy(tok), pos,
                                               tc, kv_bits=kv_bits)
        out.append((lt.numpy(), np.asarray(lj)))
    return out


@pytest.mark.parametrize("which", ["smoke", "narrow"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_logits_match_jax(which, mode):
    for lt, lj in _decode_logits(which, mode):
        assert lt.shape == lj.shape
        if MODES[mode][2] is not None:
            np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
        else:
            _check_fp_cache(lt, lj)


FP_CACHE_MODES = [m for m, (_, _, kv_bits) in MODES.items() if kv_bits is None]


@pytest.mark.parametrize("which", ["smoke", "narrow"])
@pytest.mark.parametrize("mode", FP_CACHE_MODES)
def test_fp_cache_logits_match_jax_without_attnout_quantizer(which, mode):
    """The fp-cache gap of ``_check_fp_cache`` is the attention output
    quantizer's alone: without it these modes agree within 1e-4."""
    for lt, lj in _decode_logits(which, mode, drop_attnout=True):
        assert lt.shape == lj.shape
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)


def _check_fp_cache(lt, lj):
    """The fp (bf16) cache path.  Its attention output quantizer sees
    averages of values that sit on its own 2^-6 grid, so many inputs lie
    exactly on a rounding tie, and the last ulp of a float sum, which
    XLA and PyTorch order differently, decides each tie.  A decided tie
    moves that position's logits by a few thousandths: the step's logits
    stay within 2e-2 of the reference and within 3e-2 relative (L2).
    Without that quantizer the same modes hold 1e-4
    (``test_fp_cache_logits_match_jax_without_attnout_quantizer``)."""
    assert np.abs(lt - lj).max() <= 2e-2
    assert np.linalg.norm(lt - lj) <= 3e-2 * np.linalg.norm(lj)


def test_init_module_holds_tree():
    """``TransformerLM`` is an ``nn.Module`` over the tree; its seeded
    init draws LeCun-uniform kernels and a U(+-0.02) embedding."""
    _, tc = _configs("narrow")
    g = torch.Generator().manual_seed(0)
    p, q = TransformerLM.init(g, tc, device="cpu")
    m = TransformerLM(tc, p, q)
    assert sum(1 for _ in m.buffers()) == len(_flat(p)) + len(_flat(q))
    w = p["layers"]["mlp"]["gate"]["kernel"]["w"]
    assert w.shape == (2, 128, 256)
    assert float(w.abs().max()) <= (3.0 / 128) ** 0.5
    assert float(p["embed"]["table"]["w"].abs().max()) <= 0.02
    cache = TransformerLM.init_cache(tc, 1, 8, device="cpu")
    logits, _ = m(torch.tensor([[1, 2, 3]]), cache, 0)
    assert logits.shape == (1, 3, 512) and bool(torch.isfinite(logits).all())
