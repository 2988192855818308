"""Port parity: HGQ training and the no-cache (prefill) forward of the
dense LM in ``repro_torch`` against the JAX package, at qwen2-0.5b SMOKE
(2 layers, d 56, 14 heads of 4, 2 kv heads, vocab 256, ``q_chunk =
k_chunk = 32``), on trees carried across with ``weights.from_jax``.

The JAX side runs with both of its TRAIN quantizer entries swapped for
its kernel op ``repro.kernels.hgq_quantize`` (monkeypatched in the test;
nothing on disk changes): ``repro.core.hgq.quantize`` (weights and
activations) and ``repro.nn.attention.quantize`` (the attention
probabilities, imported there by name).  Both land on Eq. 4's exact
grid, as the port does.  Inputs are made with numpy (or the JAX
package's own generator) and handed to both sides.  S = 80 is ragged
against the chunks (3 query chunks, the last padded) and multi-chunk.

Tolerances:
- ``_chunked_attention``, EVAL and TRAIN: output within 1e-5, gradients
  in q, k, v and ``probs_f`` within 1e-5 of each one's largest entry
  (read: 8.3e-7 and 1e-6).  XLA's and PyTorch's float32 ``exp`` and sums
  differ in the last ulps; no probability crosses a grid rounding point
  at these inputs.
- ``TransformerLM.forward`` in TRAIN: logits bit for bit (products and
  sums of grid values are exact in float32); ~EBOPs and L1 relative
  1e-6; range states relative 1e-6 (read: 1.3e-7, the ulps of ``rsqrt``
  and ``exp``).
- One ``make_train_step`` step: loss, total and ~EBOPs relative 1e-6,
  gradient norm 1e-5; the step's gradients (AdamW's first moment, 0.1 of
  the clipped gradient) within 1e-3 of each leaf's largest entry (read:
  5.1e-4 at most, ``attnout_f``: the sum of ``g * ln2 * (x - xq)`` over
  the attention output, whose ulps the quantization residual magnifies;
  weights 2.3e-5).  The same backward without ``ln2 * delta`` is off by
  1e-2 or more in every f (read 2.7e-2 where the ~EBOPs term dominates
  an f's gradient, up to 1.0).
- The 10-step trajectory: loss and ~EBOPs relative 1e-3 at every step
  (read: 3.0e-4 and 2.2e-4 at most, both 0 at step 0 and below 5e-6 in
  the first 5 steps).  A weight an ulp of a gradient moves across its
  2^-6 rounding point flips a grid step (AdamW's first steps move every
  weight by about +-lr whatever the gradient's size), and the two
  trajectories part from step 3 on; JAX's own surrogate quantizer, an
  ulp off the grid, parts from the kernel op's as far (5.9e-4 in loss).
- ``remat`` on and off: the same bits.
- Prefill against decode (the port's counterpart of
  ``tests/test_decode_consistency.py``): on a float32 cache, S within one
  chunk and no attention output quantizer, logits within 1e-5 and greedy
  tokens equal (the same function, unwindowed and windowed past its
  window); on the default bf16 cache
  and the 8-bit quantized ring the reference test's limits (rtol = atol
  = 0.1) and greedy agreement of at least 0.9 (read 0.93-1.0: with
  random weights the logits sit on a 2^-12 grid, top-two ties are
  common, and a bf16 or int8 rounding of k and v moves a few by a grid
  step).
- The int8 fp cache against JAX's: the bound of ``test_torch_lm.py``'s
  ``_check_fp_cache`` (the attention output quantizer's rounding ties),
  and 1e-4 without that quantizer.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.train imports repro.dist)
    import repro.core.hgq as jhgq
    import repro.nn.attention as jattn
    from repro.configs import get as jget
    from repro.core.ebops import useful_model_flops_dense as j_flops
    from repro.data import lm_batch as j_lm_batch
    from repro.dist import perf as jperf
    from repro.kernels import hgq_quantize as j_hgq_quantize
    from repro.models import model_for
    from repro import optim as joptim
    from repro.train import losses as jlosses
    from repro.train import loop as jloop

import repro_torch.kernels.hgq_quantize.ops as hops
from repro_torch import optim as toptim
from repro_torch.configs import get as tget
from repro_torch.core import hgq
from repro_torch.core.ebops import useful_model_flops_dense
from repro_torch.data import DataSpec, lm_batch, make_pipeline
from repro_torch.dist import perf as tperf
from repro_torch.models import TransformerLM
from repro_torch.nn import attention as tattn
from repro_torch.train import TrainConfig, lm_loss, make_train_step
from repro_torch.tree import tree_flatten_with_path
from repro_torch.weights import from_jax

B, S = 2, 80
# the launcher's optimizer settings (src/repro/api/spec.py), 10 steps
TCFG = dict(steps=10, lr=1e-3, beta0=1e-9, beta1=1e-7)
GRAD_LIMIT = 1e-3
TRAJ_LIMIT = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {"/".join(p): v.detach().numpy()
            for p, v in tree_flatten_with_path(tree)}


def _kernel_op(x, f):
    """The JAX kernel op, a per-channel f of shape (1, ..., 1, N) handed
    over as (N,), the shape its backward reduces to."""
    if 1 < f.ndim and f.shape != x.shape and set(f.shape[:-1]) == {1}:
        return j_hgq_quantize(x, f.reshape(-1))
    return j_hgq_quantize(x, f)


@pytest.fixture
def kernel_quantizer(monkeypatch):
    """Both JAX TRAIN quantizer entries swapped for the kernel op."""
    monkeypatch.setattr(jhgq, "quantize", _kernel_op)
    monkeypatch.setattr(jattn, "quantize", _kernel_op)


_TREES = {}


def _trees():
    """(JAX cfg, port cfg, JAX params, JAX qstate), one seeded JAX init."""
    if not _TREES:
        jc, tc = jget("qwen2-0.5b", smoke=True), tget("qwen2-0.5b",
                                                      smoke=True)
        p, q = model_for(jc).init(jax.random.PRNGKey(0), jc)
        _TREES["smoke"] = (jc, tc, p, q)
    return _TREES["smoke"]


def _port_trees(p, q):
    return from_jax(_np(p), _np(q), device="cpu")


def _tokens(step, batch=B, seq=S):
    jc = _trees()[0]
    return np.array(j_lm_batch(0, step, batch, seq, jc.vocab)["tokens"])


# ------------------------------ chunked attention ---------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
def test_chunked_attention_matches_jax(mode, kernel_quantizer):
    H, KV, hd = 14, 2, 4
    rng = np.random.default_rng(0)
    q = (rng.normal(size=(B, S, H, hd)) * 2).astype(np.float32)
    k = (rng.normal(size=(B, S, KV, hd)) * 2).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    ct = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    pf = np.float32(6.0)
    kw = dict(d_model=56, n_heads=H, n_kv=KV, head_dim=hd, q_chunk=32,
              k_chunk=32)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    pos = np.arange(S)
    oj, vjp = jax.vjp(lambda *a: jattn._chunked_attention(
        a[0], a[1], a[2], jnp.asarray(pos), jcfg, a[3], mode),
        *map(jnp.asarray, (q, k, v, pf)))
    grads_j = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, pf)]
    ot = tattn._chunked_attention(ts[0], ts[1], ts[2], torch.arange(S), tcfg,
                                  ts[3], mode)
    assert ot.shape == (B, S, H, hd)
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj), rtol=0,
                               atol=1e-5)
    (ot * torch.from_numpy(ct)).sum().backward()
    for name, t, gj in zip("qkvf", ts, grads_j):
        gj = np.asarray(gj)
        gt = np.zeros_like(gj) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(gt, gj, rtol=0,
                                   atol=1e-5 * max(np.abs(gj).max(), 1e-30),
                                   err_msg=name)
    if mode == "train":
        assert float(np.abs(np.asarray(grads_j[3]))) > 0


def test_group_heads_and_memory_tpos_match_jax():
    rng = np.random.default_rng(1)
    qh = rng.normal(size=(2, 5, 14, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tattn._group_heads(torch.from_numpy(qh), 2).numpy(),
        np.asarray(jattn._group_heads(jnp.asarray(qh), 2)))
    mem = np.array([0, 3, 7], np.int32)
    np.testing.assert_array_equal(
        tattn.memory_tpos(torch.from_numpy(mem), 7).numpy(),
        np.asarray(jattn.memory_tpos(jnp.asarray(mem), 7)))


# --------------------------- the LM forward in TRAIN ------------------------

def test_lm_forward_train_matches_jax(kernel_quantizer):
    jc, tc, p, q = _trees()
    tp, tq = _port_trees(p, q)
    toks = _tokens(0).copy()
    lj, nqj, auxj = model_for(jc).forward(p, q, {"tokens": jnp.asarray(toks)},
                                          jc, mode="train")
    lt, nqt, auxt = TransformerLM.forward(tp, tq,
                                          {"tokens": torch.from_numpy(toks)},
                                          tc, mode=hgq.TRAIN)
    np.testing.assert_array_equal(lt.detach().numpy(), np.asarray(lj))
    assert _rel(auxt.ebops.detach(), auxj.ebops) < 1e-6
    assert _rel(auxt.l1.detach(), auxj.l1) < 1e-6
    jf, tf = _flat_jax(nqj), _flat_port(nqt)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tf[k].shape == jf[k].shape, k
        np.testing.assert_allclose(tf[k], jf[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    # the stacked [L] range states moved from their zero init
    assert float(np.abs(tf["layers/attn/attnout/vmax"]).min()) > 0


def _jax_trajectory(steps):
    """(metrics per step, AdamW state after step 0) of the JAX train step
    with the kernel op, over ``steps`` lm batches."""
    jc, _, p, q = _trees()
    M = model_for(jc)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, q, b, mode: M.forward(p, q, b, jc, mode),
        lambda o, b: jlosses.lm_loss(o, b["tokens"]),
        jloop.TrainConfig(**TCFG)))
    opt, out, first = joptim.adamw_init(p), [], None
    for s in range(steps):
        p, q, opt, m = jstep(p, q, opt, {"tokens": jnp.asarray(_tokens(s))},
                             jnp.int32(s))
        out.append({k: float(v) for k, v in m.items()})
        if s == 0:
            first = opt
    return out, first


def _port_trajectory(steps, cfg=None):
    jc, tc, p, q = _trees()
    cfg = cfg or tc
    tp, tq = _port_trees(p, q)
    step = make_train_step(
        lambda p, q, b, mode: TransformerLM.forward(p, q, b, cfg, mode),
        lambda o, b: lm_loss(o, b["tokens"]), TrainConfig(**TCFG))
    opt, out, first = toptim.adamw_init(tp), [], None
    for s in range(steps):
        tp, tq, opt, m = step(tp, tq, opt,
                              {"tokens": torch.from_numpy(_tokens(s))}, s)
        out.append({k: float(v) for k, v in m.items()})
        if s == 0:
            first = opt
    return out, first, (tp, tq)


_JAX_RUN = {}


def _jax_run():
    """``_jax_trajectory`` once (its callers swap in the kernel op)."""
    if not _JAX_RUN:
        _JAX_RUN["run"] = _jax_trajectory(TCFG["steps"])
    return _JAX_RUN["run"]


def test_train_step_matches_jax(kernel_quantizer, monkeypatch):
    """One step: metrics and gradients; the backward without ``ln2 *
    delta`` (the f gradient from the loss) misses the gradient limit."""
    jm, jfirst = _jax_run()
    tm, tfirst, _ = _port_trajectory(1)
    for k in ("loss", "total", "ebops"):
        assert _rel(tm[0][k], jm[0][k]) < 1e-6, k
    assert _rel(tm[0]["gnorm"], jm[0]["gnorm"]) < 1e-5

    # the step's gradients, clipped: AdamW's first moment after one step
    # (0.1 of them)
    def gaps(t_opt):
        jg, tg = _flat_jax(jfirst.mu), _flat_port(t_opt.mu)
        assert sorted(jg) == sorted(tg)
        return {k: float(np.abs(tg[k] - jg[k]).max())
                / max(float(np.abs(jg[k]).max()), 1e-30) for k in jg}

    sound = gaps(tfirst)
    assert max(sound.values()) < GRAD_LIMIT, sound
    monkeypatch.setattr(hops.ref, "hgq_quantize_grad_ref",
                        lambda g, x, f: torch.zeros_like(f))
    _, faulty_first, _ = _port_trajectory(1)
    faulty = gaps(faulty_first)
    jg = _flat_jax(jfirst.mu)
    f_keys = [k for k in faulty
              if k.endswith("f") and np.abs(jg[k]).max() > 0]
    # the loss's share of each f's gradient is gone: read 2.7e-2 at least
    # (an f whose ~EBOPs term dominates) and 1.0 at most
    assert f_keys and min(faulty[k] for k in f_keys) > 10 * GRAD_LIMIT \
        and max(faulty[k] for k in f_keys) > 0.5, faulty


def test_ten_step_trajectory_matches_jax(kernel_quantizer):
    jm, _ = _jax_run()
    tm, _, (tp, tq) = _port_trajectory(TCFG["steps"])
    loss = [_rel(t["loss"], j["loss"]) for t, j in zip(tm, jm)]
    ebops = [_rel(t["ebops"], j["ebops"]) for t, j in zip(tm, jm)]
    assert max(loss) < TRAJ_LIMIT and max(ebops) < TRAJ_LIMIT, (loss, ebops)
    assert loss[0] == 0.0 and ebops[0] < 1e-6
    assert tm[-1]["loss"] < np.log(256) + 0.1
    # the qstate keeps the JAX layout: [L] range states
    assert tuple(tq["layers"]["ln1"]["out"].vmax.shape) == (2,)


def test_remat_on_and_off_give_the_same_bits():
    _, tc, _, _ = _trees()
    on, on_opt, (p1, q1) = _port_trajectory(2, tc)
    off, off_opt, (p2, q2) = _port_trajectory(
        2, dataclasses.replace(tc, remat=False))
    assert on == off
    for a, b in ((p1, p2), (q1, q2), (on_opt.mu, off_opt.mu)):
        fa, fb = _flat_port(a), _flat_port(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# ---------------------------- prefill against decode ------------------------

def _prefill_vs_decode(cfg, batch, seq, kv_bits=None, dtype=torch.bfloat16,
                       drop_attnout=False):
    """(forward logits, token-by-token decode logits), EVAL, port only."""
    g = torch.Generator().manual_seed(3)
    p, q = TransformerLM.init(g, cfg, device="cpu")
    if drop_attnout:
        p = _without_attnout(p)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=g)
    with torch.no_grad():
        full, _, _ = TransformerLM.forward(p, q, {"tokens": toks}, cfg,
                                           mode=hgq.EVAL)
        cache = TransformerLM.init_cache(cfg, batch, seq + 4, dtype=dtype,
                                         kv_bits=kv_bits, device="cpu")
        got = []
        for t in range(seq):
            lg, cache = TransformerLM.decode_step(p, q, cache,
                                                  toks[:, t:t + 1], t, cfg,
                                                  mode=hgq.EVAL,
                                                  kv_bits=kv_bits)
            got.append(lg[:, 0])
    return full.numpy(), torch.stack(got, dim=1).numpy()


def _windowed(cfg):
    return dataclasses.replace(cfg, window=16)


@pytest.mark.parametrize("windowed", [False, True])
def test_prefill_matches_decode_on_a_float32_cache(windowed):
    """One chunk, a float32 cache, no attention output quantizer: the same
    function up to the order of float32 operations (decode divides the
    probabilities by their sum before the PV product, the chunked forward
    after it; with the quantizer on, that ulp decides its rounding ties,
    as in ``test_torch_lm.py``).  Windowed: 24 tokens through a 16-token
    window."""
    tc = _trees()[1]
    cfg, batch, seq = (_windowed(tc), 1, 24) if windowed else (tc, 2, 12)
    full, got = _prefill_vs_decode(cfg, batch, seq, dtype=torch.float32,
                                   drop_attnout=True)
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), full.argmax(-1))


@pytest.mark.parametrize("kv_bits", [None, 8])
@pytest.mark.parametrize("case", ["one_chunk", "windowed", "chunks"])
def test_decode_matches_forward(case, kv_bits):
    """The reference test's limits on the bf16 cache and the 8-bit ring:
    12 tokens in one chunk, 24 through a 16-token window, 80 in 3 query
    chunks (the probabilities quantized per chunk pair in the forward,
    against the global maximum in decode)."""
    tc = _trees()[1]
    cfg, batch, seq = {"one_chunk": (tc, 2, 12),
                       "windowed": (_windowed(tc), 1, 24),
                       "chunks": (tc, 2, S)}[case]
    full, got = _prefill_vs_decode(cfg, batch, seq, kv_bits=kv_bits)
    np.testing.assert_allclose(got, full, rtol=1e-1, atol=1e-1)
    agree = float(np.mean(got.argmax(-1) == full.argmax(-1)))
    assert agree >= 0.9, f"top-1 agreement {agree}"


# ------------------------------ the int8 fp cache ---------------------------

def test_cache_store_and_load_match_jax():
    x = np.array([-9.0, -7.96875, -0.03125, 0.03125, 0.09375, 1.0 / 3, 7.9,
                  8.0, 100.0], np.float32)
    for dt, jdt in ((torch.int8, jnp.int8), (torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        st = tattn._cache_store(torch.from_numpy(x), dt)
        sj = jattn._cache_store(jnp.asarray(x), jdt)
        np.testing.assert_array_equal(st.to(torch.float32).numpy(),
                                      np.asarray(sj).astype(np.float32))
        np.testing.assert_array_equal(
            tattn._cache_load(st).to(torch.float32).numpy(),
            np.asarray(jattn._cache_load(sj)).astype(np.float32))


def _without_attnout(p):
    attn = {k: v for k, v in p["layers"]["attn"].items() if k != "attnout_f"}
    return {**p, "layers": {**p["layers"], "attn": attn}}


@pytest.mark.parametrize("drop_attnout", [False, True])
def test_int8_fp_cache_matches_jax(drop_attnout):
    """``init_cache(dtype=int8)`` stores round(x * 16) and reads q / 16,
    as the reference does (a plain cast truncates k and v to integers)."""
    jc, tc, p, q = _trees()
    if drop_attnout:
        p = _without_attnout(p)
    tp, tq = _port_trees(p, q)
    M = model_for(jc)
    rng = np.random.default_rng(3)
    steps = [(rng.integers(0, jc.vocab, (B, 5)), 0),
             (rng.integers(0, jc.vocab, (B, 1)), 5),
             (rng.integers(0, jc.vocab, (B, 1)), 6)]
    jcache = M.init_cache(jc, B, 16, dtype=jnp.int8)
    tcache = TransformerLM.init_cache(tc, B, 16, dtype=torch.int8,
                                      device="cpu")
    for tok, pos in steps:
        lj, jcache = M.decode_step(p, q, jcache, jnp.asarray(tok),
                                   jnp.int32(pos), jc)
        lt, tcache = TransformerLM.decode_step(tp, tq, tcache,
                                               torch.from_numpy(tok), pos, tc)
        lt, lj = lt.numpy(), np.asarray(lj)
        if drop_attnout:
            np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
        else:
            assert np.abs(lt - lj).max() <= 2e-2
            assert np.linalg.norm(lt - lj) <= 3e-2 * np.linalg.norm(lj)
    np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jcache.k))


# ------------------------------- data and helpers ---------------------------

def test_lm_data_kind():
    """Tokens [batch, seq] int64 in [0, vocab), a pure function of (seed,
    step); the rule's share (a token 31 x its predecessor mod vocab) as
    in the reference's generator, within 0.01 at 64 x 512 tokens."""
    V = 151936
    a = lm_batch(0, 3, 64, 512, V, device="cpu")["tokens"]
    assert a.shape == (64, 512) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < V
    assert torch.equal(a, lm_batch(0, 3, 64, 512, V, device="cpu")["tokens"])
    assert not torch.equal(a, lm_batch(0, 4, 64, 512, V,
                                       device="cpu")["tokens"])
    pipe = make_pipeline(DataSpec(kind="lm", batch=4, seq=16, vocab=V,
                                  seed=2), device="cpu")
    assert torch.equal(pipe(5)["tokens"], lm_batch(2, 5, 4, 16, V,
                                                    device="cpu")["tokens"])

    def rule_share(t):
        t = np.asarray(t, np.int64)
        return float(np.mean(t[:, 1:] == t[:, :-1] * 31 % V))

    j = np.asarray(j_lm_batch(0, 3, 64, 512, V)["tokens"])
    assert abs(rule_share(a.numpy()) - rule_share(j)) < 0.01
    assert 0.18 < rule_share(a.numpy()) < 0.24
    assert abs(float(a.double().mean()) / V - 0.5) < 0.01


def test_config_counts_and_compute_dtype_match_jax():
    for smoke in (False, True):
        jc, tc = jget("qwen2-0.5b", smoke=smoke), tget("qwen2-0.5b",
                                                       smoke=smoke)
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        assert tc.sub_quadratic == jc.sub_quadratic
        assert tc.np_dtype == torch.float32
        assert useful_model_flops_dense(tc.n_params(), 4096) == \
            j_flops(jc.n_params(), 4096)
    x = torch.ones(3)
    assert tperf.get_compute_dtype() is None and tperf.cast_for_matmul(x) is x
    with tperf.compute_dtype_scope(torch.bfloat16), \
            jperf.compute_dtype_scope(jnp.bfloat16):
        assert tperf.cast_for_matmul(x).dtype == torch.bfloat16
        assert jperf.cast_for_matmul(jnp.ones(3)).dtype == jnp.bfloat16
        ids = torch.arange(3)
        assert tperf.cast_for_matmul(ids) is ids
    assert tperf.get_compute_dtype() is None
    tperf.reset_precision()
