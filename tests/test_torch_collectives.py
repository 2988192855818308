"""Port parity: the compressed data-parallel gradient reduce
(``repro_torch.dist``) against the JAX package's ``repro.dist``.

The port's fused and per-leaf ``ef_wire_pmean`` on a ``LocalMesh`` (ranks
as threads) and its ``simulate_wire_pmean`` must deliver the bits of JAX's
``simulate_wire_pmean`` (which the JAX package's 8-device tests hold equal
to its shard_map collective), residuals included, for int8 and bf16
wires, stacked leaves and mixed 4/8 widths, with one bucket or many.  A
two-process gloo run (``ProcessGroupMesh``) must equal ``LocalMesh(2)``.
The bucketing, the stacked-leaf rule, ``ef_compress``, plan derivation and
the byte model are held to JAX's too.  All comparisons are of bits;
inputs come from a seed with numpy."""
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.dist as jdist
    from repro.configs.qwen2_0_5b import SMOKE as JSMOKE
    from repro.core import plan as jplan
    from repro.dist import collectives as jcoll
    from repro.dist import sharding as jsharding
    from repro.models import JetTagger as JJet
    from repro.models import TransformerLM as JLM
    from repro.nn import HGQConfig as JCfg

from repro_torch.core import plan as tplan
from repro_torch.dist import (EFState, LocalMesh, ef_compress, ef_init,
                              ef_wire_init, ef_wire_pmean, record_wire_bytes,
                              simulate_wire_pmean, stacked_tree,
                              wire_bytes_model)
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import sharding as tsharding
from repro_torch.tree import tree_flatten_with_path, tree_leaves
from repro_torch.weights import from_jax

MIXED = {"layers": 4, "vec": 8, "scalar": 8, "w3d": 4}
PLAN_W4W8 = str(Path(__file__).resolve().parents[1] / "examples" / "specs"
                / "plan_mixed_w4w8.json")


def _tree(n, seed):
    """A per-shard tree with a stacked [L, ...] leaf (under ``layers``), a
    3-D leaf that is one tensor, a flat leaf with an odd tail and a scalar
    leaf; scales differ per leaf and per layer."""
    rng = np.random.default_rng(seed)
    layers = rng.normal(size=(n, 3, 8, 5)).astype(np.float32)
    layers *= np.asarray([1e-3, 1.0, 40.0], np.float32)[None, :, None, None]
    return {"layers": layers,
            "vec": (rng.normal(size=(n, 17)) * 3).astype(np.float32),
            "scalar": rng.normal(size=(n,)).astype(np.float32),
            "w3d": (rng.normal(size=(n, 2, 3, 7)) * 0.01).astype(np.float32)}


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same_tree(t, j) -> None:
    assert sorted(t) == sorted(j)
    for k in t:
        a, b = t[k].numpy(), np.asarray(j[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("mixed", [False, True])
def test_wire_reduce_matches_jax_simulator(n, kind, mixed):
    """simulate, fused (one bucket and one leaf a bucket) and per-leaf on
    LocalMesh(n): the bits of JAX's simulator, delivered and residual."""
    tree = _tree(n, seed=10 * n + mixed)
    widths = MIXED if mixed else None
    jd, jr = jcoll.simulate_wire_pmean(_jax(tree), kind, widths=widths)
    sd, sr = simulate_wire_pmean(_torch(tree), kind, widths=widths)
    _same_tree(sd, jd)
    _same_tree(sr, jr)
    mesh = LocalMesh(n, "cpu")
    for kw in ({"fused": True}, {"fused": True, "bucket_bytes": 1},
               {"fused": False}):
        d, r = ef_wire_pmean(_torch(tree), mesh, kind, widths=widths, **kw)
        _same_tree(d, jd)
        _same_tree(r, jr)


@pytest.mark.parametrize("n", [3, 4])
def test_fused_bucket_reduce_of_bfloat16_leaves_matches_jax(n):
    """The fused reduce through the bucket entry points on a tree with
    bfloat16 leaves (a stacked one among them) and float32 leaves with
    -0.0 values, mixed 4/8 widths, n = 3 (a true division) and 4, one
    bucket and one leaf a bucket: the bits of JAX's simulator and of the
    per-leaf path, delivered and residual, in each leaf's dtype."""
    tree = _tree(n, seed=50 + n)
    tree["vec"][:, ::4] = -0.0
    t = _torch(tree)
    t["layers"] = t["layers"].to(torch.bfloat16)
    t["w3d"] = t["w3d"].to(torch.bfloat16)
    jt = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in t.items()}
    jd, jr = jcoll.simulate_wire_pmean(jt, "int8", widths=MIXED)
    mesh = LocalMesh(n, "cpu")
    leaf_d, leaf_r = ef_wire_pmean(t, mesh, "int8", widths=MIXED,
                                   fused=False)
    for bb in (None, 1):
        d, r = ef_wire_pmean(t, mesh, "int8", widths=MIXED, bucket_bytes=bb)
        for k in tree:
            for got, per_leaf, want in ((d[k], leaf_d[k], jd[k]),
                                        (r[k], leaf_r[k], jr[k])):
                assert got.dtype == t[k].dtype, k
                a = got.float().numpy()
                b = np.asarray(want).astype(np.float32)
                np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)
                np.testing.assert_array_equal(
                    _bits(a), _bits(per_leaf.float().numpy()), err_msg=k)


def test_fused_multi_bucket_schedule_matches_jax():
    """A 256-byte budget mixes leaves and splits others across buckets:
    the bucket lists equal JAX's, and the result stays JAX's bits."""
    tree = _tree(4, seed=21)
    for bb in (1, 256, 1 << 20):
        flat = tree_leaves(_torch(tree))
        sizes = [4 * -(-(int(np.prod(x.shape[1:])) or 1) // 4) for x in flat]
        assert tcoll._bucket_leaves(sizes, bb) == \
            jcoll._bucket_leaves(sizes, bb)
        d, r = ef_wire_pmean(_torch(tree), LocalMesh(4, "cpu"), "int8",
                             widths=MIXED, bucket_bytes=bb)
        jd, jr = jcoll.simulate_wire_pmean(_jax(tree), "int8", widths=MIXED)
        _same_tree(d, jd)
        _same_tree(r, jr)


@pytest.mark.parametrize("seed", range(8))
def test_bucket_leaves_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 4000, int(rng.integers(0, 13)))]
    bb = int(rng.integers(1, 5000))
    buckets = tcoll._bucket_leaves(sizes, bb)
    assert buckets == jcoll._bucket_leaves(sizes, bb)
    assert sorted(i for b in buckets for i in b) == list(range(len(sizes)))
    for b in buckets:
        assert b and (len(b) == 1 or sum(sizes[i] for i in b) <= bb)


def _param_trees():
    """The jet tagger's and a 2-layer qwen2-shaped LM's params, JAX's and
    the port's (the same values)."""
    jp, _ = JJet.init(jax.random.PRNGKey(0), JCfg(
        weight_gran="per_parameter", act_gran="per_parameter"))
    lp, _ = JLM.init(jax.random.PRNGKey(1), JSMOKE)
    out = []
    for j in (jp, lp):
        (t,) = from_jax(jax.tree.map(np.asarray, j), device="cpu")
        out.append((j, t))
    return out


def _jkey(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def test_stacked_tree_and_wire_widths_match_jax():
    plan = jplan.PrecisionPlan.from_file(PLAN_W4W8)
    tp_plan = tplan.PrecisionPlan.from_file(PLAN_W4W8)
    for j, t in _param_trees():
        jst = jsharding.stacked_tree(j)
        js = {_jkey(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(jst)[0]}
        ts = {"/".join(p): v for p, v in
              tree_flatten_with_path(stacked_tree(t))}
        assert js == ts
        jw = {_jkey(p): v for p, v in jax.tree_util.tree_flatten_with_path(
            plan.wire_bits_tree(j))[0]}
        tw = {"/".join(p): v for p, v in tree_flatten_with_path(
            tp_plan.wire_bits_tree(t))}
        assert jw == tw
    assert tsharding.model_axis_for((896, 4864), 2) == \
        jsharding.model_axis_for((896, 4864), 2)
    assert tsharding.model_axis_for((7,), 2) is None


def test_plan_derivation_matches_jax():
    for j, t in _param_trees():
        assert tplan.mixed_low_plan(t, 4).to_json() == \
            jplan.mixed_low_plan(j, 4).to_json()
        for low, thr in ((4, None), (5, 7), (8, None)):
            assert tplan.plan_from_params(t, low_bits=low,
                                          threshold=thr).to_json() == \
                jplan.plan_from_params(j, low_bits=low,
                                       threshold=thr).to_json()
        assert [k for k, _ in tplan.iter_packable(t)] == \
            [k for k, _ in jplan.iter_packable(j)]
        for (k, tw), (_, jw) in zip(tplan.iter_packable(t),
                                    jplan.iter_packable(j)):
            assert tplan.layer_occupied_bits(tw["w"], tw.get("f")) == \
                jplan.layer_occupied_bits(jw["w"], jw.get("f")), k
    assert tplan.PrecisionPlan().is_uniform_int8
    assert not tplan.mixed_low_plan(_param_trees()[0][1]).is_uniform_int8


@pytest.mark.parametrize("kind", ["int8", "bf16", "none"])
def test_ef_compress_matches_jax(kind):
    """Post-reduce error feedback, three steps, a stacked leaf with an
    outlier layer and a 3-D leaf that is one tensor: the bits of JAX's."""
    rng = np.random.default_rng(7)
    g = {"layers": {"w": (rng.normal(size=(3, 8, 5)) *
                          np.asarray([1e-3, 1.0, 1e3])[:, None, None])
                    .astype(np.float32)},
         "w3d": rng.normal(size=(2, 3, 4)).astype(np.float32),
         "b": rng.normal(size=(9,)).astype(np.float32)}
    tg = {"layers": {"w": torch.from_numpy(g["layers"]["w"])},
          "w3d": torch.from_numpy(g["w3d"]), "b": torch.from_numpy(g["b"])}
    jg = jax.tree.map(jnp.asarray, g)
    js, ts = jdist.ef_init(jg), ef_init(tg)
    for _ in range(3):
        jsent, js = jdist.ef_compress(jg, js, kind=kind)
        tsent, ts = ef_compress(tg, ts, kind=kind)
        for a, b in zip(tree_leaves(tsent), jax.tree.leaves(jsent)):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        for a, b in zip(tree_leaves(ts.residual),
                        jax.tree.leaves(js.residual)):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    with pytest.raises(ValueError, match="supported"):
        ef_compress(tg, ts, kind="fp4")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_recorded_bytes_equal_the_model(fused, kind):
    """The bytes one rank records equal ``wire_bytes_model`` summed over
    the leaves (nibble leaves at half a byte), and the fused and per-leaf
    paths record the same (op, bytes) pairs."""
    n = 4
    tree = _tree(n, seed=30)
    widths = MIXED if kind == "int8" else None
    with record_wire_bytes() as rec:
        ef_wire_pmean(_torch(tree), LocalMesh(n, "cpu"), kind, widths=widths,
                      fused=fused)
    flags = tcoll._stacked_flags(_torch(tree), None)
    want = 0.0
    for (k, x), st in zip(sorted(tree.items()), flags):
        L = x.shape[1] if (st and x.ndim - 1 >= 3) else 1
        want += wire_bytes_model(int(np.prod(x.shape[1:])), n, kind,
                                 n_scale_rows=L,
                                 bits=(widths or {}).get(k, 8))
    assert rec.total() == pytest.approx(want, rel=1e-12)
    with record_wire_bytes() as other:
        ef_wire_pmean(_torch(tree), LocalMesh(n, "cpu"), kind, widths=widths,
                      fused=not fused)
    assert sorted(rec.records) == sorted(other.records)
    assert jcoll.wire_bytes_model(1000, n, kind, 3, 4) == \
        wire_bytes_model(1000, n, kind, 3, 4)
    assert tcoll.fp32_allreduce_bytes(1000, n) == \
        jcoll.fp32_allreduce_bytes(1000, n)


def test_ef_time_average_unbiased():
    """Over K steps of a constant gradient the time-averaged delivered
    gradient is within one grid step of the truth: post-reduce int8 EF and
    the two-phase wire over LocalMesh(4)."""
    rng = np.random.default_rng(11)
    for _ in range(5):
        g = torch.from_numpy(rng.uniform(-1, 1, int(rng.integers(4, 25)))
                             .astype(np.float32))
        K = int(rng.integers(8, 21))
        grid = max(float(g.abs().max()), 1e-30) / 127.0
        st, acc = ef_init({"w": g}), torch.zeros_like(g)
        for _ in range(K):
            sent, st = ef_compress({"w": g}, st, kind="int8")
            acc = acc + sent["w"]
        assert float((acc / K - g).abs().max()) <= grid + 1e-7
        gs = torch.tensor([0.4, 0.8, 1.2, 1.6])[:, None] * g[None, :]
        true_mean = gs.mean(0)
        wire_grid = max(float(gs.abs().max()), 1e-30) / 127.0 * 2
        res = ef_wire_init({"w": true_mean}, 4)
        acc = torch.zeros_like(g)
        mesh = LocalMesh(4, "cpu")
        for _ in range(K):
            d, res = ef_wire_pmean({"w": gs + res["w"]}, mesh, "int8")
            acc = acc + d["w"]
        assert float((acc / K - true_mean).abs().max()) <= wire_grid + 1e-7


def test_wire_backward_is_the_shard_mean_transpose():
    tree = {"w": torch.randn((4, 6, 5),
                             generator=torch.Generator().manual_seed(2))}
    tree["w"].requires_grad_(True)
    d, r = ef_wire_pmean(tree, LocalMesh(4, "cpu"), "int8")
    assert not r["w"].requires_grad
    (gw,) = torch.autograd.grad(d["w"].sum() * 3.0, [tree["w"]])
    assert gw.shape == (4, 6, 5)
    assert torch.equal(gw, torch.full((4, 6, 5), 0.75))
    d0, _ = ef_wire_pmean({"w": tree["w"].detach()}, LocalMesh(4, "cpu"))
    assert torch.equal(d["w"].detach(), d0["w"])


def test_wire_validation():
    tree = {"w": torch.zeros((2, 4))}
    with pytest.raises(ValueError, match="int8"):
        simulate_wire_pmean(tree, "fp4")
    with pytest.raises(ValueError, match="wire width"):
        simulate_wire_pmean(tree, "int8", widths={"w": 9})
    with pytest.raises(ValueError, match="local"):
        ef_wire_pmean(tree, LocalMesh(4, "cpu"))
    assert tcoll._phase2_shift(5) == jcoll._phase2_shift(5) == 3


def test_local_mesh_fails_cleanly_when_a_rank_fails():
    mesh = LocalMesh(3, "cpu")

    def body(rank, x):
        if rank.index == 1:
            raise KeyError("rank 1 failed")
        return rank.all_gather(x)

    with pytest.raises(KeyError, match="rank 1"):
        mesh.run(body, [torch.zeros(2)] * 3)
    # the mesh is usable again after a failed run
    out = mesh.run(lambda rank, x: rank.pmax(x),
                   [torch.tensor([float(i)]) for i in range(3)])
    assert all(float(o[0]) == 2.0 for o in out)


def test_gloo_two_processes_equal_local_mesh(tmp_path):
    """Two processes over gloo (``ProcessGroupMesh``, a file:// rendezvous)
    deliver LocalMesh(2)'s bits, fused and per-leaf, mixed widths."""
    import torch.multiprocessing as mp
    import _torch_gloo_worker as worker
    tree = _tree(2, seed=40)
    np.savez(tmp_path / "in.npz", **tree)
    for fused in (True, False):
        out = str(tmp_path / f"out{int(fused)}_{{rank}}.npz")
        ctx = mp.spawn(worker.run_rank,
                       args=(2, str(tmp_path / f"rdv{int(fused)}"),
                             str(tmp_path / "in.npz"), out, "int8", MIXED,
                             fused),
                       nprocs=2, join=False)
        deadline = time.monotonic() + 240
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("gloo ranks did not finish in 240 s")
        ld, lr = ef_wire_pmean(_torch(tree), LocalMesh(2, "cpu"), "int8",
                               widths=MIXED, fused=fused)
        for rank in range(2):
            with np.load(out.format(rank=rank)) as o:
                for k in tree:
                    np.testing.assert_array_equal(_bits(o[f"d/{k}"]),
                                                  _bits(ld[k].numpy()))
                    np.testing.assert_array_equal(
                        _bits(o[f"r/{k}"][0]), _bits(lr[k][rank].numpy()))


def test_ef_state_from_jax():
    rng = np.random.default_rng(3)
    res = {"a": rng.normal(size=(4, 3)).astype(np.float32)}
    (st,) = from_jax(jdist.EFState(residual=res), device="cpu")
    assert isinstance(st, EFState)
    np.testing.assert_array_equal(st.residual["a"].numpy(), res["a"])
