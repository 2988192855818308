"""Port parity: the 2D (data x model) half of ``repro_torch.dist`` against
the JAX package's.

The port's ``simulate_wire_pmean_2d`` must deliver the bits of JAX's, the
delivered tree and the sliced residual, on 2x4, 4x2, 1x4 and 3x2 meshes,
for int8 and bf16 wires, mixed 4/8 widths, a stacked leaf, an unmarked
3-D leaf and a leaf whose trailing axes do not divide the model axis; the
port's exchange on a ``LocalMesh(D, model=M)`` (ranks as threads), fused
with one bucket or a bucket a leaf and per leaf, must deliver its own
simulator's bits, and four gloo processes as a 2x2 ``ProcessGroupMesh``
those of ``LocalMesh(2, model=2)``.  The slice lengths, byte models,
recorded bytes, placement specs (``dist.sharding``), the head-TP branch of
the chunked attention and a 2D compressed jet step are held to JAX's; the
sliced residual resumes from a checkpoint exactly and restarts at zero on
a rescaled mesh.  Inputs come from a seed with numpy.

The JAX placement functions read a mesh's ``axis_names`` and
``devices.shape`` only; where they wrap a spec in a ``NamedSharding`` the
test swaps in one that returns the spec."""
import time
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.core.hgq as jhgq
    import repro.dist.axes as jaxes
    import repro.nn.attention as jattn
    from repro.dist import EFState as JEFState
    from repro.dist import collectives as jcoll
    from repro.dist import sharding as jsharding
    from repro.kernels import hgq_quantize as j_hgq_quantize
    from repro.data import jet_batch as j_jet_batch
    from repro.models import JetTagger as JJet
    from repro.nn import HGQConfig as JCfg
    from repro import optim as joptim
    from repro.train import losses as jlosses
    from repro.train import loop as jloop

from repro_torch import optim as toptim
from repro_torch.api import RunSpec, build
from repro_torch.dist import EFState, LocalMesh
from repro_torch.dist import axes as taxes
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import sharding as tsharding
from repro_torch.models import JetTagger
from repro_torch.nn import attention as tattn
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train import losses as tlosses
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax

MESHES = [(2, 4), (4, 2), (1, 4), (3, 2)]
MIXED = {"w": 4, "layers": 4, "vec": 8, "scalar": 8, "w3": 8, "odd": 4}
SPEC_2X4 = str(Path(__file__).resolve().parents[1] / "examples" / "specs"
               / "host_2x4_int8wire2d.json")
CPU = torch.device("cpu")


def _tree(n, seed):
    """A per-shard tree: a model-shardable matrix, a stacked [L, ...] leaf
    (under ``layers``) with per-layer scales, a 3-D leaf that is one tensor
    (``w3``), a matrix whose trailing axes do not divide 4 (``odd``), a flat
    vector with an odd tail and a scalar."""
    rng = np.random.default_rng(seed)
    layers = rng.normal(size=(n, 3, 8, 6)).astype(np.float32)
    layers *= np.asarray([1e-3, 1.0, 40.0], np.float32)[None, :, None, None]
    return {"w": rng.normal(size=(n, 6, 8)).astype(np.float32),
            "layers": layers,
            "w3": (rng.normal(size=(n, 3, 8, 6)) * 0.01).astype(np.float32),
            "odd": (rng.normal(size=(n, 6, 9)) * 2).astype(np.float32),
            "vec": (rng.normal(size=(n, 17)) * 3).astype(np.float32),
            "scalar": rng.normal(size=(n,)).astype(np.float32)}


def _res(tree, D, M, seed):
    """A nonzero residual in the sliced layout (a few grid steps' worth)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(D, M, jcoll.wire2d_slice_len(
        v.shape[1:], D, M))) * 1e-3).astype(np.float32)
        for k, v in tree.items()}


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(t, j, what="") -> None:
    assert sorted(t) == sorted(j)
    for k in t:
        a = t[k].detach().numpy() if isinstance(t[k], torch.Tensor) \
            else np.asarray(t[k])
        b = j[k].detach().numpy() if isinstance(j[k], torch.Tensor) \
            else np.asarray(j[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{what} {k}")


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ------------------------------ slice layout --------------------------------

def test_slice_len_init_and_byte_models_match_jax():
    shapes = [(6, 8), (16, 8), (3, 8, 6), (6, 9), (17,), (), (896, 4864),
              (151936, 896), (24, 896, 128), (24, 896)]
    for D, M in MESHES + [(2, 1), (1, 8)]:
        for S in shapes:
            assert tcoll.wire2d_slice_len(S, D, M) == \
                jcoll.wire2d_slice_len(S, D, M), (S, D, M)
            assert tcoll.tp_replication_bytes(S, M) == \
                jcoll.tp_replication_bytes(S, M), (S, M)
            for kind, bits in (("int8", 8), ("int8", 4), ("bf16", 8)):
                for st in (False, True):
                    assert tcoll.wire2d_leaf_bytes(S, D, M, kind, st, bits) \
                        == jcoll.wire2d_leaf_bytes(S, D, M, kind, st, bits), \
                        (S, D, M, kind, st, bits)
    tree = _tree(1, 0)
    got = tcoll.ef_wire2d_init({k: torch.tensor(v[0])
                                for k, v in tree.items()}, 2, 4)
    want = jcoll.ef_wire2d_init({k: jnp.asarray(v[0])
                                 for k, v in tree.items()}, 2, 4)
    for k in tree:
        assert tuple(got[k].shape) == want[k].shape, k
        assert not got[k].any()
    # the mesh's sizes, as the reference reads them from its mesh
    for D, M in MESHES:
        mesh = LocalMesh(D, CPU, model=M)
        assert tcoll.data_axis_size(mesh) == D
        assert tcoll.model_axis_size(mesh) == M
        assert tcoll.data_axis_names(mesh) == ("data",)
    assert tcoll.model_axis_size(None) == 1


# ------------------------- the simulator against JAX ------------------------

@pytest.mark.parametrize("D,M", MESHES)
def test_simulate_2d_matches_jax(D, M):
    """int8, bf16 and mixed widths from a nonzero residual: delivered and
    residual bit for bit."""
    tree = _tree(D, 10 * D + M)
    for kind, widths in (("int8", None), ("bf16", None), ("int8", MIXED)):
        res = _res(tree, D, M, D + M)
        td, tr = tcoll.simulate_wire_pmean_2d(_torch(tree), _torch(res), M,
                                              kind, widths=widths)
        jd, jr = jcoll.simulate_wire_pmean_2d(_jax(tree), _jax(res), M,
                                              kind, widths=widths)
        _same(td, jd, f"{kind} {widths} delivered")
        _same(tr, jr, f"{kind} {widths} residual")


# ---------------------- the exchange against the simulator ------------------

@pytest.mark.parametrize("D,M", MESHES)
def test_local_mesh_exchange_matches_simulator(D, M):
    """Fused (one bucket, and a bucket a leaf) and per-leaf, on a
    LocalMesh(D, model=M): the simulator's bits, delivered and residual."""
    tree = _torch(_tree(D, 7 * D + M))
    mesh = LocalMesh(D, CPU, model=M)
    for kind, widths in (("int8", None), ("bf16", None), ("int8", MIXED)):
        res = _torch(_res(tree, D, M, 3))
        ds, rs = tcoll.simulate_wire_pmean_2d(tree, res, M, kind,
                                              widths=widths)
        for fused, bb in ((True, None), (True, 1), (False, None)):
            d, r = tcoll.ef_wire_pmean_2d(tree, res, mesh, kind,
                                          widths=widths, fused=fused,
                                          bucket_bytes=bb)
            what = f"{kind} {widths} fused={fused} bucket={bb}"
            _same(d, ds, what + " delivered")
            _same(r, rs, what + " residual")


def test_records_equal_the_leaf_byte_model():
    """Per leaf, the recorded bytes equal ``wire2d_leaf_bytes`` at the
    leaf's width, fused and per-leaf record the same, and the pure-TP mesh
    records no data exchange."""
    D, M = 2, 4
    full = _torch(_tree(D, 11))
    mesh = LocalMesh(D, CPU, model=M)
    for kind, bits in (("int8", 8), ("int8", 4), ("bf16", 8)):
        for name in full:
            tree = {name: full[name]}
            res = tcoll.ef_wire2d_init({name: full[name][0]}, D, M)
            recs = {}
            for fused in (True, False):
                with tcoll.record_wire_bytes() as rec:
                    tcoll.ef_wire_pmean_2d(tree, res, mesh, kind,
                                           widths={name: bits}, fused=fused)
                recs[fused] = sorted(rec.records)
                want = jcoll.wire2d_leaf_bytes(
                    full[name].shape[1:], D, M, kind,
                    stacked=name == "layers", bits=bits)
                assert rec.total() == want, (name, kind, bits, rec.records)
            assert recs[True] == recs[False], (name, kind, bits)
    tp = _torch(_tree(1, 12))
    res = tcoll.ef_wire2d_init({k: v[0] for k, v in tp.items()}, 1, 4)
    with tcoll.record_wire_bytes() as rec:
        d, _ = tcoll.ef_wire_pmean_2d(tp, res, LocalMesh(1, CPU, model=4))
    assert {op for op, _ in rec.records} == {"pmax.scale",
                                             "all_gather.int8.model"}
    ds, _ = tcoll.simulate_wire_pmean_2d(tp, res, 4)
    _same(d, ds, "pure TP")
    # the reference's acceptance ratio: 2D against 1D plus TP replication
    shape = (512, 1024)
    b2d = tcoll.wire2d_leaf_bytes(shape, 2, 4, "int8")
    b1d = (tcoll.wire_bytes_model(512 * 1024, 2, "int8", 1)
           + tcoll.tp_replication_bytes(shape, 4))
    assert b1d / b2d >= 1.9


def test_1d_exchange_on_a_model_axis_equals_the_data_mesh():
    """wire_layout="1d" on a data x model mesh: every model rank of a data
    shard runs the 1D exchange over data on the whole gradient (the
    reference's shard_map leaves model unmapped); the result is the data
    mesh's, bit for bit."""
    tree = _torch(_tree(2, 13))
    for fused in (True, False):
        d2, r2 = tcoll.ef_wire_pmean(tree, LocalMesh(2, CPU, model=2),
                                     widths=MIXED, fused=fused)
        d1, r1 = tcoll.ef_wire_pmean(tree, LocalMesh(2, CPU), widths=MIXED,
                                     fused=fused)
        _same(d2, d1, f"fused={fused} delivered")
        _same(r2, r1, f"fused={fused} residual")


# ------------------------- error feedback, backward -------------------------

def test_ef2d_time_average_unbiased():
    K, D, M = 14, 2, 4
    tree = _torch(_tree(D, 3))
    mesh = LocalMesh(D, CPU, model=M)
    res = tcoll.ef_wire2d_init({k: v[0] for k, v in tree.items()}, D, M)
    acc = {k: torch.zeros(v.shape[1:]) for k, v in tree.items()}
    for _ in range(K):
        d, res = tcoll.ef_wire_pmean_2d(tree, res, mesh, "int8",
                                        widths=MIXED)
        acc = {k: acc[k] + d[k] for k in acc}
    for k, v in tree.items():
        qmax = 7.0 if MIXED[k] <= 4 else 127.0
        grid = max(float(v.abs().max()), 1e-30) / qmax * 2
        np.testing.assert_allclose((acc[k] / K).numpy(),
                                   v.mean(dim=0).numpy(), atol=grid + 1e-7)


def test_backward_is_ct_over_n_data():
    g = torch.randn((2, 6, 8), generator=torch.Generator().manual_seed(2))
    g.requires_grad_(True)
    mesh = LocalMesh(2, CPU, model=4)
    res = tcoll.ef_wire2d_init({"w": g[0].detach()}, 2, 4)
    d, r = tcoll.ef_wire_pmean_2d({"w": g}, res, mesh)
    assert not r["w"].requires_grad
    (gw,) = torch.autograd.grad(d["w"].sum() * 3.0, [g])
    assert torch.equal(gw, torch.full((2, 6, 8), 1.5))
    d0, _ = tcoll.ef_wire_pmean_2d({"w": g.detach()}, res, mesh)
    assert torch.equal(d["w"].detach(), d0["w"])
    with pytest.raises(ValueError, match="residual"):
        tcoll.ef_wire_pmean_2d({"w": g.detach()},
                               tcoll.ef_wire2d_init({"w": g[0]}, 4, 2), mesh)


# ------------------------------ the 2D mesh ---------------------------------

def test_local_mesh_2d_collectives_and_failure():
    mesh = LocalMesh(2, CPU, model=3)
    assert (mesh.size, mesh.data, mesh.model, mesh.shards) == (6, 2, 3, 2)
    assert mesh.axis_names == ("data", "model")
    assert mesh.axis_sizes == (2, 3)

    def body(rank, x):
        return (rank.pmax(x), rank.all_to_all(torch.stack([x, -x])),
                rank.all_gather(x), rank.all_gather(x, axis="model"))

    outs = mesh.run(body, [torch.tensor([float(i)]) for i in range(6)])
    for i, (mx, a2a, gd, gm) in enumerate(outs):
        d, m = divmod(i, 3)
        assert float(mx) == 5.0
        sign = 1.0 if d == 0 else -1.0
        assert a2a.flatten().tolist() == [sign * m, sign * (3 + m)]
        assert gd.flatten().tolist() == [float(m), float(3 + m)]
        assert gm.flatten().tolist() == [float(3 * d + j) for j in range(3)]

    def failing(rank, x):
        if rank.index == 4:
            raise KeyError("rank 4 failed")
        return rank.all_gather(x, axis="model")

    with pytest.raises(KeyError, match="rank 4"):
        mesh.run(failing, [torch.zeros(1)] * 6)
    out = mesh.run(lambda rank, x: rank.pmax(x),
                   [torch.tensor([float(i)]) for i in range(6)])
    assert all(float(o[0]) == 5.0 for o in out)


def test_gloo_four_processes_equal_local_mesh(tmp_path):
    """Four processes over gloo as a 2x2 ``ProcessGroupMesh`` deliver
    ``LocalMesh(2, model=2)``'s bits, fused and per-leaf, mixed widths."""
    import torch.multiprocessing as mp
    import _torch_gloo_worker as worker
    D, M = 2, 2
    tree = _tree(D, 41)
    res = _res(tree, D, M, 5)
    np.savez(tmp_path / "in.npz", **tree)
    np.savez(tmp_path / "res.npz", **res)
    for fused in (True, False):
        out = str(tmp_path / f"out{int(fused)}_{{rank}}.npz")
        ctx = mp.spawn(worker.run_rank_2d,
                       args=(D, M, str(tmp_path / f"rdv{int(fused)}"),
                             str(tmp_path / "in.npz"),
                             str(tmp_path / "res.npz"), out, MIXED, fused),
                       nprocs=D * M, join=False)
        deadline = time.monotonic() + 240
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("gloo ranks did not finish in 240 s")
        ld, lr = tcoll.ef_wire_pmean_2d(_torch(tree), _torch(res),
                                        LocalMesh(D, CPU, model=M), "int8",
                                        widths=MIXED, fused=fused)
        for rank in range(D * M):
            d, m = divmod(rank, M)
            with np.load(out.format(rank=rank)) as o:
                for k in tree:
                    np.testing.assert_array_equal(_bits(o[f"d/{k}"]),
                                                  _bits(ld[k].numpy()))
                    np.testing.assert_array_equal(
                        _bits(o[f"r/{k}"][0, 0]), _bits(lr[k][d, m].numpy()))


# ------------------------------ placement -----------------------------------

def _jmesh(names, sizes):
    """What JAX's placement rules read of a mesh."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(sizes, dtype=object))


def _tmesh(names, sizes):
    return types.SimpleNamespace(axis_names=names, axis_sizes=sizes)


PLACEMENT_MESHES = [(("data", "model"), (2, 4)), (("data", "model"), (4, 2)),
                    (("data", "model"), (1, 4)),
                    (("pod", "data", "model"), (2, 2, 4))]


@pytest.mark.parametrize("names,sizes", PLACEMENT_MESHES)
def test_placement_specs_match_jax(monkeypatch, names, sizes):
    monkeypatch.setattr(jsharding, "NamedSharding", lambda mesh, spec: spec)
    jm, tm = _jmesh(names, sizes), _tmesh(names, sizes)
    if names == ("data", "model"):       # the port's own mesh, the same
        tm = LocalMesh(sizes[0], CPU, model=sizes[1])
    shapes = [(), (17,), (896, 4864), (4864, 896), (151936, 896),
              (24, 896, 128), (6, 9), (3, 8, 6), (40, 1536, 512), (5, 7)]
    for S in shapes:
        for mode in ("train", "serve"):
            assert tuple(tsharding.spec_for_param(("a",), S, tm, mode)) == \
                tuple(jsharding.spec_for_param(("a",), S, jm, mode)), \
                (S, mode)
    for batch in (1, 2, 4, 6, 16):
        for ndim in (2, 3):
            assert tuple(tsharding.batch_spec(tm, batch, ndim)) == \
                tuple(jsharding.batch_spec(jm, batch, ndim))
            assert tuple(tsharding.batch_sharding(tm, batch, ndim).spec) == \
                tuple(jsharding.batch_spec(jm, batch, ndim))
    for shape, kw in (((24, 8, 1024, 2, 64), dict(head_axis=3, seq_axis=2)),
                      ((24, 8, 1024, 8, 64), dict(head_axis=3, seq_axis=2)),
                      ((24, 6, 1000, 2, 64), dict(head_axis=3, seq_axis=2)),
                      ((24, 4, 512), dict(seq_axis=2))):
        assert tuple(tsharding.cache_sharding(tm, shape, **kw).spec) == \
            tuple(jsharding.cache_sharding(jm, shape, **kw)), shape
    tree = {"a": torch.zeros((2, 6, 8)), "b": torch.zeros((2,))}
    jtree = {k: jnp.zeros(v.shape) for k, v in tree.items()}
    for layout in ("1d", "2d"):
        got = tsharding.ef_residual_sharding(tree, tm, layout)
        want = jsharding.ef_residual_sharding(jtree, jm, layout)
        for k in tree:
            assert tuple(got[k].spec) == tuple(want[k]), (layout, k)
    assert tuple(tsharding.replicated(tm).spec) == tuple(
        jsharding.replicated(jm))
    # a parameter tree of the port, placed leaf by leaf
    p, _ = JetTagger.init(torch.Generator().manual_seed(0), _jcfg_torch(),
                          device="cpu")
    placed = tsharding.shard_tree(p, tm)
    for leaf, sh in zip(tree_leaves(p), tree_leaves(placed)):
        assert tuple(sh.spec) == tuple(jsharding.spec_for_param(
            (), leaf.shape, jm, "train"))


def test_constrain_and_registry_on_a_model_axis():
    mesh = LocalMesh(2, CPU, model=4)
    reg = taxes.registry_for_mesh(mesh)
    jreg = jaxes.registry_for_mesh(_jmesh(("data", "model"), (2, 4)))
    assert (reg.data_axes, reg.model_axis, reg.data_size, reg.model_size) \
        == (jreg.data_axes, jreg.model_axis, jreg.data_size, jreg.model_size)
    x = torch.zeros((4, 3, 8, 2))
    with taxes.axis_scope(reg), jaxes.axis_scope(jreg):
        assert taxes.constrain(x, "b.m.") is x
        for pat, shape in (("b.m.", (4, 3, 8, 2)), ("bm", (3, 6)),
                           (".b.m", (2, 2, 5, 12))):
            assert tuple(taxes.spec_for(pat, shape)) == \
                tuple(jaxes._spec_for(pat, shape)), pat
        with pytest.raises(ValueError, match="pattern"):
            taxes.constrain(x, "b.m")
        with pytest.raises(ValueError, match="bad axis"):
            taxes.constrain(x, "b.x.")


# --------------------------- head-TP attention ------------------------------

def test_head_tp_attention_matches_jax(monkeypatch):
    """The chunked attention with k / v repeated to full heads under a model
    axis of 2 (H = 4 over KV = 2) against JAX's branch, JAX's constrain the
    identity; the numbers equal the branch without the repeat."""
    monkeypatch.setattr(jattn, "constrain", lambda x, pattern: x)
    rng = np.random.default_rng(5)
    B, S, H, KV, hd = 2, 24, 4, 2, 8
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    jcfg = jattn.AttnConfig(d_model=H * hd, n_heads=H, n_kv=KV,
                            head_dim=hd, q_chunk=8, k_chunk=16, window=12)
    tcfg = tattn.AttnConfig(d_model=H * hd, n_heads=H, n_kv=KV,
                            head_dim=hd, q_chunk=8, k_chunk=16, window=12)
    pos = np.arange(S)
    reg, jreg = taxes.AxisRegistry(model_size=2), \
        jaxes.AxisRegistry(model_size=2)
    with jaxes.axis_scope(jreg):
        want = np.asarray(jattn._chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pos), jcfg, None, jhgq.TRAIN))
    with taxes.axis_scope(reg):
        got = tattn._chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(pos), tcfg, None, "train").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    plain = tattn._chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), tcfg, None, "train").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(plain))


# ---------------------- the 2D compressed train step -------------------------

QCFG = dict(weight_gran="per_parameter", act_gran="per_parameter",
            init_weight_f=2.0, init_act_f=2.0)
TCFG = dict(steps=20, lr=3e-3, beta0=1e-6, beta1=1e-3, gamma=2e-6)


def _jcfg_torch():
    from repro_torch.nn import HGQConfig
    return HGQConfig(**QCFG)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.fixture
def jax_reference_2d(monkeypatch):
    """The JAX step's exact-grid quantizer and the 2D collective's
    simulator (which the JAX package's 8-device tests hold equal to its
    shard_map collective)."""
    monkeypatch.setattr(jhgq, "quantize", j_hgq_quantize)
    monkeypatch.setattr(
        jcoll, "ef_wire_pmean_2d",
        lambda g, r, mesh, kind="int8", widths=None, fused=True:
        jcoll.simulate_wire_pmean_2d(
            g, r, dict(zip(mesh.axis_names, mesh.devices.shape))["model"],
            kind, widths=widths))


def test_compressed_2d_step_matches_jax(jax_reference_2d):
    """12 compressed steps over a 2 x 4 mesh at batch 256 from one init:
    loss (rel 1e-5), ~EBOPs (rel 1e-4) and beta against the JAX step at
    every step, step 0 within 1e-6; the final residuals of JAX's size."""
    D, M = 2, 4
    jp, jq = JJet.init(jax.random.PRNGKey(0), JCfg(**QCFG))
    tp, tq = from_jax(jax.tree.map(np.asarray, jp),
                      jax.tree.map(np.asarray, jq), device="cpu")
    batches = [j_jet_batch(0, s, 256) for s in range(12)]
    jstep = jax.jit(jloop.make_train_step(
        lambda p, q, b, mode: JJet.forward(p, q, b, mode),
        lambda o, b: jlosses.softmax_xent(o, b["y"]),
        jloop.TrainConfig(**TCFG), reduce="compressed",
        mesh=_jmesh(("data", "model"), (D, M)), wire_layout="auto"))
    jopt = joptim.adamw_init(jp)
    jef = JEFState(residual=jcoll.ef_wire2d_init(jp, D, M))
    tstep = make_train_step(
        lambda p, q, b, mode: JetTagger.forward(p, q, b, mode),
        lambda o, b: tlosses.softmax_xent(o, b["y"]), TrainConfig(**TCFG),
        reduce="compressed", mesh=LocalMesh(D, CPU, model=M))
    topt = toptim.adamw_init(tp)
    tef = EFState(residual=tcoll.ef_wire2d_init(tp, D, M))
    for s, b in enumerate(batches):
        jp, jq, jopt, jm, jef = jstep(jp, jq, jopt, b, jnp.int32(s), jef)
        tp, tq, topt, tm, tef = tstep(
            tp, tq, topt, {k: torch.tensor(np.asarray(v))
                           for k, v in b.items()}, s, tef)
        g = {k: _rel(tm[k], jm[k]) for k in ("loss", "ebops", "beta")}
        lim = 1e-6 if s == 0 else None
        assert g["loss"] <= (lim or 1e-5), (s, g)
        assert g["ebops"] <= (lim or 1e-4), (s, g)
        assert g["beta"] <= 1e-6, (s, g)
    for a, b in zip(tree_leaves(tef.residual), jax.tree.leaves(jef.residual)):
        assert tuple(a.shape) == b.shape


def test_pure_tp_mesh_takes_the_sliced_step():
    """A 1 x 4 mesh takes the sliced wire (not the post-reduce path): the
    step takes the [1, 4, C] residual, trains and keeps the layout."""
    p, q = JetTagger.init(torch.Generator().manual_seed(0), _jcfg_torch(),
                          device="cpu")
    from repro_torch.data import DataSpec, make_pipeline
    pipe = make_pipeline(DataSpec(kind="jet", batch=64), device="cpu")
    step = make_train_step(
        lambda p_, q_, b, mode: JetTagger.forward(p_, q_, b, mode),
        lambda o, b: tlosses.softmax_xent(o, b["y"]),
        TrainConfig(steps=4, lr=3e-3), reduce="compressed",
        mesh=LocalMesh(1, CPU, model=4))
    ef = EFState(residual=tcoll.ef_wire2d_init(p, 1, 4))
    o, losses = toptim.adamw_init(p), []
    for s in range(4):
        p, q, o, m, ef = step(p, q, o, pipe(s), s, ef)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(r.shape[:2] == (1, 4) and r.abs().sum() > 0
               for r in tree_leaves(ef.residual))


# ----------------------- the api: resume and rescale ------------------------

def _spec(tmp, *extra):
    return RunSpec.from_args(["--spec", SPEC_2X4, "--ckpt-dir", str(tmp),
                              *extra])


def test_sliced_residual_resumes_exactly_and_rescales_to_zero(tmp_path):
    """host_2x4_int8wire2d.json at SMOKE: 4 uninterrupted steps equal 2
    steps, a checkpoint, a resume into a fresh setup and 2 more, params and
    residual bit for bit; a 4 x 2 mesh resumes the params and restarts the
    residual at zero with a warning."""
    def run(steps, setup):
        for s in range(setup.start_step, steps):
            setup.step(s)
        return setup

    whole = run(4, build(_spec(tmp_path / "none"), device=CPU)
                .init_training())
    assert whole.ctx.mesh.axis_sizes == (2, 4)
    first = run(2, build(_spec(tmp_path / "a"), device=CPU).init_training())
    first.checkpoint(2)
    resumed = build(_spec(tmp_path / "a"), device=CPU).init_training()
    assert resumed.maybe_resume(log=lambda *a: None)
    assert resumed.start_step == 2
    run(4, resumed)
    for a, b in zip(tree_leaves((resumed.params, resumed.ef_state)),
                    tree_leaves((whole.params, whole.ef_state))):
        assert torch.equal(a, b)
    msgs = []
    spec42 = RunSpec.from_args(["--spec", SPEC_2X4, "--mesh", "4x2",
                                "--ckpt-dir", str(tmp_path / "a")])
    other = build(spec42, device=CPU).init_training()
    assert other.maybe_resume(log=msgs.append)
    assert any("restarting it at zero" in m for m in msgs), msgs
    assert all(not r.any() for r in tree_leaves(other.ef_state.residual))
    assert all(r.shape[:2] == (4, 2) for r in tree_leaves(
        other.ef_state.residual))
    for a, b in zip(tree_leaves(other.params), tree_leaves(first.params)):
        assert torch.equal(a, b)
    other.step(2)
