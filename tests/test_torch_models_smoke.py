"""Per-arch smoke tests of the port (the counterpart of
``tests/test_models_smoke.py``): every architecture's SMOKE config runs,
on the CPU, a TRAIN forward, one AdamW step and two decode steps, port
only.  Checks: finite logits of the right shape and nonzero ~EBOPs; the
loss finite before and after the step; some bitwidth ``f`` leaf with a
nonzero gradient; both decode steps finite; and the TRAIN forward's new
qstate with the init qstate's leaf paths (so a trained qstate takes the
next step and builds an engine)."""
import pytest
import torch

from repro_torch.configs import ARCHS, get
from repro_torch.core import hgq
from repro_torch.models import model_for
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.train import lm_loss
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_unflatten)

CPU = "cpu"


def _batch(cfg, gen, B=2, S=16):
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen)}
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                        generator=gen)
    if cfg.family == "audio":
        b["frame_embeds"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                        generator=gen)
    return b


def _paths(tree):
    return [p for p, _ in tree_flatten_with_path(tree)]


def _init(arch):
    cfg = get(arch, smoke=True)
    M = model_for(cfg)
    gen = torch.Generator().manual_seed(0)
    p, q = M.init(gen, cfg, device=CPU)
    return cfg, M, p, q, gen


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    cfg, M, p, q, gen = _init(arch)
    batch = _batch(cfg, gen)
    B, S = batch["tokens"].shape

    def loss_fn(params):
        out, nq, aux = M.forward(params, q, batch, cfg, mode=hgq.TRAIN)
        return lm_loss(out, batch["tokens"]) + 1e-9 * aux.ebops, out, nq, aux

    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
    loss, logits, newq, aux = loss_fn(tree_unflatten(p, leaves))
    assert logits.shape == (B, S, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), f"{arch}: logits not finite"
    assert float(aux.ebops.detach()) > 0, f"{arch}: ~EBOPs inactive"
    assert _paths(newq) == _paths(q), f"{arch}: the new qstate's leaf paths"
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    assert bool(torch.isfinite(loss))
    f_grads = [g for (path, _), g in zip(tree_flatten_with_path(p), grads)
               if "f" in path]
    assert f_grads and any(float(g.abs().max()) > 0 for g in f_grads), \
        f"{arch}: no gradient reached the trainable bitwidths"
    p2, _ = adamw_update(tree_unflatten(p, grads), adamw_init(p), p,
                         lr=1e-3)
    with torch.no_grad():
        loss2 = loss_fn(p2)[0]
    assert bool(torch.isfinite(loss2)), f"{arch}: loss after the step"


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step(arch):
    cfg, M, p, q, gen = _init(arch)
    B = 2
    cache = M.init_cache(cfg, B, 32, device=CPU)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen)
    with torch.no_grad():
        if cfg.family == "audio":
            cache = M.prefill_cross(p, q, cache, torch.randn(
                (B, cfg.enc_seq, cfg.d_model), generator=gen), cfg)
        logits, cache = M.decode_step(p, q, cache, tok, 0, cfg)
        assert logits.shape == (B, 1, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
        logits2, _ = M.decode_step(p, q, cache, tok, 1, cfg)
    assert bool(torch.isfinite(logits2).all())
