"""``repro_torch.launch.analytic`` against the JAX package's
``repro.launch.analytic``: the same arithmetic on the port's configs, so
every number is equal, float for float, on every arch x shape cell, at
1, 8, 256 and 512 chips, weight bits 16 and 8 and cache bytes 2 and 1."""
import warnings

import pytest

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get as j_get
    from repro.launch import analytic as janalytic

from repro_torch.configs import ARCHS, SHAPES, get
from repro_torch.launch import analytic

CHIPS = (1, 8, 256, 512)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_equals_reference(arch):
    cfg, jcfg = get(arch), j_get(arch)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert set(SHAPES) == set(J_SHAPES)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == (
            jshape.seq_len, jshape.global_batch, jshape.kind)
        assert analytic.analytic_flops_total(cfg, shape) == \
            janalytic.analytic_flops_total(jcfg, jshape), (arch, name)
        assert analytic._cache_bytes_total(cfg, shape) == \
            janalytic._cache_bytes_total(jcfg, jshape)
        for chips in CHIPS:
            for tp in (1, 16):
                for wb in (16.0, 8.0):
                    for cb in (2.0, 1.0):
                        got = analytic.hbm_bytes_per_chip(
                            cfg, shape, chips, tp, weight_bits=wb,
                            cache_bytes=cb)
                        want = janalytic.hbm_bytes_per_chip(
                            jcfg, jshape, chips, tp, weight_bits=wb,
                            cache_bytes=cb)
                        assert got == want, (arch, name, chips, tp, wb, cb)
