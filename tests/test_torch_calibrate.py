"""Port parity: calibration (Eq. 3) and the bit-exact fixed-point proxy of
``repro_torch.core.{calibrate,fixedpoint}`` against the JAX package, and
the port's versions of ``tests/test_calibrate_fixedpoint.py``.

Specs and fixed-point values are compared bit for bit at b <= 24 and
|x * 2^f| < 2^23, where the port's float64 and JAX's float32 are both
exact.  Inputs are made
with numpy from a seed (the JAX tests draw them with hypothesis)."""
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    import jax.numpy as jnp
    import repro.dist  # noqa: F401  (repro.nn imports repro.dist lazily)
    from repro.core import calibrate as jcal
    from repro.core import fixedpoint as jfix
    from repro.core.hgq import ActState as JState
    from repro.models import JetTagger as JJet
    from repro.nn import HGQConfig as JCfg

from repro_torch.core import hgq
from repro_torch.core.calibrate import (FixedSpec, assert_no_overflow,
                                        fixed_spec_for_weights,
                                        fixed_spec_from_range, int_bits_exact)
from repro_torch.core.fixedpoint import representable, to_fixed
from repro_torch.core.hgq import ActState
from repro_torch.core.quantizer import quantize_inference
from repro_torch.data import jet_batch
from repro_torch.models import JetTagger
from repro_torch.weights import from_jax


def _lists(seed):
    """Float lists like the JAX tests' hypothesis strategy: 1-64 values in
    [-64, 64], some exactly on powers of two and grid points."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 65))
    xs = rng.uniform(-64, 64, n)
    pick = rng.random(n)
    xs = np.where(pick < 0.2, np.round(xs), xs)
    xs = np.where(pick > 0.9, 2.0 ** rng.integers(-6, 6, n)
                  * np.sign(xs), xs)
    return xs.astype(np.float32), int(rng.integers(0, 9))


def _spec_equal(t: FixedSpec, j) -> None:
    for a, b in zip(t, j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", range(12))
def test_calibrated_spec_never_overflows_calib_data(seed):
    xs, f = _lists(seed)
    x, ff = torch.from_numpy(xs), torch.tensor(float(f))
    spec = fixed_spec_from_range(ActState(x.min(), x.max()), ff)
    _spec_equal(spec, jcal.fixed_spec_from_range(
        JState(jnp.min(xs), jnp.max(xs)), jnp.float32(f)))
    assert bool(assert_no_overflow(x, spec, ff))


@pytest.mark.parametrize("seed", range(12))
def test_fixed_emulation_bit_exact_in_range(seed):
    xs, f = _lists(100 + seed)
    x, ff = torch.from_numpy(xs), torch.tensor(float(f))
    spec = fixed_spec_from_range(ActState(x.min(), x.max()), ff)
    got = to_fixed(x, spec, ff)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, quantize_inference(x, ff), rtol=0, atol=0)
    jspec = jcal.fixed_spec_from_range(JState(jnp.min(xs), jnp.max(xs)),
                                       jnp.float32(f))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfix.to_fixed(jnp.asarray(xs), jspec,
                                              jnp.float32(f))))
    assert bool(representable(x, spec, ff).all())


def _spec(b, i, signed):
    return FixedSpec(bits=torch.tensor(float(b)), int_bits=torch.tensor(
        float(i)), signed=torch.tensor(signed))


def test_wraparound_overflow_eq1():
    """Eq. (1): signed fixed<3,3> covers [-4, 3]; 4 wraps to -4."""
    spec, f = _spec(3, 3, True), torch.tensor(0.0)
    for x, want in ((3.0, 3.0), (4.0, -4.0), (5.0, -3.0), (-5.0, 3.0)):
        assert float(to_fixed(torch.tensor(x), spec, f)) == want
    assert not bool(representable(torch.tensor(4.0), spec, f))


def test_wraparound_exact_at_ulp_off_widths():
    """b = 13, where exp2 is an ulp off, wraps exactly at +-2^(b-1)."""
    spec, f = _spec(13, 13, True), torch.tensor(0.0)
    for x, want in ((4095.0, 4095.0), (4096.0, -4096.0), (-4097.0, 4095.0)):
        assert float(to_fixed(torch.tensor(x), spec, f)) == want


def test_unsigned_wraparound_eq2():
    spec, f = _spec(2, 2, False), torch.tensor(0.0)
    assert float(to_fixed(torch.tensor(3.0), spec, f)) == 3.0
    assert float(to_fixed(torch.tensor(4.0), spec, f)) == 0.0


@pytest.mark.parametrize("b,signed", [(3, True), (8, False), (13, True),
                                      (16, True), (24, False), (0, True)])
def test_to_fixed_matches_jax_with_wrap(b, signed):
    rng = np.random.default_rng(b)
    # |x * 2^f| stays below 2^23, where JAX's float32 rounding is exact too
    x = (rng.normal(size=300) * 2.0 ** (min(b, 19) - 3)).astype(np.float32)
    f = rng.integers(-2, 5, 300).astype(np.float32)
    for i in (b - 2, b):
        spec = _spec(b, i, signed)
        jspec = jcal.FixedSpec(jnp.float32(b), jnp.float32(i),
                               jnp.bool_(signed))
        np.testing.assert_array_equal(
            to_fixed(torch.from_numpy(x), spec, torch.from_numpy(f)).numpy(),
            np.asarray(jfix.to_fixed(jnp.asarray(x), jspec, jnp.asarray(f))))
        np.testing.assert_array_equal(
            representable(torch.from_numpy(x), spec,
                          torch.from_numpy(f)).numpy(),
            np.asarray(jfix.representable(jnp.asarray(x), jspec,
                                          jnp.asarray(f))))


def test_int_bits_and_weight_specs_match_jax():
    rng = np.random.default_rng(4)
    vals = np.concatenate([[0.0, 8192.0, -8192.0, 0.25, -0.25, 1e-30],
                           rng.normal(size=60) * 100]).astype(np.float32)
    vmin = np.minimum(vals, np.roll(vals, 7)).astype(np.float32)
    vmax = np.maximum(vals, np.roll(vals, 3)).astype(np.float32)
    f = rng.uniform(-2, 8, vals.shape).astype(np.float32)
    for margin in (0.0, 1.0):
        np.testing.assert_array_equal(
            int_bits_exact(torch.from_numpy(vmin), torch.from_numpy(vmax),
                           torch.from_numpy(f), margin).numpy(),
            np.asarray(jcal.int_bits_exact(jnp.asarray(vmin),
                                           jnp.asarray(vmax),
                                           jnp.asarray(f), margin)))
    w = (rng.normal(size=(16, 8)) * 0.5).astype(np.float32)
    w[:, 3] = 0.0
    for fw in (rng.uniform(0, 6, (16, 8)), rng.uniform(0, 6, (1, 8)),
               np.float32(3.0)):
        fw = np.asarray(fw, np.float32)
        _spec_equal(fixed_spec_for_weights(torch.from_numpy(w),
                                           torch.from_numpy(fw)),
                    jcal.fixed_spec_for_weights(jnp.asarray(w),
                                                jnp.asarray(fw)))


def test_jet_model_proxy_bit_exact():
    """The proxy-model check on the jet tagger, on JAX's weights carried
    over: CALIB ranges cover the calibration data and equal JAX's, and the
    EVAL forward is reproducible and equals JAX's bit for bit."""
    cfg = dict(weight_gran="per_parameter", act_gran="per_parameter",
               init_weight_f=3, init_act_f=3)
    jp, jq = JJet.init(jax.random.PRNGKey(0), JCfg(**cfg))
    p, q = from_jax(jax.tree.map(np.asarray, jp),
                    jax.tree.map(np.asarray, jq), device="cpu")
    calib = jet_batch(0, 0, 512, device="cpu")
    _, q_cal, _ = JetTagger.forward(p, q, calib, mode=hgq.CALIB)
    spec = fixed_spec_from_range(q_cal["inp"], p["inp_f"])
    assert bool(assert_no_overflow(calib["x"], spec, p["inp_f"]))
    o1, _, _ = JetTagger.forward(p, q_cal, calib, mode=hgq.EVAL)
    o2, _, _ = JetTagger.forward(p, q_cal, calib, mode=hgq.EVAL)
    assert torch.equal(o1, o2)
    jcalib = {"x": jnp.asarray(calib["x"].numpy()),
              "y": jnp.asarray(calib["y"].numpy())}
    _, jq_cal, _ = JJet.forward(jp, jq, jcalib, mode="calib")
    np.testing.assert_array_equal(q_cal["inp"].vmin.numpy(),
                                  np.asarray(jq_cal["inp"].vmin))
    _spec_equal(spec, jcal.fixed_spec_from_range(jq_cal["inp"], jp["inp_f"]))
    jo, _, _ = JJet.forward(jp, jq_cal, jcalib, mode="eval")
    np.testing.assert_array_equal(o1.numpy(), np.asarray(jo))
