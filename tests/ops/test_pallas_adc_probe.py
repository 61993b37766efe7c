"""IVF-PQ probe LUT scoring (ivf.adc_scores, the XLA "gather"
formulation) against a numpy LUT-gather oracle, and the refusal of
removed formulations."""

import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_tpu.index.ivf import ADC_MODES, adc_scores, check_adc


def _oracle(lut, codes):
    m = codes.shape[1]
    return lut[np.arange(m)[None, :], codes].sum(axis=1)


def _scores(lut, codes):
    m, ksub = lut.shape
    return np.asarray(adc_scores(jnp.asarray(lut.reshape(-1)),
                                 jnp.asarray(codes), ksub))


def test_adc_probe_matches_oracle(rng):
    m, ksub, p = 4, 16, 70
    lut = rng.standard_normal((m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, (p, m)).astype(np.uint8)
    want = _oracle(lut, codes)
    # the same f32 terms summed in another order
    np.testing.assert_allclose(_scores(lut, codes), want,
                               rtol=2e-4, atol=2e-3)


def test_adc_probe_production_shape(rng):
    """The 1M-class probe shape: m=16 subspaces x ksub=256."""
    m, ksub, p = 16, 256, 2048
    lut = (rng.standard_normal((m, ksub)) ** 2).astype(np.float32)
    codes = rng.integers(0, ksub, (p, m)).astype(np.uint8)
    want = _oracle(lut, codes)
    np.testing.assert_allclose(_scores(lut, codes), want,
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("adc", ADC_MODES)
def test_adc_formulation_preserves_order(rng, adc):
    """The formulation ranks candidates as the f32 oracle does."""
    check_adc(adc)
    m, ksub, p = 8, 64, 512
    lut = (rng.random((m, ksub)) * 100).astype(np.float32)
    codes = rng.integers(0, ksub, (p, m)).astype(np.uint8)
    want = np.argsort(_oracle(lut, codes), kind="stable")[:10]
    got = np.argsort(_scores(lut, codes), kind="stable")[:10]
    assert len(set(want) & set(got)) >= 9


@pytest.mark.parametrize("adc", ["pallas", "pallas_interp", "onehot",
                                 "onehot8"])
def test_removed_formulation_refused(adc):
    with pytest.raises(ValueError, match="unknown IVF-PQ adc"):
        check_adc(adc)
