"""Block minima — the 3-phase search's phase 1, now the m=1 block top-m
scan (ops/pallas/block_topm.py) — vs the XLA oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_tpu.ops.pallas.block_topm import block_topm_scan


def block_min_scan(q, tab, xsq_eff):
    mins, _ = block_topm_scan(q, tab, xsq_eff, block=128, m=1)
    return mins


@pytest.mark.parametrize("n,ds,b", [(4096 + 512, 64, 37), (2048, 128, 8)])
def test_matches_xla_oracle(n, ds, b):
    rng = np.random.default_rng(0)
    tab = jnp.asarray(
        rng.standard_normal((n, ds)).astype(np.float32)
    ).astype(jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((b, ds)).astype(np.float32))
    xsq = jnp.asarray((rng.random(n) * 10).astype(np.float32))
    vm = np.ones(n, bool)
    vm[::13] = False
    xsq_eff = jnp.where(jnp.asarray(vm), xsq, 2.0e38)

    mins = block_min_scan(q, tab, xsq_eff)

    cross = jnp.dot(q.astype(jnp.bfloat16), tab.T,
                    preferred_element_type=jnp.float32)
    d = xsq_eff[None, :] - 2.0 * cross
    pad = (-n) % 128
    if pad:
        d = jnp.concatenate([d, jnp.full((b, pad), 2.0e38)], axis=1)
    oracle = jnp.min(d.reshape(b, -1, 128), axis=-1)
    assert mins.shape == oracle.shape
    np.testing.assert_allclose(np.asarray(mins), np.asarray(oracle),
                               rtol=1e-6, atol=1e-5)


def test_fully_invalid_block_exceeds_threshold():
    rng = np.random.default_rng(1)
    n, ds, b = 1024, 32, 4
    tab = jnp.asarray(
        rng.standard_normal((n, ds)).astype(np.float32)
    ).astype(jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((b, ds)).astype(np.float32))
    xsq_eff = jnp.where(
        jnp.arange(n) < 128, 2.0e38,
        jnp.asarray((rng.random(n)).astype(np.float32)))
    mins = block_min_scan(q, tab, xsq_eff)
    assert bool((np.asarray(mins[:, 0]) > 1.0e37).all())
    assert bool((np.asarray(mins[:, 1:]) < 1.0e37).all())


def test_three_phase_with_pallas_phase1_matches():
    """The 3-phase search with its block top-m phase 1 returns the exact
    top-k."""
    from vector_db_tpu.ops.exact import (
        block_select_search_3p,
        exact_search_tiled,
    )

    rng = np.random.default_rng(3)
    n, d_dim, b, k = 8192, 64, 16, 5
    a = rng.standard_normal((24, d_dim)).astype(np.float32)
    x = (rng.standard_normal((n, 24)).astype(np.float32) @ a
         + 0.01 * rng.standard_normal((n, d_dim)).astype(np.float32))
    q = (rng.standard_normal((b, 24)).astype(np.float32) @ a
         + 0.01 * rng.standard_normal((b, d_dim)).astype(np.float32))
    emb, qd = jnp.asarray(x), jnp.asarray(q)
    valid = jnp.ones((n,), bool)
    xsq = jnp.sum(emb * emb, -1)
    cov = np.asarray(jnp.dot(emb.T, emb)) / n
    _, v = np.linalg.eigh(cov.astype(np.float64))
    proj = jnp.asarray(v[:, ::-1][:, :32].astype(np.float32))
    tab = jnp.dot(emb, proj).astype(jnp.bfloat16)
    qp = jnp.dot(qd, proj)
    gd, gi = exact_search_tiled(qd, emb, valid, k, tile=1024)
    dd, ii = block_select_search_3p(qd, tab, qp, xsq, emb, valid, k,
                                    block=128, blocks_k=20, rows_k=64)
    np.testing.assert_array_equal(np.asarray(ii), np.asarray(gi))
    np.testing.assert_allclose(np.asarray(dd), np.asarray(gd), rtol=1e-5)
