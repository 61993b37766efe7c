"""block_select_search (ops/exact.py): two-phase block-min scan.

Contracts: exact_phase1=True reproduces exact_search_tiled bit-for-bit
(the block-selection identity is lossless when blocks_k >= k); bf16
phase-1 keeps recall ~1.0 with exact reported distances; validity masking
holds in both phases.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_tpu.ops.exact import block_select_search, exact_search_tiled


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    n, dim, b = 12000, 64, 32
    x = (rng.normal(size=(n, dim)) * 2).astype(np.float32)
    q = (rng.normal(size=(b, dim)) * 2).astype(np.float32)
    valid = np.ones((n,), bool)
    valid[::97] = False
    return jnp.asarray(x), jnp.asarray(q), jnp.asarray(valid)


def test_exact_phase1_matches_exact_scan(data):
    xd, qd, valid = data
    xsq = jnp.sum(xd * xd, -1)
    gd, gi = exact_search_tiled(qd, xd, valid, 10, tile=4096)
    dd, ii = block_select_search(qd, xd, qd, xsq, xd, valid, 10,
                                 tile=4096, block=128, exact_phase1=True)
    np.testing.assert_array_equal(np.asarray(ii), np.asarray(gi))
    np.testing.assert_allclose(np.asarray(dd), np.asarray(gd), rtol=1e-5)


def test_bf16_phase1_high_recall_exact_distances(data):
    xd, qd, valid = data
    xsq = jnp.sum(xd * xd, -1)
    gd, gi = exact_search_tiled(qd, xd, valid, 10, tile=4096)
    dd, ii = block_select_search(qd, xd.astype(jnp.bfloat16), qd, xsq,
                                 xd, valid, 10, tile=4096, block=128)
    ii, gi = np.asarray(ii), np.asarray(gi)
    rec = np.mean([len(set(ii[i].tolist()) & set(gi[i].tolist())) / 10
                   for i in range(len(gi))])
    assert rec >= 0.99
    # reported distances are exact f32 for whatever was selected
    x_np, q_np = np.asarray(xd), np.asarray(qd)
    for i in range(4):
        sel = ii[i][ii[i] >= 0]
        dref = ((q_np[i] - x_np[sel]) ** 2).sum(-1)
        np.testing.assert_allclose(np.asarray(dd)[i][: len(sel)], dref,
                                   rtol=1e-4)


def test_exact_phase1_minimal_blocks_k_still_lossless(data):
    # the selection identity needs only blocks_k >= k under EXACT block
    # selection (the default); blocks_k=k halves phase-2 gather traffic
    xd, qd, valid = data
    xsq = jnp.sum(xd * xd, -1)
    gd, gi = exact_search_tiled(qd, xd, valid, 10, tile=4096)
    dd, ii = block_select_search(qd, xd, qd, xsq, xd, valid, 10,
                                 tile=4096, block=128, blocks_k=10,
                                 exact_phase1=True)
    np.testing.assert_array_equal(np.asarray(ii), np.asarray(gi))


def test_approx_blocks_opt_in(data):
    # approx_blocks=True restores the hardware partial-reduce; recall may
    # drop below 1.0 but the path must stay valid and exact-distance
    xd, qd, valid = data
    xsq = jnp.sum(xd * xd, -1)
    gd, gi = exact_search_tiled(qd, xd, valid, 10, tile=4096)
    dd, ii = block_select_search(qd, xd, qd, xsq, xd, valid, 10,
                                 tile=4096, block=128, exact_phase1=True,
                                 approx_blocks=True)
    ii, gi = np.asarray(ii), np.asarray(gi)
    rec = np.mean([len(set(ii[i].tolist()) & set(gi[i].tolist())) / 10
                   for i in range(len(gi))])
    assert rec >= 0.9


def test_masked_rows_never_returned(data):
    xd, qd, valid = data
    xsq = jnp.sum(xd * xd, -1)
    dd, ii = block_select_search(qd, xd, qd, xsq, xd, valid, 10,
                                 tile=4096, block=128, exact_phase1=True)
    bad = set(np.nonzero(~np.asarray(valid))[0].tolist())
    assert not (set(np.asarray(ii).ravel().tolist()) & bad)


def test_tiny_corpus_padding():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    xd, qd = jnp.asarray(x), jnp.asarray(q)
    valid = jnp.ones((300,), bool)
    xsq = jnp.sum(xd * xd, -1)
    dd, ii = block_select_search(qd, xd, qd, xsq, xd, valid, 5,
                                 tile=512, block=128, exact_phase1=True)
    gd, gi = exact_search_tiled(qd, xd, valid, 5, tile=512)
    np.testing.assert_array_equal(np.asarray(ii), np.asarray(gi))


def test_hilo_phase1_matches_exact(data):
    # 3-pass bf16 hi/lo phase 1 (pseudo-f32): with a blocks_k margin the
    # selected blocks cover the true top-k and phase 2 rescores exactly
    xd, qd, valid = data
    xsq = jnp.sum(xd * xd, -1)
    gd, gi = exact_search_tiled(qd, xd, valid, 10, tile=4096)
    dd, ii = block_select_search(qd, xd, qd, xsq, xd, valid, 10,
                                 tile=4096, block=128, blocks_k=20,
                                 hilo_phase1=True)
    np.testing.assert_array_equal(np.asarray(ii), np.asarray(gi))
    np.testing.assert_allclose(np.asarray(dd), np.asarray(gd), rtol=1e-5)


def test_three_phase_low_rank_mirror():
    # production analogue: low-rank corpus, half-dim PCA mirror — the
    # mirror row-rescore cut must keep the true top-k (recall 1.0) and
    # phase 3 must return exact distances
    from vector_db_tpu.ops.exact import block_select_search_3p

    rng = np.random.default_rng(3)
    N, D, B, K = 8192, 64, 16, 5
    A = rng.standard_normal((24, D)).astype(np.float32)
    x = (rng.standard_normal((N, 24)).astype(np.float32) @ A
         + 0.01 * rng.standard_normal((N, D)).astype(np.float32))
    q = (rng.standard_normal((B, 24)).astype(np.float32) @ A
         + 0.01 * rng.standard_normal((B, D)).astype(np.float32))
    emb, qd = jnp.asarray(x), jnp.asarray(q)
    valid = jnp.ones((N,), bool)
    xsq = jnp.sum(emb * emb, -1)
    cov = np.asarray(jnp.dot(emb.T, emb)) / N
    _, v = np.linalg.eigh(cov.astype(np.float64))
    proj = jnp.asarray(v[:, ::-1][:, :32].astype(np.float32))
    tab = jnp.dot(emb, proj).astype(jnp.bfloat16)
    qp = jnp.dot(qd, proj)
    d, i = block_select_search_3p(qd, tab, qp, xsq, emb, valid, K,
                                  block=128, blocks_k=20, rows_k=64)
    gd, gi = exact_search_tiled(qd, emb, valid, K, tile=1024)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(gi))
    np.testing.assert_allclose(np.asarray(d), np.asarray(gd), rtol=1e-5)


def test_three_phase_masked_and_padded():
    from vector_db_tpu.ops.exact import block_select_search_3p

    rng = np.random.default_rng(4)
    N, D, B, K = 3000, 32, 8, 4   # N not a tile multiple
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    emb, qd = jnp.asarray(x), jnp.asarray(q)
    vm = np.ones((N,), bool); vm[::5] = False
    valid = jnp.asarray(vm)
    xsq = jnp.sum(emb * emb, -1)
    tab = emb.astype(jnp.bfloat16)
    d, i = block_select_search_3p(qd, tab, qd, xsq, emb, valid, K,
                                  block=128, blocks_k=12, rows_k=48)
    gd, gi = exact_search_tiled(qd, emb, valid, K, tile=1024)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(gi))
    assert not (set(np.asarray(i).ravel().tolist())
                & set(np.nonzero(~vm)[0].tolist()))


def test_3p_p2_chunk_equivalence(data):
    """The candidate-chunked phase 2 must return identical results to
    the one-shot gather (pure temp-size change)."""
    from vector_db_tpu.ops.exact import block_select_search_3p

    xd, qd, valid = data
    xsq = jnp.sum(xd * xd, -1)
    ptab = xd.astype(jnp.bfloat16)
    a = block_select_search_3p(qd, ptab, qd, xsq, xd, valid, 10,
                               blocks_k=8, rows_k=64)
    b = block_select_search_3p(qd, ptab, qd, xsq, xd, valid, 10,
                               blocks_k=8, rows_k=64, p2_chunk=2)
    assert (np.asarray(a[1]) == np.asarray(b[1])).all()
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                               rtol=1e-6)
