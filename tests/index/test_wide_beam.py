"""Wide-beam search correctness (index/wide_beam.py).

Mirrors the reference's recall-vs-brute-force contract
(reference tests/indexing/test_hnsw.py:127-153) for the
frontier-parallel formulation: recall against exact ground truth, exact
reported distances, no duplicate results, deletion masking.
"""

import random

import numpy as np
import pytest

from vector_db_tpu.index.hnsw import HNSW


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    n, dim = 4000, 48
    x = rng.normal(size=(n, dim)).astype(np.float32)
    q = rng.normal(size=(50, dim)).astype(np.float32)
    idx = HNSW(M=8, ef_construction=100, rng=random.Random(42),
               capacity=n, l_max=4)
    idx.bulk_build(list(range(n)), x)
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]
    return idx, x, q, gt


def _recall(ids, gt, k=10):
    return float(np.mean(
        [len(set(ids[i].tolist()) & set(gt[i].tolist())) / k
         for i in range(len(gt))]
    ))


def test_wide_recall_vs_brute_force(built):
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    dists, ids = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                       steps=12)
    assert _recall(ids, gt) >= 0.9


def test_wide_frontier_schedule(built):
    """A shrinking frontier schedule at the same total expansion budget
    must stay within noise of the fixed-F recall (the wide-early /
    narrow-late shape is the cheaper way to spend the same budget)."""
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    _, ids_fixed = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                         steps=12)
    # budget 32*12 = 384 = 64*3 + 32*3 + 16*6
    _, ids_sched = idx.search_batch_wide(
        q, k=10, ef=256, schedule=((64, 3), (32, 3), (16, 6)))
    assert _recall(ids_sched, gt) >= _recall(ids_fixed, gt) - 0.03


def test_wide_filter_ids(built):
    """Reference filter contract (reference hnsw.py:81-88,127-131):
    only matching ids in results; recall vs brute force over the filter
    set; non-matching nodes still navigate."""
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    rng = np.random.default_rng(3)
    allowed = set(int(i) for i in
                  rng.choice(len(x), size=len(x) // 5, replace=False))
    dists, ids = idx.search_batch_wide(
        q, k=10, ef=256, frontier=32, steps=12, rerank_k=128,
        filter_ids=allowed)
    al = np.asarray(sorted(allowed))
    d = ((q[:, None] - x[al][None]) ** 2).sum(-1)
    gt_f = al[np.argsort(d, 1)[:, :10]]
    for i in range(len(q)):
        got = [int(v) for v in ids[i] if v >= 0]
        assert all(g in allowed for g in got), "non-matching id returned"
    assert _recall(ids, gt_f) >= 0.85


def test_wide_filter_with_schedule(built):
    """filter_ids composes with a frontier schedule (both touch the scan
    carry): subset contract and recall must hold together."""
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    rng = np.random.default_rng(5)
    allowed = set(int(i) for i in
                  rng.choice(len(x), size=len(x) // 4, replace=False))
    _, ids = idx.search_batch_wide(
        q, k=10, ef=256, schedule=((64, 4), (32, 4), (16, 4)),
        rerank_k=128, filter_ids=allowed)
    al = np.asarray(sorted(allowed))
    d = ((q[:, None] - x[al][None]) ** 2).sum(-1)
    gt_f = al[np.argsort(d, 1)[:, :10]]
    for i in range(len(q)):
        assert all(int(v) in allowed for v in ids[i] if v >= 0)
    assert _recall(ids, gt_f) >= 0.85


def test_wide_filter_tiny_set(built):
    """A filter of a handful of ids must never return outsiders (results
    may be partial: navigation is unfiltered, per the reference)."""
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    allowed = {5, 77, 1234}
    _, ids = idx.search_batch_wide(q[:8], k=3, ef=256, frontier=32,
                                   steps=12, filter_ids=allowed)
    for i in range(8):
        got = set(int(v) for v in ids[i] if v >= 0)
        assert got <= allowed


def test_wide_exact_distances_sorted_no_dups(built):
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    dists, ids = idx.search_batch_wide(q, k=10, ef=128, frontier=16,
                                       steps=10)
    for i in range(len(q)):
        valid = ids[i][ids[i] >= 0]
        assert len(set(valid.tolist())) == len(valid)
        dref = np.sqrt(((q[i] - x[valid]) ** 2).sum(-1))
        np.testing.assert_allclose(dists[i][: len(valid)], dref, rtol=1e-4)
        assert np.all(np.diff(dists[i][: len(valid)]) >= -1e-5)


def test_wide_requires_enable(built):
    idx2 = HNSW(M=8, ef_construction=50, rng=random.Random(1), capacity=256)
    with pytest.raises(ValueError):
        idx2.search_batch_wide(np.zeros((1, 8), np.float32), k=5)


def test_wide_excludes_deleted(built):
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    # delete the top-1 hit of query 0; mirror must lazily rebuild (the
    # delete swaps graph arrays) and the node must vanish from results
    _, ids0 = idx.search_batch_wide(q[:1], k=5, ef=128, frontier=16,
                                    steps=10)
    victim = int(ids0[0, 0])
    idx.delete_node(victim)
    try:
        _, ids1 = idx.search_batch_wide(q[:1], k=5, ef=128, frontier=16,
                                        steps=10)
        assert victim not in set(ids1[0].tolist())
    finally:
        # restore for other tests (module-scoped fixture)
        from vector_db_tpu.types import Node

        idx.insert_nodes([Node(id=victim, embedding=x[victim],
                               metadata={}, content=None)])


def test_wide_pq_score_full_rerank(built):
    """ADC-scored wide traversal (HNSW-over-PQ hybrid): with a full-pool
    exact rerank the ADC estimate only SELECTS — recall must land near
    the exact-scored traversal's, and reported distances stay exact."""
    idx, x, q, gt = built
    idx.enable_pq(chunks=6, ksub=32, opq_iters=2)
    idx.enable_wide(dims=None, seeds=512)
    d_ex, i_ex = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                       steps=12)
    d_pq, i_pq = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                       steps=12, score="pq", rerank_k=256)
    r_ex, r_pq = _recall(i_ex, gt), _recall(i_pq, gt)
    # iid Gaussian is PQ's worst case (no inter-dim structure for 6x32
    # codes to exploit): bound the selection loss loosely; clustered-data
    # quality is measured at 1M in ABLATION_OPQ.json
    assert r_pq >= r_ex - 0.3
    assert r_pq >= 0.6
    # distances of returned hits are exact regardless of traversal scores
    for i in range(4):
        sel = i_pq[i][i_pq[i] >= 0]
        dref = np.sqrt(((q[i] - x[sel]) ** 2).sum(-1))
        np.testing.assert_allclose(d_pq[i][: len(sel)], dref, rtol=1e-4)


def test_wide_pq_requires_enable_pq(built):
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    if getattr(idx, "_pq", None) is not None:
        pytest.skip("pq already enabled by earlier test in module")
    with pytest.raises(ValueError):
        idx.search_batch_wide(q[:1], k=5, score="pq")


def test_wide_small_batch_padding(built):
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    d1, i1 = idx.search_batch_wide(q[:3], k=7, ef=128, frontier=16, steps=10)
    assert d1.shape == (3, 7) and i1.shape == (3, 7)


def test_beam_recall_vs_brute_force(built):
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    dists, ids = idx.search_batch_beam(q, k=10, frontier=48, steps=14)
    assert _recall(ids, gt) >= 0.9


def test_beam_exact_distances_sorted_no_dups(built):
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    dists, ids = idx.search_batch_beam(q, k=10, frontier=32, steps=10)
    for i in range(len(q)):
        valid = ids[i][ids[i] >= 0]
        assert len(set(valid.tolist())) == len(valid)
        dref = np.sqrt(((q[i] - x[valid]) ** 2).sum(-1))
        np.testing.assert_allclose(dists[i][: len(valid)], dref, rtol=1e-4)
        assert np.all(np.diff(dists[i][: len(valid)]) >= -1e-5)


def test_beam_inline_tables_agree(built):
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512, inline=True)
    _, ids = idx.search_batch_beam(q, k=10, frontier=48, steps=14)
    assert _recall(ids, gt) >= 0.9


def test_beam_pq_score_exact_distances(built):
    """ADC-scored pool-free beam (HNSW-over-PQ with beam mechanics):
    selection from the PQ-decoded mirror, exact reported distances."""
    idx, x, q, gt = built
    if getattr(idx, "_pq", None) is None:
        idx.enable_pq(chunks=6, ksub=32, opq_iters=2)
    idx.enable_wide(dims=None, seeds=512)
    d_ex, i_ex = idx.search_batch_beam(q, k=10, frontier=64, steps=14,
                                       rerank_k=512)
    d_pq, i_pq = idx.search_batch_beam(q, k=10, frontier=64, steps=14,
                                       score="pq", rerank_k=512)
    # iid Gaussian is PQ's worst case, and beam has no pool memory to
    # recover ADC-misranked candidates: bound the selection loss
    # relative to the exact-scored beam
    assert _recall(i_pq, gt) >= _recall(i_ex, gt) - 0.35
    assert _recall(i_pq, gt) >= 0.5
    for i in range(4):
        sel = i_pq[i][i_pq[i] >= 0]
        dref = np.sqrt(((q[i] - x[sel]) ** 2).sum(-1))
        np.testing.assert_allclose(d_pq[i][: len(sel)], dref, rtol=1e-4)


def test_beam_filter_ids(built):
    """Pool-free beam filter: subset contract + recall vs masked brute
    force at moderate selectivity (trajectory mask)."""
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    rng = np.random.default_rng(9)
    allowed = set(int(i) for i in
                  rng.choice(len(x), size=len(x) // 4, replace=False))
    _, ids = idx.search_batch_beam(q, k=10, frontier=48, steps=14,
                                   rerank_k=256, filter_ids=allowed)
    al = np.asarray(sorted(allowed))
    d = ((q[:, None] - x[al][None]) ** 2).sum(-1)
    gt_f = al[np.argsort(d, 1)[:, :10]]
    for i in range(len(q)):
        assert all(int(v) in allowed for v in ids[i] if v >= 0)
    assert _recall(ids, gt_f) >= 0.75  # trajectory-only memory


def test_wide_qchunk_equivalence(built):
    # host-side query chunking must be invisible in the results (each
    # query's program is independent)
    idx, x, q, gt = built
    d1, i1 = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                   steps=12, qchunk=0)
    d2, i2 = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                   steps=12, qchunk=16)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_wide_early_exit_parity(built):
    """Dynamic termination (reference hnsw.py:102-112 batched) must stay
    within noise of the fixed-T recall at the same upper bound T, and
    respect the filter contract when combined with res_mask."""
    idx, x, q, gt = built
    idx.enable_wide(dims=None, seeds=512)
    _, ids_fixed = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                         steps=12)
    d_ee, ids_ee = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                         steps=12, early_exit=True)
    assert _recall(ids_ee, gt) >= _recall(ids_fixed, gt) - 0.03
    # distances stay exact + sorted
    for row in d_ee:
        vals = row[np.isfinite(row)]
        assert (np.diff(vals) >= -1e-5).all()

    allowed = set(range(0, 4000, 3))
    _, fids = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                    steps=12, early_exit=True,
                                    filter_ids=allowed)
    assert all(int(v) % 3 == 0 for row in fids for v in row if v >= 0)
