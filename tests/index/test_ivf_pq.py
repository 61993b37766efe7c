"""IVF-PQ: ADC-scored probes with exact rerank."""

import numpy as np
import pytest

from vector_db_tpu.index.ivf import IvfIndex
from vector_db_tpu.types import Node


def test_ivf_pq_search(rng):
    n, dim = 400, 32
    x = rng.standard_normal((n, dim)).astype(np.float32)
    nodes = [Node(id=i, embedding=x[i]) for i in range(n)]
    index = IvfIndex(k=8)
    index.build_index(nodes)
    index.enable_pq(chunks=8, ksub=32)

    q = rng.standard_normal((6, dim)).astype(np.float32)
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :5]

    dd, ids = index.search_batch(q, n_probe=8, top_k=5, pq=True)
    rec = np.mean([len(set(ids[i]) & set(gt[i])) / 5 for i in range(6)])
    # full probe + rerank: only codebook quantization can cost candidates
    assert rec >= 0.7, rec

    # self query must hit with ~0 exact (reranked) distance
    dd, ids = index.search_batch(x[:3], n_probe=8, top_k=1, pq=True)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2])
    assert np.all(dd[:, 0] < 1e-2)


def test_ivf_pq_requires_enable(rng):
    n, dim = 50, 16
    nodes = [Node(id=i, embedding=rng.standard_normal(dim).astype(np.float32))
             for i in range(n)]
    index = IvfIndex(k=4)
    index.build_index(nodes)
    with pytest.raises(ValueError, match="enable_pq"):
        index.search_batch(np.zeros((1, dim), np.float32), n_probe=2,
                           top_k=1, pq=True)


def test_ivf_pq_probe_adc_modes_agree(rng):
    """Probe path (n_probe < k): the one LUT-scoring formulation named
    explicitly gives the default's results, and the removed one-hot
    formulations are refused rather than silently swapped."""
    n, dim = 600, 32
    x = rng.standard_normal((n, dim)).astype(np.float32)
    nodes = [Node(id=i, embedding=x[i]) for i in range(n)]
    index = IvfIndex(k=16)
    index.build_index(nodes)
    index.enable_pq(chunks=8, ksub=32)

    q = rng.standard_normal((8, dim)).astype(np.float32)
    d0, i0 = index.search_batch(q, n_probe=4, top_k=5, pq=True)
    d1, i1 = index.search_batch(q, n_probe=4, top_k=5, pq=True,
                                adc="gather")
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    assert (i0 >= 0).all()
    for adc in ("onehot", "onehot8"):
        with pytest.raises(ValueError, match="unknown IVF-PQ adc"):
            index.search_batch(q, n_probe=4, top_k=5, pq=True, adc=adc)


def test_ivf_pq_filter_ids(rng):
    """Filters fold into the validity mask in the approximate kernels:
    only matching ids return, and full-probe + rerank matches brute
    force over the filter set."""
    n, dim = 500, 32
    x = rng.standard_normal((n, dim)).astype(np.float32)
    index = IvfIndex(k=8)
    index.build_index([Node(id=i, embedding=x[i]) for i in range(n)])
    index.enable_pq(chunks=8, ksub=32, residual=True)

    allowed = set(int(i) for i in rng.choice(n, 150, replace=False))
    q = rng.standard_normal((6, dim)).astype(np.float32)
    _, ids = index.search_batch(q, n_probe=8, top_k=5, pq=True,
                                filter_ids=allowed, fetch=128)
    al = np.asarray(sorted(allowed))
    d = ((q[:, None] - x[al][None]) ** 2).sum(-1)
    want = al[np.argsort(d, 1)[:, :5]]
    for i in range(6):
        got = [int(v) for v in ids[i] if v >= 0]
        assert all(g in allowed for g in got)
        assert len(set(got) & set(want[i].tolist())) >= 4  # PQ noise only
