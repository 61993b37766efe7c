"""HNSW auxiliary-state persistence (reload must not
silently retrain PQ codebooks / PCA projections — minutes at 1M scale).

Ports IvfIndex's pattern (index/ivf.py save_index/load_index) to HNSW:
save stores rp/wide projections and PQ codebooks (+rotation); load
restores them bit-equal and re-encodes codes in one streaming program.
"""

import random

import numpy as np
import pytest

from vector_db_tpu.index.hnsw import HNSW
from vector_db_tpu.storage.mmap import MMapNodeStorage
from vector_db_tpu.types import Node


@pytest.fixture
def stored_index(tmp_path):
    rng = np.random.default_rng(11)
    n, dim = 600, 32
    x = rng.normal(size=(n, dim)).astype(np.float32)
    storage = MMapNodeStorage(
        str(tmp_path / "emb.npy"), str(tmp_path / "meta.npy"),
        dim=dim, capacity=1024)
    idx = HNSW(M=8, ef_construction=60, rng=random.Random(42),
               storage=storage, index_file=tmp_path / "g.npz",
               capacity=1024, l_max=3)
    idx.insert_nodes([Node(id=i, embedding=x[i], metadata={}, content=None)
                      for i in range(n)])
    return idx, x, storage, tmp_path


def test_pq_rp_wide_state_roundtrip(stored_index):
    idx, x, storage, tmp_path = stored_index
    idx.enable_pq(chunks=4, ksub=16, opq_iters=2)
    idx.enable_rp(dims=16)
    idx.enable_wide(dims=16, seeds=128)
    q = x[:8] + 0.01
    d_pq0, i_pq0 = idx.search_batch_pq(q, k=5, ef=64)
    d_rp0, i_rp0 = idx.search_batch_rp(q, k=5, ef=64)
    d_wb0, i_wb0 = idx.search_batch_wide(q, k=5, ef=64, frontier=16,
                                         steps=8)
    cb0 = np.asarray(idx._pq.codebooks)
    rot0 = np.asarray(idx._pq.rotation)
    rp0 = np.asarray(idx._rp_proj)
    wb0 = np.asarray(idx._wb_proj)
    idx.save_index()

    storage2 = MMapNodeStorage(
        str(tmp_path / "emb.npy"), str(tmp_path / "meta.npy"),
        dim=32, capacity=1024)
    idx2 = HNSW(M=8, ef_construction=60, rng=random.Random(42),
                storage=storage2, index_file=tmp_path / "g.npz",
                capacity=1024, l_max=3)

    # no retraining: restored parameters are bit-equal
    np.testing.assert_array_equal(np.asarray(idx2._pq.codebooks), cb0)
    np.testing.assert_array_equal(np.asarray(idx2._pq.rotation), rot0)
    np.testing.assert_array_equal(np.asarray(idx2._rp_proj), rp0)
    np.testing.assert_array_equal(np.asarray(idx2._wb_proj), wb0)

    # searches reproduce pre-save results without any enable_* call
    d_pq1, i_pq1 = idx2.search_batch_pq(q, k=5, ef=64)
    np.testing.assert_array_equal(i_pq1, i_pq0)
    np.testing.assert_allclose(d_pq1, d_pq0, rtol=1e-5)
    d_rp1, i_rp1 = idx2.search_batch_rp(q, k=5, ef=64)
    np.testing.assert_array_equal(i_rp1, i_rp0)
    d_wb1, i_wb1 = idx2.search_batch_wide(q, k=5, ef=64, frontier=16,
                                          steps=8)
    np.testing.assert_array_equal(i_wb1, i_wb0)


def test_plain_index_roundtrip_unaffected(stored_index):
    idx, x, storage, tmp_path = stored_index
    idx.save_index()
    storage2 = MMapNodeStorage(
        str(tmp_path / "emb.npy"), str(tmp_path / "meta.npy"),
        dim=32, capacity=1024)
    idx2 = HNSW(M=8, ef_construction=60, rng=random.Random(42),
                storage=storage2, index_file=tmp_path / "g.npz",
                capacity=1024, l_max=3)
    assert getattr(idx2, "_pq", None) is None
    assert getattr(idx2, "_rp_proj", None) is None
    d0, i0 = idx.search_batch(x[:4] + 0.01, k=5, ef=64)
    d1, i1 = idx2.search_batch(x[:4] + 0.01, k=5, ef=64)
    np.testing.assert_array_equal(i0, i1)
