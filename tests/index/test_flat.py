"""FlatIndex: exact search wrapper, metrics, persistence."""

import numpy as np
import pytest

from vector_db_tpu.index.flat import FlatIndex
from vector_db_tpu.types import Node


def make_nodes(rng, n, dim):
    return [Node(id=i, embedding=rng.standard_normal(dim).astype(np.float32))
            for i in range(n)]


def test_flat_exact_matches_brute_force(rng):
    nodes = make_nodes(rng, 80, 16)
    idx = FlatIndex()
    idx.build_index(nodes)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    _, ids = idx.search_batch(q, k=5)
    x = np.stack([n.embedding for n in nodes])
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(ids, np.argsort(d, axis=1)[:, :5])


def test_flat_cosine_metric(rng):
    nodes = make_nodes(rng, 60, 8)
    idx = FlatIndex(metric="cosine")
    idx.build_index(nodes)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    dists, ids = idx.search_batch(q, k=5)
    # ground truth by cosine distance
    x = np.stack([n.embedding for n in nodes])
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cd = 1.0 - qn @ xn.T
    np.testing.assert_array_equal(ids, np.argsort(cd, axis=1)[:, :5])
    want = np.take_along_axis(cd, np.asarray(ids), axis=1)
    np.testing.assert_allclose(dists, want, rtol=1e-3, atol=1e-4)


def test_flat_unknown_metric():
    with pytest.raises(ValueError, match="metric"):
        FlatIndex(metric="dot")


def test_flat_delete_and_filter(rng):
    nodes = make_nodes(rng, 30, 8)
    idx = FlatIndex()
    idx.build_index(nodes)
    idx.delete_node(3)
    res = idx.search(nodes[3].embedding, k=3)
    assert all(n.id != 3 for n, _ in res)
    res = idx.search(nodes[5].embedding, k=3, filter_ids={5, 6})
    assert {n.id for n, _ in res} <= {5, 6}


def test_flat_blocksel_precision(rng):
    # blocksel = three-phase block-select scan over a PCA mirror; on a
    # full-rank-coverable mirror (dim <= 128) the estimates are
    # near-exact so ids and distances must match the f32 path
    nodes = make_nodes(rng, 300, 24)
    idx = FlatIndex(precision="blocksel", capacity=512)
    idx.build_index(nodes)
    idx.delete_node(7)
    q = rng.standard_normal((4, 24)).astype(np.float32)
    d_b, i_b = idx.search_batch(q, k=5)
    ref = FlatIndex(capacity=512)
    ref.build_index(nodes)
    ref.delete_node(7)
    d_f, i_f = ref.search_batch(q, k=5)
    np.testing.assert_array_equal(i_b, i_f)
    np.testing.assert_allclose(d_b, d_f, rtol=1e-4)
    assert 7 not in set(np.asarray(i_b).ravel().tolist())


@pytest.mark.parametrize("precision", ["blocksel", "blocksel2p"])
def test_flat_blocksel_mirror_padded_once(rng, monkeypatch, precision):
    """The blocksel mirror is padded to the block top-m kernel's tiles once,
    when it is built (capacity 3000 is not a multiple of them). Searches
    over it return what they return over an unpadded mirror, and padded
    or deleted rows never come back."""
    import vector_db_tpu.ops.pallas.block_topm as BT

    n, dim = 2900, 32
    # low-rank rows: the PCA mirror keeps the neighbour gaps
    a = rng.standard_normal((8, dim)).astype(np.float32)
    x = (rng.standard_normal((n, 8)).astype(np.float32) @ a
         + 0.01 * rng.standard_normal((n, dim)).astype(np.float32))
    nodes = [Node(id=i, embedding=x[i]) for i in range(n)]
    q = rng.standard_normal((6, 8)).astype(np.float32) @ a

    def run():
        idx = FlatIndex(precision=precision, capacity=3000)
        idx.build_index(nodes)
        for i in range(0, n, 7):
            idx.delete_node(i)
        return idx, idx.search_batch(q, k=10)

    idx, (d, ids) = run()
    _, tab, x_sq = idx._proj_mirror()
    assert tab.shape[0] % 2048 == 0 and tab.shape[0] >= 3000
    assert x_sq.shape[0] == tab.shape[0]
    assert ((ids % 7 != 0) & (ids >= 0) & (ids < n)).all()
    monkeypatch.setattr(BT, "pad_mirror", lambda t, s, block=128: (t, s))
    idx2, (d2, ids2) = run()
    assert idx2._proj_mirror()[1].shape[0] == 3000
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_allclose(d, d2, rtol=1e-6)
