"""Sharding tests over the 8-virtual-device CPU mesh: per-shard search +
all-gather merge must agree with a single-device brute force."""

import numpy as np
import pytest

import jax

from vector_db_tpu.parallel.mesh import make_mesh
from vector_db_tpu.parallel.sharded import ShardedFlatIndex, ShardedHNSW


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8
    mesh = make_mesh()
    assert mesh.devices.size == 8


def brute_force(q, x, k):
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :k]


def test_sharded_flat_matches_brute_force(rng):
    mesh = make_mesh()
    idx = ShardedFlatIndex(mesh=mesh, dim=16, capacity_per_shard=64)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    idx.insert(list(range(300)), x)
    assert idx.size == 300

    q = rng.standard_normal((5, 16)).astype(np.float32)
    dists, ids = idx.search_batch(q, k=10)
    want = brute_force(q, x, 10)
    np.testing.assert_array_equal(ids, want)
    # distances ascending and correct
    wd = np.sqrt(np.take_along_axis(
        ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1), want, axis=1))
    np.testing.assert_allclose(dists, wd, rtol=1e-3, atol=1e-3)


def test_sharded_flat_delete(rng):
    idx = ShardedFlatIndex(mesh=make_mesh(), dim=8, capacity_per_shard=16)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    idx.insert(list(range(40)), x)
    idx.delete(7)
    _, ids = idx.search_batch(x[7:8], k=5)
    assert 7 not in ids[0]


def test_sharded_flat_uneven_vs_devices(rng):
    # 3 vectors over 8 shards: most shards empty; must still work.
    idx = ShardedFlatIndex(mesh=make_mesh(), dim=8, capacity_per_shard=4)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    idx.insert([10, 20, 30], x)
    dists, ids = idx.search_batch(x[1:2], k=3)
    assert ids[0][0] == 20
    assert dists[0][0] < 1e-3


def test_sharded_hnsw_recall(rng):
    mesh = make_mesh()
    idx = ShardedHNSW(M=8, ef_construction=50, mesh=mesh, dim=16,
                      capacity_per_shard=64)
    x = rng.standard_normal((320, 16)).astype(np.float32)
    # two streaming batches
    idx.insert(list(range(160)), x[:160])
    idx.insert(list(range(160, 320)), x[160:])
    assert idx.size == 320

    q = rng.standard_normal((10, 16)).astype(np.float32)
    dists, ids = idx.search_batch(q, k=5, ef=50)
    want = brute_force(q, x, 5)
    recalls = [
        len(set(ids[i]) & set(want[i])) / 5 for i in range(10)
    ]
    # mirror the reference recall contract on the sharded path
    assert np.mean([r >= 0.7 for r in recalls]) >= 0.8


def test_sharded_hnsw_self_query(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=make_mesh(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((100, 8)).astype(np.float32)
    idx.insert(list(range(100)), x)
    dists, ids = idx.search_batch(x[:4], k=1, ef=30)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2, 3])
    assert np.all(dists[:, 0] < 1e-3)


def test_sharded_hnsw_filter(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=make_mesh(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((100, 8)).astype(np.float32)
    idx.insert(list(range(100)), x)
    allowed = set(range(0, 100, 2))
    dists, ids = idx.search_batch(x[:3], k=5, ef=30, filter_ids=allowed)
    live = ids[ids >= 0]
    assert len(live) > 0
    assert set(live.tolist()) <= allowed


def test_sharded_hnsw_bulk_build_recall(rng):
    mesh = make_mesh()
    idx = ShardedHNSW(M=8, ef_construction=50, mesh=mesh, dim=16,
                      capacity_per_shard=64)
    x = rng.standard_normal((320, 16)).astype(np.float32)
    idx.bulk_build(list(range(320)), x)
    assert idx.size == 320

    q = rng.standard_normal((10, 16)).astype(np.float32)
    dists, ids = idx.search_batch(q, k=5, ef=50)
    want = brute_force(q, x, 5)
    recalls = [len(set(ids[i]) & set(want[i])) / 5 for i in range(10)]
    # exact-kNN edges: bulk graphs should beat the streaming-insert bar
    assert np.mean(recalls) >= 0.85


def test_sharded_hnsw_bulk_build_then_insert(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=make_mesh(), dim=8,
                      capacity_per_shard=64)
    x = rng.standard_normal((120, 8)).astype(np.float32)
    idx.bulk_build(list(range(100)), x[:100])
    idx.insert(list(range(100, 120)), x[100:])
    assert idx.size == 120
    _, ids = idx.search_batch(x[105:108], k=1, ef=30)
    np.testing.assert_array_equal(ids[:, 0], [105, 106, 107])


def test_sharded_hnsw_bulk_build_duplicate_ids(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=make_mesh(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    idx.bulk_build([1, 2, 1, 3, 2, 4], x)  # first occurrence wins
    assert idx.size == 4
    _, ids = idx.search_batch(x[:1], k=1, ef=20)
    assert ids[0, 0] == 1


def test_sharded_hnsw_delete_unlinks_edges(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=make_mesh(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((100, 8)).astype(np.float32)
    idx.insert(list(range(100)), x)
    victims = [5, 17, 33]
    gslots = [idx._gslot_of_id[v] for v in victims]
    idx.delete_batch(victims)
    # no table row anywhere references a deleted slot
    neigh = np.asarray(idx._neighbors)
    for g in gslots:
        s, local = g // idx.cap, g % idx.cap
        shard_rows = neigh[s * idx.cap : (s + 1) * idx.cap]
        assert not np.any(shard_rows == local)
        assert np.all(neigh[g] == -1)
    # deleted ids never surface in results
    _, ids = idx.search_batch(x[victims], k=10, ef=40)
    assert not (set(victims) & set(ids.ravel().tolist()))
    # survivors still findable
    _, ids2 = idx.search_batch(x[50:52], k=1, ef=30)
    np.testing.assert_array_equal(ids2[:, 0], [50, 51])


def test_sharded_hnsw_delete_entry_reelection(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=make_mesh(), dim=8,
                      capacity_per_shard=32, seed=3)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    idx.insert(list(range(64)), x)
    # delete every entry node once; searches must keep working
    entries = np.asarray(idx._entry)
    caps = idx.cap
    victims = []
    for s, e in enumerate(entries):
        if e >= 0:
            nid = int(idx._id_of_gslot[s * caps + int(e)])
            if nid >= 0:
                victims.append(nid)
    idx.delete_batch(victims)
    survivors = [i for i in range(64) if i not in set(victims)]
    _, ids = idx.search_batch(x[survivors[:3]], k=1, ef=30)
    np.testing.assert_array_equal(ids[:, 0], survivors[:3])


def test_reverse_merge_device_matches_host(rng):
    import jax.numpy as jnp

    from vector_db_tpu.index.hnsw import _reverse_merge
    from vector_db_tpu.ops.graph_build import reverse_merge

    n, deg, width = 50, 4, 6
    fwd_d = rng.random((n, deg)).astype(np.float32)
    fwd_i = rng.integers(0, n, (n, deg)).astype(np.int32)
    fwd_i[fwd_i == np.arange(n)[:, None]] = -1  # no self edges
    order = np.argsort(fwd_d, axis=1)
    fwd_d = np.take_along_axis(fwd_d, order, axis=1)
    fwd_i = np.take_along_axis(fwd_i, order, axis=1)

    host = _reverse_merge(fwd_i, fwd_d, width)
    dev = np.asarray(reverse_merge(jnp.asarray(fwd_d), jnp.asarray(fwd_i),
                                   width))
    for r in range(n):
        assert set(host[r][host[r] >= 0]) == set(dev[r][dev[r] >= 0])


# ---------------------------------------------------------------------------
# multi-slice 2-D mesh
# ---------------------------------------------------------------------------

def test_flat_2d_mesh_matches_bruteforce(rng):
    """2x4 ("slice", "shard") mesh: hierarchical merge (within a slice,
    then only B·k pairs per slice across the outer axis) must return
    exact results."""
    from vector_db_tpu.parallel.mesh import make_mesh_2d
    from vector_db_tpu.parallel.sharded import ShardedFlatIndex

    mesh = make_mesh_2d(2, 4)
    index = ShardedFlatIndex(mesh=mesh, dim=16, capacity_per_shard=64)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    index.insert(list(range(300)), x)

    q = rng.standard_normal((5, 16)).astype(np.float32)
    dists, ids = index.search_batch(q, k=7)
    d_all = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d_all, axis=1)[:, :7]
    assert np.array_equal(np.sort(ids, axis=1), np.sort(want, axis=1))
    np.testing.assert_allclose(
        dists, np.sqrt(np.sort(d_all, axis=1)[:, :7]), rtol=1e-4, atol=1e-4)


def test_hnsw_2d_mesh_search_and_insert(rng):
    """ShardedHNSW on a 2x4 multi-slice mesh: insert + search end-to-end
    with per-axis merges."""
    from vector_db_tpu.parallel.mesh import make_mesh_2d
    from vector_db_tpu.parallel.sharded import ShardedHNSW

    mesh = make_mesh_2d(2, 4)
    index = ShardedHNSW(M=8, ef_construction=40, mesh=mesh, dim=16,
                        capacity_per_shard=64, l_max=3)
    x = rng.standard_normal((160, 16)).astype(np.float32)
    index.insert(list(range(160)), x)

    q = x[:8] + 0.01
    dists, ids = index.search_batch(q, k=5, ef=40)
    assert (ids[np.arange(8), 0] == np.arange(8)).mean() >= 0.9
    d_all = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d_all, axis=1)[:, :5]
    recall = np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist())) / 5
                      for i in range(8)])
    assert recall >= 0.8


def test_sharded_wide_beam_recall(rng):
    """Wide-beam fan-out over the mesh: per-shard frontier
    search + hierarchical merge reaches brute-force-level recall, and the
    mesh-wide PCA path (psum'd covariance) works end to end."""
    from vector_db_tpu.parallel.sharded import ShardedHNSW

    mesh = make_mesh()
    idx = ShardedHNSW(M=8, ef_construction=50, mesh=mesh, dim=16,
                      capacity_per_shard=128, l_max=4)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    idx.bulk_build(list(range(400)), x)

    idx.enable_wide(dims=None, seeds=64)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    want = np.argsort(d, 1)[:, :5]
    dists, ids = idx.search_batch_wide(q, k=5, ef=64, frontier=16, steps=8)
    rec = np.mean([len(set(ids[i]) & set(want[i])) / 5 for i in range(16)])
    assert rec >= 0.85, rec
    # self-query through the projected variant (shared mesh-wide PCA)
    idx.enable_wide(dims=8, seeds=64)
    d2, i2 = idx.search_batch_wide(x[:4], k=1, ef=64, frontier=16, steps=8)
    assert list(i2[:, 0]) == [0, 1, 2, 3]
    # filtered fan-out: per-shard two-pool wide, subset contract + recall
    allowed = set(int(i) for i in
                  rng.choice(400, size=100, replace=False))
    _, fi = idx.search_batch_wide(q, k=5, ef=64, frontier=16, steps=8,
                                  rerank_k=64, filter_ids=allowed)
    al = np.asarray(sorted(allowed))
    df = ((q[:, None] - x[al][None]) ** 2).sum(-1)
    want_f = al[np.argsort(df, 1)[:, :5]]
    assert all(int(v) in allowed for row in fi for v in row if v >= 0)
    rec_f = np.mean([len(set(fi[i]) & set(want_f[i])) / 5
                     for i in range(16)])
    assert rec_f >= 0.8, rec_f


def test_sharded_beam_recall(rng):
    """Pool-free beam fan-out over the mesh: per-shard merge-light
    traversal + hierarchical merge reaches brute-force-level recall."""
    from vector_db_tpu.parallel.sharded import ShardedHNSW

    mesh = make_mesh()
    idx = ShardedHNSW(M=8, ef_construction=50, mesh=mesh, dim=16,
                      capacity_per_shard=128, l_max=4)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    idx.bulk_build(list(range(400)), x)

    idx.enable_wide(dims=None, seeds=64)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    want = np.argsort(d, 1)[:, :5]
    dists, ids = idx.search_batch_beam(q, k=5, frontier=16, steps=10)
    rec = np.mean([len(set(ids[i]) & set(want[i])) / 5 for i in range(16)])
    assert rec >= 0.85, rec
    # filtered fan-out: trajectory mask per shard, subset contract
    allowed = set(int(i) for i in rng.choice(400, 120, replace=False))
    _, fi = idx.search_batch_beam(q, k=5, frontier=16, steps=10,
                                  rerank_k=128, filter_ids=allowed)
    assert all(int(v) in allowed for row in fi for v in row if v >= 0)
    al = np.asarray(sorted(allowed))
    df = ((q[:, None] - x[al][None]) ** 2).sum(-1)
    want_f = al[np.argsort(df, 1)[:, :5]]
    rec_f = np.mean([len(set(fi[i]) & set(want_f[i])) / 5
                     for i in range(16)])
    assert rec_f >= 0.7, rec_f


def test_sharded_ivf_probe(rng):
    from vector_db_tpu.parallel.sharded import ShardedIVF

    idx = ShardedIVF(mesh=make_mesh(), dim=16, capacity_per_shard=64,
                     k_cells=4)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    idx.build(list(range(300)), x)

    # probing EVERY cell = exact: must match brute force
    q = rng.standard_normal((5, 16)).astype(np.float32)
    _, ids = idx.search_batch(q, k=10, n_probe=4)
    np.testing.assert_array_equal(ids, brute_force(q, x, 10))

    # partial probe: self-query still lands in its own cell
    _, ids1 = idx.search_batch(x[:4], k=1, n_probe=1)
    np.testing.assert_array_equal(ids1[:, 0], [0, 1, 2, 3])

    # delete hides the row without a list rebuild
    idx.delete(3)
    _, ids2 = idx.search_batch(x[3:4], k=3, n_probe=4)
    assert 3 not in ids2[0]


def test_sharded_hnsw_save_load_roundtrip(rng, tmp_path):
    """Sharded resume story (reference analog: storage.py:146-161 +
    hnsw.py pickle round-trip): save -> fresh mesh object -> load ->
    identical search results, and the loaded index keeps ingesting."""
    mesh = make_mesh()
    idx = ShardedHNSW(M=8, ef_construction=50, mesh=mesh, dim=16,
                      capacity_per_shard=64)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    idx.bulk_build(list(range(200)), x[:200])
    idx.insert(list(range(200, 300)), x[200:])  # mixed build paths
    idx.delete(17)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    d0, i0 = idx.search_batch(q, k=5, ef=50)

    path = tmp_path / "sharded.npz"
    idx.save_index(path)

    idx2 = ShardedHNSW(M=8, ef_construction=50, mesh=make_mesh(), dim=16,
                       capacity_per_shard=64)
    idx2.load_index(path)
    assert idx2.size == idx.size
    d1, i1 = idx2.search_batch(q, k=5, ef=50)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-5, atol=1e-5)
    assert not np.any(i1 == 17)  # tombstone survives the round-trip

    # the resumed index accepts new inserts and routes around used slots
    idx2.insert([500], x[:1] + 0.001)
    _, ids = idx2.search_batch(x[:1], k=2, ef=50)
    assert set(ids[0].tolist()) == {0, 500}


def test_sharded_hnsw_load_rejects_mesh_mismatch(rng, tmp_path):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=make_mesh(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    idx.bulk_build(list(range(40)), x)
    path = tmp_path / "s.npz"
    idx.save_index(path)
    other = ShardedHNSW(M=4, ef_construction=30, mesh=make_mesh(), dim=8,
                        capacity_per_shard=16)  # different capacity
    with pytest.raises(ValueError, match="Mesh/capacity mismatch"):
        other.load_index(path)
