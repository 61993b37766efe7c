"""IndexingService with flat and IVF backends (the reference accepts
n_probe in its API but never wires IVF in — here index.type selects)."""

import numpy as np
import pytest
import yaml

from vector_db_tpu.services.indexing_service import IndexingService
from vector_db_tpu.services.storage_service import StorageService
from vector_db_tpu.types import Node


def make_config(tmp_path, index_type, **extra):
    cfg = {
        "embedding": {"model": "fake-16", "dimension": 16},
        "index": {"ef_construction": 30, "M": 4, "flush_threshold": 1000,
                  "type": index_type, **extra},
        "vector_db": {"file_path": str(tmp_path / "vdb"), "dimension": 16,
                      "capacity": 256},
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def make_nodes(rng, n):
    return [Node(id=i, embedding=rng.standard_normal(16).astype(np.float32),
                 metadata={"par": i % 2}) for i in range(n)]


def test_flat_index_service(tmp_path, rng):
    cfg = make_config(tmp_path, "flat")
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 30)
    svc.insert_nodes(nodes)
    assert svc.get_index_size() == 30
    res = svc.search(nodes[7].embedding, k=3)
    assert res[0][0].id == 7
    assert res[0][1] < 1e-3
    # exact: results == brute force
    q = rng.standard_normal(16).astype(np.float32)
    got = [n.id for n, _ in svc.search(q, k=5)]
    d = [np.linalg.norm(q - n.embedding) for n in nodes]
    want = [nodes[i].id for i in np.argsort(d)[:5]]
    assert got == want


def test_flat_index_persistence(tmp_path, rng):
    cfg = make_config(tmp_path, "flat")
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 10)
    svc.insert_nodes(nodes)
    svc.save_index()

    svc2 = IndexingService(storage=storage.storage, config_path=cfg)
    assert svc2.is_index_loaded()
    assert svc2.get_index_size() == 10
    assert svc2.search(nodes[3].embedding, k=1)[0][0].id == 3


def test_ivf_index_service(tmp_path, rng):
    cfg = make_config(tmp_path, "ivf", ivf_k=4)
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 3)
    svc.insert_nodes(nodes)
    # below ivf_k: pending queue, brute-force search still works
    assert svc.get_index_size() == 3
    assert svc.search(nodes[1].embedding, k=1)[0][0].id == 1

    more = [Node(id=100 + i, embedding=rng.standard_normal(16).astype(np.float32))
            for i in range(30)]
    svc.insert_nodes(more)  # crosses ivf_k -> k-means build
    assert svc.index.centroids is not None
    assert svc.get_index_size() == 33

    res = svc.search(more[5].embedding, k=1, n_probe=4)
    assert res[0][0].id == 105

    # filter post-selection
    res = svc.search(nodes[0].embedding, k=5, n_probe=4,
                     filter_ids={n.id for n in nodes})
    assert {n.id for n, _ in res} <= {0, 1, 2}


def test_ivf_delete(tmp_path, rng):
    cfg = make_config(tmp_path, "ivf", ivf_k=4)
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 20)
    svc.insert_nodes(nodes)
    svc.delete_node(5)
    assert svc.get_index_size() == 19
    res = svc.search(nodes[5].embedding, k=5, n_probe=4)
    assert all(n.id != 5 for n, _ in res)


def test_sharded_hnsw_service(tmp_path, rng):
    cfg = make_config(tmp_path, "sharded-hnsw")
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 40)
    svc.insert_nodes(nodes)
    assert svc.get_index_size() == 40
    res = svc.search(nodes[9].embedding, k=3, ef=30)
    assert res[0][0].id == 9
    assert res[0][1] < 1e-3
    # filter post-selection
    allowed = {n.id for n in nodes if n.metadata["par"] == 0}
    res = svc.search(nodes[2].embedding, k=5, ef=30, filter_ids=allowed)
    assert {n.id for n, _ in res} <= allowed
    # delete tombstones
    svc.delete_node(9)
    res = svc.search(nodes[9].embedding, k=3, ef=30)
    assert all(n.id != 9 for n, _ in res)
    # persistence round trip
    svc.force_save_index()
    svc2 = IndexingService(storage=storage.storage, config_path=cfg)
    assert svc2.get_index_size() == 39
    assert svc2.search(nodes[3].embedding, k=1, ef=30)[0][0].id == 3


def test_hnsw_pq_via_config(tmp_path, rng):
    cfg = make_config(tmp_path, "hnsw",
                      pq={"chunks": 4, "ksub": 16, "min_size": 32})
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 100)
    svc.insert_nodes(nodes)
    # first search activates PQ (size 100 >= min_size 32)
    res = svc.search(nodes[11].embedding, k=1, ef=40)
    assert svc._pq_active
    assert res[0][0].id == 11
    assert res[0][1] < 1e-2  # exact rerank distance
    # inserts mark codes stale; next search refreshes and finds the new node
    new = Node(id=500, embedding=rng.standard_normal(16).astype(np.float32))
    svc.insert_node(new)
    assert svc._pq_stale
    res = svc.search(new.embedding, k=1, ef=40)
    assert res[0][0].id == 500
    assert not svc._pq_stale


def test_pq_chunks_request_param(tmp_path, rng):
    # no config pq, but the search request asks for it (reference accepts
    # pq_chunks and ignores it; here it activates when feasible)
    cfg = make_config(tmp_path, "hnsw")
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    svc._pq_min_size = 32
    svc._pq_ksub = 16
    nodes = make_nodes(rng, 80)
    svc.insert_nodes(nodes)
    res = svc.search(nodes[5].embedding, k=1, ef=40, pq_chunks=4)
    assert svc._pq_active
    assert res[0][0].id == 5


def test_ivf_batch_filter_ids(tmp_path, rng):
    """search_batch must honor filter_ids for IVF (filters often implement
    tenancy/ACL; dropping them silently leaks excluded documents)."""
    cfg = make_config(tmp_path, "ivf", ivf_k=4)
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 40)
    svc.insert_nodes(nodes)
    allowed = {n.id for n in nodes if n.metadata["par"] == 0}
    q = np.stack([nodes[1].embedding, nodes[2].embedding])
    _, ids = svc.search_batch(q, k=5, n_probe=4, filter_ids=allowed)
    got = {int(i) for row in ids for i in row if i >= 0}
    assert got, "filtered batch search returned nothing"
    assert got <= allowed


def test_ivf_n_probe_changes_probing(tmp_path, rng):
    """n_probe must actually change probing: a query whose true nearest
    neighbor sits in its SECOND-nearest cluster misses it at n_probe=1 and
    finds it at n_probe=2."""
    cfg = make_config(tmp_path, "ivf", ivf_k=2)
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    c1 = np.zeros(16, np.float32); c1[0] = 10.0
    c2 = np.zeros(16, np.float32); c2[1] = 10.0
    nodes = []
    for i in range(10):  # tight cluster around c1
        v = c1 + 0.1 * rng.standard_normal(16).astype(np.float32)
        nodes.append(Node(id=i, embedding=v))
    for i in range(10, 20):  # tight cluster around c2
        v = c2 + 0.1 * rng.standard_normal(16).astype(np.float32)
        nodes.append(Node(id=i, embedding=v))
    # id 99: assigned to cluster 2 (closer to c2) but very close to the query
    p2 = np.zeros(16, np.float32); p2[0], p2[1] = 5.0, 6.0
    nodes.append(Node(id=99, embedding=p2))
    svc.insert_nodes(nodes)
    # query: nearest centroid is c1, but the true NN is p2 in cluster 2
    q = np.zeros(16, np.float32); q[0], q[1] = 6.0, 4.9
    near = svc.search(q, k=1, n_probe=1)
    far = svc.search(q, k=1, n_probe=2)
    assert far[0][0].id == 99
    assert near[0][0].id != 99


def test_flat_bf16_precision(tmp_path, rng):
    """bf16 scan mode: same contract as f32, near-identical ranking."""
    cfg = make_config(tmp_path, "flat", precision="bf16")
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 50)
    svc.insert_nodes(nodes)
    res = svc.search(nodes[7].embedding, k=1)
    assert res[0][0].id == 7
    assert res[0][1] < 1e-3  # k survivors are exactly re-scored
    # mutations invalidate the mirror: a new node must be findable
    from vector_db_tpu.types import Node as _N
    v = rng.standard_normal(16).astype(np.float32)
    svc.insert_node(_N(id=500, embedding=v))
    assert svc.search(v, k=1)[0][0].id == 500
    svc.delete_node(500)
    assert all(n.id != 500 for n, _ in svc.search(v, k=5))
    # top-5 overlap with exact brute force >= 4/5 (bf16 rounding only)
    q = rng.standard_normal(16).astype(np.float32)
    got = {n.id for n, _ in svc.search(q, k=5)}
    d = [np.linalg.norm(q - n.embedding) for n in nodes]
    want = {nodes[i].id for i in np.argsort(d)[:5]}
    assert len(got & want) >= 4


def test_ivf_pq_via_config(tmp_path, rng):
    """index.type: ivf + index.pq activates residual IVFADC probing once
    the corpus passes min_size; results stay consistent with exact IVF."""
    cfg = make_config(tmp_path, "ivf", ivf_k=4,
                      pq={"chunks": 4, "ksub": 16, "min_size": 16,
                          "residual": True})
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 64)
    svc.insert_nodes(nodes)

    res = svc.search(nodes[9].embedding, k=3, n_probe=4)
    assert svc._pq_active
    assert getattr(svc.index, "_pq_residual", False)
    assert res[0][0].id == 9  # exact rerank recovers the true neighbor

    # batch path also probes with PQ
    q = np.stack([nodes[5].embedding, nodes[11].embedding])
    _, ids = svc.search_batch(q, k=1, n_probe=4)
    assert ids[0, 0] == 5 and ids[1, 0] == 11

    # filtered searches fall back to the exact probe path (ADC kernel
    # carries no filter mask) and still respect the filter
    fres = svc.search(nodes[9].embedding, k=5,
                      filter_ids={n.id for n in nodes if n.id % 2 == 0})
    assert all(n.id % 2 == 0 for n, _ in fres)


def test_ivf_pq_add_after_activation(tmp_path, rng):
    """Nodes inserted after PQ activation must be findable via ADC (codes
    and correction scalars are maintained incrementally by IvfIndex.add)."""
    cfg = make_config(tmp_path, "ivf", ivf_k=4,
                      pq={"chunks": 4, "ksub": 16, "min_size": 16})
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    svc.insert_nodes(make_nodes(rng, 48))
    svc.search(np.zeros(16, np.float32), k=1, n_probe=4)  # activate PQ
    assert svc._pq_active

    late = Node(id=999, embedding=rng.standard_normal(16).astype(np.float32),
                metadata={})
    svc.insert_nodes([late])
    res = svc.search(late.embedding, k=1, n_probe=4)
    assert res[0][0].id == 999


def test_ivf_rp_via_config(tmp_path, rng):
    """index.type: ivf + index.rp activates residual-projection probing;
    late adds stay current (projected in place by IvfIndex.add)."""
    cfg = make_config(tmp_path, "ivf", ivf_k=4,
                      rp={"dims": 8, "min_size": 16})
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 64)
    svc.insert_nodes(nodes)

    res = svc.search(nodes[9].embedding, k=3, n_probe=4)
    assert svc._rp_active
    assert res[0][0].id == 9

    late = Node(id=999, embedding=rng.standard_normal(16).astype(np.float32),
                metadata={})
    svc.insert_nodes([late])
    res = svc.search(late.embedding, k=1, n_probe=4)
    assert res[0][0].id == 999

    # filtered search falls back to the exact probe path, still correct
    fres = svc.search(nodes[8].embedding, k=5,
                      filter_ids={n.id for n in nodes if n.id % 2 == 0})
    assert all(n.id % 2 == 0 for n, _ in fres)


def test_hnsw_rp_via_config(tmp_path, rng):
    """index.type: hnsw + index.rp activates projected traversal; the
    mirror re-projects lazily so post-activation inserts are findable."""
    cfg = make_config(tmp_path, "hnsw", rp={"dims": 8, "min_size": 16})
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 48)
    svc.insert_nodes(nodes)
    res = svc.search(nodes[11].embedding, k=3, ef=40)
    assert svc._rp_active
    assert res[0][0].id == 11

    late = Node(id=777, embedding=rng.standard_normal(16).astype(np.float32),
                metadata={})
    svc.insert_nodes([late])
    res = svc.search(late.embedding, k=1, ef=40)
    assert res[0][0].id == 777

    # filters fall back to the full-precision masked beam
    fres = svc.search(nodes[4].embedding, k=5,
                      filter_ids={n.id for n in nodes if n.id % 2 == 0})
    assert all(n.id % 2 == 0 for n, _ in fres)


def test_sharded_hnsw_multislice_config(tmp_path, rng):
    """index.slices: 2 builds the 2-D ("slice", "shard") mesh; search and
    insert work end-to-end with hierarchical merges (8 virtual devices)."""
    import jax

    if len(jax.devices()) < 4:
        import pytest as _pytest
        _pytest.skip("needs >=4 devices")
    cfg = make_config(tmp_path, "sharded-hnsw", slices=2)
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    assert len(svc.index.mesh.axis_names) == 2
    nodes = make_nodes(rng, 40)
    svc.insert_nodes(nodes)
    res = svc.search(nodes[13].embedding, k=3, ef=40)
    assert res[0][0].id == 13


def test_hnsw_wide_mode_service(tmp_path, rng):
    """index.wide activates wide-beam traversal once min_size is crossed
    (frontier-parallel search); self-query stays exact and the
    single-query path resolves Nodes."""
    cfg = make_config(
        tmp_path, "hnsw",
        wide={"dims": 0, "seeds": 64, "frontier": 16, "steps": 8,
              "min_size": 16},
    )
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 40)
    svc.insert_nodes(nodes)
    res = svc.search(nodes[9].embedding, k=3, ef=32)
    assert svc._wide_active
    assert res[0][0].id == 9
    assert res[0][1] < 1e-3
    d, ids = svc.search_batch(
        np.stack([n.embedding for n in nodes[:4]]), k=1, ef=32)
    assert list(ids[:, 0]) == [0, 1, 2, 3]
    # filtered queries route to the masked scan by default
    # (index.filtered_engine: scan): only matching ids may appear, and
    # the true nearest matching node wins
    assert svc._filtered_engine == "scan"
    resf = svc.search(nodes[9].embedding, k=3, ef=32,
                      filter_ids={n.id for n in nodes[:5]})
    assert all(n.id < 5 for n, _ in resf)
    emb9 = nodes[9].embedding
    want = min(range(5),
               key=lambda i: float(np.sum((emb9 - nodes[i].embedding) ** 2)))
    assert resf[0][0].id == want


def test_hnsw_filtered_engine_graph(tmp_path, rng):
    """index.filtered_engine: graph keeps the reference's
    navigate-but-exclude two-pool wide traversal for filtered queries."""
    cfg = make_config(
        tmp_path, "hnsw",
        filtered_engine="graph",
        wide={"dims": 0, "seeds": 64, "frontier": 16, "steps": 8,
              "min_size": 16},
    )
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 40)
    svc.insert_nodes(nodes)
    assert svc._filtered_engine == "graph"
    resf = svc.search(nodes[9].embedding, k=3, ef=32,
                      filter_ids={n.id for n in nodes[:5]})
    assert svc._wide_active
    assert all(n.id < 5 for n, _ in resf)


def test_hnsw_wide_beam_mode_service(tmp_path, rng):
    """index.wide.mode: beam routes unfiltered hnsw queries to the
    pool-free beam traversal."""
    cfg = make_config(
        tmp_path, "hnsw",
        wide={"dims": 0, "seeds": 64, "frontier": 16, "steps": 10,
              "min_size": 16, "mode": "beam"},
    )
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 40)
    svc.insert_nodes(nodes)
    res = svc.search(nodes[9].embedding, k=3, ef=32)
    assert svc._wide_active and svc._wide_mode == "beam"
    assert res[0][0].id == 9
    assert res[0][1] < 1e-3
    d, ids = svc.search_batch(
        np.stack([n.embedding for n in nodes[:4]]), k=1, ef=32)
    assert list(ids[:, 0]) == [0, 1, 2, 3]


def test_hnsw_wide_schedule_config(tmp_path, rng):
    """index.wide.schedule routes pool-mode queries through the
    per-segment frontier schedule."""
    cfg = make_config(
        tmp_path, "hnsw",
        wide={"dims": 0, "seeds": 64, "min_size": 16,
              "schedule": [[32, 3], [16, 4]]},
    )
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    assert svc._wide_schedule == ((32, 3), (16, 4))
    nodes = make_nodes(rng, 40)
    svc.insert_nodes(nodes)
    res = svc.search(nodes[7].embedding, k=3, ef=32)
    assert svc._wide_active
    assert res[0][0].id == 7 and res[0][1] < 1e-3


def test_scan_batch_threshold_routing(tmp_path, rng):
    """index.scan_batch_threshold routes big batches to the bf16 scan
    over the same table (batch-throughput mode); small batches keep the
    wide graph path."""
    cfg = make_config(
        tmp_path, "hnsw",
        scan_batch_threshold=8,
        wide={"dims": 0, "seeds": 64, "min_size": 16},
    )
    storage = StorageService(str(tmp_path / "vdb"), dim=16, capacity=256)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, 40)
    svc.insert_nodes(nodes)
    qs = np.stack([n.embedding for n in nodes[:8]])
    _, ids = svc.search_batch(qs, k=1)          # >= threshold -> scan
    assert list(ids[:, 0]) == list(range(8))
    _, ids2 = svc.search_batch(qs[:2], k=1, ef=32)  # below -> wide
    assert list(ids2[:, 0]) == [0, 1]
