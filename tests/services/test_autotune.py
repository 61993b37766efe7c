"""Calibrated target-recall routing (services/autotune.py).

The reference exposes a raw ef knob with no recall feedback
(src/vector_db/api/models.py:19); the autotuner serves a recall target
by measuring each mode against on-device exact ground truth.
"""

import numpy as np
import yaml

from vector_db_tpu.services.indexing_service import IndexingService
from vector_db_tpu.services.storage_service import StorageService
from vector_db_tpu.types import Node

DIM = 16


def make_config(tmp_path, **autotune):
    cfg = {
        "embedding": {"model": "fake-16", "dimension": DIM},
        "index": {
            "M": 8, "ef_construction": 60, "flush_threshold": 100000,
            "type": "hnsw",
            "wide": {"enabled": True, "min_size": 64},
            "autotune": {"enabled": True, "target_recall": 0.9,
                         "sample": 32, "k": 5, "ef_ladder": [64, 128],
                         "min_size": 64, **autotune},
        },
        "vector_db": {"file_path": str(tmp_path / "vdb"),
                      "dimension": DIM, "capacity": 2048},
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def build_service(tmp_path, rng, n=512, **autotune):
    cfg = make_config(tmp_path, **autotune)
    storage = StorageService(str(tmp_path / "vdb"), dim=DIM, capacity=2048)
    svc = IndexingService(storage=storage.storage, config_path=cfg)
    nodes = [Node(id=i,
                  embedding=rng.standard_normal(DIM).astype(np.float32),
                  metadata={"par": i % 2}) for i in range(n)]
    svc.insert_nodes(nodes)
    return svc, nodes


def test_routes_through_calibrated_decision(tmp_path, rng):
    svc, nodes = build_service(tmp_path, rng)
    res = svc.search(nodes[41].embedding, k=5)
    assert res[0][0].id == 41
    # exactly one decision was made, for the B=1 bucket at the default
    # target, and it meets the target (every mode is near-exact at 512)
    stats = svc._autotune.stats()
    assert list(stats) == ["b8@0.9"]
    dec = next(iter(stats.values()))
    assert dec["met"] and dec["recall"] >= 0.9
    assert dec["mode"] in ("scan-bf16", "scan-blocksel", "wide",
                           "scan-exact")

    # batch path reuses the tuner at its own bucket
    q = np.stack([n.embedding for n in nodes[:20]])
    dists, ids = svc.search_batch(q, k=3)
    assert ids.shape == (20, 3)
    assert (ids[:, 0] == [n.id for n in nodes[:20]]).all()
    assert "b32@0.9" in svc._autotune.stats()


def test_per_request_target_overrides(tmp_path, rng):
    svc, nodes = build_service(tmp_path, rng)
    q = np.stack([n.embedding for n in nodes[:8]])
    svc.search_batch(q, k=5, target_recall=1.0)
    stats = svc._autotune.stats()
    assert "b8@1" in stats
    dec = stats["b8@1"]
    # an exact-capable mode must win a recall-1.0 target on this corpus
    assert dec["met"] and dec["recall"] == 1.0


def test_recalibrates_after_growth(tmp_path, rng):
    svc, nodes = build_service(tmp_path, rng, n=256)
    svc.search(nodes[0].embedding, k=5)
    first = next(iter(svc._autotune.stats().values()))
    assert first["calibrated_at_size"] == 256

    more = [Node(id=1000 + i,
                 embedding=rng.standard_normal(DIM).astype(np.float32),
                 metadata={}) for i in range(512)]
    svc.insert_nodes(more)
    svc.search(nodes[0].embedding, k=5)
    second = next(iter(svc._autotune.stats().values()))
    assert second["calibrated_at_size"] == 768


def test_ivf_autotune_picks_n_probe(tmp_path, rng):
    cfg = {
        "embedding": {"model": "fake-16", "dimension": DIM},
        "index": {
            "M": 8, "ef_construction": 60, "flush_threshold": 100000,
            "type": "ivf", "ivf_k": 16,
            "autotune": {"enabled": True, "target_recall": 0.95,
                         "sample": 24, "k": 5, "min_size": 64},
        },
        "vector_db": {"file_path": str(tmp_path / "vdb"),
                      "dimension": DIM, "capacity": 2048},
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    storage = StorageService(str(tmp_path / "vdb"), dim=DIM, capacity=2048)
    svc = IndexingService(storage=storage.storage, config_path=str(p))
    nodes = [Node(id=i,
                  embedding=rng.standard_normal(DIM).astype(np.float32),
                  metadata={}) for i in range(512)]
    svc.insert_nodes(nodes)
    assert svc.index.centroids is not None

    res = svc.search(nodes[17].embedding, k=5)
    assert res[0][0].id == 17
    stats = svc._autotune.stats()
    dec = next(iter(stats.values()))
    assert dec["mode"] == "ivf" and "n_probe" in dec["params"]
    assert dec["met"] and dec["recall"] >= 0.95
    # full probe (n_probe == k_cells) always reaches 1.0, so the chosen
    # probe width must be <= the cell count and the target must be met
    assert 1 <= dec["params"]["n_probe"] <= 16

    q = np.stack([n.embedding for n in nodes[:16]])
    dists, ids = svc.search_batch(q, k=3)
    assert (ids[:, 0] == [n.id for n in nodes[:16]]).all()


def test_filtered_queries_calibrate_per_selectivity(tmp_path, rng):
    """Filtered hnsw queries route through a selectivity-bucketed
    decision (the scan/graph ranking flips with match
    fraction) and the REAL filter is always honored."""
    svc, nodes = build_service(tmp_path, rng)
    allowed = {n.id for n in nodes if n.id % 2 == 0}  # ~50% selectivity
    res = svc.search(nodes[10].embedding, k=5, filter_ids=allowed)
    assert res and all(n.id in allowed for n, _ in res)
    assert res[0][0].id == 10
    stats = svc._autotune.stats()
    assert "b8@0.9/sel0.5" in stats
    dec = stats["b8@0.9/sel0.5"]
    assert dec["met"] and dec["recall"] >= 0.9
    assert dec["mode"] in ("scan-bf16-f", "wide-f", "scan-exact-f")

    # a much more selective filter lands in its own bucket
    tiny = {n.id for n in nodes if n.id % 64 == 0}  # ~1.6%
    res2 = svc.search(nodes[64].embedding, k=3, filter_ids=tiny)
    assert res2 and all(n.id in tiny for n, _ in res2)
    assert res2[0][0].id == 64
    assert any("/sel0.02" in kk or "/sel0.01" in kk
               for kk in svc._autotune.stats())

    # batch path: same selectivity bucket is reused, filter honored
    q = np.stack([n.embedding for n in nodes[:16]])
    _, ids = svc.search_batch(q, k=3, filter_ids=allowed)
    assert all(int(v) in allowed for row in ids for v in row if v >= 0)


def test_filtered_autotune_bypassed_for_ivf(tmp_path, rng):
    cfg = {
        "embedding": {"model": "fake-16", "dimension": DIM},
        "index": {
            "M": 8, "ef_construction": 60, "flush_threshold": 100000,
            "type": "ivf", "ivf_k": 16,
            "autotune": {"enabled": True, "target_recall": 0.95,
                         "sample": 24, "k": 5, "min_size": 64},
        },
        "vector_db": {"file_path": str(tmp_path / "vdb"),
                      "dimension": DIM, "capacity": 2048},
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    storage = StorageService(str(tmp_path / "vdb"), dim=DIM, capacity=2048)
    svc = IndexingService(storage=storage.storage, config_path=str(p))
    nodes = [Node(id=i,
                  embedding=rng.standard_normal(DIM).astype(np.float32),
                  metadata={}) for i in range(512)]
    svc.insert_nodes(nodes)
    allowed = {n.id for n in nodes if n.id % 2 == 0}
    res = svc.search(nodes[10].embedding, k=5, filter_ids=allowed)
    assert res and all(n.id in allowed for n, _ in res)
    assert svc._autotune.stats() == {}  # ivf filters keep the direct path
