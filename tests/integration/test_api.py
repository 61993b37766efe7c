"""API integration tests, mirroring the reference's
(tests/integration/test_search_api.py): insert-then-search over real
storage/indexing services with a deterministic embedder, metadata filter
semantics, empty-filter short-circuit, extra-params passthrough — plus the
embedding service app and the batch endpoints.

Driven through aiohttp's TestClient with asyncio.run (no pytest-asyncio in
this environment).
"""

import asyncio

import numpy as np
import pytest
import yaml

from aiohttp.test_utils import TestClient, TestServer

from vector_db_tpu.api.app import create_app
from vector_db_tpu.api.embedding_app import create_app as create_embedding_app
from vector_db_tpu.services.embedding_service import EmbeddingService
from vector_db_tpu.services.indexing_service import IndexingService
from vector_db_tpu.services.storage_service import StorageService


@pytest.fixture
def config_path(tmp_path):
    cfg = {
        "embedding": {"model": "fake-32", "dimension": 32},
        "device": "cpu",
        "index": {"ef_construction": 40, "M": 4, "flush_threshold": 100},
        "vector_db": {
            "file_path": str(tmp_path / "vdb"),
            "dimension": 32,
            "capacity": 256,
        },
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def run(coro):
    return asyncio.run(coro)


async def _client_for(config_path, tmp_path):
    embedding = EmbeddingService(config_path)
    storage = StorageService(str(tmp_path / "vdb"), dim=32, capacity=256)
    indexing = IndexingService(
        storage=storage.storage, config_path=config_path,
        index_file=str(tmp_path / "vdb.index.npz"),
    )
    app = create_app(
        config_path=config_path,
        embedding_client=embedding,
        storage_service=storage,
        indexing_service=indexing,
    )
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def test_health(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        r = await client.get("/health")
        assert r.status == 200
        body = await r.json()
        assert body["status"] == "healthy"
        assert body["index_size"] == 0
        assert body["storage_size"] == 0
        assert body["index_loaded"] is False
        await client.close()

    run(go())


def test_insert_then_search(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        docs = ["the cat sat", "a dog barked", "quantum mechanics", "gpu kernels"]
        for d in docs:
            r = await client.post(
                "/embed", json={"content": d, "metadata": {"kind": "test"}}
            )
            assert r.status == 200
            body = await r.json()
            assert body["status_code"] == 200

        r = await client.get("/health")
        body = await r.json()
        assert body["index_size"] == 4
        assert body["storage_size"] == 4
        assert body["index_modified"] is True

        r = await client.post(
            "/search", json={"query": "the cat sat", "top_k": 2}
        )
        assert r.status == 200
        body = await r.json()
        assert body["status_code"] == 200
        results = body["results"]
        assert len(results) == 2
        # same text embeds identically -> exact match first with distance ~0
        assert results[0]["content"] == "the cat sat"
        assert results[0]["distance"] < 1e-3
        assert results[0]["metadata"] == {"kind": "test"}
        await client.close()

    run(go())


def test_metadata_filter(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        for i, cat in enumerate(["a", "b", "a", "b", "a"]):
            await client.post(
                "/embed", json={"content": f"document {i}", "metadata": {"cat": cat}}
            )
        r = await client.post(
            "/search",
            json={"query": "document 1", "top_k": 5,
                  "metadata_filter": {"cat": "a"}},
        )
        body = await r.json()
        cats = {res["metadata"]["cat"] for res in body["results"]}
        assert cats == {"a"}
        assert len(body["results"]) == 3
        await client.close()

    run(go())


def test_empty_filter_short_circuit(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        await client.post("/embed", json={"content": "only doc"})
        r = await client.post(
            "/search",
            json={"query": "only doc", "top_k": 5,
                  "metadata_filter": {"cat": "missing"}},
        )
        body = await r.json()
        assert body["status_code"] == 200
        assert body["results"] == []
        await client.close()

    run(go())


def test_extra_params_passthrough(config_path, tmp_path):
    async def go():
        # Unknown params must be ignored by the index (reference
        # hnsw.py:330-341 accepts **kwargs).
        client = await _client_for(config_path, tmp_path)
        await client.post("/embed", json={"content": "something"})
        r = await client.post(
            "/search",
            json={"query": "something", "top_k": 1, "pq_chunks": 4,
                  "params": {"bogus_knob": 7}},
        )
        assert r.status == 200
        body = await r.json()
        assert body["status_code"] == 200
        assert len(body["results"]) == 1
        await client.close()

    run(go())


def test_batch_endpoints(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        docs = [f"batch doc {i}" for i in range(8)]
        r = await client.post(
            "/embed/batch-docs",
            json={"contents": docs,
                  "metadatas": [{"i": i} for i in range(8)]},
        )
        assert r.status == 200
        body = await r.json()
        assert len(body["ids"]) == 8

        r = await client.post(
            "/search/batch",
            json={"queries": ["batch doc 0", "batch doc 5"], "top_k": 1},
        )
        body = await r.json()
        assert body["status_code"] == 200
        assert body["results"][0][0]["content"] == "batch doc 0"
        assert body["results"][1][0]["content"] == "batch doc 5"

        r = await client.get("/metrics")
        m = await r.json()
        assert m["POST /embed/batch-docs"]["requests"] == 1
        assert m["POST /search/batch"]["errors"] == 0
        await client.close()

    run(go())


def test_validation_error_is_422(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        r = await client.post("/embed", json={"not_content": "x"})
        assert r.status == 422
        await client.close()

    run(go())


def test_embedding_service_app(config_path):
    async def go():
        app = create_embedding_app(config_path=config_path)
        client = TestClient(TestServer(app))
        await client.start_server()

        r = await client.get("/health")
        body = await r.json()
        assert body["status"] == "healthy"
        assert body["dimension"] == 32

        r = await client.post("/embed", json={"text": "hello"})
        assert r.status == 200
        body = await r.json()
        assert body["dimension"] == 32
        assert len(body["embedding"]) == 32

        r = await client.post("/embed/batch", json={"texts": ["a", "b"]})
        body = await r.json()
        assert body["count"] == 2
        assert len(body["embeddings"]) == 2
        # determinism across single and batch paths
        r2 = await client.post("/embed", json={"text": "a"})
        single = (await r2.json())["embedding"]
        assert np.allclose(single, body["embeddings"][0])
        await client.close()

    run(go())


def test_stats_endpoint(config_path, tmp_path):
    async def go():
        client = await _client_for(config_path, tmp_path)
        await client.post("/embed", json={"content": "a doc"})
        r = await client.get("/stats")
        assert r.status == 200
        body = await r.json()
        assert body["index"]["type"] == "hnsw"
        assert body["index"]["size"] == 1
        assert body["storage"]["size"] == 1
        assert body["storage"]["dim"] == 32
        assert "device" in body
        await client.close()

    run(go())


def test_n_probe_forwarded_to_service(config_path, tmp_path):
    """QueryRequest.n_probe must reach the index (the reference accepts it
    in its schema but its HNSW-only service drops it; our IVF honors it)."""
    seen = {}

    async def go():
        embedding = EmbeddingService(config_path)
        storage = StorageService(str(tmp_path / "vdb"), dim=32, capacity=256)
        indexing = IndexingService(
            storage=storage.storage, config_path=config_path,
            index_file=str(tmp_path / "vdb.index.npz"),
        )
        orig = indexing.search

        def spy(query, k, **kwargs):
            seen.update(kwargs)
            return orig(query, k, **kwargs)

        indexing.search = spy
        from vector_db_tpu.api.app import create_app as mk
        app = mk(config_path=config_path, embedding_client=embedding,
                 storage_service=storage, indexing_service=indexing)
        client = TestClient(TestServer(app))
        await client.start_server()
        await client.post("/embed", json={"content": "a doc"})
        r = await client.post(
            "/search", json={"query": "a doc", "top_k": 1, "n_probe": 3}
        )
        assert r.status == 200
        await client.close()

    run(go())
    assert seen.get("n_probe") == 3
