"""Accelerator-native vector database engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
GProgrammer1/Vector-DB (HNSW + IVF ANN indexes, product quantization, exact
search, tiered persistent vector storage, metadata filtering, and a FastAPI
embed/search frontend), built for the accelerator first:

- distances are fused batched matmuls, not per-pair Python calls
  (reference: src/vector_db/util/distance.py:3-4 called per graph edge);
- HNSW is fixed-degree int32 device neighbor tables traversed by a batched,
  masked beam search under ``jax.lax.while_loop`` (reference:
  src/vector_db/indexing/hnsw.py — heapq + dict pointer chasing);
- PQ trains codebooks with vmapped k-means and scores via fused ADC
  lookup-table scans (reference: src/vector_db/inference/pq.py —
  ProcessPoolExecutor + per-vector Python loops);
- the corpus shards across a ``jax.sharding.Mesh`` with per-shard search and
  all-gather top-k merges (reference: docker-compose replica copies).
"""

__version__ = "0.1.0"

from vector_db_tpu.types import Node

__all__ = [
    "Node",
    "__version__",
    # lazy: FlatIndex, HNSW, IvfIndex, PQCodec, ProductQuantizationService,
    # MemoryMappingService — import from vector_db_tpu.index /
    # vector_db_tpu.engine (importing them here would pull jax into every
    # lightweight consumer, e.g. the embedding service container).
]


def __getattr__(name):  # lazy top-level conveniences
    if name in ("FlatIndex", "HNSW", "IvfIndex", "PQCodec",
                "ProductQuantizationService"):
        import vector_db_tpu.index as _index

        return getattr(_index, name)
    if name == "MemoryMappingService":
        from vector_db_tpu.engine import MemoryMappingService

        return MemoryMappingService
    raise AttributeError(name)
