from vector_db_tpu.services.storage_service import StorageService
from vector_db_tpu.services.indexing_service import IndexingService
from vector_db_tpu.services.embedding_service import EmbeddingService

__all__ = [
    "StorageService",
    "IndexingService",
    "EmbeddingService",
    "EmbeddingClient",
    "SyncEmbeddingClient",
]


def __getattr__(name):
    # the HTTP clients need httpx; import it only when a client is asked
    # for, so the engine and services load without it
    if name in ("EmbeddingClient", "SyncEmbeddingClient"):
        from vector_db_tpu.services import embedding_client

        return getattr(embedding_client, name)
    raise AttributeError(name)
