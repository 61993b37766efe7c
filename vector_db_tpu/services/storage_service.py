"""Storage lifecycle service.

Parity target: reference ``StorageService``
(src/vector_db/services/storage_service.py:11-142): wraps MMapNodeStorage,
derives ``<base>.embeddings.npy`` / ``<base>.metadata.npy`` file names,
CRUD passthrough, ``filter_by_metadata`` full-scan with exact key/value
match, and the same constructor validation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Set

import numpy as np

from vector_db_tpu.storage import MMapNodeStorage
from vector_db_tpu.storage.mmap import CONTENT_CHARS, METADATA_CHARS
from vector_db_tpu.types import Node


class StorageService:
    def __init__(self, file_path: str, dim: int, capacity: int,
                 content_chars: int = CONTENT_CHARS,
                 metadata_chars: int = METADATA_CHARS) -> None:
        """``content_chars`` / ``metadata_chars`` are the fixed row widths
        of the content layer (4 bytes per char): the defaults hold the
        reference's widths, ~61 KB per row."""
        if dim <= 0:
            raise ValueError("Dimension must be greater than 0")
        if capacity <= 0:
            raise ValueError("Capacity must be greater than 0")
        self.file_path = Path(file_path)
        self.dim = int(dim)
        self.capacity = int(capacity)
        self._storage = MMapNodeStorage(
            embedding_file=self.file_path.with_suffix(".embeddings.npy"),
            metadata_file=self.file_path.with_suffix(".metadata.npy"),
            dim=dim,
            capacity=capacity,
            content_chars=content_chars,
            metadata_chars=metadata_chars,
        )
        # Inverted metadata index (native C++ when a toolchain exists,
        # Python dicts otherwise) — same exact-match semantics as the
        # reference's full scan, O(matches) per filter query. Hydrated from
        # storage on open so reopen-resume keeps filters correct.
        from vector_db_tpu.native.metadata import MetadataIndex

        self._meta_index = MetadataIndex()
        if hasattr(self._storage, "iter_metadata"):
            # bulk path: one metadata-column read, no embedding copies /
            # Node construction per id (1M-capacity reopen in seconds)
            for nid, metadata, _content in self._storage.iter_metadata():
                self._meta_index.set(nid, metadata)
        else:
            for nid in self._storage.get_all_ids():
                node = self._storage.get(nid)
                if node is not None:
                    self._meta_index.set(nid, node.metadata)

    def save(self, node: Node) -> None:
        self._storage.save(node)
        self._meta_index.set(node.id, node.metadata)

    def save_many(self, nodes) -> None:
        """Batched save: one flush per layer instead of per document (the
        batch-ingest hot path; see MMapNodeStorage.save_many)."""
        self._storage.save_many(nodes)
        for node in nodes:
            self._meta_index.set(node.id, node.metadata)

    def get(self, node_id: int) -> Optional[Node]:
        return self._storage.get(node_id)

    def get_embedding(self, node_id: int) -> np.ndarray:
        return self._storage.get_embedding(node_id)

    def delete(self, node_id: int) -> None:
        self._storage.delete(node_id)
        self._meta_index.remove(node_id)

    def get_next_id(self) -> int:
        return self._storage.get_next_id()

    def filter_by_metadata(self, filter_dict: Dict[str, Any]) -> Set[int]:
        """Exact key/value match (reference semantics,
        storage_service.py:106-128) served from the inverted metadata
        index — O(matches) instead of the reference's O(N) scan."""
        return self._meta_index.query(filter_dict)

    def filter_by_metadata_scan(self, filter_dict: Dict[str, Any]) -> Set[int]:
        """Reference-identical full scan; kept as the semantic oracle for
        the indexed path (tests assert equality)."""
        matching: Set[int] = set()
        for nid in self._storage.get_all_ids():
            node = self._storage.get(nid)
            if node is None:
                continue
            if all(node.metadata.get(k) == v for k, v in filter_dict.items()):
                matching.add(nid)
        return matching

    def size(self) -> int:
        return self._storage.size()

    def close(self) -> None:
        self._storage.close()

    @property
    def storage(self) -> MMapNodeStorage:
        """Underlying storage (for the indexing service)."""
        return self._storage
