"""Node storage contract.

Parity target: reference ``NodeStorage`` ABC (src/vector_db/storage.py:15-51)
— save/get/get_embedding/get_all_ids/size/close/add — plus the non-ABC
``delete``/``get_next_id`` that every concrete reference backend grows.
Here those two are part of the contract proper.

Storage holds embeddings + metadata/content; index structures hold only
graph state and reference storage by id (reference hnsw.py:18-21).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

import numpy as np

from vector_db_tpu.types import Node


class NodeStorage(ABC):
    """Abstract node persistence backend."""

    @abstractmethod
    def save(self, node: Node) -> None:
        """Insert or overwrite a node."""

    @abstractmethod
    def get(self, node_id: int) -> Optional[Node]:
        """Fetch a full node record, or None if absent."""

    @abstractmethod
    def get_embedding(self, node_id: int) -> np.ndarray:
        """Fetch just the embedding. Raises KeyError if absent."""

    @abstractmethod
    def get_all_ids(self) -> List[int]:
        """All live node ids."""

    @abstractmethod
    def size(self) -> int:
        """Number of live nodes."""

    @abstractmethod
    def delete(self, node_id: int) -> None:
        """Remove a node. No-op if absent."""

    @abstractmethod
    def get_next_id(self) -> int:
        """Allocate the next unused id (monotonic)."""

    def save_many(self, nodes) -> None:
        """Save a batch; backends with per-write flushes override this
        to flush once per batch."""
        for node in nodes:
            self.save(node)

    def add(self, node: Node) -> None:
        """Alias for save (reference storage.py:49-51)."""
        self.save(node)

    def get_embeddings(self, ids) -> "tuple[np.ndarray, np.ndarray]":
        """Bulk embedding fetch: (f32[n, dim] — zero rows where missing,
        found bool[n]). Default loops :meth:`get_embedding`; memmap
        backends override with one vectorized read — this is the
        1M-capacity index-reopen path, where a per-id Python loop costs
        minutes."""
        ids = list(ids)
        found = np.zeros(len(ids), bool)
        out: Optional[np.ndarray] = None
        for j, nid in enumerate(ids):
            try:
                v = np.asarray(self.get_embedding(int(nid)), np.float32)
            except KeyError:
                continue
            if out is None:
                out = np.zeros((len(ids), v.shape[0]), np.float32)
            out[j] = v
            found[j] = True
        if out is None:
            out = np.zeros((len(ids), 0), np.float32)
        return out, found

    def close(self) -> None:
        """Release resources; default no-op."""
