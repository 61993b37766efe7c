"""Core record types.

Parity target: reference ``src/vector_db/types.py:5-10`` (``Node`` dataclass
with ``id``, ``embedding``, ``metadata``, ``content``). On the device side
nodes are decomposed structure-of-arrays style — ``ids: int32[N]``,
``embeddings: f32[capacity, dim]`` on device, host-side metadata/content — but
the host-facing API keeps the same ``Node`` record shape.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class Node:
    """A single vector record.

    Mirrors the reference ``Node`` (src/vector_db/types.py:5-10): integer id,
    embedding vector, free-form metadata dict, and optional raw content.
    """

    id: int
    embedding: np.ndarray
    metadata: Dict[str, Any] = field(default_factory=dict)
    content: Optional[str] = None

    def __post_init__(self) -> None:
        if self.metadata is None:
            self.metadata = {}
        self.embedding = np.asarray(self.embedding, dtype=np.float32)
