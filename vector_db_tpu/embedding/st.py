"""sentence-transformers embedding engine (optional dependency).

Parity target: reference ``EmbeddingService``
(src/vector_db/inference/embedding.py:8-52): wraps a SentenceTransformer,
moves it to the selected device, exposes ``embed_text`` / ``embed_texts``
returning numpy. torch runs CPU-side here — the GPU is reserved for the
index engine's one JAX process; swap-in of a JAX-native encoder is a
later optimization.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

try:  # torch/sentence-transformers are optional (reference device.py:5-11)
    from sentence_transformers import SentenceTransformer

    _HAS_ST = True
except Exception:  # pragma: no cover - absent/broken optional dep
    SentenceTransformer = None  # type: ignore[assignment]
    _HAS_ST = False


def has_sentence_transformers() -> bool:
    return _HAS_ST


class SentenceTransformerEmbedder:
    def __init__(self, model_name: str, device: Optional[str] = None) -> None:
        if not _HAS_ST:
            raise RuntimeError(
                "sentence-transformers is not installed; use the fake "
                "embedder (model name 'fake-<dim>') or install the "
                "'embedding' extra"
            )
        # jax device names ("gpu") are not torch devices; torch encodes on
        # CPU unless an explicit torch device is passed.
        torch_device = device if device in ("cpu", "cuda", "mps") else "cpu"
        self.model_name = model_name
        self.model = SentenceTransformer(model_name, device=torch_device)
        self.dim = int(self.model.get_sentence_embedding_dimension())

    def embed_text(self, text: str) -> np.ndarray:
        return np.asarray(
            self.model.encode(text, convert_to_numpy=True), np.float32
        )

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray(
            self.model.encode(list(texts), convert_to_numpy=True), np.float32
        )

    def close(self) -> None:
        pass
