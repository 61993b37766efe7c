"""Embedding engine tests.

The heavyweight model path is covered with a patched SentenceTransformer —
the reference's own strategy (tests/inference/test_embedding.py:8-10
injects module mocks); the deterministic hashing embedder is tested for
real (it IS a real component here, not a mock).
"""

from unittest.mock import MagicMock, patch

import numpy as np
import pytest

from vector_db_tpu.embedding.device import (
    get_device,
    get_device_info,
    is_accelerator_available,
)
from vector_db_tpu.embedding.fake import HashingEmbedder


def test_hashing_embedder_deterministic():
    e = HashingEmbedder(32)
    a = e.embed_text("hello")
    b = e.embed_text("hello")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (32,)
    assert abs(np.linalg.norm(a) - 1.0) < 1e-5
    assert not np.allclose(a, e.embed_text("other"))


def test_hashing_embedder_batch_matches_single():
    e = HashingEmbedder(16)
    m = e.embed_texts(["x", "y"])
    np.testing.assert_array_equal(m[0], e.embed_text("x"))
    np.testing.assert_array_equal(m[1], e.embed_text("y"))
    assert e.embed_texts([]).shape == (0, 16)


def test_hashing_embedder_validation():
    with pytest.raises(ValueError):
        HashingEmbedder(0)


def test_sentence_transformer_wrapper_mocked():
    import vector_db_tpu.embedding.st as st_mod

    fake_model = MagicMock()
    fake_model.get_sentence_embedding_dimension.return_value = 8
    fake_model.encode.return_value = np.ones(8, np.float32)
    fake_cls = MagicMock(return_value=fake_model)
    with patch.object(st_mod, "SentenceTransformer", fake_cls), \
         patch.object(st_mod, "_HAS_ST", True):
        emb = st_mod.SentenceTransformerEmbedder("some-model", device="gpu")
        # non-torch device names fall back to cpu for the torch model
        assert fake_cls.call_args.kwargs["device"] == "cpu"
        assert emb.dim == 8
        v = emb.embed_text("hi")
        assert v.shape == (8,)


def test_sentence_transformer_missing_raises():
    import vector_db_tpu.embedding.st as st_mod

    with patch.object(st_mod, "_HAS_ST", False):
        with pytest.raises(RuntimeError, match="sentence-transformers"):
            st_mod.SentenceTransformerEmbedder("some-model")


def test_device_utils_on_cpu():
    # tests force the cpu platform (conftest)
    assert get_device("cpu") == "cpu"
    assert get_device("auto") == "cpu"
    assert is_accelerator_available() is False
    info = get_device_info()
    assert info["device_count"] == 8  # virtual mesh
    assert info["platforms"] == ["cpu"]


def test_get_device_gpu_raises_without_gpu():
    """No silent CPU fallback: 'gpu' on a CPU-only process is an error."""
    with pytest.raises(RuntimeError, match="no GPU"):
        get_device("gpu")


@pytest.mark.parametrize("pref", ["tpu", "mps"])
def test_get_device_unknown_raises(pref):
    with pytest.raises(ValueError, match="unknown device"):
        get_device(pref)
