"""bf16 scan self-calibration guard (FlatIndex).

A user who pins ``index.precision: bf16`` on a corpus whose neighbor
gaps are below the bf16 rounding noise got silently-garbage results
(a SIFT-like 128-d corpus is such a case);
the guard measures calibration recall on live rows at mirror build and
warns/refuses below threshold. The adversarial corpus here makes the
table-rounding term dominate on any platform: coordinates ~N(0,1)*256
with 0.01-scale neighbor jitter, so bf16's ~2^-9 relative rounding
(~0.5 absolute) swamps the true gaps even with f32 accumulation.
"""

import numpy as np
import pytest

from vector_db_tpu.index.flat import FlatIndex
from vector_db_tpu.types import Node


def _nodes(emb, start=0):
    return [Node(id=start + i, embedding=emb[i], metadata={}) for i in
            range(emb.shape[0])]


def _bad_corpus(n=512, dim=64, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, dim)).astype(np.float32) * 256.0
    base = centers[rng.integers(8, size=n)]
    return (base + 0.01 * rng.standard_normal((n, dim))).astype(np.float32)


def _good_corpus(n=512, dim=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_refuses_on_collapsing_corpus():
    emb = _bad_corpus()
    idx = FlatIndex(capacity=emb.shape[0], precision="bf16",
                    bf16_guard="refuse")
    idx.insert_nodes(_nodes(emb))
    with pytest.raises(RuntimeError, match="bf16 scan calibration"):
        idx.search_batch(emb[:4], k=5)
    assert idx.bf16_calibration is not None
    assert idx.bf16_calibration < 0.9


def test_warns_by_default_and_still_serves():
    emb = _bad_corpus(seed=1)
    idx = FlatIndex(capacity=emb.shape[0], precision="bf16")
    idx.insert_nodes(_nodes(emb))
    with pytest.warns(UserWarning, match="bf16 scan calibration"):
        dists, ids = idx.search_batch(emb[:4], k=5)
    assert ids.shape == (4, 5)


def test_healthy_corpus_passes_silently():
    import warnings

    emb = _good_corpus()
    idx = FlatIndex(capacity=emb.shape[0], precision="bf16",
                    bf16_guard="refuse")
    idx.insert_nodes(_nodes(emb))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        idx.search_batch(emb[:4], k=5)
    assert idx.bf16_calibration is not None
    assert idx.bf16_calibration >= 0.9


def test_recalibrates_only_on_doubling():
    emb = _good_corpus(n=600)
    idx = FlatIndex(capacity=1024, precision="bf16")
    idx.insert_nodes(_nodes(emb[:256]))
    idx.search_batch(emb[:2], k=3)
    first = idx._calibrated_size
    assert first == 256
    idx.insert_nodes(_nodes(emb[256:400], 256))  # < 2x: no recalibration
    idx.search_batch(emb[:2], k=3)
    assert idx._calibrated_size == first
    idx.insert_nodes(_nodes(emb[400:600], 400))  # >= 2x: recalibrates
    idx.search_batch(emb[:2], k=3)
    assert idx._calibrated_size == 600


def test_guard_off_never_calibrates():
    emb = _bad_corpus(seed=2)
    idx = FlatIndex(capacity=emb.shape[0], precision="bf16",
                    bf16_guard="off")
    idx.insert_nodes(_nodes(emb))
    idx.search_batch(emb[:2], k=3)
    assert idx.bf16_calibration is None
