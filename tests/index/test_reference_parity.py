"""Recall-parity regression guard.

The reference HNSW was measured head-to-head on this exact corpus
(2000 x 384-d isotropic gaussian, seed 0, M=16, ef_construction=200):
recall@10 = 0.877 / 0.953 / 0.977 at ef = 50 / 100 / 200
(matching trajectory measured for this engine at the time of writing).
This test pins our engine to within a small tolerance of those anchors so
parity never silently regresses.
"""

import random

import numpy as np
import pytest

from vector_db_tpu.index.hnsw import HNSW

REFERENCE_ANCHORS = {50: 0.877, 100: 0.953, 200: 0.977}
TOLERANCE = 0.02  # the recall trajectory is stable: a 6-point
# regression must not pass


@pytest.mark.slow
def test_recall_parity_with_reference_trajectory():
    rng = np.random.default_rng(0)
    n, dim = 2000, 384
    x = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((30, dim)).astype(np.float32)
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]

    index = HNSW(M=16, ef_construction=200, rng=random.Random(42),
                 capacity=2048, l_max=5)
    index.insert_arrays(list(range(n)), x, batch_size=1024)

    for ef, anchor in REFERENCE_ANCHORS.items():
        _, ids = index.search_batch(q, k=10, ef=ef)
        rec = np.mean([len(set(ids[i]) & set(gt[i])) / 10
                       for i in range(len(q))])
        assert rec >= anchor - TOLERANCE, (
            f"ef={ef}: recall {rec:.3f} fell below reference anchor "
            f"{anchor} - {TOLERANCE}"
        )
