"""Triton LUT probe scan (ops/pallas/lut_probe.py) in the Pallas
interpreter, against a numpy oracle and against the XLA gather path of
the IVF-PQ probe."""

import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_tpu.ops.pallas.lut_probe import lut_probe_scores


@pytest.mark.parametrize("k,L,m,ksub,b,n_probe,tl", [
    (8, 300, 4, 16, 3, 3, 32),     # L not a tile multiple
    (4, 64, 8, 32, 2, 4, 64),      # one full tile per cell
])
def test_lut_probe_matches_oracle(rng, k, L, m, ksub, b, n_probe, tl):
    codes = rng.integers(0, ksub, (k, L, m)).astype(np.uint8)
    lens = rng.integers(0, L + 1, k).astype(np.int32)
    lens[0] = L  # a full cell
    lut = rng.standard_normal((b, m * ksub)).astype(np.float32)
    probe = rng.integers(0, k, (b, n_probe)).astype(np.int32)
    probe[:, 0] = 0
    out = np.asarray(lut_probe_scores(
        jnp.asarray(probe), jnp.asarray(lens), jnp.asarray(codes),
        jnp.asarray(lut), tl=tl, interpret=True))
    assert out.shape == (b, n_probe * L)
    offs = np.arange(m) * ksub
    for q in range(b):
        for p in range(n_probe):
            c = probe[q, p]
            n = lens[c]
            want = lut[q][offs + codes[c, :n].astype(int)].sum(axis=1)
            np.testing.assert_allclose(out[q, p * L: p * L + n], want,
                                       rtol=1e-6, atol=1e-5)


def test_probe_path_with_kernel_matches_xla_gather():
    from vector_db_tpu.datasets import sift_like
    from vector_db_tpu.index.ivf import IvfIndex, _ivf_pq_probe_cells
    from vector_db_tpu.types import Node

    x, q = sift_like(4096, 32, seed=0, queries=16)
    index = IvfIndex(k=16)
    index.build_index([Node(id=i, embedding=x[i]) for i in range(len(x))])
    index.enable_pq(chunks=8, ksub=32, residual=True)
    cells, codes, cell_s = index._device_cells()
    qd = jnp.asarray(q)
    args = (index._centroids_dev, cells, codes, cell_s, index._pq.codebooks,
            index._emb, index._has_emb, qd, index._pq.rotate_queries(qd))
    kw = dict(n_probe=4, top_k=10, fetch=100, rerank=True, residual=True,
              qblock=8)
    d0, i0 = _ivf_pq_probe_cells(*args, **kw)
    d1, i1 = _ivf_pq_probe_cells(*args, lut_kernel=True, interpret=True,
                                 **kw)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), rtol=1e-6)


@pytest.mark.parametrize("platform,on", [("gpu", True), ("cpu", False)])
def test_lut_kernel_per_platform(platform, on):
    from vector_db_tpu.index.ivf import lut_kernel_on

    assert lut_kernel_on(platform) is on


def test_lut_kernel_unknown_platform_raises():
    from vector_db_tpu.index.ivf import lut_kernel_on

    with pytest.raises(ValueError, match="no formulation"):
        lut_kernel_on("metal")


def test_probe_qblock_sizes_by_transient():
    from vector_db_tpu.index.ivf import probe_qblock

    p = 16 * 12932  # SIFT-shape probe: 16 cells of the largest cell's rows
    assert probe_qblock(p, 16, lut_kernel=True) == 128
    assert probe_qblock(p, 16, lut_kernel=False) == 16
    # small probes: the per-path caps
    assert probe_qblock(100, 16, lut_kernel=False) == 64
    assert probe_qblock(100, 16, lut_kernel=True) == 128
    # the floor of 4 queries per step, however large the probe
    assert probe_qblock(1 << 26, 16, lut_kernel=False) == 4
