"""Benchmark / evaluation datasets: real-file loaders + synthetic corpora.

The reference ships no data loaders or benchmarks (SURVEY.md §6). The
rebuild's north star names SIFT1M (BASELINE.json config 3), so this module
provides:

- ``read_fvecs`` / ``read_bvecs`` / ``read_ivecs`` — the TEXMEX binary
  formats SIFT1M ships in (each record: int32 dim, then dim values);
- ``load_sift1m`` — loads a real SIFT1M directory when present (point
  ``SIFT1M_DIR`` at it); this environment has no network egress, so
- ``sift_like`` — a synthetic stand-in with SIFT-like structure: a
  mixture of anisotropic Gaussian clusters with log-normal sizes/scales
  plus background noise, 128-d, non-negative, NOT L2-normalized. Every
  benchmark that uses it says so explicitly in its output.
- ``embedding_like`` — low-intrinsic-dimension (rank-64) L2-normalized
  vectors matching sentence-embedding corpora (the reference's default
  all-MiniLM-L6-v2 output shape, reference src/config.yaml:1-12).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# TEXMEX binary formats (http://corpus-texmex.irisa.fr/ layout)
# ---------------------------------------------------------------------------

def read_fvecs(path, count: Optional[int] = None) -> np.ndarray:
    """Read .fvecs: records of (int32 dim, float32[dim])."""
    raw = np.fromfile(path, dtype=np.int32, count=-1)
    if raw.size == 0:
        return np.zeros((0, 0), np.float32)
    dim = int(raw[0])
    rec = dim + 1
    n = raw.size // rec
    if count is not None:
        n = min(n, count)
    mat = raw[: n * rec].reshape(n, rec)[:, 1:]
    return mat.view(np.float32).copy()


def read_ivecs(path, count: Optional[int] = None) -> np.ndarray:
    """Read .ivecs: records of (int32 dim, int32[dim]) — ground-truth ids."""
    raw = np.fromfile(path, dtype=np.int32, count=-1)
    if raw.size == 0:
        return np.zeros((0, 0), np.int32)
    dim = int(raw[0])
    rec = dim + 1
    n = raw.size // rec
    if count is not None:
        n = min(n, count)
    return raw[: n * rec].reshape(n, rec)[:, 1:].copy()


def read_bvecs(path, count: Optional[int] = None) -> np.ndarray:
    """Read .bvecs: records of (int32 dim, uint8[dim])."""
    raw = np.fromfile(path, dtype=np.uint8, count=-1)
    if raw.size == 0:
        return np.zeros((0, 0), np.float32)
    dim = int(np.frombuffer(raw[:4], np.int32)[0])
    rec = 4 + dim
    n = raw.size // rec
    if count is not None:
        n = min(n, count)
    mat = raw[: n * rec].reshape(n, rec)[:, 4:]
    return mat.astype(np.float32)


def load_sift1m(
    root: Optional[str] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Load real SIFT1M (base, query, groundtruth) if the files exist.

    Looks in ``root`` or ``$SIFT1M_DIR`` for sift_base.fvecs,
    sift_query.fvecs, sift_groundtruth.ivecs. Returns None when absent
    (callers fall back to :func:`sift_like` and must label results).
    """
    d = Path(root or os.environ.get("SIFT1M_DIR", "/data/sift1m"))
    base_f = d / "sift_base.fvecs"
    query_f = d / "sift_query.fvecs"
    gt_f = d / "sift_groundtruth.ivecs"
    if not (base_f.exists() and query_f.exists()):
        return None
    base = read_fvecs(base_f)
    query = read_fvecs(query_f)
    gt = read_ivecs(gt_f) if gt_f.exists() else np.zeros((0, 0), np.int32)
    return base, query, gt


# ---------------------------------------------------------------------------
# synthetic corpora
# ---------------------------------------------------------------------------

def embedding_like(
    n: int, dim: int, seed: int, intrinsic: int = 64,
    device: str = "auto",
) -> np.ndarray:
    """Sentence-embedding-like vectors: rank-``intrinsic`` mixing + noise,
    L2-normalized (matches MiniLM-style embedding geometry).

    ``device="auto"`` generates on the accelerator when one is attached
    and the corpus is large: ~830M gaussians + a 98-GFLOP mix matmul are
    slow in numpy on one core (the device→host pull is streamed in row
    chunks).
    The numpy and device corpora are statistically identical but not
    bit-identical — a corpus cache must never mix the two (the wide1m
    cache regenerates GT/graph whenever the corpus file is rewritten).
    """
    use_dev = False
    if device == "auto" and n * dim >= 64 * (1 << 20):
        try:
            import jax

            use_dev = jax.default_backend() != "cpu"
        except Exception:
            use_dev = False
    if device == "jax" or use_dev:
        return _embedding_like_device(n, dim, seed, intrinsic)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, intrinsic)).astype(np.float32)
    v = rng.standard_normal((intrinsic, dim)).astype(np.float32)
    v /= np.sqrt(intrinsic)
    x = u @ v + 0.05 * rng.standard_normal((n, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _embedding_like_device(
    n: int, dim: int, seed: int, intrinsic: int
) -> np.ndarray:
    """Device-side twin of :func:`embedding_like` (same distribution,
    different bits). One jitted chunk program over fold_in'd keys keeps
    HLO small; the host pull streams chunk by chunk."""
    import jax
    import jax.numpy as jnp

    chunk = 131072
    key = jax.random.PRNGKey(seed)
    kv, kr = jax.random.split(key)
    v = jax.random.normal(kv, (intrinsic, dim), jnp.float32)
    v = v / jnp.sqrt(jnp.float32(intrinsic))

    @jax.jit
    def make_chunk(k, v):
        ku, kn = jax.random.split(k)
        u = jax.random.normal(ku, (chunk, intrinsic), jnp.float32)
        x = jnp.dot(u, v, precision=jax.lax.Precision.HIGHEST)
        x = x + 0.05 * jax.random.normal(kn, (chunk, dim), jnp.float32)
        return x / jnp.linalg.norm(x, axis=1, keepdims=True)

    out = np.empty((n, dim), np.float32)
    for i, s in enumerate(range(0, n, chunk)):
        xc = make_chunk(jax.random.fold_in(kr, i), v)
        e = min(n, s + chunk)
        from vector_db_tpu.runtime import device_pull
        out[s:e] = device_pull(xc[: e - s])
    return out


def sift_like(
    n: int,
    dim: int = 128,
    seed: int = 0,
    n_clusters: int = 1024,
    queries: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """SIFT-shaped synthetic corpus: anisotropic Gaussian mixture.

    Structure chosen to match published SIFT1M characteristics that matter
    for ANN difficulty: strong cluster structure (local intrinsic dimension
    ~10-15 despite ambient 128), log-normal cluster populations, per-cluster
    anisotropic spread, non-negative values, unnormalized norms.

    Returns (base f32[n, dim], queries f32[queries, dim]); queries are drawn
    from the same mixture (held out of the base).
    """
    rng = np.random.default_rng(seed)
    total = n + queries
    centers = rng.gamma(2.0, 24.0, size=(n_clusters, dim)).astype(np.float32)
    # log-normal cluster sizes
    weights = rng.lognormal(0.0, 1.0, size=n_clusters)
    weights /= weights.sum()
    assign = rng.choice(n_clusters, size=total, p=weights)
    # per-cluster anisotropy: a few dominant directions + isotropic floor
    k_dir = 12
    dirs = rng.standard_normal((n_clusters, k_dir, dim)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=2, keepdims=True)
    scales = rng.lognormal(2.2, 0.4, size=(n_clusters, 1)).astype(np.float32)

    coef = rng.standard_normal((total, k_dir)).astype(np.float32)
    x = centers[assign]
    x += scales[assign] * np.einsum("tk,tkd->td", coef, dirs[assign])
    x += 4.0 * rng.standard_normal((total, dim)).astype(np.float32)
    x = np.maximum(x, 0.0)  # SIFT descriptors are non-negative histograms
    x = x.astype(np.float32)
    return x[:n], x[n:]
