"""Batched distance kernels.

Accelerator-native replacement for the reference's per-pair
``euclidean_vector_distance`` (src/vector_db/util/distance.py:3-4), which the
reference calls once per graph edge inside Python loops
(src/vector_db/indexing/hnsw.py:102-131). Here every distance computation is
a batched matmul expansion ``||q - x||² = ||q||² - 2 q·x + ||x||²`` so the
FLOPs land on the matrix units and elementwise terms fuse into the matmul
epilogue.

All distances are SQUARED L2 internally (monotone in L2, so rankings match);
take ``sqrt`` only at the host-facing edge for reference-parity distance
values.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Sentinel "infinite" distance for masked entries. A numpy scalar, NOT a
# jnp array: module import must never initialize the JAX backend (services
# pin the platform from config AFTER import; a device allocation here would
# grab the GPU on import and race concurrent processes for it).
BIG = np.float32(3.0e38)


def squared_norms(x: jnp.ndarray) -> jnp.ndarray:
    """Row-wise squared L2 norms: f32[N, d] -> f32[N]."""
    return jnp.sum(x * x, axis=-1)


def l2_sq(q: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Squared L2 between one query f32[d] and rows of x f32[N, d] -> f32[N]."""
    return l2_sq_pairwise(q[None, :], x)[0]


def l2_sq_pairwise(
    q: jnp.ndarray,
    x: jnp.ndarray,
    x_sq: jnp.ndarray | None = None,
    precision=None,
) -> jnp.ndarray:
    """Squared L2 distance matrix: f32[B, d] × f32[N, d] -> f32[B, N].

    ``x_sq`` (precomputed row norms of ``x``) is an optional cache — the
    corpus norms are computed once at ingest and reused per query batch.
    The ``q·xᵀ`` term is a single matmul.

    ``precision``: at DEFAULT precision an f32 matmul may multiply in
    reduced precision (TF32 on the GPU); on unnormalized corpora
    (‖x‖² ≫ neighbor gaps, e.g. SIFT) that noise exceeds the gaps and
    "exact" results misrank. Query-facing exact paths pass
    ``jax.lax.Precision.HIGHEST`` (f32-accurate); throughput-critical
    build internals keep DEFAULT.
    """
    if x_sq is None:
        x_sq = squared_norms(x)
    q_sq = squared_norms(q)
    cross = jnp.dot(q, x.T, precision=precision,
                    preferred_element_type=jnp.float32)
    d = q_sq[:, None] - 2.0 * cross + x_sq[None, :]
    # Guard tiny negatives from float cancellation (exact self-match must be 0).
    return jnp.maximum(d, 0.0)


def cosine_distance_pairwise(q: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Cosine distance matrix 1 - cos(q, x): f32[B, d] × f32[N, d] -> f32[B, N].

    The reference only supports L2; cosine is added because its default
    embedder (all-MiniLM-L6-v2) L2-normalizes, making L2 ranking monotone in
    cosine — supporting both explicitly lets callers pick either.
    """
    qn = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    xn = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    return 1.0 - jnp.dot(qn, xn.T, preferred_element_type=jnp.float32)


def gather_l2_sq(
    q: jnp.ndarray, emb: jnp.ndarray, idx: jnp.ndarray, valid: jnp.ndarray,
    precision="HIGHEST",
) -> jnp.ndarray:
    """Distances from one query to a gathered index set, masked.

    q: f32[d]; emb: f32[capacity, d]; idx: int32[K] (may contain -1 padding);
    valid: bool[K]. Returns f32[K] with BIG where invalid.

    This is the HNSW neighbor-expansion primitive: gather K embedding rows
    from device memory, one (K, d) · (d,) contraction, mask.

    ``precision`` defaults to HIGHEST — this is also the exact-rerank
    primitive, and reduced-precision DEFAULT matvecs misrank
    unnormalized corpora. Hot traversal/construction loops that only
    SELECT candidates (a rerank follows) pass ``None`` (DEFAULT).
    """
    import jax

    if precision == "HIGHEST":
        precision = jax.lax.Precision.HIGHEST
    safe = jnp.maximum(idx, 0)
    rows = emb[safe]  # [K, d] gather — traffic at the TABLE's dtype
    if rows.dtype != jnp.float32:
        # bf16 table: gather halves HBM traffic, math still runs f32
        rows = rows.astype(jnp.float32)
    q = q.astype(jnp.float32)
    diff_sq = (
        jnp.sum(rows * rows, axis=-1)
        - 2.0 * jnp.dot(rows, q, precision=precision,
                        preferred_element_type=jnp.float32)
        + jnp.dot(q, q, preferred_element_type=jnp.float32)
    )
    diff_sq = jnp.maximum(diff_sq, 0.0)
    ok = valid & (idx >= 0)
    return jnp.where(ok, diff_sq, BIG)
