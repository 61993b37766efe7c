"""JAX k-means (Lloyd's algorithm) as matmuls.

Accelerator-native replacement for the reference's two k-means call sites:
``scipy.cluster.vq.kmeans2(k, iter=100, minit='points')`` in the IVF index
(src/vector_db/indexing/ivf.py:75) and the per-subspace ProcessPoolExecutor
fan-out in PQ training (src/vector_db/inference/pq.py:64-75). Semantics
matched: 'points' init (k distinct rows sampled without replacement), fixed
iteration count, and empty clusters keep their previous centroid (kmeans2's
default behaviour short of a warning).

The E-step distance matrix is a batched matmul; the M-step is a one-hot
matmul (``assign_onehotᵀ @ x``) so both steps are matmuls. Subspace
parallelism (PQ) is a ``vmap`` over this function — one compiled program
replaces one OS process per subspace.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from vector_db_tpu.ops.distance import l2_sq_pairwise


def _lloyd(x: jnp.ndarray, init_centroids: jnp.ndarray, iters: int):
    k = init_centroids.shape[0]

    def step(centroids, _):
        d = l2_sq_pairwise(x, centroids)  # [N, k]
        labels = jnp.argmin(d, axis=-1)
        onehot = jax.nn.one_hot(labels, k, dtype=x.dtype)  # [N, k]
        sums = jnp.dot(onehot.T, x, preferred_element_type=jnp.float32)
        counts = jnp.sum(onehot, axis=0)
        new = sums / jnp.maximum(counts[:, None], 1.0)
        # Empty cluster: keep the previous centroid (kmeans2 'warn' semantics).
        new = jnp.where(counts[:, None] > 0, new, centroids)
        return new, None

    centroids, _ = jax.lax.scan(step, init_centroids, None, length=iters)
    d = l2_sq_pairwise(x, centroids)
    labels = jnp.argmin(d, axis=-1).astype(jnp.int32)
    inertia = jnp.sum(jnp.min(d, axis=-1))
    return centroids, labels, inertia


@partial(jax.jit, static_argnames=("k", "iters", "restarts"))
def kmeans(
    x: jnp.ndarray,
    k: int,
    key: jax.Array,
    iters: int = 100,
    restarts: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lloyd's k-means with optional vmapped restarts (best inertia wins).

    x: f32[N, d]. Returns (centroids f32[k, d], labels int32[N]).
    """
    n = x.shape[0]
    keys = jax.random.split(key, restarts)
    init_idx = jax.vmap(
        lambda kk: jax.random.choice(kk, n, shape=(k,), replace=False)
    )(keys)
    cents, labels, inertias = jax.vmap(lambda ic: _lloyd(x, x[ic], iters))(init_idx)
    best = jnp.argmin(inertias)
    return cents[best], labels[best]


@partial(jax.jit, static_argnames=("tile", "n_cand"))
def assign_tiled(
    x: jnp.ndarray,
    centroids: jnp.ndarray,
    tile: int = 65536,
    n_cand: int = 1,
) -> jnp.ndarray:
    """Nearest-centroid assignment of a large corpus, streamed in tiles.

    x: f32[N, d]; centroids: f32[k, d]. Returns int32[N, n_cand] — each
    row's ``n_cand`` nearest centroids, best first. This is the scalable
    complement to :func:`kmeans`: train on a subsample, then assign the
    full corpus with one streaming pass of matmuls (the E-step only).
    """
    n, dim = x.shape
    pad = (-n) % tile
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad, dim), x.dtype)], axis=0)
    xt = x.reshape(-1, tile, dim)

    def body(_, rows):
        d = l2_sq_pairwise(rows, centroids)
        _, idx = jax.lax.top_k(-d, n_cand)
        return None, idx.astype(jnp.int32)

    _, out = jax.lax.scan(body, None, xt)
    return out.reshape(-1, n_cand)[:n]


def kmeans_multi(
    x: jnp.ndarray,
    k: int,
    key: jax.Array,
    iters: int = 100,
    restarts: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """vmapped k-means over a leading "subspace" axis.

    x: f32[S, N, d] -> (centroids f32[S, k, d], labels int32[S, N]).
    This is the PQ codebook trainer: all subspaces train concurrently in one
    XLA program (reference used one OS process per subspace,
    src/vector_db/inference/pq.py:72-74).
    """
    keys = jax.random.split(key, x.shape[0])
    return jax.vmap(
        lambda xs, ks: kmeans(xs, k, ks, iters=iters, restarts=restarts)
    )(x, keys)
