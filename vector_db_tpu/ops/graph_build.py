"""Bulk graph-construction ops: batched occlusion pruning + reverse edges.

The reference selects neighbors as the naive closest-M
(src/vector_db/indexing/hnsw.py:136-141 — no paper heuristic). For bulk
builds this module implements the HNSW-paper / DiskANN occlusion rule as a
batched device kernel: a candidate c (in ascending distance order) is
dropped when an already-selected s is closer to c than c is to the query
node, i.e. ``d(c, s) < alpha * d(c, q)`` — edges then spread across
directions instead of bunching inside one tight cluster. Pruned-out slots
are refilled with the closest rejected candidates (keep-pruned-connections),
so rows stay at full degree.

All pairwise candidate distances come from one batched matmul per node
chunk; the selection scan is a static unroll over K candidates of [C, K]
vector ops.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from vector_db_tpu.ops.distance import BIG
from vector_db_tpu.ops.topk import masked_top_k_smallest


def _occlusion_prune_core(cand_d, cand_i, cand_emb, deg, alpha=1.0):
    c, k = cand_d.shape
    sq = jnp.sum(cand_emb * cand_emb, axis=-1)
    cross = jnp.einsum(
        "ckd,cld->ckl", cand_emb, cand_emb,
        preferred_element_type=jnp.float32,
    )
    pair = jnp.maximum(sq[:, :, None] - 2.0 * cross + sq[:, None, :], 0.0)

    # selection scan over candidates in distance order; fori_loop keeps the
    # HLO small (an unrolled loop here costs minutes of XLA compile time)
    def step(j, carry):
        sel_mask, cnt = carry
        pair_j = lax.dynamic_slice_in_dim(pair, j, 1, axis=1)[:, 0, :]  # [C,K]
        d_j = lax.dynamic_slice_in_dim(cand_d, j, 1, axis=1)  # [C,1]
        i_j = lax.dynamic_slice_in_dim(cand_i, j, 1, axis=1)[:, 0]  # [C]
        occ = jnp.any(sel_mask & (pair_j < alpha * d_j), axis=1)
        ok = (i_j >= 0) & (d_j[:, 0] < BIG) & (cnt < deg) & ~occ
        onehot = jnp.arange(k)[None, :] == j
        sel_mask = jnp.where(onehot & ok[:, None], True, sel_mask)
        return sel_mask, cnt + ok.astype(jnp.int32)

    sel_mask, cnt = lax.fori_loop(
        0, k, step, (jnp.zeros((c, k), bool), jnp.zeros((c,), jnp.int32))
    )

    offset = jnp.float32(1.0e30)
    key = jnp.where(sel_mask, cand_d - offset, cand_d)
    key = jnp.where(cand_i >= 0, key, BIG)
    sel_key, sel_i = masked_top_k_smallest(key, cand_i, deg)
    sel_d = jnp.where(sel_key < -offset / 2, sel_key + offset, sel_key)
    return sel_d, sel_i


@functools.partial(
    jax.jit, static_argnames=("deg", "k_cand", "chunk", "alpha")
)
def build_forward_edges(
    emb: jnp.ndarray,       # f32[N, dim] (N padded to a multiple of chunk)
    valid: jnp.ndarray,     # bool[N]
    deg: int,
    k_cand: int,
    chunk: int,
    alpha: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Whole-corpus forward-edge construction as ONE device program.

    For every (valid) row: exact k_cand nearest neighbors by streaming
    matmul + top-k, then occlusion-pruned to ``deg`` edges. Runs as a
    ``lax.scan`` over query chunks with zero host round-trips — queries are
    slices of the on-device embedding table itself. Returns
    (fwd_d f32[N, deg], fwd_i int32[N, deg]).
    """
    from vector_db_tpu.ops.distance import l2_sq_pairwise, squared_norms

    n, dim = emb.shape
    assert n % chunk == 0, "caller pads N to a multiple of chunk"
    n_chunks = n // chunk
    x_sq = squared_norms(emb)
    ids = jnp.arange(n, dtype=jnp.int32)

    def body(_, c_idx):
        q = lax.dynamic_slice(emb, (c_idx * chunk, 0), (chunk, dim))
        qi = c_idx * chunk + jnp.arange(chunk, dtype=jnp.int32)
        d = l2_sq_pairwise(q, emb, x_sq=x_sq)
        d = jnp.where(valid[None, :], d, BIG)
        d = jnp.where(ids[None, :] == qi[:, None], BIG, d)
        cd, ci = masked_top_k_smallest(d, ids, k_cand)
        ce = emb[jnp.maximum(ci, 0)]
        sd, si = _occlusion_prune_core(cd, ci, ce, deg, alpha)
        q_ok = valid[jnp.maximum(qi, 0)]
        sd = jnp.where(q_ok[:, None], sd, BIG)
        si = jnp.where(q_ok[:, None], si, -1)
        return None, (sd, si)

    _, (fwd_d, fwd_i) = lax.scan(
        body, None, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return fwd_d.reshape(n, deg), fwd_i.reshape(n, deg)


@functools.partial(jax.jit, static_argnames=("width",))
def reverse_merge(
    fwd_d: jnp.ndarray,   # f32[n, deg]
    fwd_i: jnp.ndarray,   # int32[n, deg] (-1 padded)
    width: int,
) -> jnp.ndarray:
    """Device analog of the host ``_reverse_merge`` (index/hnsw.py):
    symmetrize forward edges, dedup (v, u) pairs, keep each row's closest
    ``width``. All-sort formulation with static shapes so it can run
    per-shard inside ``shard_map`` (the SPMD bulk-build path).

    Returns rows int32[n, width] of local neighbor indices.
    """
    n, deg = fwd_i.shape
    src = jnp.repeat(jnp.arange(n, dtype=jnp.int32), deg)
    dst = fwd_i.reshape(-1)
    dd = fwd_d.reshape(-1)
    ok = dst >= 0
    # undirected edge set; invalid entries get v = n (sorts last, dropped)
    v = jnp.concatenate([jnp.where(ok, src, n), jnp.where(ok, dst, n)])
    u = jnp.concatenate([jnp.where(ok, dst, 0), jnp.where(ok, src, 0)])
    w = jnp.concatenate([dd, dd])

    # dedup (v, u): lexsort by pair, invalidate repeats. Pairwise
    # comparison, NOT a packed v*(n+1)+u key: with x64 disabled the key
    # silently truncates to int32 and overflows beyond n ~46k (false
    # dedup collisions dropping real edges, plus a per-call warning).
    order = jnp.lexsort((u, v))
    v, u, w = v[order], u[order], w[order]
    dup = jnp.concatenate(
        [jnp.zeros((1,), bool), (v[1:] == v[:-1]) & (u[1:] == u[:-1])]
    )
    v = jnp.where(dup, n, v)

    # per-row closest-width: sort by (v, w), rank within each v segment
    order2 = jnp.lexsort((w, v))
    v, u, w = v[order2], u[order2], w[order2]
    starts = jnp.searchsorted(v, jnp.arange(n, dtype=v.dtype))
    rank = jnp.arange(v.shape[0], dtype=jnp.int32) - starts[
        jnp.minimum(v, n - 1)
    ].astype(jnp.int32)
    sel = (v < n) & (rank < width)
    rows = jnp.full((n, width), -1, jnp.int32)
    rows = rows.at[
        jnp.where(sel, v, n), jnp.where(sel, rank, 0)
    ].set(u.astype(jnp.int32), mode="drop")
    return rows


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def assign_topk_clusters(
    emb: jnp.ndarray,        # f32[N, dim], N multiple of chunk
    centroids: jnp.ndarray,  # f32[C, dim]
    k: int,
    chunk: int = 8192,
) -> jnp.ndarray:
    """Nearest-k centroid assignment, streamed so the [N, C] distance
    matrix never materializes. Returns int32[N, k]."""
    from vector_db_tpu.ops.distance import l2_sq_pairwise

    n, dim = emb.shape
    assert n % chunk == 0
    c_sq = jnp.sum(centroids * centroids, axis=1)

    def body(_, c_idx):
        q = lax.dynamic_slice(emb, (c_idx * chunk, 0), (chunk, dim))
        d = l2_sq_pairwise(q, centroids, x_sq=c_sq)
        _, idx = lax.top_k(-d, k)
        return None, idx.astype(jnp.int32)

    _, out = lax.scan(body, None, jnp.arange(n // chunk, dtype=jnp.int32))
    return out.reshape(n, k)


@functools.partial(jax.jit, static_argnames=("deg",))
def clustered_knn_merge(
    emb: jnp.ndarray,      # f32[N_pad, dim]
    members: jnp.ndarray,  # int32[C, Lmax] rows into emb, -1 padded
    deg: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-cluster exact k-NN, merged across clusters into per-point
    forward edges — ONE device program (lax.scan over clusters).

    Each scan step gathers one cluster's member embeddings, computes the
    [Lmax, Lmax] distance block as one matmul, takes each member's deg nearest
    within the cluster, and merges into the running [N, deg] tables with a
    gather + top-k + scatter (members are unique within a cluster, so the
    scatter is conflict-free). Points spilled into several clusters get the
    best deg of the union. Returns (fwd_d f32[N_pad, deg],
    fwd_i int32[N_pad, deg]).
    """
    n_pad, dim = emb.shape
    c, lmax = members.shape

    fwd_d0 = jnp.full((n_pad, deg), BIG, jnp.float32)
    fwd_i0 = jnp.full((n_pad, deg), -1, jnp.int32)

    def body(carry, m_row):
        fwd_d, fwd_i = carry
        ok = m_row >= 0
        safe = jnp.where(ok, m_row, n_pad - 1)
        x = emb[safe]  # [Lmax, dim]
        sq = jnp.sum(x * x, axis=1)
        d = sq[:, None] - 2.0 * jnp.dot(
            x, x.T, preferred_element_type=jnp.float32
        ) + sq[None, :]
        d = jnp.maximum(d, 0.0)
        eye = jax.lax.broadcasted_iota(jnp.int32, (lmax, lmax), 0) == \
            jax.lax.broadcasted_iota(jnp.int32, (lmax, lmax), 1)
        # mask self, padding columns, and duplicate member ids
        same = safe[:, None] == safe[None, :]
        d = jnp.where(eye | same | ~ok[None, :], BIG, d)
        nd, nj = masked_top_k_smallest(d, safe, min(deg, lmax))
        if nd.shape[1] < deg:
            padw = deg - nd.shape[1]
            nd = jnp.concatenate(
                [nd, jnp.full((lmax, padw), BIG, jnp.float32)], axis=1
            )
            nj = jnp.concatenate(
                [nj, jnp.full((lmax, padw), -1, jnp.int32)], axis=1
            )
        # merge with the members' current rows: sort the FULL union first,
        # dedup identical (dist, id) pairs (a spilled pair is found once in
        # each shared cluster, with bitwise-equal distance so duplicates
        # land adjacent), and only then truncate to deg — truncating first
        # would let duplicates crowd out distinct neighbors
        cur_d = fwd_d[safe]
        cur_i = fwd_i[safe]
        md, mi = masked_top_k_smallest(
            jnp.concatenate([cur_d, nd], axis=1),
            jnp.concatenate([cur_i, nj], axis=1),
            2 * deg,
        )
        dup = jnp.concatenate(
            [jnp.zeros((lmax, 1), bool), mi[:, 1:] == mi[:, :-1]], axis=1
        ) & (mi >= 0)
        md = jnp.where(dup, BIG, md)
        mi = jnp.where(dup, -1, mi)
        md, mi = masked_top_k_smallest(md, mi, deg)

        scatter_to = jnp.where(ok, safe, n_pad)
        fwd_d = fwd_d.at[scatter_to].set(md, mode="drop")
        fwd_i = fwd_i.at[scatter_to].set(mi, mode="drop")
        return (fwd_d, fwd_i), None

    (fwd_d, fwd_i), _ = lax.scan(body, (fwd_d0, fwd_i0), members)
    return fwd_d, fwd_i


@functools.partial(jax.jit, static_argnames=("deg", "chunk", "sample"))
def nn_descent_round(
    emb: jnp.ndarray,     # f32[N, dim], N multiple of chunk
    fwd_d: jnp.ndarray,   # f32[N, deg]
    fwd_i: jnp.ndarray,   # int32[N, deg]
    deg: int,
    chunk: int = 2048,
    sample: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One NN-descent refinement round: each node rescopes its neighbor
    list against its neighbors' neighbors ("a neighbor of my neighbor is
    probably my neighbor"), keeping the best ``deg`` of the union. Runs as
    a lax.scan over node chunks; candidate scoring is one [chunk*K, dim]
    gather + batched contraction per step. Recovers most of the recall a
    cluster-partitioned build loses at cell boundaries.
    """
    n, dim = emb.shape
    assert n % chunk == 0
    # candidates per node: each neighbor contributes its `sample` closest
    # neighbors (rows are distance-sorted, so truncation keeps the best);
    # sample bounds HBM gather traffic — full deg^2 is prohibitive at 1M+
    s = sample if sample > 0 else deg
    s = min(s, deg)
    k_cand = deg * s

    def body(carry, c_idx):
        cur_d, cur_i = carry
        base = c_idx * chunk
        rows_i = lax.dynamic_slice(cur_i, (base, 0), (chunk, deg))
        rows_d = lax.dynamic_slice(cur_d, (base, 0), (chunk, deg))
        q = lax.dynamic_slice(emb, (base, 0), (chunk, dim))
        # candidates: neighbors' closest-s neighbor entries
        safe_n = jnp.maximum(rows_i, 0)                 # [C, deg]
        cand = cur_i[safe_n][:, :, :s].reshape(chunk, k_cand)
        cand = jnp.where(
            (rows_i >= 0).repeat(s, axis=1), cand, -1
        )
        # mask self
        self_ids = base + jnp.arange(chunk, dtype=jnp.int32)
        cand = jnp.where(cand == self_ids[:, None], -1, cand)
        safe_c = jnp.maximum(cand, 0)
        ce = emb[safe_c]                                 # [C, K, dim]
        d = (
            jnp.sum(ce * ce, axis=-1)
            - 2.0 * jnp.einsum(
                "ckd,cd->ck", ce, q, preferred_element_type=jnp.float32
            )
            + jnp.sum(q * q, axis=-1)[:, None]
        )
        d = jnp.maximum(d, 0.0)
        d = jnp.where(cand >= 0, d, BIG)
        # union with current edges, sorted-dedup, keep best deg
        md, mi = masked_top_k_smallest(
            jnp.concatenate([rows_d, d], axis=1),
            jnp.concatenate([rows_i, cand], axis=1),
            deg + k_cand,
        )
        dup = jnp.concatenate(
            [jnp.zeros((chunk, 1), bool), mi[:, 1:] == mi[:, :-1]], axis=1
        ) & (mi >= 0)
        md = jnp.where(dup, BIG, md)
        mi = jnp.where(dup, -1, mi)
        md, mi = masked_top_k_smallest(md, mi, deg)
        return carry, (md, mi)

    # NOTE: candidates come from the PRE-round tables (carry is read-only
    # within the scan); outputs assemble after the scan so every node sees
    # a consistent snapshot.
    _, (out_d, out_i) = lax.scan(
        body, (fwd_d, fwd_i), jnp.arange(n // chunk, dtype=jnp.int32)
    )
    return out_d.reshape(n, deg), out_i.reshape(n, deg)


@functools.partial(jax.jit, static_argnames=("deg", "chunk", "alpha"))
def occlusion_prune_tiled(
    emb: jnp.ndarray,     # f32[N_any, dim] embedding table (gather source)
    fwd_d: jnp.ndarray,   # f32[N, K] ascending candidate distances
    fwd_i: jnp.ndarray,   # int32[N, K] candidate ids (-1 padded)
    deg: int,
    chunk: int = 2048,
    alpha: float = 1.2,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming occlusion prune over whole forward-edge tables.

    The 1M-scale clustered build produces plain closest-K rows; this pass
    diversifies them to ``deg`` alpha-occlusion-selected edges (DiskANN's
    alpha > 1 keeps longer "highway" edges that pure closest-K bunches
    away — the known search-recall lever on navigable graphs), with
    closest-rejected refill so rows stay full. One ``lax.scan`` over row
    chunks; per chunk one [chunk, K, dim] gather + [chunk, K, K] pairwise
    block. N must be a multiple of ``chunk`` (callers pad with -1 rows).
    """
    n, k = fwd_i.shape
    assert n % chunk == 0, "caller pads N to a multiple of chunk"

    def body(_, c):
        cd, ci = c
        ce = emb[jnp.maximum(ci, 0)]
        sd, si = _occlusion_prune_core(cd, ci, ce, deg, alpha)
        return None, (sd, si)

    _, (od, oi) = lax.scan(
        body, None,
        (fwd_d.reshape(-1, chunk, k), fwd_i.reshape(-1, chunk, k)),
    )
    return od.reshape(n, deg), oi.reshape(n, deg)


@functools.partial(jax.jit, static_argnames=("deg",))
def occlusion_prune(
    cand_d: jnp.ndarray,    # f32[C, K] ascending (BIG = padding)
    cand_i: jnp.ndarray,    # int32[C, K] (-1 = padding)
    cand_emb: jnp.ndarray,  # f32[C, K, dim] candidate embeddings
    deg: int,
    alpha: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Select up to ``deg`` diverse neighbors per node; refill to ``deg``
    with the closest rejected candidates. Returns (d f32[C, deg],
    ids int32[C, deg]), ascending, (BIG, -1) padded."""
    return _occlusion_prune_core(cand_d, cand_i, cand_emb, deg, alpha)
