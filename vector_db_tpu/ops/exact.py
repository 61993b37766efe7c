"""Exact (brute-force) k-NN search as fused matmul + top-k.

This is the recall ground-truth path and the "flat index" the reference
lacks. One matmul scores a whole query batch against the corpus; for
corpora too large for a single product matrix, the corpus is tiled with
``lax.scan`` and per-tile top-k results are merged (running top-k), so HBM
traffic is one streaming pass over the embedding table.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vector_db_tpu.ops.distance import BIG, l2_sq_pairwise, squared_norms
from vector_db_tpu.ops.topk import masked_top_k_smallest, merge_top_k


@partial(jax.jit, static_argnames=("k",))
def exact_search(
    queries: jnp.ndarray,
    emb: jnp.ndarray,
    valid: jnp.ndarray,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-k by squared L2, single-tile.

    queries: f32[B, d]; emb: f32[N, d]; valid: bool[N].
    Returns (dists_sq f32[B, k], slot ids int32[B, k]); invalid slots never
    appear (padded with (BIG, -1) when fewer than k valid rows exist).
    """
    d = l2_sq_pairwise(queries, emb, precision=jax.lax.Precision.HIGHEST)
    ids = jnp.arange(emb.shape[0], dtype=jnp.int32)
    return masked_top_k_smallest(d, ids, k, valid=valid[None, :])


@partial(jax.jit, static_argnames=("k", "tile"))
def exact_search_tiled(
    queries: jnp.ndarray,
    emb: jnp.ndarray,
    valid: jnp.ndarray,
    k: int,
    tile: int = 65536,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-k with the corpus streamed in tiles.

    Same contract as :func:`exact_search`; corpus rows are processed ``tile``
    at a time under ``lax.scan`` with a running top-k merge, so peak memory is
    O(B * tile) instead of O(B * N). ``N`` must be a multiple of ``tile``
    after padding (callers pad with ``valid=False`` rows).
    """
    n, dim = emb.shape
    b = queries.shape[0]
    pad = (-n) % tile
    if pad:
        emb = jnp.concatenate([emb, jnp.zeros((pad, dim), emb.dtype)], axis=0)
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)], axis=0)
    n_tiles = emb.shape[0] // tile

    emb_t = emb.reshape(n_tiles, tile, dim)
    valid_t = valid.reshape(n_tiles, tile)
    x_sq_t = squared_norms(emb_t)  # [n_tiles, tile]
    base_ids = jnp.arange(tile, dtype=jnp.int32)

    init = (
        jnp.full((b, k), BIG, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )

    def body(carry, xs):
        best_d, best_i = carry
        tile_emb, tile_valid, tile_xsq, tile_idx = xs
        # HIGHEST: this is the recall-1.0 contract path; DEFAULT
        # precision may run f32 products in reduced precision (TF32 on
        # the GPU) and return wrong "exact" results on unnormalized
        # corpora
        d = l2_sq_pairwise(queries, tile_emb, x_sq=tile_xsq,
                           precision=jax.lax.Precision.HIGHEST)
        d = jnp.where(tile_valid[None, :], d, BIG)
        ids = base_ids + tile_idx * tile
        td, ti = masked_top_k_smallest(d, ids, min(k, tile))
        return merge_top_k(best_d, best_i, td, ti, k), None

    (best_d, best_i), _ = jax.lax.scan(
        body,
        init,
        (emb_t, valid_t, x_sq_t, jnp.arange(n_tiles, dtype=jnp.int32)),
    )
    return best_d, best_i


@partial(jax.jit, static_argnames=("k", "tile", "recall_target"))
def approx_search_tiled(
    queries: jnp.ndarray,
    emb: jnp.ndarray,
    valid: jnp.ndarray,
    k: int,
    tile: int = 125000,
    x_sq: jnp.ndarray | None = None,
    recall_target: float = 0.95,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k by squared L2 with an approximate per-tile reduction.

    Same contract as :func:`exact_search_tiled`, two performance levers:

    - ``emb`` may be **bfloat16** (cast once at ingest): halves the bytes
      read and runs the product on bf16 tensor cores; the cross term still
      accumulates in f32. Pass ``x_sq`` computed from the f32 source for
      exact norms.
    - per-tile top-k uses ``lax.approx_min_k`` instead of a full sort.

    The returned distances of surviving candidates are bf16-accurate;
    callers needing exact distances re-score the k rows.
    """
    n, dim = emb.shape
    b = queries.shape[0]
    pad = (-n) % tile
    if pad:
        emb = jnp.concatenate([emb, jnp.zeros((pad, dim), emb.dtype)], axis=0)
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)], axis=0)
        if x_sq is not None:
            x_sq = jnp.concatenate([x_sq, jnp.zeros((pad,), x_sq.dtype)])
    n_tiles = emb.shape[0] // tile
    emb_t = emb.reshape(n_tiles, tile, dim)
    valid_t = valid.reshape(n_tiles, tile)
    xsq_t = (
        x_sq.reshape(n_tiles, tile) if x_sq is not None
        else jnp.sum(
            emb_t.astype(jnp.float32) * emb_t.astype(jnp.float32), axis=-1
        )
    )
    base_ids = jnp.arange(tile, dtype=jnp.int32)
    q_sq = squared_norms(queries.astype(jnp.float32))
    qc = queries.astype(emb.dtype)

    init = (
        jnp.full((b, k), BIG, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )

    def body(carry, xs):
        best_d, best_i = carry
        tile_emb, tile_valid, tile_xsq, tile_idx = xs
        cross = jnp.dot(qc, tile_emb.T, preferred_element_type=jnp.float32)
        d = q_sq[:, None] - 2.0 * cross + tile_xsq[None, :]
        d = jnp.where(tile_valid[None, :], d, BIG)
        nd, pos = jax.lax.approx_min_k(
            d, min(k, tile), recall_target=recall_target
        )
        ids = base_ids + tile_idx * tile
        ti = jnp.where(nd >= BIG_THRESH_LOCAL, -1, ids[pos])
        return merge_top_k(best_d, best_i, nd, ti, k), None

    (best_d, best_i), _ = jax.lax.scan(
        body,
        init,
        (emb_t, valid_t, xsq_t, jnp.arange(n_tiles, dtype=jnp.int32)),
    )
    return best_d, best_i


BIG_THRESH_LOCAL = np.float32(1.0e37)  # numpy scalar: no device alloc at import


@partial(jax.jit, static_argnames=("k", "tile", "block", "blocks_k",
                                   "qblock", "exact_phase1",
                                   "approx_blocks", "hilo_phase1"))
def block_select_search(
    queries: jnp.ndarray,    # f32[B, dim]
    score_tab: jnp.ndarray,  # f32|bf16[N, ds] phase-1 table (full or proj)
    score_q: jnp.ndarray,    # f32[B, ds] queries in score space
    x_sq: jnp.ndarray,       # f32[N] row norms pairing with score_tab:
                             #   full-space for a same-dim table, and ALSO
                             #   full-space for a PCA mirror (unbiased
                             #   estimate ||x||^2 - 2 q̂·x̂)
    emb: jnp.ndarray,        # f32[N, dim] exact rerank table
    valid: jnp.ndarray,      # bool[N]
    k: int,
    tile: int = 131072,
    block: int = 128,
    blocks_k: int = 0,
    qblock: int = 128,
    exact_phase1: bool = False,
    approx_blocks: bool = False,
    hilo_phase1: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-phase scan: streaming block-min select, then exact block rerank.

    The tiled scans above pay a top-k (or approx_min_k) over every
    [B, tile] score block on top of the scoring matmul. This path exploits
    a selection identity:

      phase 1: one streaming pass computes only the MIN of every
        ``block`` consecutive rows — [B, N/block] minima, a reduction
        that fuses into the scoring matmul's epilogue (no sort, no
        top-k, no [B, N] tensor);
      phase 2: the top-``blocks_k`` blocks per query by minimum are
        gathered (contiguous [block, dim] slabs — block reads, never
        row gathers) and ALL their rows re-scored exactly (f32,
        HIGHEST) before the final top-k cut.

    Lossless w.r.t. phase-1 scores when blocks_k >= k: if a row is among
    the true top-k, fewer than k blocks can hold a smaller minimum than
    that row's own block (each such block would contain a strictly closer
    row), so its block always survives EXACT block selection. The only
    approximation is phase-1 score precision (bf16 / projection) — and a
    row misranked by phase-1 noise is still rescored exactly as long as
    its BLOCK is selected, which makes this far more noise-tolerant than
    per-row selection at equal cost. ``exact_phase1=True`` scores phase 1
    in f32 HIGHEST: the result is then provably the exact top-k.

    Block selection is EXACT ``lax.top_k`` by default: the minima tensor
    is N/block wide (128x smaller than the row space), so the full sort
    is off the critical path, and approximate selection here silently
    voids the losslessness guarantee. ``approx_blocks=True`` selects
    blocks with ``approx_min_k`` for callers that trade the guarantee
    for speed.

    Returns (d_sq f32[B, k], ids int32[B, k]) ascending, (BIG, -1) padded.
    """
    n, dim = emb.shape
    b = queries.shape[0]
    blocks_k = blocks_k or 2 * k
    assert tile % block == 0
    pad = (-n) % tile
    if pad:
        score_tab = jnp.concatenate(
            [score_tab, jnp.zeros((pad, score_tab.shape[1]),
                                  score_tab.dtype)])
        emb = jnp.concatenate([emb, jnp.zeros((pad, dim), emb.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
        x_sq = jnp.concatenate([x_sq, jnp.zeros((pad,), x_sq.dtype)])
    n_pad = emb.shape[0]
    n_tiles = n_pad // tile
    n_blocks = n_pad // block
    blocks_k = min(blocks_k, n_blocks)

    st_t = score_tab.reshape(n_tiles, tile, score_tab.shape[1])
    xsq_t = x_sq.reshape(n_tiles, tile)
    valid_t = valid.reshape(n_tiles, tile)
    prec = jax.lax.Precision.HIGHEST if exact_phase1 else None
    sq = score_q.astype(score_tab.dtype)
    if hilo_phase1:
        # 3-pass pseudo-f32 phase 1: split both operands into bf16
        # hi + lo and drop only the lo*lo term (~2^-16 relative each
        # side => cross-term error ~2^-22 relative — far below 1M-scale
        # neighbor gaps, at 3 bf16-rate passes vs 6 for f32 HIGHEST).
        # Selection is no longer *provably* lossless; blocks_k >= 2k
        # absorbs boundary misranks in practice.
        sq_hi = score_q.astype(jnp.bfloat16)
        sq_lo = (score_q - sq_hi.astype(jnp.float32)).astype(jnp.bfloat16)

    def p1(_, xs):
        t_tab, t_xsq, t_valid = xs
        if hilo_phase1:
            t_hi = t_tab.astype(jnp.bfloat16)
            t_lo = (t_tab - t_hi.astype(jnp.float32)).astype(jnp.bfloat16)
            cross = (
                jnp.dot(sq_hi, t_hi.T, preferred_element_type=jnp.float32)
                + jnp.dot(sq_hi, t_lo.T, preferred_element_type=jnp.float32)
                + jnp.dot(sq_lo, t_hi.T, preferred_element_type=jnp.float32)
            )
        else:
            cross = jnp.dot(sq, t_tab.T, precision=prec,
                            preferred_element_type=jnp.float32)
        d = t_xsq[None, :] - 2.0 * cross
        d = jnp.where(t_valid[None, :], d, BIG)
        return None, jnp.min(
            d.reshape(b, tile // block, block), axis=-1)

    _, mins = jax.lax.scan(p1, None, (st_t, xsq_t, valid_t))
    # [n_tiles, B, tile/block] -> [B, n_blocks]
    mins = jnp.moveaxis(mins, 0, 1).reshape(b, n_blocks)

    if approx_blocks:
        _, bidx = jax.lax.approx_min_k(mins, blocks_k)   # [B, blocks_k]
    else:
        _, bidx = jax.lax.top_k(-mins, blocks_k)         # exact selection

    emb_b = emb.reshape(n_blocks, block, dim)
    valid_b = valid.reshape(n_blocks, block)
    q_sq = jnp.sum(queries * queries, axis=-1)

    padq = (-b) % qblock
    if padq:
        queries_p = jnp.concatenate(
            [queries, jnp.zeros((padq, dim), queries.dtype)])
        bidx_p = jnp.concatenate(
            [bidx, jnp.zeros((padq, blocks_k), bidx.dtype)])
        qsq_p = jnp.concatenate([q_sq, jnp.zeros((padq,))])
    else:
        queries_p, bidx_p, qsq_p = queries, bidx, q_sq
    nqb = queries_p.shape[0] // qblock

    def p2(args):
        q_c, bi_c, qsq_c = args                          # [Q, ...]
        rows = emb_b[bi_c]                               # [Q, C, block, dim]
        ok = valid_b[bi_c]                               # [Q, C, block]
        d = (
            jnp.sum(rows * rows, axis=-1)
            - 2.0 * jnp.einsum("qcbd,qd->qcb", rows, q_c,
                               precision=jax.lax.Precision.HIGHEST,
                               preferred_element_type=jnp.float32)
            + qsq_c[:, None, None]
        )
        d = jnp.where(ok, jnp.maximum(d, 0.0), BIG)
        d = d.reshape(q_c.shape[0], -1)
        neg, pos = jax.lax.top_k(-d, k)
        ids = (bi_c[:, :, None] * block
               + jnp.arange(block, dtype=jnp.int32)[None, None, :]
               ).reshape(q_c.shape[0], -1)
        out_i = jnp.take_along_axis(ids, pos, axis=1)
        out_d = -neg
        out_i = jnp.where(out_d < BIG_THRESH_LOCAL, out_i, -1)
        return out_d, out_i

    def rs(a):
        return a.reshape((nqb, qblock) + a.shape[1:])

    dd, ii = jax.lax.map(p2, (rs(queries_p), rs(bidx_p), rs(qsq_p)))
    return (dd.reshape(-1, k)[:b], ii.reshape(-1, k)[:b])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_to(a: jnp.ndarray, rows: int) -> jnp.ndarray:
    """``a`` zero-extended along axis 0 to ``rows`` (a no-op when it has
    them already)."""
    pad = rows - a.shape[0]
    if not pad:
        return a
    return jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])


@partial(jax.jit, static_argnames=("k", "block", "blocks_k", "rows_k",
                                   "approx_blocks", "p2_chunk"))
def block_select_search_3p(
    queries: jnp.ndarray,    # f32[B, dim]
    score_tab: jnp.ndarray,  # bf16[N, ds] phase-1/2 table (PCA mirror)
    score_q: jnp.ndarray,    # f32[B, ds] queries in score space
    x_sq: jnp.ndarray,       # f32[N] full-space row norms
    emb: jnp.ndarray,        # f32[N, dim] exact rerank table
    valid: jnp.ndarray,      # bool[N]
    k: int,
    block: int = 128,
    blocks_k: int = 0,
    rows_k: int = 0,
    approx_blocks: bool = False,
    p2_chunk: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Three-phase block-min scan: select blocks, rescore rows in the
    projected mirror, exact-rescore only the top ``rows_k`` rows.

    Phase 1 is the block top-m scan (ops/pallas/block_topm.py) at m=1:
    block minima are its first pass.

    The two-phase :func:`block_select_search` gathers
    ``[B, blocks_k, block, dim]`` f32 rows and runs a per-query HIGHEST
    matvec. Here phase 2 rescoring runs in the ``ds``-dim bf16 mirror
    (dim*4/(ds*2)x less gather traffic), producing per-ROW estimates whose
    top ``rows_k`` rows per query are then fetched from the f32 table
    (``rows_k`` row reads per query) and scored exactly — the same
    estimate->exact contract as the wide-beam rerank. Recall is 1.0 as
    long as the true top-k survive the mirror-scored cut; ``rows_k``
    (default ``8*k``) is the margin.

    Returns (d_sq f32[B, k], ids int32[B, k]) ascending, (BIG, -1) pad.
    """
    from vector_db_tpu.ops.pallas.block_topm import block_topm_scan

    b = queries.shape[0]
    ds = score_tab.shape[1]
    blocks_k = blocks_k or 2 * k
    rows_k = rows_k or 8 * k
    # the mirror may carry padded rows (block_topm.pad_mirror): blocks
    # span the mirror's rows, zero-extended to whole blocks; rows past the
    # f32 table are invalid, and their clamped gathers are masked below
    n_rows = _round_up(score_tab.shape[0], block)
    score_tab = _pad_to(score_tab, n_rows)
    valid = _pad_to(valid, n_rows)
    x_sq = _pad_to(x_sq, n_rows)
    n_blocks = n_rows // block
    blocks_k = min(blocks_k, n_blocks)
    rows_k = min(rows_k, blocks_k * block)

    sq = score_q.astype(score_tab.dtype)

    # phase 1: streaming block minima of the mirror estimate
    mins, _ = block_topm_scan(score_q, score_tab,
                              jnp.where(valid, x_sq, 2.0e38),
                              block=block, m=1)
    if approx_blocks:
        _, bidx = jax.lax.approx_min_k(mins, blocks_k)
    else:
        _, bidx = jax.lax.top_k(-mins, blocks_k)         # [B, blocks_k]

    # phase 2: per-row mirror rescore of the selected blocks (bf16
    # block-contiguous gather, per-query matvec in ds dims only).
    # p2_chunk > 0 scans candidate-chunks of that many blocks per step:
    # the one-shot path materializes a [B, C, blk, ds] gather (plus
    # XLA's f32 convert of it) — chunking caps the live temp with no
    # semantic change
    st_b = score_tab.reshape(n_blocks, block, ds)
    xsq_b = x_sq.reshape(n_blocks, block)
    valid_b = valid.reshape(n_blocks, block)
    if p2_chunk and p2_chunk < blocks_k and blocks_k % p2_chunk == 0:
        bidx_c = bidx.reshape(b, blocks_k // p2_chunk,
                              p2_chunk).transpose(1, 0, 2)

        def p2(_, bc):
            e_c = (xsq_b[bc]
                   - 2.0 * jnp.einsum("qcbd,qd->qcb", st_b[bc], sq,
                                      preferred_element_type=jnp.float32))
            return None, jnp.where(valid_b[bc], e_c, BIG)

        _, est_parts = jax.lax.scan(p2, None, bidx_c)
        est = est_parts.transpose(1, 0, 2, 3).reshape(
            b, blocks_k * block)
    else:
        rows = st_b[bidx]                                # [B, C, blk, ds]
        est = (
            xsq_b[bidx]
            - 2.0 * jnp.einsum("qcbd,qd->qcb", rows, sq,
                               preferred_element_type=jnp.float32)
        )
        est = jnp.where(valid_b[bidx], est, BIG)
        est = est.reshape(b, blocks_k * block)
    _, rpos = jax.lax.top_k(-est, rows_k)                # [B, rows_k]
    row_ids = (bidx[:, :, None] * block
               + jnp.arange(block, dtype=jnp.int32)[None, None, :]
               ).reshape(b, blocks_k * block)
    cand = jnp.take_along_axis(row_ids, rpos, axis=1)    # [B, rows_k]

    # phase 3: exact rescore of rows_k rows per query, final top-k
    crows = emb[jnp.minimum(cand, emb.shape[0] - 1)]     # [B, rows_k, dim]
    d = (
        jnp.sum(crows * crows, axis=-1)
        - 2.0 * jnp.einsum("brd,bd->br", crows, queries,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
        + jnp.sum(queries * queries, axis=-1, keepdims=True)
    )
    ok = jnp.take_along_axis(valid_b[bidx].reshape(b, -1), rpos, axis=1)
    d = jnp.where(ok, jnp.maximum(d, 0.0), BIG)
    neg, pos = jax.lax.top_k(-d, k)
    out_d = -neg
    out_i = jnp.take_along_axis(cand, pos, axis=1)
    out_i = jnp.where(out_d < BIG_THRESH_LOCAL, out_i, -1)
    return out_d, out_i


@partial(jax.jit, static_argnames=("k", "block", "m", "rows_k"))
def block_select_search_2p(
    queries: jnp.ndarray,    # f32[B, dim]
    score_tab: jnp.ndarray,  # bf16[N, ds] phase-1 mirror table
    score_q: jnp.ndarray,    # f32[B, ds] queries in score space
    x_sq: jnp.ndarray,       # f32[N] full-space row norms
    emb: jnp.ndarray,        # f32[N, dim] exact rerank table
    valid: jnp.ndarray,      # bool[N]
    k: int,
    block: int = 128,
    m: int = 4,
    rows_k: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-phase exact search: fused per-block top-m scan, exact rescore.

    Successor to :func:`block_select_search_3p` for the recall-1.0
    serving path, without its block selection, [B, blocks_k, block, ds]
    mirror gather, per-row rescore and second top-k. The block top-m
    scan (ops/pallas/block_topm.py) emits the ``m`` best mirror rows per
    128-row block directly, so the pipeline collapses to:

      phase 1: streaming fused scan -> per-block top-m estimates
        (f32[B, N/block*m]) with global row ids;
      phase 2: one ``lax.top_k`` picks the best ``rows_k`` estimates,
        whose rows are fetched from the f32 table and scored exactly
        (HIGHEST) before the final top-k cut.

    Candidate contract: a true top-k row is found iff it is within the
    best ``m`` mirror rows of its own block and the best ``rows_k``
    mirror estimates overall — the same estimate->exact margin as the
    3-phase path's ``rows_k``, plus an in-block rank-m condition that
    only bites when >m true neighbors share one slot-order block
    (slot order is uncorrelated with query neighborhoods).

    Exactness semantics match the reference's recall-1.0 search contract
    (reference hnsw.py:89-134 / indexing flat scan) with exact final
    distances; only candidate selection runs in the bf16 mirror.

    Returns (d_sq f32[B, k], ids int32[B, k]) ascending, (BIG, -1) pad.
    """
    from vector_db_tpu.ops.pallas.block_topm import block_topm_scan

    n = emb.shape[0]
    rows_k = rows_k or 8 * k

    # a padded mirror (block_topm.pad_mirror) has rows past the f32
    # table: they are invalid
    n_rows = score_tab.shape[0]
    xsq_eff = jnp.where(_pad_to(valid, n_rows), _pad_to(x_sq, n_rows),
                        2.0e38)
    est, rows = block_topm_scan(score_q, score_tab, xsq_eff, block=block,
                                m=m)
    rows_k = min(rows_k, est.shape[1])

    neg, pos = jax.lax.top_k(-est, rows_k)               # [B, rows_k]
    cand = jnp.take_along_axis(rows, pos, axis=1)
    # padded / invalid rows carry estimates >= 1e37 (xsq_eff mask)
    live = (-neg) < BIG_THRESH_LOCAL
    cand = jnp.where(live, jnp.minimum(cand, n - 1), 0)

    crows = emb[cand]                                    # [B, rows_k, dim]
    d = (
        jnp.sum(crows * crows, axis=-1)
        - 2.0 * jnp.einsum("brd,bd->br", crows, queries,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
        + jnp.sum(queries * queries, axis=-1, keepdims=True)
    )
    d = jnp.where(live, jnp.maximum(d, 0.0), BIG)
    negd, posd = jax.lax.top_k(-d, k)
    out_d = -negd
    out_i = jnp.take_along_axis(cand, posd, axis=1)
    out_i = jnp.where(out_d < BIG_THRESH_LOCAL, out_i, -1)
    return out_d, out_i


@partial(jax.jit, static_argnames=())
def rescore_exact(
    queries: jnp.ndarray,
    emb: jnp.ndarray,
    cand: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact f32 re-scoring of per-query candidate rows, sorted ascending.

    queries: f32[B, d]; emb: f32[capacity, d] (the f32 source table);
    cand: int32[B, K] slot ids (-1 padded). Returns (f32[B, K], int32[B, K]).
    Used after a bf16/approx scan so returned distances are full-precision
    (the scan's job is candidate selection, not distance reporting).
    """
    safe = jnp.maximum(cand, 0)
    rows = emb[safe]  # [B, K, d]
    d = (
        jnp.sum(rows * rows, axis=-1)
        - 2.0 * jnp.einsum("bkd,bd->bk", rows, queries,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
        + jnp.sum(queries * queries, axis=-1, keepdims=True)
    )
    d = jnp.where(cand >= 0, jnp.maximum(d, 0.0), BIG)
    order = jnp.argsort(d, axis=-1)
    return (
        jnp.take_along_axis(d, order, axis=-1),
        jnp.take_along_axis(cand, order, axis=-1),
    )


@partial(jax.jit, static_argnames=("k", "tile"))
def knn_exact(
    queries: jnp.ndarray,
    q_ids: jnp.ndarray,
    emb: jnp.ndarray,
    valid: jnp.ndarray,
    k: int,
    tile: int = 16384,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-NN of corpus members against the corpus, excluding self.

    queries: f32[B, d] (rows OF the corpus); q_ids: int32[B] their slot ids;
    emb/valid: the corpus. Returns (dists_sq f32[B, k], slots int32[B, k]).
    This is the bulk-graph-construction primitive: one streaming pass of
    matmuls builds exact neighbor tables for a whole node batch.
    """
    n, dim = emb.shape
    b = queries.shape[0]
    pad = (-n) % tile
    if pad:
        emb = jnp.concatenate([emb, jnp.zeros((pad, dim), emb.dtype)], axis=0)
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)], axis=0)
    n_tiles = emb.shape[0] // tile
    emb_t = emb.reshape(n_tiles, tile, dim)
    valid_t = valid.reshape(n_tiles, tile)
    x_sq_t = squared_norms(emb_t)
    base_ids = jnp.arange(tile, dtype=jnp.int32)

    init = (
        jnp.full((b, k), BIG, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )

    def body(carry, xs):
        best_d, best_i = carry
        tile_emb, tile_valid, tile_xsq, tile_idx = xs
        # HIGHEST: exact neighbor tables are the graph-quality foundation;
        # the matmul is a small fraction of build wall-clock
        d = l2_sq_pairwise(queries, tile_emb, x_sq=tile_xsq,
                           precision=jax.lax.Precision.HIGHEST)
        ids = base_ids + tile_idx * tile
        d = jnp.where(tile_valid[None, :], d, BIG)
        d = jnp.where(ids[None, :] == q_ids[:, None], BIG, d)  # exclude self
        td, ti = masked_top_k_smallest(d, ids, min(k, tile))
        return merge_top_k(best_d, best_i, td, ti, k), None

    (best_d, best_i), _ = jax.lax.scan(
        body, init,
        (emb_t, valid_t, x_sq_t, jnp.arange(n_tiles, dtype=jnp.int32)),
    )
    return best_d, best_i
