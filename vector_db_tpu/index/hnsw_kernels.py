"""Device-side HNSW kernels: batched beam search over fixed-degree tables.

Accelerator-native re-design of the reference HNSW
(src/vector_db/indexing/hnsw.py).
The reference stores the graph as ``Dict[id, InternalNode{neighbors:
Dict[level, List[id]]}]`` and traverses it with Python heapqs, calling a
per-pair NumPy distance once per edge (hnsw.py:89-134). Here:

- the graph is one ``int32[capacity, NCOLS]`` device neighbor table, -1
  padded: level-0 edges occupy columns [0, 2M) (M_max0 = 2M,
  hnsw.py:48-50), level-l >= 1 edges occupy columns [M(l+1), M(l+2));
- search is a fixed-shape best-first beam under ``lax.while_loop``: each
  step expands the nearest unexpanded candidate, gathers its <=2M neighbor
  rows, computes all edge distances in one (2M, d) contraction,
  and merges into the candidate/result pools with ``lax.top_k``;
- the visited set is a packed int32 bitmap (capacity/32 words) carried
  through the loop;
- queries batch via ``vmap``.

Semantics matched to the reference:
- candidate pop + "break when best unexpanded > worst of ef results"
  termination (hnsw.py:102-112) — popping is modelled by setting the
  expanded slot's pool distance to +inf;
- ``filter_ids`` navigates through non-matching nodes but excludes them
  from results (hnsw.py:81-88, 96-97, 127-131) — a per-slot bool mask;
- nodes missing from storage are skipped entirely (never enter the pool,
  hnsw.py:117-121) — the ``has_emb`` mask;
- greedy 1-best hill-climb descent on upper levels (hnsw.py:289-328);
- naive closest-M neighbor selection (hnsw.py:136-141) and append-then-
  prune-to-m_limit backlinks (hnsw.py:190-213).

One deliberate approximation: the reference's candidate heap is unbounded;
here the candidate pool is a fixed-size top-ef array, so candidates worse
than the current ef-th best are dropped early. The reference's termination
rule would almost never expand those anyway; recall parity is validated in
tests against brute force.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as _np
from jax import lax

from vector_db_tpu.ops.distance import BIG, gather_l2_sq
from vector_db_tpu.ops.topk import masked_top_k_smallest

BIG_THRESH = _np.float32(1.0e37)  # numpy scalar: no device alloc at import


class Graph(NamedTuple):
    """HNSW graph state (a pytree; all arrays device-resident).

    neighbors: int32[capacity, NCOLS] — -1-padded adjacency rows per level.
    levels:    int32[capacity] — node's top level; -1 = slot not in graph.
    entry:     int32[] — entry point slot; -1 = empty graph.
    entry_level: int32[] — level of the entry point (-1 = empty).
    """

    neighbors: jnp.ndarray
    levels: jnp.ndarray
    entry: jnp.ndarray
    entry_level: jnp.ndarray


def ncols(M: int, l_max: int) -> int:
    # level 0: 2M cols at [0, 2M); level l>=1: M cols at [M(l+1), M(l+2)).
    # One extra M of -1 padding at the tail lets upper-level reads use a
    # static 2M-wide slice regardless of level.
    return M * (l_max + 2)


def level_col_start(level: int, M: int) -> int:
    """Static column offset of level ``level``'s adjacency slice."""
    return 0 if level == 0 else M * (level + 1)


def level_width(level: int, M: int) -> int:
    """m_limit per level: M_max0 = 2M at level 0, M_max = M above
    (reference hnsw.py:48-50, 188)."""
    return 2 * M if level == 0 else M


def empty_graph(capacity: int, M: int, l_max: int) -> Graph:
    return Graph(
        neighbors=jnp.full((capacity, ncols(M, l_max)), -1, jnp.int32),
        levels=jnp.full((capacity,), -1, jnp.int32),
        entry=jnp.int32(-1),
        entry_level=jnp.int32(-1),
    )


def _neighbor_slice_dyn(row: jnp.ndarray, level: jnp.ndarray, M: int) -> jnp.ndarray:
    """Dynamic-level read of a node's adjacency at ``level`` (upper levels
    only, width M) — used by greedy descent where level is traced."""
    start = M * (level + 1)
    return lax.dynamic_slice(row, (start,), (M,))


def _dist_to(q: jnp.ndarray, emb: jnp.ndarray, idx: jnp.ndarray,
             has_emb: jnp.ndarray) -> jnp.ndarray:
    """Traversal/construction scoring: DEFAULT-precision matvec — beam
    steps only SELECT candidates (final results are re-scored exactly);
    the 6-pass HIGHEST multiply slowed 1M graph builds 2.7x."""
    safe = jnp.maximum(idx, 0)
    return gather_l2_sq(q, emb, idx, has_emb[safe], precision=None)


def greedy_descent(
    graph: Graph,
    score,
    start_slot: jnp.ndarray,
    start_d: jnp.ndarray,
    stop_level: jnp.ndarray,
    M: int,
    l_max: int,
    max_moves: int = 128,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """1-best hill climb from entry_level down to ``stop_level`` (exclusive
    of levels < stop_level). Mirrors reference _greedy_search_level
    (hnsw.py:289-328) applied over range(max_level, stop_level-1, -1).

    ``score(idx int32[K]) -> f32[K]`` is the distance oracle for the current
    query — full-precision gathers or PQ/ADC lookups (BIG where invalid).
    """

    def climb_at(level: int, cur: jnp.ndarray, cur_d: jnp.ndarray):
        active = (level <= graph.entry_level) & (level >= stop_level)

        def cond(c):
            cur, cur_d, moved, steps = c
            return active & moved & (steps < max_moves)

        def body(c):
            cur, cur_d, _, steps = c
            row = graph.neighbors[cur]
            nbr = _neighbor_slice_dyn(row, jnp.int32(level), M)
            d = score(nbr)
            j = jnp.argmin(d)
            better = d[j] < cur_d
            return (
                jnp.where(better, nbr[j], cur),
                jnp.where(better, d[j], cur_d),
                better,
                steps + 1,
            )

        cur, cur_d, _, _ = lax.while_loop(
            cond, body, (cur, cur_d, jnp.bool_(True), jnp.int32(0))
        )
        return cur, cur_d

    cur, cur_d = start_slot, start_d
    for level in range(l_max - 1, 0, -1):
        cur, cur_d = climb_at(level, cur, cur_d)
    return cur, cur_d


def beam_layer(
    graph: Graph,
    score,
    capacity: int,
    res_ok,
    entry_slot: jnp.ndarray,
    entry_d: jnp.ndarray,
    active: jnp.ndarray,
    res_mask: Optional[jnp.ndarray],
    level: int,
    ef: int,
    M: int,
    max_steps: int,
    pool: int = 0,
    expand: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Best-first search of width ``ef`` at a static ``level``.

    ``pool`` sets the candidate-frontier capacity (default = ef). The
    reference's candidate heap is unbounded (hnsw.py:89-134); a pool wider
    than ef trades a little merge cost for recall on hard corpora.

    ``expand`` pops the E nearest unexpanded candidates per loop step
    instead of 1 — E neighbor rows gather and score together, cutting the
    sequential step count ~E× for the same ef. expand=1 reproduces the
    reference's strictly-best-first order exactly; E>1 expands a superset
    of what best-first would (never fewer), so recall at equal ef is >=.

    Returns (res_d f32[ef], res_s int32[ef]) — the ef closest found, BIG/-1
    padded, unsorted. ``res_mask`` (bool[capacity] or None) is the
    filter-ids semantics: masked-out nodes navigate but never enter results.
    ``active`` disables the whole layer (used for masked per-level unrolls).

    ``score(idx int32[K]) -> f32[K]`` is the distance oracle (BIG where
    invalid); ``res_ok(idx int32[K]) -> bool[K]`` says which nodes may enter
    the RESULT pool (storage-present check, hnsw.py:117-121).
    """
    words = (capacity + 31) // 32
    start = level_col_start(level, M)
    width = level_width(level, M)
    pool = max(pool, ef)
    expand = max(1, min(expand, pool))

    cand_d = jnp.full((pool,), BIG, jnp.float32).at[0].set(entry_d)
    cand_s = jnp.full((pool,), -1, jnp.int32).at[0].set(entry_slot)

    entry_ok = res_ok(entry_slot[None])[0] & (entry_slot >= 0)
    if res_mask is not None:
        entry_in_res = entry_ok & res_mask[jnp.maximum(entry_slot, 0)]
    else:
        entry_in_res = entry_ok
    res_d = jnp.full((ef,), BIG, jnp.float32)
    res_s = jnp.full((ef,), -1, jnp.int32)
    res_d = jnp.where(entry_in_res, res_d.at[0].set(entry_d), res_d)
    res_s = jnp.where(entry_in_res, res_s.at[0].set(entry_slot), res_s)

    visited = jnp.zeros((words,), jnp.int32)
    e_word = jnp.maximum(entry_slot, 0) // 32
    e_bit = jnp.maximum(entry_slot, 0) % 32
    visited = visited.at[e_word].set(
        jnp.where(entry_slot >= 0, (1 << e_bit).astype(jnp.int32), 0)
    )

    def cond(c):
        cand_d, cand_s, res_d, res_s, visited, steps = c
        best = jnp.min(cand_d)
        worst_res = jnp.max(res_d)
        # Reference break rule (hnsw.py:102-112): stop when the nearest
        # unexpanded candidate is farther than the worst of a full result set.
        go = (best < BIG_THRESH) & ~(best > worst_res)
        return active & go & (steps < max_steps)

    def body(c):
        cand_d, cand_s, res_d, res_s, visited, steps = c
        # pop the E nearest unexpanded candidates at once
        # (reference heappop, hnsw.py:103, E=1)
        neg, pos = jax.lax.top_k(-cand_d, expand)
        pop_ok = -neg < BIG_THRESH
        curs = jnp.where(pop_ok, cand_s[pos], -1)  # [E]
        cand_d = cand_d.at[pos].set(BIG)

        rows = lax.dynamic_slice(
            graph.neighbors[jnp.maximum(curs, 0)], (0, start),
            (expand, 2 * M),
        )  # [E, 2M]
        col_ok = jnp.arange(2 * M)[None, :] < width
        nbr = jnp.where(col_ok & (curs[:, None] >= 0), rows, -1).reshape(-1)
        safe = jnp.maximum(nbr, 0)

        bits = (visited[safe // 32] >> (safe % 32)) & 1
        fresh = (nbr >= 0) & (bits == 0)
        if expand > 1:
            # dedup across the E gathered rows: the same neighbor may appear
            # in several rows, and double-adding its bit would corrupt the
            # bitmap
            order = jnp.argsort(nbr)
            snbr = nbr[order]
            first_sorted = jnp.concatenate(
                [jnp.ones((1,), bool), snbr[1:] != snbr[:-1]]
            )
            first = jnp.zeros_like(fresh).at[order].set(first_sorted)
            fresh = fresh & first

        # mark visited (ids now unique, so add == bitwise-or)
        wordv = jnp.where(fresh, (1 << (safe % 32)).astype(jnp.int32), 0)
        visited = visited.at[jnp.where(fresh, safe // 32, 0)].add(
            jnp.where(fresh, wordv, 0)
        )

        d = score(jnp.where(fresh, nbr, -1))

        # merge into candidate pool (traversal uses every fresh node,
        # hnsw.py:123-124)
        md, ms = masked_top_k_smallest(
            jnp.concatenate([cand_d, d]),
            jnp.concatenate([cand_s, nbr]),
            pool,
        )

        # merge into result pool (filtered, hnsw.py:127-131)
        if res_mask is not None:
            d_res = jnp.where(res_mask[safe], d, BIG)
        else:
            d_res = d
        rd, rs = masked_top_k_smallest(
            jnp.concatenate([res_d, d_res]),
            jnp.concatenate([res_s, nbr]),
            ef,
        )
        return md, ms, rd, rs, visited, steps + 1

    cand_d, cand_s, res_d, res_s, visited, _ = lax.while_loop(
        cond, body, (cand_d, cand_s, res_d, res_s, visited, jnp.int32(0))
    )
    return res_d, res_s


def beam_layer_unified(
    graph: Graph,
    score,
    capacity: int,
    entry_slot: jnp.ndarray,
    entry_d: jnp.ndarray,
    active: jnp.ndarray,
    level: int,
    ef: int,
    M: int,
    max_steps: int,
    expand: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-pool best-first search for UNFILTERED queries (the common
    case): one ef-wide pool holds the best visited nodes with per-entry
    expanded flags — the hnswlib formulation. Equivalent to the two-pool
    version when no result mask exists (results = top-ef visited), but does
    ONE top-k merge per step instead of two — the merges bound the
    loop. Returns (res_d f32[ef], res_s int32[ef]),
    BIG/-1 padded, unsorted.
    """
    words = (capacity + 31) // 32
    start = level_col_start(level, M)
    width = level_width(level, M)
    expand = max(1, min(expand, ef))

    pool_d = jnp.full((ef,), BIG, jnp.float32).at[0].set(entry_d)
    pool_s = jnp.full((ef,), -1, jnp.int32).at[0].set(entry_slot)
    pool_e = jnp.zeros((ef,), bool)

    visited = jnp.zeros((words,), jnp.int32)
    e_word = jnp.maximum(entry_slot, 0) // 32
    e_bit = jnp.maximum(entry_slot, 0) % 32
    visited = visited.at[e_word].set(
        jnp.where(entry_slot >= 0, (1 << e_bit).astype(jnp.int32), 0)
    )

    def cond(c):
        pool_d, pool_s, pool_e, visited, steps = c
        unexp = jnp.where(pool_e, BIG, pool_d)
        best = jnp.min(unexp)
        worst = jnp.max(pool_d)
        go = (best < BIG_THRESH) & ~(best > worst)
        return active & go & (steps < max_steps)

    def body(c):
        pool_d, pool_s, pool_e, visited, steps = c
        unexp = jnp.where(pool_e, BIG, pool_d)
        neg, pos = jax.lax.top_k(-unexp, expand)
        pop_ok = -neg < BIG_THRESH
        curs = jnp.where(pop_ok, pool_s[pos], -1)
        pool_e = pool_e.at[pos].set(True)

        rows = lax.dynamic_slice(
            graph.neighbors[jnp.maximum(curs, 0)], (0, start),
            (expand, 2 * M),
        )
        col_ok = jnp.arange(2 * M)[None, :] < width
        nbr = jnp.where(col_ok & (curs[:, None] >= 0), rows, -1).reshape(-1)
        safe = jnp.maximum(nbr, 0)

        bits = (visited[safe // 32] >> (safe % 32)) & 1
        fresh = (nbr >= 0) & (bits == 0)
        if expand > 1:
            order = jnp.argsort(nbr)
            snbr = nbr[order]
            first_sorted = jnp.concatenate(
                [jnp.ones((1,), bool), snbr[1:] != snbr[:-1]]
            )
            first = jnp.zeros_like(fresh).at[order].set(first_sorted)
            fresh = fresh & first

        wordv = jnp.where(fresh, (1 << (safe % 32)).astype(jnp.int32), 0)
        visited = visited.at[jnp.where(fresh, safe // 32, 0)].add(
            jnp.where(fresh, wordv, 0)
        )

        d = score(jnp.where(fresh, nbr, -1))

        cat_d = jnp.concatenate([pool_d, d])
        cat_s = jnp.concatenate([pool_s, nbr])
        cat_e = jnp.concatenate(
            [pool_e, jnp.zeros((d.shape[0],), bool)]
        )
        negk, idx = jax.lax.top_k(-cat_d, ef)
        pool_d = -negk
        pool_s = jnp.where(pool_d < BIG_THRESH, cat_s[idx], -1)
        pool_e = cat_e[idx]
        return pool_d, pool_s, pool_e, visited, steps + 1

    pool_d, pool_s, pool_e, visited, _ = lax.while_loop(
        cond, body, (pool_d, pool_s, pool_e, visited, jnp.int32(0))
    )
    res_s = jnp.where(pool_d < BIG_THRESH, pool_s, -1)
    return pool_d, res_s


@functools.partial(
    jax.jit,
    static_argnames=("M", "l_max", "ef", "k", "max_steps", "use_filter",
                     "pool", "expand"),
)
def search_batch(
    graph: Graph,
    emb: jnp.ndarray,
    has_emb: jnp.ndarray,
    queries: jnp.ndarray,
    filter_mask: Optional[jnp.ndarray],
    M: int,
    l_max: int,
    ef: int,
    k: int,
    max_steps: int,
    use_filter: bool,
    pool: int = 0,
    expand: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched HNSW search (reference HNSW.search, hnsw.py:330-374).

    queries: f32[B, d]. Returns (dists_sq f32[B, k], slots int32[B, k]),
    sorted ascending, (BIG, -1) padded.
    """
    rm = filter_mask if use_filter else None
    capacity = emb.shape[0]

    def res_ok(idx):
        return has_emb[jnp.maximum(idx, 0)]

    def one(q):
        def score(idx):
            return _dist_to(q, emb, idx, has_emb)

        entry = graph.entry
        entry_d = score(entry[None])[0]
        cur, cur_d = greedy_descent(
            graph, score, entry, entry_d, jnp.int32(1), M, l_max
        )
        if rm is None:
            rd, rs = beam_layer_unified(
                graph, score, capacity, cur, cur_d,
                active=entry >= 0, level=0,
                ef=ef, M=M, max_steps=max_steps, expand=expand,
            )
        else:
            rd, rs = beam_layer(
                graph, score, capacity, res_ok, cur, cur_d,
                active=entry >= 0, res_mask=rm, level=0,
                ef=ef, M=M, max_steps=max_steps, pool=pool, expand=expand,
            )
        return masked_top_k_smallest(rd, rs, k)

    return jax.vmap(one)(queries)


@functools.partial(
    jax.jit,
    static_argnames=("M", "l_max", "ef", "k", "max_steps", "pool", "expand",
                     "rerank"),
)
def search_batch_pq(
    graph: Graph,
    codes: jnp.ndarray,       # int32[capacity, chunks] PQ codes
    codebooks: jnp.ndarray,   # f32[chunks, ksub, subdim]
    emb: jnp.ndarray,         # f32[capacity, dim] (exact rerank only)
    has_emb: jnp.ndarray,
    queries: jnp.ndarray,
    queries_rot: jnp.ndarray,  # queries in code space (OPQ-rotated; may
    # be the same array when no rotation is trained)
    M: int,
    l_max: int,
    ef: int,
    k: int,
    max_steps: int,
    pool: int = 0,
    expand: int = 1,
    rerank: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """HNSW-over-PQ hybrid search (no reference analog — the reference's
    ``pq_chunks`` request param is silently ignored, api/models.py:18 vs
    hnsw.py:330-341).

    Beam traversal scores nodes by asymmetric PQ distance: a per-query LUT
    (chunks × ksub subspace distances) turns each neighbor visit into a
    codes-row gather (chunks bytes-scale) + LUT adds, instead of a full
    dim-wide embedding gather — ~dim*4/chunks× less HBM traffic in the hot
    loop. With ``rerank``, the final ef candidates are re-scored exactly
    (one [ef, dim] gather) so returned distances/order are full-precision.
    """
    from vector_db_tpu.index.pq import _adc_lut

    capacity = emb.shape[0]
    lut = _adc_lut(queries_rot, codebooks)  # [B, chunks, ksub]

    def res_ok(idx):
        return has_emb[jnp.maximum(idx, 0)]

    def one(q, lut_q):
        def score(idx):
            safe = jnp.maximum(idx, 0)
            c = codes[safe]  # [K, chunks]
            g = jax.vmap(lambda lm, cm: lm[cm], in_axes=(0, 1),
                         out_axes=1)(lut_q, c)  # [K, chunks]
            d = jnp.sum(g, axis=1)
            ok = (idx >= 0) & has_emb[safe]
            return jnp.where(ok, d, BIG)

        entry = graph.entry
        entry_d = score(entry[None])[0]
        cur, cur_d = greedy_descent(
            graph, score, entry, entry_d, jnp.int32(1), M, l_max
        )
        rd, rs = beam_layer_unified(
            graph, score, capacity, cur, cur_d,
            active=entry >= 0, level=0,
            ef=ef, M=M, max_steps=max_steps, expand=expand,
        )
        if rerank:
            # exact rerank: HIGHEST matvec (reported order/distances)
            rd = gather_l2_sq(q, emb, rs,
                              has_emb[jnp.maximum(rs, 0)])
        return masked_top_k_smallest(rd, rs, k)

    return jax.vmap(one)(queries, lut)


@functools.partial(
    jax.jit,
    static_argnames=("M", "l_max", "ef", "k", "max_steps", "expand"),
)
def search_batch_rp(
    graph: Graph,
    rp: jnp.ndarray,          # bf16[capacity, dp] PCA-projected mirror
    xsq: jnp.ndarray,         # f32[capacity] full-space ‖x‖²
    emb: jnp.ndarray,         # f32[capacity, dim] (exact rerank only)
    has_emb: jnp.ndarray,
    queries: jnp.ndarray,     # f32[B, dim]
    queries_proj: jnp.ndarray,  # f32[B, dp] projected queries
    M: int,
    l_max: int,
    ef: int,
    k: int,
    max_steps: int,
    expand: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Projected-traversal HNSW search (pHNSW-style PCA filtering).

    Beam traversal scores nodes from a PCA bf16 mirror: each neighbor
    visit gathers ``dp`` bf16 values instead of a full f32 row —
    ``dim*4 / (dp*2)``× less HBM traffic in the gather-bound hot loop
    (12× at 768-d/dp=128). The score ``‖x‖² − 2 q̂·x̂`` is the unbiased
    distance estimate minus the per-query constant ‖q‖² (ordering within
    a query is unaffected); the final ef candidates are re-scored exactly
    from the f32 table so returned distances/order are full-precision.
    """
    capacity = emb.shape[0]

    def one(q, qp):
        qp16 = qp.astype(rp.dtype)

        def score(idx):
            safe = jnp.maximum(idx, 0)
            rows = rp[safe]                           # [K, dp]
            dots = jnp.dot(rows, qp16,
                           preferred_element_type=jnp.float32)
            d = xsq[safe] - 2.0 * dots
            ok = (idx >= 0) & has_emb[safe]
            return jnp.where(ok, d, BIG)

        entry = graph.entry
        entry_d = score(entry[None])[0]
        cur, cur_d = greedy_descent(
            graph, score, entry, entry_d, jnp.int32(1), M, l_max
        )
        rd, rs = beam_layer_unified(
            graph, score, capacity, cur, cur_d,
            active=entry >= 0, level=0,
            ef=ef, M=M, max_steps=max_steps, expand=expand,
        )
        # exact rerank: HIGHEST matvec (reported order/distances)
        rd = gather_l2_sq(q, emb, rs, has_emb[jnp.maximum(rs, 0)])
        return masked_top_k_smallest(rd, rs, k)

    return jax.vmap(one)(queries, queries_proj)


@functools.partial(
    jax.jit,
    static_argnames=("M", "l_max", "ef_construction", "max_steps", "expand"),
)
def construction_search(
    graph: Graph,
    emb: jnp.ndarray,
    has_emb: jnp.ndarray,
    queries: jnp.ndarray,
    target_levels: jnp.ndarray,
    M: int,
    l_max: int,
    ef_construction: int,
    max_steps: int,
    expand: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Phase 1 of bulk insert: per new point, per level <= target, the
    ef_construction-wide candidate set (reference insert_node hnsw.py:174-184).

    Returns (cand_d f32[B, l_max, efc], cand_s int32[B, l_max, efc]).
    Levels above min(target, entry_level) come back empty (BIG/-1) — the
    reference gives such levels no edges either (hnsw.py:179-184 only covers
    start_level..0).
    """
    efc = ef_construction

    capacity = emb.shape[0]

    def res_ok(idx):
        return has_emb[jnp.maximum(idx, 0)]

    def one(q, tgt):
        def score(idx):
            return _dist_to(q, emb, idx, has_emb)

        entry = graph.entry
        entry_d = score(entry[None])[0]
        # greedy descent for levels above the new node's level
        cur, cur_d = greedy_descent(
            graph, score, entry, entry_d, tgt + 1, M, l_max
        )
        start_level = jnp.minimum(tgt, graph.entry_level)

        cds = []
        css = []
        for level in range(l_max - 1, -1, -1):
            act = (graph.entry >= 0) & (level <= start_level)
            rd, rs = beam_layer_unified(
                graph, score, capacity, cur, cur_d,
                active=act, level=level,
                ef=efc, M=M, max_steps=max_steps, expand=expand,
            )
            rd = jnp.where(act, rd, BIG)
            rs = jnp.where(act, rs, -1)
            cds.append(rd)
            css.append(rs)
            # entry for the next level down = closest candidate
            # (reference: curr_id = selected_neighbors[0], hnsw.py:216)
            jbest = jnp.argmin(rd)
            has_best = rd[jbest] < BIG_THRESH
            cur = jnp.where(act & has_best, rs[jbest], cur)
            cur_d = jnp.where(act & has_best, rd[jbest], cur_d)
        # cds was built top level first; reorder to [level] ascending
        cd = jnp.stack(cds[::-1])  # [l_max, efc]
        cs = jnp.stack(css[::-1])
        return cd, cs

    return jax.vmap(one)(queries, target_levels)


@functools.partial(
    jax.jit,
    static_argnames=("l_max", "ef_construction", "ef_upper", "tile"),
)
def construction_candidates_exact(
    graph: Graph,
    emb: jnp.ndarray,
    has_emb: jnp.ndarray,
    queries: jnp.ndarray,       # f32[B, d] (the new points)
    l_max: int,
    ef_construction: int,
    ef_upper: int,
    tile: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact construction candidates via one tiled matmul scan.

    The reference finds insert candidates with a per-level beam search of
    width ef_construction (hnsw.py:174-184). A batched exact scan replaces
    the pointer-chasing AND returns the
    true top-ef_construction — a strict superset in quality of what any
    beam finds, so graph quality can only improve. One pass over the table
    maintains a running top-k per level (level-l candidates are nodes with
    ``levels >= l``); uncommitted batch rows have level -1, so the batch
    never sees itself (the commit injects earlier batch members causally
    via exact intra-batch distances instead).

    Returns (cand_d f32[B, l_max, efc], cand_s int32[B, l_max, efc]); upper
    levels carry at most ``ef_upper`` live entries (BIG/-1 beyond).
    """
    from vector_db_tpu.ops.topk import merge_top_k

    efc = ef_construction
    n, dim = emb.shape
    assert n % tile == 0, "capacity must be a tile multiple"
    n_tiles = n // tile
    emb_t = emb.reshape(n_tiles, tile, dim)
    valid_t = (has_emb & (graph.levels >= 0)).reshape(n_tiles, tile)
    levels_t = graph.levels.reshape(n_tiles, tile)
    base_ids = jnp.arange(tile, dtype=jnp.int32)
    b = queries.shape[0]
    q_sq = jnp.sum(queries * queries, axis=-1)

    def k_of(level: int) -> int:
        return efc if level == 0 else min(ef_upper, efc)

    init = tuple(
        (jnp.full((b, k_of(l)), BIG, jnp.float32),
         jnp.full((b, k_of(l)), -1, jnp.int32))
        for l in range(l_max)
    )

    def body(carry, xs):
        tile_emb, tile_valid, tile_levels, tile_idx = xs
        x_sq = jnp.sum(tile_emb * tile_emb, axis=-1)
        cross = jnp.dot(queries, tile_emb.T,
                        preferred_element_type=jnp.float32)
        d = q_sq[:, None] - 2.0 * cross + x_sq[None, :]
        ids = base_ids + tile_idx * tile
        out = []
        for l in range(l_max):
            dl = jnp.where(
                tile_valid[None, :] & (tile_levels[None, :] >= l), d, BIG
            )
            nd, pos = jax.lax.approx_min_k(dl, k_of(l))
            ti = jnp.where(nd >= BIG_THRESH, -1, ids[pos])
            best_d, best_i = carry[l]
            out.append(merge_top_k(best_d, best_i, nd, ti, k_of(l)))
        return tuple(out), None

    carry, _ = jax.lax.scan(
        body, init,
        (emb_t, valid_t, levels_t, jnp.arange(n_tiles, dtype=jnp.int32)),
    )

    # assemble [B, l_max, efc] (upper levels right-padded to efc)
    cds, css = [], []
    for l in range(l_max):
        d_l, s_l = carry[l]
        pad = efc - d_l.shape[1]
        if pad:
            d_l = jnp.concatenate(
                [d_l, jnp.full((b, pad), BIG, jnp.float32)], axis=1
            )
            s_l = jnp.concatenate(
                [s_l, jnp.full((b, pad), -1, jnp.int32)], axis=1
            )
        cds.append(d_l)
        css.append(s_l)
    return jnp.stack(cds, axis=1), jnp.stack(css, axis=1)


@functools.partial(jax.jit, static_argnames=("M", "l_max", "ef_construction"),
                   donate_argnames=("graph",))
def commit_inserts(
    graph: Graph,
    emb: jnp.ndarray,
    has_emb: jnp.ndarray,
    new_slots: jnp.ndarray,
    new_levels: jnp.ndarray,
    cand_d: jnp.ndarray,
    cand_s: jnp.ndarray,
    batch_d: jnp.ndarray,
    M: int,
    l_max: int,
    ef_construction: int,
) -> Graph:
    """Phase 2 of bulk insert: sequential edge commit (reference
    hnsw.py:186-221), one batch item at a time inside a fori_loop.

    Search ran against the pre-batch graph, so each item's candidates are
    augmented with earlier batch members via the exact intra-batch distance
    matrix ``batch_d`` (f32[B, B]) — earlier members are *exact* nearest
    candidates, at least as good as the reference's sequential beam search.

    new_slots/new_levels: int32[B]; cand_d/cand_s: [B, l_max, efc].
    """
    B = new_slots.shape[0]
    efc = ef_construction

    def insert_one(i, g: Graph) -> Graph:
        neighbors, levels, entry, entry_level = g
        slot_raw = new_slots[i]
        slot = jnp.maximum(slot_raw, 0)
        lvl = new_levels[i]
        is_first = entry < 0
        # idempotent insert (hnsw.py:152-155): host filters dup ids, but a
        # slot already in the graph is also a structural no-op guard.
        # slot_raw < 0 marks batch padding (sharded per-shard batches pad to
        # a common length) — a full no-op.
        already = levels[slot] >= 0
        do = ~already & (slot_raw >= 0)

        # earlier batch members as candidates, by exact distance
        barange = jnp.arange(B, dtype=jnp.int32)
        b_earlier = barange < i
        bd_i = jnp.where(b_earlier, batch_d[i], BIG)

        for level in range(l_max):
            start = level_col_start(level, M)
            width = level_width(level, M)
            lvl_active = do & ~is_first & (level <= lvl)

            b_lvl = jnp.where(new_levels >= level, bd_i, BIG)
            md, ms = masked_top_k_smallest(
                jnp.concatenate([cand_d[i, level], b_lvl]),
                jnp.concatenate([cand_s[i, level], new_slots]),
                efc,
            )
            # select M closest (hnsw.py:136-141,188)
            sel_d, sel_s = masked_top_k_smallest(md, ms, M)
            sel_ok = (sel_s >= 0) & lvl_active

            # forward edges: write the new node's row at this level
            # (width >= M always: 2M at level 0, M above)
            fwd = jnp.full((width,), -1, jnp.int32)
            fwd = fwd.at[:M].set(jnp.where(sel_ok, sel_s, -1))
            old_row = lax.dynamic_slice(neighbors, (slot, start), (1, width))[0]
            row_w = jnp.where(lvl_active, fwd, old_row)
            neighbors = lax.dynamic_update_slice(
                neighbors, row_w[None, :], (slot, start)
            )

            # backlinks + prune (hnsw.py:190-213) — all M neighbor rows
            # update in ONE batched gather/compute/scatter (the selected
            # slots are unique, so the scatter has no conflicts)
            n_safe = jnp.maximum(sel_s, 0)  # [M]
            rows = neighbors[n_safe, start : start + width]  # [M, width]
            free = rows < 0
            has_free = jnp.any(free, axis=1)  # [M]
            first_free = jnp.argmax(free, axis=1)  # [M]
            appended = rows.at[jnp.arange(M), first_free].set(slot)
            # prune path: distances from each neighbor to row ∪ {slot}
            cand = jnp.concatenate(
                [rows, jnp.broadcast_to(slot, (M,))[:, None]], axis=1
            )  # [M, width+1]
            dn = jax.vmap(
                lambda nn, cc: _dist_to(emb[nn], emb, cc, has_emb)
            )(n_safe, cand)
            _, pruned = masked_top_k_smallest(dn, cand, width)
            new_rows = jnp.where(has_free[:, None], appended, pruned)
            # inactive entries scatter out-of-bounds (dropped) — writing a
            # stale copy back to their clamped row 0 would race with a
            # genuine update of row 0
            scatter_to = jnp.where(sel_ok, sel_s, neighbors.shape[0])
            neighbors = neighbors.at[
                scatter_to, start : start + width
            ].set(new_rows, mode="drop")

        levels = levels.at[slot].set(jnp.where(do, lvl, levels[slot]))
        new_entry = is_first | (lvl > entry_level)
        entry = jnp.where(do & new_entry, slot, entry)
        entry_level = jnp.where(do & new_entry, lvl, entry_level)
        return Graph(neighbors, levels, entry, entry_level)

    return lax.fori_loop(0, B, insert_one, graph)


@functools.partial(jax.jit, static_argnames=("M", "l_max", "ef_construction"),
                   donate_argnames=("graph",))
def commit_inserts_grouped(
    graph: Graph,
    emb: jnp.ndarray,
    has_emb: jnp.ndarray,
    new_slots: jnp.ndarray,
    new_levels: jnp.ndarray,
    cand_d: jnp.ndarray,
    cand_s: jnp.ndarray,
    batch_d: jnp.ndarray,
    M: int,
    l_max: int,
    ef_construction: int,
) -> Graph:
    """Batch-parallel edge commit, equivalent to :func:`commit_inserts`.

    The sequential loop (reference hnsw.py:186-221 one node at a time) is
    latency-bound on a device: B tiny dependent steps. This version commits the
    whole batch in O(l_max) big ops by exploiting two identities:

    1. item i's neighbor selection depends only on the pre-batch search
       results plus exact distances to EARLIER batch items — a [B, B]
       causal mask, so all selections vectorize;
    2. the per-row backlink fold "append if free else prune to the closest
       ``width``" is exactly a streaming top-k, so the final row equals
       ``top_width(existing row ∪ all incoming backlinks)`` — incoming
       edges group by destination row (sort + segment ranks) and every
       affected row merges once, in parallel.

    Forward rows write first (slots are unique), then grouped backlink
    merges read them, preserving the sequential interleaving's semantics
    (backlinks only ever target pre-batch nodes or earlier batch items).
    """
    B = new_slots.shape[0]
    efc = ef_construction
    neighbors, levels, entry, entry_level = graph
    capacity = levels.shape[0]

    slot_safe = jnp.maximum(new_slots, 0)
    already = levels[slot_safe] >= 0
    do = ~already & (new_slots >= 0)
    barange = jnp.arange(B, dtype=jnp.int32)
    # earlier-batch causal mask [i, j]: j precedes i
    causal = barange[None, :] < barange[:, None]

    E = B * M
    src_flat = jnp.repeat(slot_safe, M)  # [E]
    src_do = jnp.repeat(do, M)

    for level in range(l_max):
        start = level_col_start(level, M)
        width = level_width(level, M)
        # NOTE: an empty graph needs no explicit first-item guard — the
        # first item has no candidates (beam returned -1s, no earlier batch
        # members), so its sel_ok is all-false naturally.
        lvl_active = do & (level <= new_levels)

        # --- selection (vectorized over items) ---
        b_lvl = jnp.where(
            causal & (new_levels[None, :] >= level), batch_d, BIG
        )  # [B, B]
        md, ms = masked_top_k_smallest(
            jnp.concatenate([cand_d[:, level], b_lvl], axis=1),
            jnp.concatenate(
                [cand_s[:, level],
                 jnp.broadcast_to(new_slots[None, :], (B, B))], axis=1,
            ),
            efc,
        )
        sel_d, sel_s = masked_top_k_smallest(md, ms, M)  # [B, M]
        sel_ok = (sel_s >= 0) & lvl_active[:, None]

        # --- forward rows (disjoint slots -> one scatter) ---
        fwd = jnp.full((B, width), -1, jnp.int32)
        fwd = fwd.at[:, :M].set(jnp.where(sel_ok, sel_s, -1))
        fwd_to = jnp.where(lvl_active, new_slots, capacity)
        neighbors = neighbors.at[fwd_to, start : start + width].set(
            fwd, mode="drop"
        )

        # --- backlinks, grouped by destination row ---
        dst = jnp.where(sel_ok.reshape(-1) & src_do, sel_s.reshape(-1),
                        capacity)  # invalid -> sorts last
        d_e = jnp.where(dst < capacity, sel_d.reshape(-1), BIG)
        order = jnp.lexsort((d_e, dst))
        dst_s = dst[order]
        src_s = src_flat[order]
        first = jnp.concatenate(
            [jnp.ones((1,), bool), dst_s[1:] != dst_s[:-1]]
        ) & (dst_s < capacity)
        idx = jnp.arange(E, dtype=jnp.int32)
        seg_of_e = jnp.cumsum(first.astype(jnp.int32)) - 1  # [-1 .. S-1]
        seg_start = jax.lax.cummax(jnp.where(first, idx, 0))
        rank = idx - seg_start
        keep = (dst_s < capacity) & (rank < width) & (seg_of_e >= 0)

        # incoming table per segment (at most `width` closest kept — more
        # could never survive the row's top-width merge anyway)
        inc = jnp.full((E, width), -1, jnp.int32)
        inc = inc.at[
            jnp.where(keep, seg_of_e, E), jnp.minimum(rank, width - 1)
        ].set(jnp.where(keep, src_s, -1), mode="drop")
        seg_dst = jnp.full((E,), capacity, jnp.int32)
        seg_dst = seg_dst.at[jnp.where(first, seg_of_e, E)].set(
            jnp.where(first, dst_s, capacity), mode="drop"
        )

        seg_dst_safe = jnp.minimum(seg_dst, capacity - 1)
        rows = neighbors[seg_dst_safe, start : start + width]  # [E, width]
        cand = jnp.concatenate([rows, inc], axis=1)  # [E, 2*width]
        dn = jax.vmap(
            lambda nn, cc: _dist_to(emb[nn], emb, cc, has_emb)
        )(seg_dst_safe, cand)
        _, merged = masked_top_k_smallest(dn, cand, width)
        neighbors = neighbors.at[seg_dst, start : start + width].set(
            merged, mode="drop"
        )

    # --- levels + entry ---
    levels = levels.at[jnp.where(do, new_slots, capacity)].set(
        new_levels, mode="drop"
    )
    lv_masked = jnp.where(do, new_levels, -1)
    best_i = jnp.argmax(lv_masked)  # first occurrence of the max, as the
    # sequential fold elects (first item whose level exceeds the running
    # entry level ends up being the first argmax)
    best_lvl = lv_masked[best_i]
    any_new = jnp.any(do)
    promote = any_new & ((entry < 0) | (best_lvl > entry_level))
    entry = jnp.where(promote, slot_safe[best_i], entry)
    entry_level = jnp.where(promote, best_lvl, entry_level)
    return Graph(neighbors, levels, entry, entry_level)


@functools.partial(
    jax.jit,
    static_argnames=("M", "l_max", "ef_construction", "max_steps", "commit",
                     "expand"),
    donate_argnames=("graph",),
)
def insert_step(
    graph: Graph,
    emb: jnp.ndarray,
    has_emb: jnp.ndarray,
    new_emb: jnp.ndarray,      # f32[B, d] (padded rows are zeros)
    new_slots: jnp.ndarray,    # int32[B], -1 = padding
    new_levels: jnp.ndarray,   # int32[B]
    M: int,
    l_max: int,
    ef_construction: int,
    max_steps: int,
    commit: str = "grouped",
    expand: int = 1,
) -> Graph:
    """Fused streaming insert: construction search + intra-batch distances
    + edge commit in ONE compiled program (one dispatch per batch —
    per-call latency dominates on remote backends).

    commit="grouped" (default) uses the batch-parallel commit
    (:func:`commit_inserts_grouped`); "sequential" keeps the item-at-a-time
    fori_loop (:func:`commit_inserts`) for comparison/property tests.

    ``expand`` > 1 pops that many beam candidates per construction-search
    step (see beam_layer_unified) — the sequential step count, the
    insert bottleneck, drops ~expand-fold; the explored set is a superset
    of best-first's at equal ef_construction."""
    cd, cs = construction_search(
        graph, emb, has_emb, new_emb, new_levels,
        M=M, l_max=l_max, ef_construction=ef_construction,
        max_steps=max_steps, expand=expand,
    )
    from vector_db_tpu.ops.distance import l2_sq_pairwise

    batch_d = l2_sq_pairwise(new_emb, new_emb)
    pad = new_slots < 0
    batch_d = jnp.where(pad[None, :] | pad[:, None], BIG, batch_d)
    commit_fn = commit_inserts_grouped if commit == "grouped" else commit_inserts
    return commit_fn(
        graph, emb, has_emb, new_slots, new_levels, cd, cs, batch_d,
        M=M, l_max=l_max, ef_construction=ef_construction,
    )


@functools.partial(
    jax.jit,
    static_argnames=("M", "l_max", "ef_construction", "ef_upper", "tile",
                     "commit"),
    donate_argnames=("graph",),
)
def insert_step_exact(
    graph: Graph,
    emb: jnp.ndarray,
    has_emb: jnp.ndarray,
    new_emb: jnp.ndarray,      # f32[B, d] (padded rows are zeros)
    new_slots: jnp.ndarray,    # int32[B], -1 = padding
    new_levels: jnp.ndarray,   # int32[B]
    M: int,
    l_max: int,
    ef_construction: int,
    ef_upper: int,
    tile: int,
    commit: str = "grouped",
) -> Graph:
    """Fused streaming insert with EXACT candidates: one tiled matmul scan
    of the table replaces the per-item construction beam (strictly better
    candidates; see
    construction_candidates_exact), then the batch-parallel edge commit.
    One compiled program per batch."""
    cd, cs = construction_candidates_exact(
        graph, emb, has_emb, new_emb,
        l_max=l_max, ef_construction=ef_construction, ef_upper=ef_upper,
        tile=tile,
    )
    from vector_db_tpu.ops.distance import l2_sq_pairwise

    batch_d = l2_sq_pairwise(new_emb, new_emb)
    pad = new_slots < 0
    batch_d = jnp.where(pad[None, :] | pad[:, None], BIG, batch_d)
    commit_fn = commit_inserts_grouped if commit == "grouped" else commit_inserts
    return commit_fn(
        graph, emb, has_emb, new_slots, new_levels, cd, cs, batch_d,
        M=M, l_max=l_max, ef_construction=ef_construction,
    )


@functools.partial(jax.jit, static_argnames=("M", "l_max"),
                   donate_argnames=("graph",))
def delete_slot(graph: Graph, slot: jnp.ndarray, M: int, l_max: int) -> Graph:
    """Remove a node: drop incident edges both ways, clear its rows, and
    re-elect the entry point as the highest-level survivor (reference
    delete_node, hnsw.py:227-277).

    Unlinking scans the WHOLE neighbor table, not just the deleted node's
    own rows: backlink pruning makes edges asymmetric, and a surviving
    incoming edge would alias whatever new node later recycles the slot
    (the reference's id-keyed dict graph can never alias). One vectorized
    compare-and-mask pass over [capacity, ncols] replaces the per-edge
    unlink loop — also far fewer HLO ops."""
    neighbors, levels, entry, entry_level = graph
    present = levels[slot] >= 0

    # clear every reference to the slot anywhere in the table, then the
    # slot's own rows (row write covers all levels at once)
    neighbors = jnp.where(present & (neighbors == slot), -1, neighbors)
    own = jnp.where(present, jnp.full_like(neighbors[slot], -1),
                    neighbors[slot])
    neighbors = neighbors.at[slot].set(own)

    levels = levels.at[slot].set(jnp.where(present, -1, levels[slot]))

    # entry re-election (hnsw.py:240-258)
    need = present & (entry == slot)
    best = jnp.argmax(levels)  # -1 everywhere if empty
    any_left = levels[best] >= 0
    entry = jnp.where(need, jnp.where(any_left, best.astype(jnp.int32), -1), entry)
    entry_level = jnp.where(
        need, jnp.where(any_left, levels[best], -1), entry_level
    )
    return Graph(neighbors, levels, entry, entry_level)
