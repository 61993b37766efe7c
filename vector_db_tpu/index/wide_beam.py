"""Wide-beam HNSW search: frontier-parallel graph traversal.

Replaces the reference's best-first ``_search_layer`` hot loop
(reference src/vector_db/indexing/hnsw.py:89-134) for unfiltered queries.
The classic formulation pops ONE candidate per step and re-sorts an
ef-wide pool each hop, so the per-hop ``lax.top_k`` merges and the
while_loop's sequential steps bound throughput, not gather traffic.

Wide-beam restructures the loop around what the hardware is good at:

- expand a whole FRONTIER of F nodes per step (F ~ 16-64), so each step
  gathers F*2M candidate rows and scores them in one batched contraction
  — sequential depth drops from ~ef hops to T ~ 8-16 steps;
- the pool merge is one hardware partial-reduce (``lax.approx_min_k``)
  over [pool ∪ new candidates] per step — never a full sort;
- scoring reads an AUGMENTED bf16 mirror row ``[-2·x̂, ‖x‖²]`` so a
  candidate's score is a single row-gather + dot with ``[q̂, 1]`` (no
  separate norm/validity gathers in the hot loop; invalid rows carry
  ‖x‖² = BIG and never win);
- entry seeding scores a fixed SEED set (the upper-level HNSW nodes —
  the same navigation hierarchy the reference descends greedily,
  hnsw.py:356-358) with one matmul, replacing the sequential greedy
  descent entirely;
- the visited set is implicit: a slot already present in the pool is
  masked from re-entry, and expansion marks every pool copy expanded.
  Nodes evicted from the pool may be re-scored if re-encountered (wasted
  work, never wrong results); the final exact rerank reports
  full-precision distances, so traversal scores only ever SELECT.

Semantics vs the reference: termination is a static step count T instead
of the data-dependent "best candidate worse than ef-th result" rule —
queries that converge early waste steps inside the batch (which runs in
lockstep under vmap anyway). Recall parity at matched (ef, T) is
validated against brute force in tests.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as _np

from vector_db_tpu.ops.distance import BIG

BIG_THRESH = _np.float32(1.0e37)


def build_aug_table(
    emb: jnp.ndarray,        # f32[capacity, dim]
    has_emb: jnp.ndarray,    # bool[capacity]
    proj: jnp.ndarray | None,  # f32[dim, dp] or None (identity mirror)
) -> jnp.ndarray:
    """Augmented scoring mirror: bf16[capacity, dpa] rows ``[-2·x̂, ‖x‖²]``
    (dpa = dp + 8, zero padded for lane alignment). ``‖x‖²`` is the
    FULL-space norm — with a PCA mirror the score ‖x‖² − 2 q̂·x̂ is the
    standard unbiased estimate (constant ‖q‖² dropped; ranking unchanged).
    Invalid rows carry ‖x‖² = BIG so they never enter the pool."""
    xsq = jnp.sum(emb * emb, axis=-1)
    xsq = jnp.where(has_emb, xsq, BIG)
    x_m = emb if proj is None else jnp.dot(
        emb, proj, preferred_element_type=jnp.float32)
    dp = x_m.shape[1]
    dpa = dp + 8
    aug = jnp.zeros((emb.shape[0], dpa), jnp.bfloat16)
    aug = aug.at[:, :dp].set((-2.0 * x_m).astype(jnp.bfloat16))
    aug = aug.at[:, dp].set(xsq.astype(jnp.bfloat16))
    return aug


def build_aug_table_pq(
    codes: jnp.ndarray,        # int32[capacity, m] PQ codes
    codebooks: jnp.ndarray,    # f32[m, ksub, subdim]
    rotation: jnp.ndarray | None,  # f32[dim, dim] OPQ (code space <- input)
    has_emb: jnp.ndarray,      # bool[capacity]
    proj: jnp.ndarray | None,  # f32[dim, dp] PCA (input space) or None
    chunk: int = 16384,
) -> jnp.ndarray:
    """Augmented mirror with PQ-DECODED content: rows
    ``[-2·R_p^T·decode(x), ‖decode(x)‖²]``.

    Scoring q against this table computes ``‖q − decode(x)‖²`` (up to the
    per-query constant) — the asymmetric-distance (ADC) estimate, i.e.
    HNSW-over-PQ traversal semantics — but as the same augmented-row dot
    product the wide-beam kernel already uses, instead of per-element LUT
    gathers. Decoding streams on device in one scan; nothing is retrained.
    The mirror costs dp bytes/vector (the codes stay the compact store —
    this is a query-time acceleration structure, rebuilt from codes).
    """
    from vector_db_tpu.index.pq import _decode

    cap = codes.shape[0]
    pad = (-cap) % chunk
    codes_p = (jnp.concatenate(
        [codes, jnp.zeros((pad, codes.shape[1]), codes.dtype)])
        if pad else codes)
    n_chunks = codes_p.shape[0] // chunk

    def body(_, c):
        dec = _decode(c, codebooks)            # [chunk, dim] (code space)
        if rotation is not None:
            dec = jnp.dot(dec, rotation.T,
                          preferred_element_type=jnp.float32)
        xsq = jnp.sum(dec * dec, axis=-1)
        dm = dec if proj is None else jnp.dot(
            dec, proj, preferred_element_type=jnp.float32)
        return None, (dm.astype(jnp.bfloat16), xsq)

    _, (dm, xsq) = jax.lax.scan(
        body, None, codes_p.reshape(n_chunks, chunk, -1))
    dm = dm.reshape(-1, dm.shape[-1])[:cap]
    xsq = xsq.reshape(-1)[:cap]
    xsq = jnp.where(has_emb, xsq, BIG)
    dp = dm.shape[1]
    aug = jnp.zeros((cap, dp + 8), jnp.bfloat16)
    aug = aug.at[:, :dp].set((-2.0 * dm.astype(jnp.float32)
                              ).astype(jnp.bfloat16))
    aug = aug.at[:, dp].set(xsq.astype(jnp.bfloat16))
    return aug


def build_inline_tables(
    neighbors0: jnp.ndarray,   # int32[capacity, W] level-0 adjacency
    emb: jnp.ndarray,          # f32[capacity, dim]
    has_emb: jnp.ndarray,      # bool[capacity]
    proj: jnp.ndarray | None,  # f32[dim, dp] or None
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Inline neighbor replication (the CAGRA/DiskANN layout):
    every node stores its W neighbors' int8-quantized mirror rows as ONE
    contiguous [W, dp] block, plus a [W, 2] f32 aux row (dequant scale,
    full-space norm).

    Why: small-row gathers are bound by the number of gathers issued, not
    by bytes — the per-candidate gather of F·W mirror rows dominates the
    wide-beam step. One inline block per FRONTIER node replaces W
    row-gathers with one 4 KB block-gather, a ~W× cut in gather issues.

    Cost: capacity·W·dp bytes (4 GB at 1M, W=32, dp=128) — a query-time
    acceleration structure rebuilt from the graph + table, never
    persisted. Returns (nbr_i8 int8[capacity, W, dp],
    nbr_scale f32[capacity, W], nbr_xsq f32[capacity, W])."""
    x_m = emb if proj is None else jnp.dot(
        emb, proj, preferred_element_type=jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(x_m), axis=1), 1e-9) / 127.0
    xi8 = jnp.round(x_m / scale[:, None]).astype(jnp.int8)
    # pad the quantized mirror to a 128-lane multiple HERE: a [*, W, dp]
    # int8 block with dp % 128 != 0 makes XLA materialize a padded
    # layout COPY of the whole table inside the search program (3.8 GB
    # at 1M, W=32, dp=120 — OOMed); explicit zero columns cost nothing
    # in the dot products and keep the table in its final layout
    lane_pad = (-xi8.shape[1]) % 128
    if lane_pad:
        xi8 = jnp.concatenate(
            [xi8, jnp.zeros((xi8.shape[0], lane_pad), jnp.int8)], axis=1)
    xsq = jnp.sum(emb * emb, axis=-1)
    xsq = jnp.where(has_emb, xsq, BIG)
    safe = jnp.maximum(neighbors0, 0)
    ok = neighbors0 >= 0
    nbr_i8 = xi8[safe]                                   # [cap, W, dp128]
    nbr_scale = jnp.where(ok, scale[safe], 0.0)
    nbr_xsq = jnp.where(ok, xsq[safe], BIG)
    return nbr_i8, nbr_scale, nbr_xsq


def aug_queries(
    queries: jnp.ndarray,      # f32[B, dim]
    proj: jnp.ndarray | None,  # f32[dim, dp] or None
    dpa: int,
) -> jnp.ndarray:
    """Query-side augmentation ``[q̂, 1, 0...]`` matching build_aug_table."""
    q_m = queries if proj is None else jnp.dot(
        queries, proj, preferred_element_type=jnp.float32)
    dp = q_m.shape[1]
    qa = jnp.zeros((queries.shape[0], dpa), jnp.float32)
    qa = qa.at[:, :dp].set(q_m)
    qa = qa.at[:, dp].set(1.0)
    return qa


@functools.partial(
    jax.jit,
    static_argnames=("F", "T", "k", "rerank_k", "hist", "dedup_window"),
)
def beam_search(
    neighbors0: jnp.ndarray,   # int32[capacity, W] level-0 adjacency
    aug: jnp.ndarray,          # bf16[capacity, dpa] scoring mirror
    emb: jnp.ndarray,          # f32[capacity, dim] exact rerank table
    has_emb: jnp.ndarray,      # bool[capacity]
    seed_slots: jnp.ndarray,   # int32[S], -1 padded
    queries: jnp.ndarray,      # f32[B, dim]
    queries_aug: jnp.ndarray,  # f32[B, dpa]
    F: int,
    T: int,
    k: int,
    rerank_k: int,
    hist: int = 2,
    dedup_window: int = 8,
    inline_tabs: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray] | None = None,
    res_mask: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pool-free beam traversal: the merge-light wide-beam variant.

    :func:`wide_search` keeps an ef-wide best-so-far pool and pays three
    selection passes per step over it (pop ``approx_min_k`` over P, merge
    over P+K, and the pool permutation gather). This variant removes the
    pool from the loop entirely:

    - the next frontier is the top-F of THIS step's K=F·W candidate
      scores — one partial-reduce at a 16x reduction ratio and one
      [B, F] gather, instead
      of three pool-wide passes;
    - every step's frontier (scores + slots) is EMITTED through the scan's
      stacked outputs — no running merge; one deferred ``approx_min_k``
      over the [B, (T+1)·F] trajectory picks the rerank set at the end,
      and the exact rerank reports full-precision distances;
    - revisit control is a sliding HISTORY mask against the last ``hist``
      frontiers (graph edges are near-symmetric, so unmasked traversal
      oscillates parent<->child): [K, hist·F] compares, ~4x cheaper than
      the pool-membership mask wide_search dropped for cost.

    Trade-off vs wide_search: a candidate seen but not chosen at step t
    cannot be revisited later (no pool memory), so per-step recall is
    lower at equal (F, T) — but each step is ~2x cheaper, buying more
    steps or wider frontiers at equal latency. Returns the
    :func:`wide_search` contract: (d_sq f32[B, k], slots int32[B, k]).

    ``res_mask`` (filter-ids contract, reference hnsw.py:81-88): the
    emitted trajectory already holds every frontier node, so filtering
    is one mask over the [B, (T+1)·F] trajectory scores before the
    deferred selection — navigation stays unfiltered for free. Matching
    candidates that were scored but never frontier-chosen are not in
    the trajectory, so very selective filters prefer wide_search's
    two-pool mode.
    """
    B = queries.shape[0]
    qa16 = queries_aug.astype(jnp.bfloat16)

    # ---- seed: score the fixed seed set, take the first frontier ----
    seed_safe = jnp.maximum(seed_slots, 0)
    seed_rows = aug[seed_safe]
    d_seed = jnp.dot(qa16, seed_rows.T.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)      # [B, S]
    d_seed = jnp.where(seed_slots[None, :] >= 0, d_seed, BIG)
    fd, fpos = jax.lax.approx_min_k(d_seed, F)
    frontier = jnp.where(fd < BIG_THRESH, seed_slots[fpos], -1)

    if inline_tabs is not None:
        dp_i = inline_tabs[0].shape[-1]
        dp_real = queries_aug.shape[1] - 8
        qm = queries_aug[:, : min(dp_i, queries_aug.shape[1])]
        if qm.shape[1] < dp_i:
            qm = jnp.concatenate(
                [qm, jnp.zeros((B, dp_i - qm.shape[1]), qm.dtype)], axis=1)
        if dp_i > dp_real:
            qm = jnp.where(jnp.arange(dp_i)[None, :] < dp_real, qm, 0.0)
        q_scale = jnp.maximum(jnp.max(jnp.abs(qm), axis=1), 1e-9) / 127.0
        q_i8 = jnp.round(qm / q_scale[:, None]).astype(jnp.int8)

    hist0 = jnp.full((B, max(hist, 1) * F), -1, jnp.int32)

    def step(carry, _):
        frontier, fd, seen = carry
        fvalid = frontier >= 0
        f_safe = jnp.maximum(frontier, 0)
        cand = neighbors0[f_safe]                     # [B, F, W]
        cand = jnp.where(fvalid[:, :, None], cand, -1)
        cand = cand.reshape(B, -1)                    # [B, K]
        if inline_tabs is not None:
            nbr_i8, nbr_scale, nbr_xsq = inline_tabs
            blk = nbr_i8[f_safe]                      # [B, F, W, dp] int8
            scl = nbr_scale[f_safe]
            nxq = nbr_xsq[f_safe]
            dots = jnp.einsum("bfnd,bd->bfn", blk, q_i8,
                              preferred_element_type=jnp.int32)
            d_new = (nxq - (2.0 * q_scale)[:, None, None] * scl
                     * dots.astype(jnp.float32)).reshape(B, -1)
        else:
            c_safe = jnp.maximum(cand, 0)
            d_new = jnp.einsum(
                "bkd,bd->bk", aug[c_safe].astype(jnp.bfloat16), qa16,
                preferred_element_type=jnp.float32)
        # mask invalid + recently-expanded (history window, incl. the
        # CURRENT frontier — its members are already emitted)
        recent = jnp.concatenate([seen[:, F:], frontier], axis=1) \
            if hist > 1 else frontier
        dup = jnp.any(cand[:, :, None] == recent[:, None, :], axis=-1)
        d_new = jnp.where((cand >= 0) & ~dup, d_new, BIG)

        nd, npos = jax.lax.approx_min_k(d_new, F)
        nfront = jnp.take_along_axis(cand, npos, axis=1)
        nfront = jnp.where(nd < BIG_THRESH, nfront, -1)
        # window dedup WITHIN the new frontier: equal scores (same slot
        # multi-path) land adjacent in the partial-reduce output
        if dedup_window > 0:
            d = jnp.zeros((B, F), bool)
            for w in range(1, dedup_window + 1):
                s_r = jnp.pad(nfront[:, :-w], ((0, 0), (w, 0)),
                              constant_values=-3)
                d = d | (nfront == s_r)
            nd = jnp.where(d, BIG, nd)
            nfront = jnp.where(d, -1, nfront)
        seen = recent if hist > 1 else frontier
        return (nfront, nd, seen), (fd, frontier)

    (lf, lfd, _), (ds, ss) = jax.lax.scan(
        step, (frontier, fd, hist0), None, length=T)
    # trajectory = T emitted frontiers + the last one still in carry
    ds = jnp.concatenate(
        [jnp.moveaxis(ds, 0, 1).reshape(B, -1), lfd], axis=1)
    ss = jnp.concatenate(
        [jnp.moveaxis(ss, 0, 1).reshape(B, -1), lf], axis=1)

    # ---- one deferred selection + exact rerank ----
    if res_mask is not None:
        ds = jnp.where(
            (ss >= 0) & res_mask[jnp.maximum(ss, 0)], ds, BIG)
    R = min(max(rerank_k, k), ds.shape[1])
    rd, rpos = jax.lax.approx_min_k(ds, R)
    rs = jnp.take_along_axis(ss, rpos, axis=1)
    dup = jnp.any(
        (rs[:, :, None] == rs[:, None, :])
        & (jnp.arange(R)[None, :] < jnp.arange(R)[:, None])[None, :, :],
        axis=-1,
    )
    ok = (rs >= 0) & ~dup & has_emb[jnp.maximum(rs, 0)]
    if res_mask is not None:
        ok = ok & res_mask[jnp.maximum(rs, 0)]
    r_safe = jnp.maximum(rs, 0)
    diff = emb[r_safe] - queries[:, None, :]
    d_ex = jnp.sum(diff * diff, axis=-1)
    d_ex = jnp.where(ok, d_ex, BIG)
    neg, pos = jax.lax.top_k(-d_ex, k)
    out_d = -neg
    out_s = jnp.take_along_axis(rs, pos, axis=1)
    out_s = jnp.where(out_d < BIG_THRESH, out_s, -1)
    return out_d, out_s


@functools.partial(
    jax.jit,
    static_argnames=("ef", "F", "T", "k", "rerank_k", "dedup_window",
                     "seen_mask", "score_chunks", "schedule",
                     "early_exit"),
)
def wide_search(
    neighbors0: jnp.ndarray,   # int32[capacity, W] level-0 adjacency
    aug: jnp.ndarray,          # bf16[capacity, dpa] scoring mirror
    emb: jnp.ndarray,          # f32[capacity, dim] exact rerank table
    has_emb: jnp.ndarray,      # bool[capacity]
    seed_slots: jnp.ndarray,   # int32[S], -1 padded
    queries: jnp.ndarray,      # f32[B, dim]
    queries_aug: jnp.ndarray,  # f32[B, dpa]
    ef: int,
    F: int,
    T: int,
    k: int,
    rerank_k: int,
    dedup_window: int = 16,
    seen_mask: bool = True,
    inline_tabs: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray] | None = None,
    score_chunks: int = 1,
    schedule: Tuple[Tuple[int, int], ...] | None = None,
    res_mask: jnp.ndarray | None = None,
    early_exit: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched wide-beam search. Returns (d_sq f32[B, k], slots int32[B, k])
    sorted ascending, (BIG, -1) padded; distances exact (difference-form
    rerank).

    ``inline_tabs`` (from build_inline_tables) switches candidate scoring
    from per-candidate mirror-row gathers to one inline block per frontier
    node — W× fewer gather issues on issue-bound HBM gathers.
    ``seen_mask`` toggles the pre-merge pool-membership mask (the [K, P]
    broadcast compare); the post-merge window dedup stays either way.
    ``schedule`` replaces the fixed (F, T) loop with segments
    ``((F1, T1), (F2, T2), ...)``: T1 steps at frontier F1, then T2 at
    F2, ... — early steps explore wide, later steps refine narrow, so
    the per-step expansion cost (gather + score + merge all scale with
    F·W) shrinks as the pool converges. Each distinct F compiles one
    scan body (segments stay O(segments) in HLO size, not O(T)).
    ``res_mask`` (bool[capacity]) is the filter-ids contract (reference
    hnsw.py:81-88,96-97,127-131): masked-out nodes still navigate (the
    main pool is unchanged) but only matching nodes enter a separate
    result pool [B, R] merged per step — the wide-beam analog of the
    classic beam's two-pool filtered mode (hnsw_kernels.beam_layer).
    ``early_exit`` restores the reference's dynamic termination
    (hnsw.py:102-112 — stop when the best candidate is worse than the
    worst kept result) batched: a ``while_loop`` over the same step body
    stops once NO query's best unexpanded pool entry beats its R-th
    best result (anything that cannot make the rerank set cannot change
    the output). T becomes an upper bound; early-converging small
    batches stop in a few steps instead of burning all T. Incompatible
    with ``schedule`` (fixed F only) — filtered queries use the result
    pool's R-th best as the bound.
    """
    B = queries.shape[0]
    P = ef
    R = min(max(rerank_k, k), P)  # rerank set can never be narrower than k
    qa16 = queries_aug.astype(jnp.bfloat16)

    # ---- seed the pool: one matmul over the fixed seed set ----
    seed_safe = jnp.maximum(seed_slots, 0)
    seed_rows = aug[seed_safe]                        # [S, dpa] (invariant)
    d_seed = jnp.dot(qa16, seed_rows.T.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)  # [B, S]
    d_seed = jnp.where(seed_slots[None, :] >= 0, d_seed, BIG)
    s_pad = max(0, P - d_seed.shape[1])
    if s_pad:
        d_seed = jnp.concatenate(
            [d_seed, jnp.full((B, s_pad), BIG, jnp.float32)], axis=1)
        seed_b = jnp.concatenate(
            [jnp.broadcast_to(seed_slots[None, :], (B, seed_slots.shape[0])),
             jnp.full((B, s_pad), -1, jnp.int32)], axis=1)
    else:
        seed_b = jnp.broadcast_to(
            seed_slots[None, :], (B, seed_slots.shape[0]))
    pool_d, pos = jax.lax.approx_min_k(d_seed, P)
    pool_s0 = jnp.take_along_axis(seed_b, pos, axis=1)
    pool_s0 = jnp.where(pool_d < BIG_THRESH, pool_s0, -1)
    # pool distances carried in bf16: halves the merge/pop partial-reduce
    # traffic (the largest remaining step cost). Selection-only — the
    # duplicate-adjacency invariant survives (identical rows round
    # identically) and the rerank reports exact f32.
    pool_d = pool_d.astype(jnp.bfloat16)
    # (slot, expanded) PACKED into one int32 (slot*2 | e): the merge's
    # pool permutation then needs ONE take_along_axis instead of two
    # (the taa gathers are issue-bound like every other gather). slot -1
    # packs to -2;
    # arithmetic >> 1 unpacks both signs correctly.
    pool_se = pool_s0 * 2

    if res_mask is not None:
        ok_seed = (seed_b >= 0) & res_mask[jnp.maximum(seed_b, 0)]
        d_seed_m = jnp.where(ok_seed, d_seed, BIG)
        res_d, rpos0 = jax.lax.approx_min_k(d_seed_m, R)
        res_s = jnp.take_along_axis(seed_b, rpos0, axis=1)
        res_s = jnp.where(res_d < BIG_THRESH, res_s, -1)

    if inline_tabs is not None:
        # int8 query mirror: an int8 x int8 contraction skips the
        # [B, K, dp] bf16 cast materialization. Selection-only noise;
        # rerank is exact. The inline
        # table is lane-padded to a 128 multiple; columns at/after the
        # aug xsq position (dpa-8) are not mirror data — zero them so the
        # query's [.., 1, 0..] tail neither skews q_scale nor scores
        # against the table's zero padding.
        dp_i = inline_tabs[0].shape[-1]
        dp_real = queries_aug.shape[1] - 8
        qm = queries_aug[:, : min(dp_i, queries_aug.shape[1])]
        if qm.shape[1] < dp_i:
            qm = jnp.concatenate(
                [qm, jnp.zeros((B, dp_i - qm.shape[1]), qm.dtype)], axis=1)
        if dp_i > dp_real:
            qm = jnp.where(
                jnp.arange(dp_i)[None, :] < dp_real, qm, 0.0)
        q_scale = jnp.maximum(jnp.max(jnp.abs(qm), axis=1), 1e-9) / 127.0
        q_i8 = jnp.round(qm / q_scale[:, None]).astype(jnp.int8)

    def make_step(F):
      def step(carry, _):
        if res_mask is not None:
            pool_d, pool_se, res_d, res_s = carry
        else:
            pool_d, pool_se = carry
        big = jnp.asarray(BIG, pool_d.dtype)
        pool_sid = pool_se >> 1
        pool_e = (pool_se & 1) == 1
        # ---- pop the F best unexpanded entries ----
        unexp = jnp.where(pool_e | (pool_sid < 0), big, pool_d)
        fd, fpos = jax.lax.approx_min_k(unexp, F)
        frontier = jnp.take_along_axis(pool_sid, fpos, axis=1)  # [B, F]
        fvalid = (fd < BIG_THRESH) & (frontier >= 0)
        frontier = jnp.where(fvalid, frontier, -1)
        # mark EVERY pool copy of a popped slot expanded (duplicates from
        # multi-path re-encounters must not re-expand)
        hit = jnp.any(
            (pool_sid[:, :, None] == frontier[:, None, :])
            & fvalid[:, None, :],
            axis=-1,
        )
        pool_se = pool_se | hit.astype(jnp.int32)

        # ---- expand: gather adjacency + score candidates ----
        f_safe = jnp.maximum(frontier, 0)
        cand = neighbors0[f_safe]                     # [B, F, W]
        cand = jnp.where(fvalid[:, :, None], cand, -1)
        cand = cand.reshape(B, -1)                    # [B, K]
        if inline_tabs is not None:
            # one contiguous [W, dp] block per FRONTIER node (issue-bound
            # gathers: W x fewer issues than per-candidate rows)
            nbr_i8, nbr_scale, nbr_xsq = inline_tabs
            blk = nbr_i8[f_safe]                      # [B, F, W, dp] int8
            scl = nbr_scale[f_safe]                   # [B, F, W]
            nxq = nbr_xsq[f_safe]                     # [B, F, W]
            dots = jnp.einsum(
                "bfnd,bd->bfn", blk, q_i8,
                preferred_element_type=jnp.int32)
            d_new = (
                nxq
                - (2.0 * q_scale)[:, None, None] * scl
                * dots.astype(jnp.float32)
            ).reshape(B, -1)
        elif score_chunks > 1:
            # bound the [B, K, dpa] mirror gather + f32 score temp: at
            # B=1024, F=256, W=32 the one-shot gather is 4 GB padded
            # (and XLA materializes an f32 convert of it) — chunking the
            # candidate axis through a scan caps the live temp at
            # ~B*K/score_chunks rows with no semantic change
            Kc = cand.shape[1] // score_chunks
            cs = jnp.maximum(cand, 0).reshape(
                B, score_chunks, Kc).transpose(1, 0, 2)

            def sc(_, cc):
                d_c = jnp.einsum(
                    "bkd,bd->bk", aug[cc], qa16,
                    preferred_element_type=jnp.float32)
                return None, d_c

            _, d_parts = jax.lax.scan(sc, None, cs)
            d_new = d_parts.transpose(1, 0, 2).reshape(B, -1)
        else:
            c_safe = jnp.maximum(cand, 0)
            rows = aug[c_safe]                        # [B, K, dpa]
            d_new = jnp.einsum(
                "bkd,bd->bk", rows.astype(jnp.bfloat16), qa16,
                preferred_element_type=jnp.float32)
        # result-pool merge BEFORE the seen mask: a matching node first
        # scored this step must enter results even if it is already
        # pooled for navigation
        if res_mask is not None:
            ok_res = (cand >= 0) & res_mask[jnp.maximum(cand, 0)]
            d_res = jnp.where(ok_res, d_new, BIG)
            res_d, rpos = jax.lax.approx_min_k(
                jnp.concatenate([res_d, d_res], axis=1), R)
            res_s = jnp.take_along_axis(
                jnp.concatenate([res_s, cand], axis=1), rpos, axis=1)
            res_s = jnp.where(res_d < BIG_THRESH, res_s, -1)
            # window-dedup the result pool too: re-encountered matching
            # nodes carry bit-identical scores (deterministic mirror
            # scoring) and land adjacent in the sorted partial-reduce
            # output; without this, duplicates of the few nearest
            # matches crowd out farther DISTINCT matches under
            # selective filters and the final dup-kill under-fills k
            dupr = jnp.zeros(res_s.shape, bool)
            for w in range(1, min(max(dedup_window, 1), 8) + 1):
                s_r = jnp.pad(res_s[:, :-w], ((0, 0), (w, 0)),
                              constant_values=-3)
                dupr = dupr | (res_s == s_r)
            res_d = jnp.where(dupr, BIG, res_d)
            res_s = jnp.where(dupr, -1, res_s)

        # mask invalid (+ optionally already-pooled)
        ok_new = cand >= 0
        if seen_mask:
            seen = jnp.any(
                cand[:, :, None] == pool_sid[:, None, :], axis=-1)
            ok_new = ok_new & ~seen
        d_new = jnp.where(ok_new, d_new, BIG)

        # ---- merge: one hardware partial-reduce over pool ∪ new ----
        cat_d = jnp.concatenate([pool_d, d_new.astype(pool_d.dtype)],
                                axis=1)
        cat_se = jnp.concatenate([pool_se, cand * 2], axis=1)
        pool_d, mi = jax.lax.approx_min_k(cat_d, P)
        pool_se = jnp.take_along_axis(cat_se, mi, axis=1)
        pool_se = jnp.where(pool_d < BIG_THRESH, pool_se, -2)

        # Duplicate kill: a slot re-entering the merge (multi-path within
        # a step, or a re-encounter of a pooled/evicted node) carries a
        # BIT-IDENTICAL score — deterministic scoring of the same mirror
        # row — so copies land adjacent in the score-ordered
        # partial-reduce output. A shifted-window pass (1) propagates the
        # expanded flag among equal-id neighbors in BOTH directions, so
        # whichever copy survives remembers any copy's expansion (without
        # this, surviving fresh copies get re-expanded and waste frontier
        # slots — measured -0.10 recall at 1M), then (2) voids the later
        # copies (they wash out at the next merge). This replaces a
        # [K, P] pool-membership compare (~10 G ops/step at ef=1536) with
        # O(W·P) shifts.
        if dedup_window > 0:
            sid = pool_se >> 1
            eflag = pool_se & 1
            dup = jnp.zeros((B, P), bool)
            prop = eflag
            for w in range(1, dedup_window + 1):
                s_r = jnp.pad(
                    sid[:, :-w], ((0, 0), (w, 0)), constant_values=-3)
                e_r = jnp.pad(
                    prop[:, :-w], ((0, 0), (w, 0)), constant_values=0)
                s_l = jnp.pad(
                    sid[:, w:], ((0, 0), (0, w)), constant_values=-3)
                e_l = jnp.pad(
                    prop[:, w:], ((0, 0), (0, w)), constant_values=0)
                eq_r = sid == s_r
                eq_l = sid == s_l
                prop = prop | (eq_r.astype(jnp.int32) & e_r) \
                    | (eq_l.astype(jnp.int32) & e_l)
                dup = dup | eq_r
            pool_se = (sid * 2) | prop
            pool_d = jnp.where(dup, big, pool_d)
            pool_se = jnp.where(dup, -1, pool_se)  # slot -1, e=1 (husk)
        if res_mask is not None:
            return (pool_d, pool_se, res_d, res_s), None
        return (pool_d, pool_se), None
      return step

    carry = ((pool_d, pool_se, res_d, res_s) if res_mask is not None
             else (pool_d, pool_se))
    if early_exit and schedule is None:
        step = make_step(min(F, P))

        def _live(carry):
            pool_d = carry[0]
            pool_se = carry[1]
            big_t = jnp.asarray(BIG, pool_d.dtype)
            unexp = jnp.where(((pool_se & 1) == 1) | ((pool_se >> 1) < 0),
                              big_t, pool_d)
            best_unexp = jnp.min(unexp, axis=1)            # [B]
            # bound: the R-th best kept score — the result pool's under a
            # filter, else the navigation pool's (pool_d carries BIG
            # voids from the window dedup, so reduce, don't slice)
            kept = carry[2] if res_mask is not None else pool_d
            bound = jax.lax.approx_min_k(
                kept.astype(jnp.float32), min(R, kept.shape[1]))[0][:, -1]
            bound = jnp.minimum(bound, _np.float32(BIG_THRESH))
            return best_unexp.astype(jnp.float32) < bound

        def body(state):
            i, carry = state
            carry, _ = step(carry, None)
            return i + 1, carry

        def cond(state):
            i, carry = state
            return (i < T) & jnp.any(_live(carry))

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))
    else:
        for seg_f, seg_t in (schedule if schedule is not None
                             else ((F, T),)):
            # clamp to the pool width: approx_min_k(_, F) raises when
            # F > P, and a service-configured schedule meets per-request
            # ef values
            carry, _ = jax.lax.scan(make_step(min(seg_f, P)), carry, None,
                                    length=seg_t)
    if res_mask is not None:
        pool_d, pool_se, res_d, res_s = carry
    else:
        pool_d, pool_se = carry
    pool_s = pool_se >> 1

    # ---- exact rerank of the R best pool entries ----
    if res_mask is not None:
        # filtered: rerank the matching-only result pool
        rd, rs = res_d, res_s                         # [B, R]
    else:
        rd, rpos = jax.lax.approx_min_k(pool_d, R)
        rs = jnp.take_along_axis(pool_s, rpos, axis=1)  # [B, R]
    # drop duplicate slots (multi-path copies): keep first occurrence
    dup = jnp.any(
        (rs[:, :, None] == rs[:, None, :])
        & (jnp.arange(R)[None, :] < jnp.arange(R)[:, None])[None, :, :],
        axis=-1,
    )
    ok = (rs >= 0) & ~dup & has_emb[jnp.maximum(rs, 0)]
    if res_mask is not None:
        ok = ok & res_mask[jnp.maximum(rs, 0)]
    r_safe = jnp.maximum(rs, 0)
    r_rows = emb[r_safe]                              # [B, R, dim]
    # difference form, not the matmul expansion: R is small, and the
    # expansion's ||x||^2 - 2x.q + ||q||^2 cancellation leaves ~1e-6
    # relative noise that breaks the exact-self-match contract
    diff = r_rows - queries[:, None, :]
    d_ex = jnp.sum(diff * diff, axis=-1)
    d_ex = jnp.where(ok, d_ex, BIG)
    neg, pos = jax.lax.top_k(-d_ex, k)
    out_d = -neg
    out_s = jnp.take_along_axis(rs, pos, axis=1)
    out_s = jnp.where(out_d < BIG_THRESH, out_s, -1)
    return out_d, out_s
