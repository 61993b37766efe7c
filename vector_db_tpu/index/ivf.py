"""IVF index — JAX k-means + padded inverted lists + fused probe scoring.

Parity target: reference ``IvfIndex`` (src/vector_db/indexing/ivf.py:13-241):
same constructor ``IvfIndex(k, storage, index_file)``, same validation
errors, ``build_index`` (k-means over the in-memory embedding matrix),
``add`` (assign to nearest centroid), ``delete``, ``search(query, n_probe,
top_k) -> [(Node, L2)]``, ``get_cluster_size`` / ``get_cluster_stats``, and
index-file persistence.

Accelerator-first differences:
- k-means is the vmapped JAX Lloyd's from ``ops.kmeans`` (reference: scipy
  ``kmeans2(iter=100, minit='points')``, ivf.py:75) — E and M steps are
  matmuls;
- inverted lists are a -1-padded ``int32[k, max_list]`` slot table in
  device memory;
  ``search`` is one jitted program per query batch: centroid distance
  matmul → top-n_probe → member gather → masked distance matmul → top-k
  (reference probes clusters with a per-member Python loop calling
  ``storage.get_embedding``, ivf.py:169-199);
- embeddings mirror into a device table keyed by slot, like the HNSW index.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from vector_db_tpu.runtime import device_pull
from vector_db_tpu.ops.distance import BIG, gather_l2_sq, l2_sq_pairwise
from vector_db_tpu.ops.kmeans import kmeans
from vector_db_tpu.ops.topk import masked_top_k_smallest, merge_top_k
from vector_db_tpu.storage import InMemoryNodeStorage, NodeStorage
from vector_db_tpu.storage.device_store import DeviceVectorStore
from vector_db_tpu.types import Node

# IVF-PQ probe LUT-scoring formulations (IvfIndex.search_batch ``adc``)
ADC_MODES = ("gather",)
DEFAULT_ADC = "gather"


def check_adc(adc: str) -> str:
    """Refuse an unknown probe formulation (config ``index.pq.adc``)."""
    if adc not in ADC_MODES:
        raise ValueError(
            f"unknown IVF-PQ adc formulation {adc!r}; choose one of "
            f"{ADC_MODES}")
    return adc


def lut_kernel_on(platform: str) -> bool:
    """Whether the "gather" probe formulation runs as the Triton LUT scan
    (ops/pallas/lut_probe.py): on ``gpu``, where it beats the XLA gather
    end to end (PERF.md); on ``cpu`` the XLA gather runs. Any other
    platform is an error."""
    if platform not in ("gpu", "cpu"):
        raise ValueError(
            f"IVF-PQ probe has no formulation for platform {platform!r}")
    return platform == "gpu"


# device-memory budget for one probe step's per-query transients
PROBE_STEP_BUDGET = 512 << 20


def probe_qblock(p_tot: int, m: int, lut_kernel: bool) -> int:
    """Queries per ``lax.map`` step of the probe: the largest power of two
    in [4, 128] (kernel) or [4, 64] whose per-step transient fits
    :data:`PROBE_STEP_BUDGET`. The transient per query: [P] f32 scores +
    int32 slots + f32 corrections for the kernel; [P, m] int32 LUT
    indices + f32 values for the XLA gather."""
    if lut_kernel:
        per_q, qblock = p_tot * 12, 128
    else:
        per_q, qblock = p_tot * m * 8, 64
    while qblock > 4 and qblock * per_q > PROBE_STEP_BUDGET:
        qblock //= 2
    return qblock


@functools.partial(
    jax.jit, static_argnames=("n_probe", "top_k", "use_filter", "dedup")
)
def _ivf_search_batch(
    centroids: jnp.ndarray,      # f32[k, d]
    lists: jnp.ndarray,          # int32[k, max_list], -1 padded (slots)
    emb: jnp.ndarray,            # f32[capacity, d]
    has_emb: jnp.ndarray,        # bool[capacity]
    queries: jnp.ndarray,        # f32[B, d]
    fmask: jnp.ndarray,          # bool[capacity] (ignored unless use_filter)
    n_probe: int,
    top_k: int,
    use_filter: bool = False,
    dedup: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    cd = l2_sq_pairwise(queries, centroids,
                        precision=jax.lax.Precision.HIGHEST)  # [B, k]
    _, probe = jax.lax.top_k(-cd, n_probe)   # [B, n_probe]
    p_total = n_probe * lists.shape[1]

    def one(q, probe_row):
        members = lists[probe_row].reshape(-1)  # [n_probe * max_list]
        safe = jnp.maximum(members, 0)
        ok = has_emb[safe]
        if use_filter:
            ok = ok & fmask[safe]
        d = gather_l2_sq(q, emb, members, ok)
        if not dedup:
            return masked_top_k_smallest(d, members, top_k)
        # spilled copies of one slot carry identical distances: take a
        # 2k window, drop repeats pairwise (small), then cut to k
        m2 = min(2 * top_k, p_total)
        td, ti = masked_top_k_smallest(d, members, m2)
        rep = (ti[:, None] == ti[None, :]) & (ti[:, None] >= 0)
        drop = jnp.tril(rep, k=-1).any(axis=1)
        return masked_top_k_smallest(
            jnp.where(drop, BIG, td), jnp.where(drop, -1, ti), top_k
        )

    return jax.vmap(one)(queries, probe)


def adc_scores(lut_row: jnp.ndarray, codes: jnp.ndarray,
               ksub: int) -> jnp.ndarray:
    """ADC distances of one query's probed candidates by per-element LUT
    gathers (the "gather" formulation in XLA): f32[P] =
    sum_j lut_row[j * ksub + codes[:, j]].

    lut_row: f32[m * ksub]; codes: uint8|int32[P, m].
    """
    m = codes.shape[1]
    offs = (jnp.arange(m, dtype=jnp.int32) * ksub)[None, :]
    return jnp.sum(lut_row[codes.astype(jnp.int32) + offs], axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("n_probe", "top_k", "fetch", "rerank", "residual",
                     "qblock", "lut_kernel", "interpret"),
)
def _ivf_pq_probe_cells(
    centroids: jnp.ndarray,    # f32[k, d]
    cell_slots: jnp.ndarray,   # int32[k, L] slot ids, -1 padded
    cell_codes: jnp.ndarray,   # uint8[k, L, m] PQ codes, cell-contiguous
    cell_s: jnp.ndarray,       # f32[k, L] residual correction scalars
    codebooks: jnp.ndarray,    # f32[m, ksub, subdim]
    emb: jnp.ndarray,          # f32[capacity, d] (exact rerank source)
    has_emb: jnp.ndarray,      # bool[capacity]
    queries: jnp.ndarray,      # f32[B, d]
    queries_rot: jnp.ndarray,  # f32[B, d] in code space (OPQ)
    n_probe: int,
    top_k: int,
    fetch: int,
    rerank: bool,
    residual: bool,
    qblock: int = 64,
    lut_kernel: bool = False,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scale-path IVFADC probe with cell-contiguous code storage.

    The 1M-class layout: PQ codes are stored grouped by cell
    (``cell_codes[c]`` is one contiguous block), so probing gathers
    ``n_probe`` whole blocks — large contiguous HBM reads — instead of
    per-member row gathers. Candidate scoring reads tens of bytes/vector
    (the codes) rather than 3 KB (the f32 row): the classic IVFADC memory
    story (Jégou et al.), laid out for contiguous gathers.

    With ``residual=True`` the codes quantize ``x − c_cell`` and scoring
    adds the per-vector correction ``cell_s`` plus the coarse term
    ``‖q−c‖² − ‖q‖²`` (FAISS precomputed-tables identity) — one query
    LUT serves every probed cell, no per-(query, cell) LUT tensor.

    Per query: flat-LUT gather scores all padded candidates, a masked
    top-``fetch`` picks the ADC front, and (optionally) an exact f32
    re-scoring of those ``fetch`` rows re-ranks before the final top-k cut
    — reranking wider than ``top_k`` recovers quantizer misrankings.

    ``lut_kernel`` scores the "gather" formulation for a whole query block
    with the Triton LUT-scan kernel (ops/pallas/lut_probe.py), which
    skips each probed cell's padding; ``interpret`` runs it in the Pallas
    interpreter (tests).
    """
    from vector_db_tpu.index.pq import _adc_lut

    m, ksub, _ = codebooks.shape
    p_total = n_probe * cell_slots.shape[1]
    fetch = max(top_k, min(fetch, p_total))
    pad = max(0, fetch - p_total)  # tiny-corpus guard (static)
    cd = l2_sq_pairwise(queries, centroids,
                        precision=jax.lax.Precision.HIGHEST)
    _, probe = jax.lax.top_k(-cd, n_probe)           # [B, n_probe]
    lut = _adc_lut(queries_rot, codebooks)           # [B, m, ksub]
    lut_flat = lut.reshape(queries.shape[0], m * ksub)
    if residual:
        # coarse correction per (query, probed cell): ‖q−c‖² − ‖q_rot‖²
        # (the LUT sum carries ‖q_rot‖²; rotation keeps norms, cd is
        # rotation-invariant)
        q_sq = jnp.sum(queries_rot * queries_rot, axis=-1)       # [B]
        cdp = jnp.take_along_axis(cd, probe, axis=1) - q_sq[:, None]
    else:
        cdp = jnp.zeros_like(probe, dtype=jnp.float32)

    def _select_rerank(q, d, slots):
        """Shared tail: pad to ``fetch``, ADC top-``fetch``, exact
        re-score, final top-k (or direct top-k when un-reranked)."""
        if pad > 0:
            d = jnp.concatenate([d, jnp.full((pad,), BIG, d.dtype)])
            slots = jnp.concatenate(
                [slots, jnp.full((pad,), -1, slots.dtype)])
        if not rerank:
            return masked_top_k_smallest(d, slots, top_k)
        fd, fi = masked_top_k_smallest(d, slots, fetch)
        fd = gather_l2_sq(q, emb, fi, fi >= 0)
        return masked_top_k_smallest(fd, fi, top_k)

    L = cell_slots.shape[1]

    def finish(q, probe_row, cdp_row, d):
        """Residual terms, validity mask, selection + rerank of one
        query's [P] ADC scores."""
        slots = cell_slots[probe_row].reshape(-1)            # [P]
        if residual:
            d = d + cell_s[probe_row].reshape(-1) + jnp.repeat(cdp_row, L)
        ok = (slots >= 0) & has_emb[jnp.maximum(slots, 0)]
        return _select_rerank(q, jnp.where(ok, d, BIG), slots)

    def one(q, probe_row, lut_row, cdp_row):
        codes = cell_codes[probe_row].reshape(-1, m)         # [P, m]
        return finish(q, probe_row, cdp_row,
                      adc_scores(lut_row, codes, ksub))

    def blk_kernel(qs, probe_b, lutf_b, cdp_b):
        from vector_db_tpu.ops.pallas.lut_probe import lut_probe_scores

        d = lut_probe_scores(probe_b, cell_len, cell_codes, lutf_b,
                             interpret=interpret)
        return jax.vmap(finish)(qs, probe_b, cdp_b, d)

    if lut_kernel:
        # occupied length per cell (rows past the last live slot are
        # padding the kernel skips)
        cell_len = jnp.max(
            jnp.where(cell_slots >= 0,
                      jnp.arange(1, L + 1, dtype=jnp.int32)[None, :], 0),
            axis=1)

    # queries stream in qblock chunks under lax.map: the vmapped ADC
    # intermediates are O(B · n_probe · L · m); unchunked at B=1000 that
    # is multi-GB at 1M scale
    b = queries.shape[0]
    padq = (-b) % qblock
    if padq:
        queries = jnp.concatenate(
            [queries, jnp.zeros((padq, queries.shape[1]), queries.dtype)])
        probe = jnp.concatenate(
            [probe, jnp.zeros((padq, n_probe), probe.dtype)])
        lut_flat = jnp.concatenate(
            [lut_flat, jnp.zeros((padq, m * ksub), lut_flat.dtype)])
        cdp = jnp.concatenate([cdp, jnp.zeros((padq, n_probe), cdp.dtype)])
    nblk = queries.shape[0] // qblock

    def blk(a):
        return a.reshape((nblk, qblock) + a.shape[1:])

    body = blk_kernel if lut_kernel else jax.vmap(one)
    dd, ii = jax.lax.map(
        lambda args: body(*args),
        (blk(queries), blk(probe), blk(lut_flat), blk(cdp)),
    )
    kk = dd.shape[-1]
    return dd.reshape(-1, kk)[:b], ii.reshape(-1, kk)[:b]


@functools.partial(
    jax.jit,
    static_argnames=("n_probe", "top_k", "fetch", "rerank", "dedup",
                     "qblock"),
)
def _ivf_rp_probe_cells(
    centroids: jnp.ndarray,    # f32[k, d]
    mu_proj: jnp.ndarray,      # f32[dp] projected global data mean
    cell_slots: jnp.ndarray,   # int32[k, L] slot ids, -1 padded
    cell_rp: jnp.ndarray,      # bf16[k, L, dp] projected rows, cell blocks
    cell_xsq: jnp.ndarray,     # f32[k, L] full-space ‖x‖² per member
    emb: jnp.ndarray,          # f32[capacity, d] (exact rerank source)
    has_emb: jnp.ndarray,      # bool[capacity]
    queries: jnp.ndarray,      # f32[B, d]
    proj: jnp.ndarray,         # f32[d, dp] orthonormal projection
    n_probe: int,
    top_k: int,
    fetch: int,
    rerank: bool,
    dedup: bool,
    qblock: int = 128,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Residual-projection probe: the gather-free scoring mode.

    Classic IVFADC scores candidates through per-element LUT gathers.
    This mode instead keeps PCA-projected RESIDUAL blocks
    ``r̂ = R^T(x) − R^T(c)`` per (cell, member) and scores with one
    matvec per cell block:

        d(q, x) ≈ (‖q−c‖² − ‖c‖²) − 2 (q̂−ĉ)·r̂ + (‖x‖² − 2 ĉ·r̂)

    i.e. q·x is approximated by q·c + q̂·r̂: the coarse centroid carries
    the full-space component, the projection carries the residual. The
    three bracketed terms are per-(query, cell), per-candidate-matvec, and
    per-(cell, member)-stored respectively. With the TRUE ‖x‖² folded
    into the stored scalar, the only estimation errors are the zero-mean
    cross term 2 q_⊥·(x−c)_⊥ and bf16 noise at RESIDUAL scale — both
    operands of the einsum are centered, so the multiply noise stays
    below neighbor gaps even on unnormalized corpora (storing full-
    magnitude x̂ in bf16 sank recall at 1M on SIFT-shaped data). Per-
    candidate work is a contiguous [L, dp] bf16 block read + dot product:
    contiguous reads + matmuls, no scalar gathers anywhere. Blocks are
    per-(cell, member), so spilled (multi-assigned) copies each carry
    their own cell's residual; ``dedup`` masks duplicate slots inside the
    rerank window.

    Queries run in ``qblock`` chunks under ``lax.map`` and cells stream
    under ``lax.scan`` so peak memory is O(qblock · L · dp), independent
    of batch size and n_probe.
    """
    b, d = queries.shape
    k_cells, max_l = cell_slots.shape
    p_total = n_probe * max_l
    fetch = max(top_k, min(fetch, p_total))
    pad_c = max(0, fetch - p_total)  # tiny-corpus guard (static)

    cd = l2_sq_pairwise(queries, centroids,
                        precision=jax.lax.Precision.HIGHEST)
    _, probe = jax.lax.top_k(-cd, n_probe)                   # [B, n_probe]
    qp = jnp.dot(queries, proj, precision=jax.lax.Precision.HIGHEST,
                 preferred_element_type=jnp.float32)
    cdp = jnp.take_along_axis(cd, probe, axis=1)             # [B, n_probe]
    csq = jnp.sum(centroids * centroids, axis=-1)[probe]     # [B, n_probe]
    corr = cdp - csq                                         # [B, n_probe]
    # μ̂-CENTERED queries (the stored scalar folds −2μ̂·r̂, see
    # _build_rp_blocks): both einsum operands are deviation-scale, so the
    # bf16 multiply noise stays below neighbor gaps even on unnormalized
    # corpora
    qr = (qp - mu_proj[None, :]).astype(jnp.bfloat16)        # [B, dp]

    padq = (-b) % qblock
    if padq:
        qz = jnp.zeros((padq, d), queries.dtype)
        queries_p = jnp.concatenate([queries, qz])
        qr_p = jnp.concatenate(
            [qr, jnp.zeros((padq,) + qr.shape[1:])])
        probe_p = jnp.concatenate(
            [probe, jnp.zeros((padq, n_probe), probe.dtype)])
        corr_p = jnp.concatenate([corr, jnp.zeros((padq, n_probe))])
    else:
        queries_p, qr_p, probe_p, corr_p = queries, qr, probe, corr
    nblk = queries_p.shape[0] // qblock

    def reshape_blk(a):
        return a.reshape((nblk, qblock) + a.shape[1:])

    def block_fn(args):
        q_b, qr_b, probe_b, corr_b = args  # [Q, ...]

        def pstep(_, pi):
            cells = probe_b[:, pi]                  # [Q]
            blk = cell_rp[cells]                    # [Q, L, dp] bf16
            xsq = cell_xsq[cells]                   # [Q, L]
            slots = cell_slots[cells]               # [Q, L]
            dots = jnp.einsum(
                "qld,qd->ql", blk, qr_b,
                preferred_element_type=jnp.float32,
            )
            score = corr_b[:, pi][:, None] - 2.0 * dots + xsq
            ok = (slots >= 0) & has_emb[jnp.maximum(slots, 0)]
            return None, (jnp.where(ok, score, BIG), slots)

        _, (scores, slots) = jax.lax.scan(
            pstep, None, jnp.arange(n_probe, dtype=jnp.int32)
        )
        # [n_probe, Q, L] -> [Q, P]
        d_all = scores.transpose(1, 0, 2).reshape(qblock, p_total)
        s_all = slots.transpose(1, 0, 2).reshape(qblock, p_total)
        if pad_c > 0:
            d_all = jnp.concatenate(
                [d_all, jnp.full((qblock, pad_c), BIG, d_all.dtype)], axis=1)
            s_all = jnp.concatenate(
                [s_all, jnp.full((qblock, pad_c), -1, s_all.dtype)], axis=1)
        if not rerank:
            return jax.vmap(
                lambda dv, sv: masked_top_k_smallest(dv, sv, top_k)
            )(d_all, s_all)

        def one(qv, dv, sv):
            # fetch via lax.approx_min_k instead of a full sort — the
            # exact rerank below re-orders anyway,
            # so only candidate SELECTION is approximate
            nd, pos = jax.lax.approx_min_k(dv, fetch, recall_target=0.95)
            fi = jnp.where(nd >= 1e37, -1, sv[pos])
            if dedup:
                # spilled copies: same slot can appear twice; keep the
                # first (they re-rank to identical exact distances)
                eq = (fi[:, None] == fi[None, :]) & (fi[:, None] >= 0)
                first = jnp.tril(eq, k=-1).any(axis=1)
                fi = jnp.where(first, -1, fi)
            fd = gather_l2_sq(qv, emb, fi, fi >= 0)
            return masked_top_k_smallest(fd, fi, top_k)

        return jax.vmap(one)(q_b, d_all, s_all)

    dd, ii = jax.lax.map(
        block_fn,
        (reshape_blk(queries_p), reshape_blk(qr_p),
         reshape_blk(probe_p), reshape_blk(corr_p)),
    )
    dd = dd.reshape(-1, top_k)[:b]
    ii = ii.reshape(-1, top_k)[:b]
    return dd, ii


@functools.partial(
    jax.jit,
    static_argnames=("top_k", "fetch", "rerank", "dedup", "ctile", "qblock"),
)
def _ivf_rp_scan_cells(
    centroids: jnp.ndarray,    # f32[k, d]
    cell_slots: jnp.ndarray,   # int32[k, L] slot ids, -1 padded
    cell_rp: jnp.ndarray,      # bf16[k, L, dp] residual blocks
    cell_t: jnp.ndarray,       # f32[k, L] stored scalars ‖x‖² − 2μ̂·r̂
    emb: jnp.ndarray,          # f32[capacity, d] (exact rerank source)
    has_emb: jnp.ndarray,      # bool[capacity]
    queries: jnp.ndarray,      # f32[B, d]
    proj: jnp.ndarray,         # f32[d, dp]
    mu_proj: jnp.ndarray,      # f32[dp] projected global data mean
    top_k: int,
    fetch: int,
    rerank: bool,
    dedup: bool,
    ctile: int = 64,
    qblock: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full-scan residual-projection search: the batched-throughput mode.

    Per-query cell gathers cannot amortize across a batch — every query
    pays its own HBM reads — while a full scan reads each byte once per
    BATCH. This kernel scores *all* cells for the whole batch by slicing
    the cell-blocked residual corpus tile-by-tile (contiguous, no gathers
    anywhere) with one bf16 matmul per tile:

        score[b, c, l] = (‖q‖² − 2 q·c) − 2 q̂·r̂[c, l] + t[c, l]

    The per-(query, cell) coarse term needs no gather because cells are
    the tile axis (broadcast), and the ‖c‖² halves of cd cancel against
    corr. Coarse recall is 1.0 by construction (every cell is scored);
    accuracy is residual-bf16 + projection, recovered by the exact
    rerank. Compared to a full bf16 scan of the raw vectors this reads
    dp/dim of the bytes at *better* effective precision (residual
    centering), so it dominates at batch-throughput — the classic IVF
    n_probe story is kept for latency-bound single queries.
    """
    b, d = queries.shape
    k_cells, max_l = cell_slots.shape
    dp = cell_rp.shape[-1]
    assert k_cells % ctile == 0, "k_cells must be a multiple of ctile"
    p_tile = ctile * max_l
    fetch = max(top_k, min(fetch, k_cells * max_l))

    corr = (jnp.sum(queries * queries, axis=-1)[:, None]
            - 2.0 * jnp.dot(queries, centroids.T,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32))  # [B, k]
    # μ̂-centering before the bf16 cast: the stored scalar folds −2μ̂·r̂
    # (see _build_rp_blocks), so both matmul operands are deviation-scale
    qp16 = (jnp.dot(queries, proj, precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
            - mu_proj[None, :]).astype(jnp.bfloat16)

    padq = (-b) % qblock
    if padq:
        queries = jnp.concatenate(
            [queries, jnp.zeros((padq, d), queries.dtype)])
        corr = jnp.concatenate([corr, jnp.zeros((padq, k_cells))])
        qp16 = jnp.concatenate(
            [qp16, jnp.zeros((padq, dp), qp16.dtype)])
    nblk = queries.shape[0] // qblock
    n_tiles = k_cells // ctile
    slot_ok = (cell_slots >= 0) & has_emb[jnp.maximum(cell_slots, 0)]

    def block_fn(args):
        q_b, corr_b, qp_b = args   # [Q, ...]

        init = (jnp.full((qblock, fetch), BIG, jnp.float32),
                jnp.full((qblock, fetch), -1, jnp.int32))

        def tstep(carry, ti):
            best_d, best_i = carry
            c0 = ti * ctile
            blk = jax.lax.dynamic_slice(
                cell_rp, (c0, 0, 0), (ctile, max_l, dp))
            t = jax.lax.dynamic_slice(cell_t, (c0, 0), (ctile, max_l))
            slots = jax.lax.dynamic_slice(
                cell_slots, (c0, 0), (ctile, max_l))
            ok = jax.lax.dynamic_slice(slot_ok, (c0, 0), (ctile, max_l))
            corr_t = jax.lax.dynamic_slice(
                corr_b, (0, c0), (qblock, ctile))
            dots = jnp.einsum("cld,bd->bcl", blk, qp_b,
                              preferred_element_type=jnp.float32)
            score = corr_t[:, :, None] - 2.0 * dots + t[None]
            score = jnp.where(ok[None], score, BIG)
            score = score.reshape(qblock, p_tile)
            # per-tile extraction caps at fetch/min(4, n_tiles): one tile
            # of many rarely holds more of the global front, and
            # approx_min_k cost grows steeply with k (with few tiles the
            # cap must not cut below the requested fetch)
            per_tile = min(max(top_k, fetch // min(4, n_tiles)), p_tile)
            nd, pos = jax.lax.approx_min_k(
                score, per_tile, recall_target=0.95)
            si = slots.reshape(p_tile)[pos]
            si = jnp.where(nd >= 1e37, -1, si)
            return merge_top_k(best_d, best_i, nd, si, fetch), None

        (fd, fi), _ = jax.lax.scan(
            tstep, init, jnp.arange(n_tiles, dtype=jnp.int32))
        if not rerank:
            return fd[:, :top_k], fi[:, :top_k]

        def one(qv, dv, iv):
            if dedup:
                eq = (iv[:, None] == iv[None, :]) & (iv[:, None] >= 0)
                first = jnp.tril(eq, k=-1).any(axis=1)
                iv = jnp.where(first, -1, iv)
            rd = gather_l2_sq(qv, emb, iv, iv >= 0)
            return masked_top_k_smallest(rd, iv, top_k)

        return jax.vmap(one)(q_b, fd, fi)

    def reshape_blk(a):
        return a.reshape((nblk, qblock) + a.shape[1:])

    dd, ii = jax.lax.map(
        block_fn, (reshape_blk(queries), reshape_blk(corr),
                   reshape_blk(qp16)),
    )
    return dd.reshape(-1, top_k)[:b], ii.reshape(-1, top_k)[:b]


@functools.partial(
    jax.jit,
    static_argnames=("top_k", "fetch", "rerank", "residual", "dedup",
                     "ctile", "qblock"),
)
def _ivf_pq_scan_cells(
    centroids: jnp.ndarray,    # f32[k, d]
    cell_slots: jnp.ndarray,   # int32[k, L] slot ids, -1 padded
    cell_codes: jnp.ndarray,   # uint8[k, L, m] PQ codes, cell-contiguous
    cell_s: jnp.ndarray,       # f32[k, L] residual correction scalars
    codebooks: jnp.ndarray,    # f32[m, ksub, subdim]
    emb: jnp.ndarray,          # f32[capacity, d] (exact rerank source)
    has_emb: jnp.ndarray,      # bool[capacity]
    queries: jnp.ndarray,      # f32[B, d]
    queries_rot: jnp.ndarray,  # f32[B, d] in code space (OPQ)
    top_k: int,
    fetch: int,
    rerank: bool,
    residual: bool,
    dedup: bool,
    ctile: int = 16,
    qblock: int = 128,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full-scan ADC: LUT scoring as one-hot matmuls over cell tiles.

    Scanning ALL cells lets the LUT "gather" become matmul work shared by
    the whole batch: per tile, one-hot the codes per subspace group and
    matmul against the flattened query LUTs. B·N·m·ksub MACs total — at
    m=16, ksub=256 that is ~4k MACs per (query, vector), while candidate
    bytes stay at m per vector (16 B: the memory-tight mode).
    Residual scoring adds only the stored scalar + coarse term, exactly
    as in the probe kernel.
    """
    b, d = queries.shape
    k_cells, max_l, m = cell_codes.shape
    ksub = codebooks.shape[1]
    assert k_cells % ctile == 0, "k_cells must be a multiple of ctile"
    p_tile = ctile * max_l
    fetch = max(top_k, min(fetch, k_cells * max_l))
    from vector_db_tpu.index.pq import _adc_lut

    lut = _adc_lut(queries_rot, codebooks)            # [B, m, ksub]
    lut_flat = lut.reshape(b, m * ksub)
    if residual:
        cd = l2_sq_pairwise(queries, centroids,
                            precision=jax.lax.Precision.HIGHEST)
        q_sq = jnp.sum(queries_rot * queries_rot, axis=-1)
        corr = cd - q_sq[:, None]                      # [B, k]
    else:
        corr = jnp.zeros((b, k_cells), jnp.float32)

    padq = (-b) % qblock
    if padq:
        queries = jnp.concatenate(
            [queries, jnp.zeros((padq, d), queries.dtype)])
        lut_flat = jnp.concatenate(
            [lut_flat, jnp.zeros((padq, m * ksub), lut_flat.dtype)])
        corr = jnp.concatenate([corr, jnp.zeros((padq, k_cells))])
    nblk = queries.shape[0] // qblock
    n_tiles = k_cells // ctile
    slot_ok = (cell_slots >= 0) & has_emb[jnp.maximum(cell_slots, 0)]
    gsz = 4 if m % 4 == 0 else 1                      # subspace group size

    def block_fn(args):
        q_b, lut_b, corr_b = args                      # [Q, ...]
        # hi+lo bf16 LUT pair: the one-hot operand is exact, so two
        # contractions recover the f32 LUT sum to ~2^-16 (single-bf16
        # LUT rounding measurably cost recall at the fetch boundary)
        lut16 = lut_b.astype(jnp.bfloat16)             # [Q, m*ksub]
        lut_lo = (lut_b - lut16.astype(jnp.float32)).astype(jnp.bfloat16)

        init = (jnp.full((qblock, fetch), BIG, jnp.float32),
                jnp.full((qblock, fetch), -1, jnp.int32))

        def tstep(carry, ti):
            best_d, best_i = carry
            c0 = ti * ctile
            codes_t = jax.lax.dynamic_slice(
                cell_codes, (c0, 0, 0), (ctile, max_l, m))
            s_t = jax.lax.dynamic_slice(cell_s, (c0, 0), (ctile, max_l))
            slots = jax.lax.dynamic_slice(
                cell_slots, (c0, 0), (ctile, max_l))
            ok = jax.lax.dynamic_slice(slot_ok, (c0, 0), (ctile, max_l))
            corr_t = jax.lax.dynamic_slice(
                corr_b, (0, c0), (qblock, ctile))
            flat = codes_t.reshape(p_tile, m).astype(jnp.int32)
            acc = jnp.zeros((qblock, p_tile), jnp.float32)
            for j0 in range(0, m, gsz):
                oh = jax.nn.one_hot(
                    flat[:, j0:j0 + gsz], ksub, dtype=jnp.bfloat16
                ).reshape(p_tile, gsz * ksub)
                acc = acc + jnp.dot(
                    lut16[:, j0 * ksub:(j0 + gsz) * ksub], oh.T,
                    preferred_element_type=jnp.float32)
                acc = acc + jnp.dot(
                    lut_lo[:, j0 * ksub:(j0 + gsz) * ksub], oh.T,
                    preferred_element_type=jnp.float32)
            score = acc + s_t.reshape(p_tile)[None]
            if residual:
                score = score + jnp.repeat(corr_t, max_l, axis=1)
            score = jnp.where(ok.reshape(p_tile)[None], score, BIG)
            nd, pos = jax.lax.approx_min_k(
                score, min(fetch, p_tile), recall_target=0.95)
            si = slots.reshape(p_tile)[pos]
            si = jnp.where(nd >= 1e37, -1, si)
            return merge_top_k(best_d, best_i, nd, si, fetch), None

        (fd, fi), _ = jax.lax.scan(
            tstep, init, jnp.arange(n_tiles, dtype=jnp.int32))
        if not rerank:
            return fd[:, :top_k], fi[:, :top_k]

        def one(qv, dv, iv):
            if dedup:
                eq = (iv[:, None] == iv[None, :]) & (iv[:, None] >= 0)
                first = jnp.tril(eq, k=-1).any(axis=1)
                iv = jnp.where(first, -1, iv)
            rd = gather_l2_sq(qv, emb, iv, iv >= 0)
            return masked_top_k_smallest(rd, iv, top_k)

        return jax.vmap(one)(q_b, fd, fi)

    def reshape_blk(a):
        return a.reshape((nblk, qblock) + a.shape[1:])

    dd, ii = jax.lax.map(
        block_fn,
        (reshape_blk(queries), reshape_blk(lut_flat), reshape_blk(corr)),
    )
    return dd.reshape(-1, top_k)[:b], ii.reshape(-1, top_k)[:b]


@functools.partial(
    jax.jit, static_argnames=("top_k", "fetch", "rerank", "tile"))
def _rp_flat_search(
    queries: jnp.ndarray,   # f32[B, d]
    proj: jnp.ndarray,      # f32[d, dp]
    mu: jnp.ndarray,        # f32[dp]
    flat: jnp.ndarray,      # bf16[capacity, dp] centered mirror
    u: jnp.ndarray,         # f32[capacity] stored scalars
    valid: jnp.ndarray,     # bool[capacity]
    emb: jnp.ndarray,       # f32[capacity, d] (exact rerank source)
    top_k: int,
    fetch: int,
    rerank: bool,
    tile: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One-program flat projected scan: projection, centering, tiled
    approximate scan and exact rerank fused into a single dispatch
    instead of one eager dispatch per op."""
    from vector_db_tpu.ops.exact import approx_search_tiled, rescore_exact

    qp = jnp.dot(queries, proj, precision=jax.lax.Precision.HIGHEST,
                 preferred_element_type=jnp.float32)
    qc = qp - mu[None, :]
    fd, fi = approx_search_tiled(qc, flat, valid, fetch, tile=tile, x_sq=u)
    if rerank:
        d_sq, slots = rescore_exact(queries, emb, fi)
        return d_sq[:, :top_k], slots[:, :top_k]
    off = (jnp.sum(queries * queries, -1) - jnp.sum(qp * qp, -1)
           + jnp.sum(mu * mu))
    return fd[:, :top_k] + off[:, None], fi[:, :top_k]


@jax.jit
def _build_rp_blocks(
    table: jnp.ndarray,     # int32[k, L] slot ids, -1 padded
    rp: jnp.ndarray,        # f32[capacity, dp] per-slot x̂
    xsq: jnp.ndarray,       # f32[capacity] full-space ‖x‖²
    cent_proj: jnp.ndarray,  # f32[k, dp]
    mu_proj: jnp.ndarray,   # f32[dp] projected global data mean
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Device-side rebuild of the RP cell blocks: residuals r̂ = x̂ − ĉ
    (bf16 after subtraction) and stored scalars t = ‖x‖² − 2μ̂·r̂.

    Folding the GLOBAL-mean cross term (rather than the per-cell one)
    lets every kernel dot the same centered query (q̂ − μ̂) against r̂:
    −2q̂·r̂ = −2(q̂−μ̂)·r̂ − 2μ̂·r̂, so the estimator is exact for any μ̂,
    and with μ̂ ≈ data mean both einsum operands are deviation-scale —
    the bf16 cast of a full-magnitude q̂ was burying neighbor gaps on
    unnormalized corpora (measured: scan-mode ADC-only recall 0.015)."""
    safe = jnp.maximum(table, 0)
    ok = table >= 0
    res = rp[safe] - cent_proj[:, None, :]            # [k, L, dp] f32
    res = jnp.where(ok[..., None], res, 0.0)
    t = xsq[safe] - 2.0 * jnp.einsum(
        "kld,d->kl", res, mu_proj,
        preferred_element_type=jnp.float32)
    t = jnp.where(ok, t, 0.0)
    return res.astype(jnp.bfloat16), t


class IvfIndex:
    def __init__(
        self,
        k: int,
        storage: Optional[NodeStorage] = None,
        index_file: Optional[Union[str, Path]] = None,
    ) -> None:
        if k <= 0:
            raise ValueError("k-means parameter should be positive")
        self.k = int(k)
        self.storage = storage or InMemoryNodeStorage()
        self.index_file = Path(index_file) if index_file else None

        self.centroids: Optional[np.ndarray] = None
        self._centroids_dev: Optional[jnp.ndarray] = None
        # host inverted lists of node ids (parity + persistence)
        self.inverted_lists: List[List[int]] = []
        # device: padded slot table, rebuilt lazily when dirty
        self._lists_dev: Optional[jnp.ndarray] = None
        self._lists_dirty = True
        # cell-contiguous PQ code blocks (scale path), rebuilt with lists
        self._cells_codes_dev: Optional[jnp.ndarray] = None
        # persist index_file on every mutation (reference behavior,
        # ivf.py:210-214); services set False and flush on their threshold
        self.autosave = True

        self._store = DeviceVectorStore(capacity=256)

        if self.index_file and self.index_file.exists():
            self.load_index()

    # device tables live in DeviceVectorStore
    @property
    def _emb(self):
        return self._store.emb

    @property
    def _has_emb(self):
        return self._store.valid

    @property
    def _capacity(self) -> int:
        return self._store.capacity

    @property
    def _dim(self):
        return self._store.dim

    @property
    def _slot_of_id(self):
        return self._store._slot_of_id

    @property
    def _id_of_slot(self):
        return self._store.export_id_map()

    # ------------------------------------------------------------------
    def _ensure_capacity(self, need: int, dim: int) -> None:
        self._store.ensure_dim(dim)
        self._store.grow_to(need)

    def _slot_table(self) -> np.ndarray:
        """Vectorized [k, max_list] -1-padded slot table from the host
        inverted lists (no per-member Python loop; O(total) numpy)."""
        sizes = np.asarray([len(l) for l in self.inverted_lists], np.int64)
        total = int(sizes.sum())
        max_list = max(int(sizes.max()) if sizes.size else 0, 1)
        table = np.full((self.k, max_list), -1, np.int32)
        if total:
            flat_ids = np.fromiter(
                (nid for lst in self.inverted_lists for nid in lst),
                np.int64, count=total,
            )
            slot_map = self._slot_of_id
            flat_slots = np.fromiter(
                (slot_map.get(int(nid), -1) for nid in flat_ids),
                np.int32, count=total,
            )
            rows = np.repeat(np.arange(self.k), sizes)
            offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            cols = np.arange(total) - offsets[rows]
            table[rows, cols] = flat_slots
        return table

    def _rebuild_device_tables(self) -> None:
        table = self._slot_table()
        self._lists_dev = jnp.asarray(table)
        codes_np = self._ensure_codes_capacity()
        if codes_np is not None:
            safe = np.maximum(table, 0)
            blocks = codes_np[safe]                  # [k, L, m] uint8
            blocks[table < 0] = 0
            self._cells_codes_dev = jnp.asarray(blocks)
            sx = getattr(self, "_sx_np", None)
            if sx is not None:
                s_blocks = sx[safe].astype(np.float32)
                s_blocks[table < 0] = 0.0
                self._cells_s_dev = jnp.asarray(s_blocks)
            else:
                self._cells_s_dev = jnp.zeros(table.shape, jnp.float32)
        else:
            self._cells_codes_dev = None
            self._cells_s_dev = None
        if getattr(self, "_rp_dev", None) is not None:
            # per-(cell, member) RESIDUAL blocks r̂ = x̂ − ĉ, bf16 only
            # AFTER the subtraction: residual magnitudes are intra-cell
            # deviations, so bf16's 8 mantissa bits land below neighbor
            # gaps even on unnormalized corpora (storing x̂ itself put the
            # full-vector magnitude into bf16 and sank recall at scale).
            # Built ON DEVICE — no host round-trip of GB-scale tables.
            self._cells_rp_dev, self._cells_xsq_dev = _build_rp_blocks(
                self._lists_dev, self._rp_dev, self._rp_xsq_dev,
                self._cent_proj_dev, self._rp_mu_dev,
            )
        else:
            self._cells_rp_dev = None
            self._cells_xsq_dev = None
        self._lists_dirty = False

    def _ensure_codes_capacity(self) -> Optional[np.ndarray]:
        """Grow the host PQ code table to match store capacity (new rows
        zero-coded until written)."""
        codes_np = getattr(self, "_codes_np", None)
        if codes_np is not None and codes_np.shape[0] < self._capacity:
            grow = self._capacity - codes_np.shape[0]
            codes_np = np.concatenate([
                codes_np, np.zeros((grow, codes_np.shape[1]), np.uint8),
            ])
            self._codes_np = codes_np
            sx = getattr(self, "_sx_np", None)
            if sx is not None:
                self._sx_np = np.concatenate(
                    [sx, np.zeros((grow,), np.float32)]
                )
        return codes_np

    def _rp_flat_tables(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Compact flat-scan mirror: ((x̂−μ̂) bf16[capacity, dp],
        u = ‖x‖² − 2μ̂·x̂ f32[capacity]) — identity-tracked lazy rebuild.

        Ranking identity: ‖q−x‖² ≈ ‖q̂−μ̂‖² − 2(q̂−μ̂)·(x̂−μ̂) + u + const(q),
        so :func:`ops.exact.approx_search_tiled` runs it unchanged with
        the centered mirror as the table and u as the norm cache — an
        UNPADDED projected scan (the padded cell-block scan carries 2-4x
        score-tensor traffic from cell padding)."""
        src = self._rp_dev
        if getattr(self, "_rp_flat_src", None) is not src:
            mu = self._rp_mu_dev
            self._rp_flat_dev = (src - mu[None, :]).astype(jnp.bfloat16)
            self._rp_u_dev = self._rp_xsq_dev - 2.0 * jnp.dot(
                src, mu, preferred_element_type=jnp.float32)
            self._rp_flat_src = src
        return self._rp_flat_dev, self._rp_u_dev

    def _ensure_rp_capacity(self) -> None:
        rp = getattr(self, "_rp_dev", None)
        if rp is not None and rp.shape[0] < self._capacity:
            grow = self._capacity - rp.shape[0]
            self._rp_dev = jnp.concatenate(
                [rp, jnp.zeros((grow, rp.shape[1]), rp.dtype)])
            self._rp_xsq_dev = jnp.concatenate(
                [self._rp_xsq_dev, jnp.zeros((grow,), jnp.float32)])

    def _device_lists(self) -> jnp.ndarray:
        if self._lists_dirty or self._lists_dev is None:
            self._rebuild_device_tables()
        return self._lists_dev

    def _device_cells(self) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        if self._lists_dirty or self._cells_codes_dev is None:
            self._rebuild_device_tables()
        return self._lists_dev, self._cells_codes_dev, self._cells_s_dev

    # ------------------------------------------------------------------
    def build_index(self, nodes: Sequence[Node], seed: int = 0) -> None:
        if not nodes:
            raise ValueError("Cannot build index with empty node list")
        self.storage.save_many(nodes)

        embeddings = np.array([np.asarray(n.embedding, np.float32) for n in nodes])
        ids = [n.id for n in nodes]
        if embeddings.ndim != 2:
            raise ValueError(
                f"embeddings must be 2D array, got {embeddings.ndim}D"
            )
        if embeddings.shape[0] < self.k:
            raise ValueError(
                f"Need at least {self.k} vectors for {self.k} clusters"
            )

        self._ensure_capacity(len(nodes), embeddings.shape[1])
        slots = np.array(
            [self._store.slot_of(nid) if nid in self._store
             else self._store.take_slot(nid) for nid in ids],
            np.int32,
        )
        self._store.write(slots, embeddings)

        cents, labels = kmeans(
            jnp.asarray(embeddings), self.k, jax.random.key(seed), iters=100
        )
        self.centroids = np.asarray(cents)
        self._centroids_dev = cents
        labels = device_pull(labels)

        self.inverted_lists = [[] for _ in range(self.k)]
        for nid, label in zip(ids, labels):
            self.inverted_lists[int(label)].append(nid)
        self._lists_dirty = True

        if self.index_file:
            self.save_index()

    def build_arrays(
        self,
        ids: Sequence[int],
        embeddings: np.ndarray,
        seed: int = 0,
        iters: int = 25,
        train_sample: Optional[int] = None,
        assign_candidates: int = 8,
        list_cap_alpha: float = 4.0,
        spill: int = 1,
    ) -> None:
        """Scale-path build (no Node objects): train k-means on a subsample,
        assign the full corpus in one tiled device pass, construct the
        inverted lists vectorized.

        The reference's ``build_index`` (ivf.py:52-96) clusters the whole
        corpus with scipy on host; at 1M x 768 that is neither feasible nor
        necessary — centroids converge on a ``train_sample`` subsample
        (default ``min(N, max(64k, 100k))``) and the E-step for the full
        corpus is a streaming matmul pass (:func:`ops.kmeans.assign_tiled`).

        ``list_cap_alpha`` bounds cell size at ``alpha * N / k``: members of
        an over-full cell cascade to their next-nearest centroid (up to
        ``assign_candidates`` choices, then the cap is waived). Bounded
        lists keep the padded probe tensor — and probe cost — O(n_probe *
        alpha * N/k) instead of O(n_probe * max_cluster).

        ``spill`` > 1 multi-assigns each vector to its ``spill`` nearest
        distinct cells (SOAR-style spilling): on high-intrinsic-dimension
        corpora, where neighbors straddle cell boundaries (measured probe
        recall 0.62 at n_probe=64/1024 on the rank-64 embedding corpus),
        spilling trades index memory for coarse recall. Search paths
        de-duplicate repeated slots in the top-k window.
        """
        from vector_db_tpu.ops.kmeans import assign_tiled

        embeddings = np.asarray(embeddings, np.float32)
        ids_arr = np.asarray(list(ids), np.int64)
        n, dim = embeddings.shape
        if n != ids_arr.shape[0]:
            raise ValueError("ids and embeddings must have equal length")
        if n < self.k:
            raise ValueError(
                f"Need at least {self.k} vectors for {self.k} clusters"
            )
        self._ensure_capacity(n, dim)
        slots = self._store.take_slots(ids_arr.tolist())
        self._store.write(slots, embeddings)

        sample = train_sample or min(n, max(64 * self.k, 100_000))
        rng = np.random.default_rng(seed)
        sel = (rng.choice(n, size=sample, replace=False)
               if sample < n else np.arange(n))
        cents, _ = kmeans(
            jnp.asarray(embeddings[sel]), self.k, jax.random.key(seed),
            iters=iters,
        )
        self.centroids = np.asarray(cents)
        self._centroids_dev = cents

        spill = max(1, min(int(spill), self.k))
        n_cand = max(spill, min(assign_candidates, self.k))
        tile = 65536 if n >= 65536 else max(256, 1 << (n - 1).bit_length())
        cand = device_pull(assign_tiled(
            jnp.asarray(embeddings), cents, tile=tile, n_cand=n_cand
        ))
        labels = self._balanced_assign(cand, list_cap_alpha)
        all_ids, all_labels = [ids_arr], [labels]
        taken = labels[:, None]                     # cells already used
        # spill copies respect a widened cap so the padded [k, L] probe
        # tensor stays O(alpha * spill * N/k); over-cap copies are dropped
        # (those rows stay single-assigned)
        cap2 = max(1, int(np.ceil(list_cap_alpha * spill * n / self.k)))
        counts = np.bincount(labels, minlength=self.k)
        for _ in range(1, spill):
            sec = np.full(n, -1, np.int64)
            for j in range(n_cand):
                todo = sec < 0
                cj = cand[:, j].astype(np.int64)
                fresh = todo & ~(taken == cj[:, None]).any(axis=1)
                sec[fresh] = cj[fresh]
            want_rows = np.flatnonzero(sec >= 0)
            w = sec[want_rows]
            order2 = np.argsort(w, kind="stable")
            sw = w[order2]
            group_start = np.searchsorted(sw, np.arange(self.k))
            rank = np.arange(want_rows.size) - group_start[sw]
            accept = rank < (cap2 - counts[sw])
            keep = want_rows[order2[accept]]
            sec_final = np.full(n, -1, np.int64)
            sec_final[keep] = sec[keep]
            counts += np.bincount(sec_final[keep], minlength=self.k)
            ok = sec_final >= 0
            all_ids.append(ids_arr[ok])
            all_labels.append(sec_final[ok])
            taken = np.concatenate([taken, sec_final[:, None]], axis=1)
        ids_cat = np.concatenate(all_ids)
        lab_cat = np.concatenate(all_labels)
        self._spill = spill

        order = np.argsort(lab_cat, kind="stable")
        sorted_ids = ids_cat[order]
        bounds = np.searchsorted(lab_cat[order], np.arange(self.k + 1))
        self.inverted_lists = [
            sorted_ids[bounds[c]:bounds[c + 1]].tolist()
            for c in range(self.k)
        ]
        self._lists_dirty = True
        if self.index_file and self.autosave:
            self.save_index()

    def _balanced_assign(
        self, cand: np.ndarray, alpha: float
    ) -> np.ndarray:
        """Capacity-bounded nearest-centroid assignment.

        cand: int32[N, C] per-row nearest centroids, best first. Each row
        takes its best candidate whose cell is under ``cap = alpha * N / k``;
        rows exhausting all C candidates go to their LEAST-LOADED candidate
        (never back to an over-full first choice: on heavy-tailed corpora
        the old cap waiver grew cells to ~20x cap, and every padded
        [k, L, ...] device tensor scales with the max cell — measured 19 GB
        at 1M on log-normal cluster sizes)."""
        n, n_cand = cand.shape
        cap = max(1, int(np.ceil(alpha * n / self.k)))
        chosen = np.full(n, -1, np.int64)
        counts = np.zeros(self.k, np.int64)

        def accept_rounds(limit: int) -> None:
            nonlocal counts
            for c in range(n_cand):
                todo = np.flatnonzero(chosen < 0)
                if todo.size == 0:
                    return
                want = cand[todo, c].astype(np.int64)
                order = np.argsort(want, kind="stable")
                sw = want[order]
                # rank of each row within its cluster group this round
                group_start = np.searchsorted(sw, np.arange(self.k))
                rank = np.arange(todo.size) - group_start[sw]
                accept = rank < (limit - counts[sw])
                taken = order[accept]
                chosen[todo[taken]] = sw[accept]
                counts += np.bincount(sw[accept], minlength=self.k)

        # distance-ordered under cap, then doubling relaxed caps for the
        # stragglers (dense-region rows whose every candidate filled)
        limit = cap
        while (chosen < 0).any() and limit < 2 * n:
            accept_rounds(limit)
            limit *= 2
        left = np.flatnonzero(chosen < 0)
        if left.size:  # unreachable in practice; keep total = n invariant
            chosen[left] = cand[left, 0]
        return chosen

    def add(self, node: Node) -> None:
        if self.centroids is None:
            raise ValueError("Index must be built before adding nodes")
        embedding = np.asarray(node.embedding, np.float32)
        if embedding.ndim != 1:
            raise ValueError("embedding must be 1D array")
        if embedding.shape[0] != self.centroids.shape[1]:
            raise ValueError(
                f"embedding dimension {embedding.shape[0]} doesn't match "
                f"centroid dimension {self.centroids.shape[1]}"
            )
        self.storage.save(node)
        self._store.ensure_dim(embedding.shape[0])
        slot = self._store.slot_of(node.id)
        if slot is None:
            slot = self._store.take_slot(node.id)
        self._store.write(np.asarray([slot], np.int32), embedding[None, :])

        distances = np.linalg.norm(self.centroids - embedding, axis=1)
        nearest = int(np.argmin(distances))
        spill = max(1, getattr(self, "_spill", 1))
        for c in np.argsort(distances)[:spill]:
            self.inverted_lists[int(c)].append(node.id)
        if getattr(self, "_rp_dev", None) is not None:
            xh = (embedding @ self._rp_proj).astype(np.float32)
            self._ensure_rp_capacity()
            self._rp_xsq_dev = self._rp_xsq_dev.at[slot].set(
                float(np.sum(embedding * embedding)))
            self._rp_dev = self._rp_dev.at[slot].set(jnp.asarray(xh))
        if self._ensure_codes_capacity() is not None:
            # keep the PQ code row current so the cell rebuild stays valid
            vec = embedding[None, :]
            if getattr(self, "_pq_residual", False):
                vec = vec - self.centroids[nearest][None, :]
            code = self._pq.encode(vec)
            self._codes_np[slot] = code[0]
            if getattr(self, "_sx_np", None) is not None:
                # s = 2·c_rot·recon_rot = 2·c·recon_orig (rotation cancels)
                self._sx_np[slot] = 2.0 * float(
                    np.dot(self.centroids[nearest],
                           self._pq.decode(code)[0])
                )
        self._lists_dirty = True
        if self.index_file and self.autosave:
            self.save_index()

    def delete(self, node_id: int) -> None:
        for cluster_list in self.inverted_lists:
            if node_id in cluster_list:
                cluster_list.remove(node_id)
        self._store.release(node_id)
        self._lists_dirty = True
        if hasattr(self.storage, "delete"):
            self.storage.delete(node_id)
        if self.index_file and self.autosave:
            self.save_index()

    # ------------------------------------------------------------------
    def _validate_query(self, query: np.ndarray, n_probe: int) -> None:
        if self.centroids is None:
            raise ValueError("Index must be built before searching")
        if query.ndim != 1:
            raise ValueError("query must be 1D array")
        if query.shape[0] != self.centroids.shape[1]:
            raise ValueError(
                f"query dimension {query.shape[0]} doesn't match "
                f"centroid dimension {self.centroids.shape[1]}"
            )
        if n_probe <= 0 or n_probe > self.k:
            raise ValueError(f"n_probe must be between 1 and {self.k}")

    def search(
        self, query: np.ndarray, n_probe: int, top_k: int
    ) -> List[Tuple[Node, float]]:
        query = np.asarray(query, np.float32)
        self._validate_query(query, n_probe)
        dists, ids = self.search_batch(query[None, :], n_probe, top_k)
        out: List[Tuple[Node, float]] = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.storage.get(int(nid))
            if node is not None:
                out.append((node, float(d)))
        return out

    def _slot_cell_table(self) -> np.ndarray:
        """int32[capacity] coarse cell of each live slot (-1 for dead);
        one vectorized pass over the padded slot table."""
        out = np.full(self._capacity, -1, np.int32)
        table = self._slot_table()
        valid = table >= 0
        cells = np.broadcast_to(
            np.arange(self.k, dtype=np.int32)[:, None], table.shape
        )
        out[table[valid]] = cells[valid]
        return out

    def enable_pq(self, chunks: int = 16, ksub: int = 256, seed: int = 0,
                  restarts: int = 2, opq_iters: int = 0,
                  train_sample: int = 262144, residual: bool = True) -> None:
        """Attach IVF-PQ scoring: train codebooks on the stored vectors and
        encode them; subsequent ``search_batch(..., pq=True)`` scores probed
        candidates by asymmetric PQ distance with exact rerank.
        ``opq_iters`` > 0 trains an OPQ rotation first (PQCodec.train).

        ``residual=True`` (default) trains and encodes the residuals
        ``x − c_cell(x)`` — the IVFADC formulation (Jégou et al.): the
        coarse quantizer absorbs the cluster mean so the m·8-bit budget
        quantizes only intra-cell variance. Query-time cost is unchanged
        (one LUT per query; the per-cell term folds into a stored scalar)."""
        from vector_db_tpu.index.pq import (
            PQCodec, _encode_residual_scan, _encode_scan,
        )

        if self.centroids is None:
            raise ValueError("Index must be built before enabling PQ")
        if residual and getattr(self, "_spill", 1) > 1:
            raise ValueError(
                "residual PQ stores one code per slot and cannot serve "
                "spilled (multi-assigned) copies; use enable_rp() for "
                "spilled indexes, or enable_pq(residual=False)"
            )
        live = device_pull(self._has_emb)
        n_live = int(live.sum())
        ksub = min(ksub, max(2, n_live))
        if ksub > 256:
            raise ValueError("ksub must be <= 256 (codes are uint8)")
        self._pq = PQCodec(k=ksub, chunks=chunks, dim=self._dim)
        emb_np = device_pull(self._emb)
        slot_cell = self._slot_cell_table() if residual else None
        if residual:
            live = live & (slot_cell >= 0)
        train_rows = np.flatnonzero(live)
        if train_rows.shape[0] > train_sample:
            train_rows = np.random.default_rng(seed).choice(
                train_rows, train_sample, replace=False
            )
        train = emb_np[train_rows]
        if residual:
            train = train - self.centroids[slot_cell[train_rows]]
        self._pq.train(train, seed=seed, restarts=restarts,
                       opq_iters=opq_iters)
        rot = (jnp.asarray(self._pq.rotation)
               if self._pq.rotation is not None else None)
        # encode the whole table (dead rows too — harmless, masked at probe);
        # capacity is a power of two (DeviceVectorStore doubling), so
        # min(8192, capacity) always divides it
        chunk = min(8192, self._capacity)
        if residual:
            cents_d = jnp.asarray(self.centroids, jnp.float32)
            cent_rot = (jnp.dot(cents_d, rot,
                                preferred_element_type=jnp.float32)
                        if rot is not None else cents_d)
            self._cent_rot = cent_rot
            codes, sx = _encode_residual_scan(
                self._emb, jnp.asarray(np.maximum(slot_cell, 0)), cent_rot,
                self._pq.codebooks, chunk=chunk, rotation=rot,
            )
            self._sx_np = np.array(sx, np.float32)  # writable copy
            enc = device_pull(codes)
        else:
            enc = device_pull(_encode_scan(
                self._emb, self._pq.codebooks, chunk=chunk, rotation=rot,
            ))
            self._sx_np = None
        self._pq_residual = bool(residual)
        self._codes_np = enc.astype(np.uint8)
        self._lists_dirty = True  # cell code blocks must rebuild

    def enable_rp(self, dims: int = 128, seed: int = 0,
                  train_sample: int = 131072) -> None:
        """Attach residual-projection scoring: PCA the coarse residuals
        ``x − c_cell`` down to ``dims`` directions, keep the projected
        corpus ``x̂ = R^T x`` as a bf16 mirror plus per-row ‖x̂‖².

        This is the gather-free IVF mode (see
        :func:`_ivf_rp_probe_cells`): where classic ADC gathers LUT
        entries per element, this path's candidate scoring is
        contiguous cell-block reads + one matvec. Because x̂ is
        cell-independent, spilled (multi-assigned) copies share one row —
        compatible with ``build_arrays(spill>1)``, unlike residual PQ.
        Memory: 2·dims bytes/vector (e.g. 256 B at dims=128 vs 3 KB f32)."""
        if self.centroids is None:
            raise ValueError("Index must be built before enabling RP")
        dims = int(min(dims, self._dim))
        if dims <= 0:
            raise ValueError("dims must be positive")
        slot_cell = self._slot_cell_table()
        live = device_pull(self._has_emb) & (slot_cell >= 0)
        rows = np.flatnonzero(live)
        if rows.size == 0:
            raise ValueError("no live vectors to train the projection")
        if rows.shape[0] > train_sample:
            rows = np.random.default_rng(seed).choice(
                rows, train_sample, replace=False)
        # PCA train: covariance accumulates ON DEVICE (one matmul over the
        # sampled rows); only the [d, d] matrix crosses to host.
        rows_dev = jnp.asarray(rows.astype(np.int32))
        cells_dev = jnp.asarray(slot_cell[rows].astype(np.int32))
        res_dev = (self._emb[rows_dev]
                   - jnp.asarray(self.centroids)[cells_dev])
        cov = device_pull(jnp.dot(
            res_dev.T, res_dev, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)) / max(1, rows.shape[0])
        w, v = np.linalg.eigh(cov.astype(np.float64))
        proj = v[:, ::-1][:, :dims].astype(np.float32)     # [dim, dims]
        self._rp_proj = proj
        self._rp_proj_dev = jnp.asarray(proj)
        self._cent_proj_dev = jnp.asarray(self.centroids @ proj)
        # per-slot x̂ (f32) + TRUE full-space norms, both computed and kept
        # on device; bf16 quantization happens only AFTER the per-cell
        # centroid subtraction in the block rebuild
        self._rp_dev = jnp.dot(self._emb, self._rp_proj_dev,
                               preferred_element_type=jnp.float32)
        self._rp_xsq_dev = jnp.sum(self._emb * self._emb, axis=-1)
        # projected global data mean (from the PCA sample): the shared
        # centering vector for every scoring kernel (see _build_rp_blocks)
        self._rp_mu_dev = jnp.dot(
            jnp.mean(self._emb[rows_dev], axis=0), self._rp_proj_dev,
            preferred_element_type=jnp.float32)
        self._rp_flat_src = None  # compact flat-scan mirror (lazy)
        # cell-vs-flat scan heuristic: how much of the deviation energy
        # the coarse centroids absorb. Strongly clustered corpora keep
        # the padded cell-block scan (residual centering matters);
        # weakly clustered ones use the compact unpadded mirror.
        res_e = float(jnp.mean(jnp.sum(res_dev * res_dev, axis=-1)))
        dev = self._emb[rows_dev] - jnp.mean(self._emb[rows_dev], axis=0)
        dev_e = float(jnp.mean(jnp.sum(dev * dev, axis=-1)))
        self._rp_res_ratio = res_e / max(dev_e, 1e-30)
        self._lists_dirty = True  # rp cell blocks must rebuild

    def search_batch(
        self, queries: np.ndarray, n_probe: int, top_k: int,
        pq: bool = False, rp: bool = False, rerank: bool = True,
        filter_ids=None, fetch: Optional[int] = None,
        adc: str = DEFAULT_ADC,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Device fast path: (L2 f32[B, top_k], ids int64[B, top_k]).
        ``filter_ids`` masks candidates in-kernel (every mode: the
        filter folds into the validity mask for rp/pq paths).
        ``pq`` scores probes by (residual) ADC; ``rp`` by the projected
        bf16 mirror (``enable_rp``). ``fetch`` widens the approximate
        candidate front that gets exact re-ranking; default
        ``max(4*top_k, 100)``. ``adc`` names the probe-mode LUT scoring
        formulation (one of :data:`ADC_MODES`): "gather", f32 per-element
        LUT gathers — the Triton LUT scan on the GPU, see
        :func:`lut_kernel_on`."""
        check_adc(adc)
        if self.centroids is None:
            raise ValueError("Index must be built before searching")
        q = jnp.asarray(np.asarray(queries, np.float32))
        use_filter = filter_ids is not None
        if use_filter:
            fmask = jnp.asarray(self._store.filter_mask(filter_ids))
        else:
            # cached all-False placeholder: never rebuild/transfer a
            # capacity-sized mask on the unfiltered hot path
            fmask = getattr(self, "_zero_mask", None)
            if fmask is None or fmask.shape[0] != self._capacity:
                fmask = jnp.zeros((self._capacity,), bool)
                self._zero_mask = fmask
        spilled = getattr(self, "_spill", 1) > 1
        if fetch is None:
            fetch = max(4 * int(top_k), 100)
        # IVF has no navigate-through requirement (unlike HNSW), so the
        # filter contract for the approximate modes is exactly candidate
        # masking: fold the filter into the validity mask every kernel
        # already applies. No new kernel arguments, no recompiles (same
        # shape/dtype).
        has = (self._has_emb & fmask) if use_filter else self._has_emb
        if rp:
            if getattr(self, "_rp_dev", None) is None:
                raise ValueError("call enable_rp() first")
            if self._lists_dirty or self._cells_rp_dev is None:
                self._rebuild_device_tables()
            if (int(n_probe) >= self.k
                    and getattr(self, "_rp_res_ratio", 1.0) > 0.5):
                # weakly clustered corpus: cells absorb little deviation
                # energy, so full-scan goes through the compact UNPADDED
                # projected mirror — ops.exact.approx_search_tiled runs
                # it directly (see _rp_flat_tables), then exact rerank
                flat, u = self._rp_flat_tables()
                d_sq, slots = _rp_flat_search(
                    q, self._rp_proj_dev, self._rp_mu_dev, flat, u,
                    has, self._emb,
                    top_k=int(top_k), fetch=int(fetch), rerank=rerank,
                    tile=min(flat.shape[0], 131072),
                )
            elif int(n_probe) >= self.k:
                # probing everything: the tiled full-scan kernel reads
                # each residual byte once per BATCH (no per-query
                # gathers) — the batched-throughput mode. Geometry aims
                # for FEW, BIG steps (scan-step overhead dominates small
                # tiles): grow ctile until p_tile ~ 128k, bound the score
                # tensor at ~256 MB.
                max_l = self._lists_dev.shape[1]
                ctile = 1
                for cand_t in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
                    if self.k % cand_t == 0 and cand_t * max_l <= 131072:
                        ctile = cand_t
                        break
                else:
                    import math as _math
                    ctile = _math.gcd(self.k, 64)
                qblock = 1 << (max(1, min(q.shape[0], 512)) - 1).bit_length()
                while qblock > 8 and qblock * ctile * max_l * 4 > 268_435_456:
                    qblock //= 2
                d_sq, slots = _ivf_rp_scan_cells(
                    self._centroids_dev, self._lists_dev,
                    self._cells_rp_dev, self._cells_xsq_dev, self._emb,
                    has, q, self._rp_proj_dev, self._rp_mu_dev,
                    top_k=int(top_k), fetch=int(fetch), rerank=rerank,
                    dedup=spilled, ctile=ctile, qblock=qblock,
                )
            else:
                d_sq, slots = _ivf_rp_probe_cells(
                    self._centroids_dev, self._rp_mu_dev,
                    self._lists_dev, self._cells_rp_dev,
                    self._cells_xsq_dev, self._emb, has, q,
                    self._rp_proj_dev,
                    n_probe=int(n_probe), top_k=int(top_k),
                    fetch=int(fetch), rerank=rerank, dedup=spilled,
                )
        elif pq:
            if getattr(self, "_pq", None) is None:
                raise ValueError("call enable_pq() first")
            cell_slots, cell_codes, cell_s = self._device_cells()
            if int(n_probe) >= self.k:
                # scanning everything: one-hot matmul scoring shared by the
                # whole batch instead of per-element LUT gathers
                import math as _math

                ctile = _math.gcd(self.k, 16)
                qblock = min(128,
                             1 << (max(1, q.shape[0]) - 1).bit_length())
                d_sq, slots = _ivf_pq_scan_cells(
                    self._centroids_dev, cell_slots, cell_codes, cell_s,
                    self._pq.codebooks, self._emb, has, q,
                    self._pq.rotate_queries(q),
                    top_k=int(top_k), fetch=int(fetch), rerank=rerank,
                    residual=getattr(self, "_pq_residual", False),
                    dedup=spilled, ctile=ctile, qblock=qblock,
                )
            else:
                lut_kernel = lut_kernel_on(jax.default_backend())
                qblock = probe_qblock(
                    int(n_probe) * cell_slots.shape[1], self._pq.chunks,
                    lut_kernel)
                d_sq, slots = _ivf_pq_probe_cells(
                    self._centroids_dev, cell_slots, cell_codes, cell_s,
                    self._pq.codebooks, self._emb, has, q,
                    self._pq.rotate_queries(q),
                    n_probe=int(n_probe), top_k=int(top_k),
                    fetch=int(fetch), rerank=rerank,
                    residual=getattr(self, "_pq_residual", False),
                    qblock=qblock, lut_kernel=lut_kernel,
                )
        else:
            d_sq, slots = _ivf_search_batch(
                self._centroids_dev, self._device_lists(), self._emb,
                self._has_emb, q, fmask,
                n_probe=int(n_probe), top_k=int(top_k),
                use_filter=use_filter, dedup=spilled,
            )
        d_sq = np.asarray(d_sq)
        slots = np.asarray(slots)
        ids = self._store.ids_of(slots)
        dists = np.where(slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)), np.inf)
        return dists.astype(np.float32), ids

    @property
    def size(self) -> int:
        """Live vector count (sum of inverted-list sizes)."""
        return sum(len(lst) for lst in self.inverted_lists)

    # ------------------------------------------------------------------
    def get_cluster_size(self, cluster_id: int) -> int:
        if cluster_id < 0 or cluster_id >= self.k:
            raise ValueError(f"cluster_id must be between 0 and {self.k - 1}")
        return len(self.inverted_lists[cluster_id])

    def get_cluster_stats(self) -> dict:
        sizes = [len(lst) for lst in self.inverted_lists]
        return {
            "min_size": min(sizes) if sizes else 0,
            "max_size": max(sizes) if sizes else 0,
            "avg_size": sum(sizes) / len(sizes) if sizes else 0,
            "total_vectors": sum(sizes),
        }

    # ------------------------------------------------------------------
    def save_index(self) -> None:
        if self.index_file is None or self.centroids is None:
            return
        self.index_file.parent.mkdir(parents=True, exist_ok=True)
        extra = {}
        # persist trained auxiliary state so reopen skips retraining:
        # PCA projection (+mean) for RP, PQ codebooks (+OPQ rotation) for
        # ADC. Mirrors/codes regenerate from the embedding table in one
        # streaming device program at load.
        if getattr(self, "_rp_proj", None) is not None:
            extra["rp_proj"] = self._rp_proj
            extra["rp_mu"] = np.asarray(self._rp_mu_dev, np.float32)
        pq = getattr(self, "_pq", None)
        if pq is not None and pq.codebooks is not None:
            extra["pq_codebooks"] = np.asarray(pq.codebooks, np.float32)
            extra["pq_residual"] = np.asarray(
                getattr(self, "_pq_residual", False))
            if pq.rotation is not None:
                extra["pq_rotation"] = np.asarray(pq.rotation, np.float32)
        if getattr(self, "_spill", 1) > 1:
            extra["spill"] = np.asarray(self._spill)
        # uncompressed: same rationale as HNSW.save_index — flush-path
        # write time beats disk bytes
        np.savez(
            self.index_file,
            k=self.k,
            centroids=self.centroids,
            list_ids=np.concatenate(
                [np.asarray(l, np.int64) for l in self.inverted_lists]
            ) if any(self.inverted_lists) else np.zeros((0,), np.int64),
            list_sizes=np.asarray(
                [len(l) for l in self.inverted_lists], np.int64
            ),
            **extra,
        )

    def load_index(self) -> None:
        if self.index_file is None or not self.index_file.exists():
            return
        with np.load(self.index_file) as z:
            self.k = int(z["k"])
            self.centroids = np.asarray(z["centroids"])
            sizes = np.asarray(z["list_sizes"])
            flat = np.asarray(z["list_ids"])
            aux = {name: np.asarray(z[name]) for name in
                   ("rp_proj", "rp_mu", "pq_codebooks", "pq_rotation",
                    "pq_residual", "spill") if name in z}
        self._centroids_dev = jnp.asarray(self.centroids)
        self.inverted_lists = []
        off = 0
        for s in sizes:
            self.inverted_lists.append([int(x) for x in flat[off : off + s]])
            off += int(s)
        self._lists_dirty = True
        if "spill" in aux:
            self._spill = int(aux["spill"])
        # hydrate embeddings from storage in one bulk read (spilled ids
        # appear in several lists; dedupe preserving first occurrence)
        all_ids = list(dict.fromkeys(
            nid for lst in self.inverted_lists for nid in lst))
        if all_ids:
            dim = self.centroids.shape[1]
            self._ensure_capacity(len(all_ids), dim)
            rows, found = self.storage.get_embeddings(all_ids)
            if found.any():
                slots = np.asarray([
                    self._store.slot_of(nid)
                    if nid in self._store else self._store.take_slot(nid)
                    for nid, f in zip(all_ids, found) if f
                ], np.int32)
                self._store.write(slots, rows[found])
        # rebuild trained auxiliary state without retraining
        if "rp_proj" in aux and all_ids:
            self._rp_proj = aux["rp_proj"].astype(np.float32)
            self._rp_proj_dev = jnp.asarray(self._rp_proj)
            self._cent_proj_dev = jnp.asarray(self.centroids @ self._rp_proj)
            self._rp_mu_dev = jnp.asarray(aux["rp_mu"].astype(np.float32))
            self._rp_dev = jnp.dot(self._emb, self._rp_proj_dev,
                                   preferred_element_type=jnp.float32)
            self._rp_xsq_dev = jnp.sum(self._emb * self._emb, axis=-1)
            self._rp_flat_src = None
            if not hasattr(self, "_rp_res_ratio"):
                self._rp_res_ratio = 1.0  # conservative: cell-block scan
        if "pq_codebooks" in aux and all_ids:
            from vector_db_tpu.index.pq import PQCodec

            cb = aux["pq_codebooks"]
            self._pq = PQCodec(k=cb.shape[1], chunks=cb.shape[0],
                               dim=self._dim)
            self._pq.codebooks = jnp.asarray(cb)
            if "pq_rotation" in aux:
                self._pq.rotation = jnp.asarray(aux["pq_rotation"])
            self._reencode_pq(residual=bool(aux.get("pq_residual", False)))

    def _reencode_pq(self, residual: bool) -> None:
        """Re-encode the hydrated table with existing codebooks (one
        streaming device program; no retraining)."""
        from vector_db_tpu.index.pq import (
            _encode_residual_scan, _encode_scan,
        )

        rot = (jnp.asarray(self._pq.rotation)
               if self._pq.rotation is not None else None)
        chunk = min(8192, self._capacity)
        if residual:
            slot_cell = self._slot_cell_table()
            cents_d = jnp.asarray(self.centroids, jnp.float32)
            cent_rot = (jnp.dot(cents_d, rot,
                                preferred_element_type=jnp.float32)
                        if rot is not None else cents_d)
            self._cent_rot = cent_rot
            codes, sx = _encode_residual_scan(
                self._emb, jnp.asarray(np.maximum(slot_cell, 0)), cent_rot,
                self._pq.codebooks, chunk=chunk, rotation=rot,
            )
            self._sx_np = np.array(sx, np.float32)
            enc = device_pull(codes)
        else:
            enc = device_pull(_encode_scan(
                self._emb, self._pq.codebooks, chunk=chunk, rotation=rot,
            ))
            self._sx_np = None
        self._pq_residual = bool(residual)
        self._codes_np = enc.astype(np.uint8)
        self._lists_dirty = True
