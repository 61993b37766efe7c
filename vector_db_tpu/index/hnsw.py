"""Host-facing HNSW index over the device kernels.

Parity target: reference ``HNSW`` (src/vector_db/indexing/hnsw.py:30-423):
same constructor shape ``HNSW(M, ef_construction, rng, storage, index_file)``,
same level sampling ``int(-ln(U) / ln(M))`` (hnsw.py:66-68), idempotent
insert (hnsw.py:152-155), delete with entry re-election (hnsw.py:227-277),
``search(query, k, ef=, filter_ids=)`` returning ``[(Node, distance)]``
(hnsw.py:330-374), and graph-only persistence (embeddings stay in storage,
hnsw.py:18-21, 376-423).

Accelerator-first differences:
- embeddings mirror into a device-resident f32[capacity, dim] table; all
  traversal distance math happens on-device in batched form;
- ``insert_nodes`` bulk-inserts: beam searches for the whole batch run
  vmapped in parallel against the pre-batch graph, then edges commit
  sequentially inside one jitted fori_loop, with earlier batch members
  injected as exact-distance candidates (so batch order still "sees"
  earlier inserts, like the reference's sequential loop);
- ``search_batch`` answers a whole query batch per device program;
- persistence is npz of the fixed-degree tables (+ id map), not pickle of a
  dict graph — and is NOT rewritten after every insert; threshold-flush
  policy lives in IndexingService, as in the reference's service layer
  (services/indexing_service.py:85-89,137-144).
"""

from __future__ import annotations

import math
import os
import random
from functools import partial
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from vector_db_tpu.index import hnsw_kernels as K
from vector_db_tpu.runtime import device_pull
from vector_db_tpu.storage import InMemoryNodeStorage, NodeStorage
from vector_db_tpu.storage.device_store import DeviceVectorStore
from vector_db_tpu.types import Node

DEFAULT_L_MAX = 6
MIN_CAPACITY = 256


@partial(jax.jit, static_argnames=("m2",))
def _pack_snapshot(nbr, upper_idx, entry, entry_level, m2: int):
    """One int32 vector = [entry, entry_level, level0-block, upper-block]
    — the whole graph checkpoint comes to the host in a SINGLE
    device->host transfer instead of four. One compiled program per
    (capacity, upper-bucket, M) combination, reused across flushes."""
    head = jnp.stack(
        [entry.astype(jnp.int32), entry_level.astype(jnp.int32)])
    return jnp.concatenate([
        head,
        nbr[:, :m2].reshape(-1),
        nbr[upper_idx][:, m2:].reshape(-1),
    ])


def _reverse_merge(fwd_i: np.ndarray, fwd_d: np.ndarray, width: int) -> np.ndarray:
    """Combine forward edges with reverse edges, keeping the closest
    ``width`` per row (bulk-build analog of the reference's
    append-backlink-then-prune, hnsw.py:190-213).

    fwd_i/fwd_d: [n, deg] local neighbor indices/distances (-1/inf padded).
    Returns rows int32[n, width].
    """
    n, deg = fwd_i.shape
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = fwd_i.ravel().astype(np.int64)
    dd = fwd_d.ravel()
    keep = dst >= 0
    src, dst, dd = src[keep], dst[keep], dd[keep]
    # undirected edge set (v, u, d), deduped on (v, u)
    v = np.concatenate([src, dst])
    u = np.concatenate([dst, src])
    w = np.concatenate([dd, dd])
    _, first = np.unique(v * n + u, return_index=True)
    v, u, w = v[first], u[first], w[first]
    # rank each node's edges by distance; keep the closest `width`
    order = np.lexsort((w, v))
    v, u = v[order], u[order]
    starts = np.searchsorted(v, np.arange(n), "left")
    ranks = np.arange(v.size) - starts[v]
    sel = ranks < width
    rows = np.full((n, width), -1, np.int32)
    rows[v[sel], ranks[sel]] = u[sel].astype(np.int32)
    return rows


# bulk_build level-size thresholds (module-level so tests can exercise
# every branch on small corpora):
# - below HOST: plain numpy beats device compiles;
# - above EXACT: O(n^2) all-pairs kNN is too expensive — switch to the
#   cluster-partitioned device pipeline (fully device-resident).
BULK_HOST_THRESHOLD = 8192
BULK_EXACT_THRESHOLD = 262144


def _clustered_forward(
    embeddings,
    deg: int,
    seed: int = 0,
    spill: int = 3,
    lmax_cap: int = 8192,
    refine_rounds: int = 2,
    return_device: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate forward edges for large corpora via cluster-partitioned
    exact kNN: k-means into ~sqrt(n) cells, assign every point to its
    ``spill`` nearest cells, exact kNN within each cell (one device scan,
    see ops.graph_build.clustered_knn_merge), best-of-union per point.
    O(n^1.5) matmul work instead of O(n^2); spill=2 keeps boundary recall.

    ``embeddings`` may be a DEVICE array (jnp): the pipeline then runs
    without re-uploading the corpus (3 GB at 1M x 768).
    ``return_device=True`` keeps the edge tables on device for the
    device-side reverse merge.
    """
    import jax as _jax

    from vector_db_tpu.ops.graph_build import (
        assign_topk_clusters,
        clustered_knn_merge,
    )
    from vector_db_tpu.ops.kmeans import kmeans

    n, dim = embeddings.shape
    c = max(64, 1 << int(round(math.log2(math.sqrt(n)))))
    rng = np.random.default_rng(seed)
    on_device = isinstance(embeddings, jnp.ndarray)

    sample_n = min(n, 131072)
    sample_idx = rng.choice(n, sample_n, replace=False)
    if on_device:
        sample = embeddings[jnp.asarray(np.sort(sample_idx))]
    else:
        sample = jnp.asarray(embeddings[sample_idx])
    cents, _ = kmeans(sample, c, _jax.random.key(seed), iters=15)

    chunk = 8192
    pad = (-n) % chunk
    if on_device:
        emb_dev = (
            jnp.concatenate(
                [embeddings, jnp.zeros((pad, dim), jnp.float32)])
            if pad else embeddings
        )
    else:
        emb_pad = np.zeros((n + pad, dim), np.float32)
        emb_pad[:n] = embeddings
        emb_dev = jnp.asarray(emb_pad)
    assign = device_pull(
        assign_topk_clusters(emb_dev, cents, k=spill, chunk=chunk)
    )[:n]

    # padded member table; over-full cells truncate their later-spill
    # entries (primary assignments rank first within each cell, so every
    # point keeps at least its own cell). Fully vectorized: stable-sort the
    # (cell, point) pairs in spill-major order and rank within cell.
    cl = assign.T.reshape(-1).astype(np.int64)   # s-major: all s=0 first
    pt = np.tile(np.arange(n, dtype=np.int32), spill)
    order = np.argsort(cl, kind="stable")
    cl_s, pt_s = cl[order], pt[order]
    starts = np.searchsorted(cl_s, np.arange(c))
    ranks = np.arange(cl_s.size) - starts[cl_s]
    lmax = int(ranks.max()) + 1 if ranks.size else 1
    lmax = min(max(256, lmax), lmax_cap)
    lmax = ((lmax + 255) // 256) * 256
    keep = ranks < lmax
    members = np.full((c, lmax), -1, np.int32)
    members[cl_s[keep], ranks[keep]] = pt_s[keep]

    fwd_d, fwd_i = clustered_knn_merge(emb_dev, jnp.asarray(members), deg)

    # NN-descent refinement: recover cell-boundary neighbors the partition
    # missed by rescoring each node against its neighbors' neighbors
    from vector_db_tpu.ops.graph_build import nn_descent_round

    n_pad_rows = emb_dev.shape[0]
    for _ in range(refine_rounds):
        # pad rows must stay inert: their edges are -1 already
        fd_pad = jnp.concatenate([
            fwd_d, jnp.full((n_pad_rows - fwd_d.shape[0], deg),
                            np.float32(3e38))
        ]) if fwd_d.shape[0] < n_pad_rows else fwd_d
        fi_pad = jnp.concatenate([
            fwd_i, jnp.full((n_pad_rows - fwd_i.shape[0], deg), -1,
                            jnp.int32)
        ]) if fwd_i.shape[0] < n_pad_rows else fwd_i
        # chunk sized so the [chunk, deg*sample, dim] gather stays <1GB
        nd_sample = max(4, min(8, deg // 2))
        nd_chunk = 2048 if deg * nd_sample <= 128 else 1024
        fd_pad, fi_pad = nn_descent_round(
            emb_dev, fd_pad, fi_pad, deg, chunk=nd_chunk,
            sample=nd_sample,
        )
        # pad rows may have picked up edges via their zero vectors; real
        # rows never reference pads (cand ids come from real rows' edges)
        fwd_d, fwd_i = fd_pad[:n], fi_pad[:n]
    if return_device:
        return fwd_d[:n], fwd_i[:n]
    return device_pull(fwd_d[:n]), device_pull(fwd_i[:n])


class HNSW:
    def __init__(
        self,
        M: int,
        ef_construction: int,
        rng: random.Random,
        storage: Optional[NodeStorage] = None,
        index_file: Optional[Union[str, Path]] = None,
        l_max: int = DEFAULT_L_MAX,
        capacity: int = MIN_CAPACITY,
        max_steps: int = 0,
        precision: str = "f32",
    ) -> None:
        self.M = int(M)
        self.M_max = self.M
        self.M_max0 = self.M * 2
        self.ef_construction = int(ef_construction)
        self.rng = rng
        self.storage = storage or InMemoryNodeStorage()
        self.index_file = Path(index_file) if index_file else None
        self.l_max = int(l_max)
        self.level_mult = 1.0 / math.log(self.M) if self.M > 1 else 1.0
        # beam expansion budget; 0 = auto (2*ef + 16 at query time)
        self.max_steps = int(max_steps)
        # edge-commit strategy: "grouped" (batch-parallel, default) or
        # "sequential" (item-at-a-time fori_loop; reference-faithful fold)
        self.commit_mode = "grouped"
        # traversal precision: "bf16" gathers beam-expansion rows from a
        # bfloat16 mirror (half the HBM traffic of the memory-bound beam
        # loop); final results are re-scored exactly from the f32 table.
        # Mirror rebuilds lazily after mutations (identity-tracked).
        if precision not in ("f32", "bf16"):
            raise ValueError("precision must be 'f32' or 'bf16'")
        self.precision = precision
        self._emb16 = None
        self._emb16_src = None
        # construction-beam multi-pop: expand E candidates per step (the
        # sequential step count is the insert bottleneck; the explored set
        # at equal ef_construction is a superset of best-first's)
        self.insert_expand = 4
        # candidate generation for streaming inserts: "exact" (tiled
        # matmul scan of the table — exact) or "beam"
        # (reference-shaped per-item beam search)
        self.construction_mode = "exact"

        self.graph: Optional[K.Graph] = None
        self._store = DeviceVectorStore(
            capacity=capacity, on_grow=self._grow_graph
        )

        if self.index_file and self.index_file.exists():
            self.load_index()

    # -- store aliases (device tables live in DeviceVectorStore) ----------
    @property
    def _emb(self):
        return self._store.emb

    @property
    def _has_emb(self):
        return self._store.valid

    @_has_emb.setter
    def _has_emb(self, v):
        self._store.valid = v

    @property
    def _capacity(self) -> int:
        return self._store.capacity

    @property
    def _dim(self):
        return self._store.dim

    @property
    def _id_of_slot(self):
        return self._store.export_id_map()

    @property
    def _slot_of_id(self):
        return self._store._slot_of_id

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return self._store.size

    def __len__(self) -> int:
        return self.size

    def sample_level(self) -> int:
        """Geometric level sampling (reference hnsw.py:66-68), clamped to
        the static table depth."""
        lvl = int(-math.log(self.rng.random()) * self.level_mult)
        return min(lvl, self.l_max - 1)

    # ------------------------------------------------------------------
    def _ensure_init(self, dim: int) -> None:
        had_dim = self._store.dim is not None
        self._store.ensure_dim(dim)
        if not had_dim and self.graph is None:
            self.graph = K.empty_graph(self._capacity, self.M, self.l_max)
            self._levels_host = np.full((self._capacity,), -1, np.int32)

    def _grow_graph(self, old_cap: int, new_cap: int) -> None:
        """DeviceVectorStore growth hook: pad the graph tables in step."""
        if self.graph is None:
            return
        pad = new_cap - old_cap
        g = self.graph
        self.graph = K.Graph(
            neighbors=jnp.concatenate(
                [g.neighbors,
                 jnp.full((pad, g.neighbors.shape[1]), -1, jnp.int32)]
            ),
            levels=jnp.concatenate(
                [g.levels, jnp.full((pad,), -1, jnp.int32)]
            ),
            entry=g.entry,
            entry_level=g.entry_level,
        )
        if getattr(self, "_levels_host", None) is not None:
            self._levels_host = np.concatenate(
                [self._levels_host, np.full((pad,), -1, np.int32)])

    # ------------------------------------------------------------------
    def insert_node(self, node: Node) -> None:
        """Single insert (reference insert_node, hnsw.py:143-225)."""
        self.insert_nodes([node])

    def build_index(self, nodes: Sequence[Node]) -> None:
        """Bulk build (reference build_index, hnsw.py:279-287)."""
        self.insert_nodes(nodes)

    def insert_nodes(self, nodes: Sequence[Node], batch_size: int = 1024) -> None:
        """Bulk insert. Embedding writes, construction searches, and edge
        commits all run on-device; levels are sampled host-side from the
        same rng stream as the reference."""
        if not nodes:
            return
        # storage first (reference hnsw.py:150). One batched call =
        # one flush per memmap layer (save_many), not 2 msyncs/node.
        self.storage.save_many(list(nodes))
        # Idempotent insert (hnsw.py:152-155) — against the existing graph
        # AND within the batch: a duplicate id inside one batch would
        # otherwise allocate two slots for one id (ghost row after delete).
        seen: Set[int] = set()
        fresh = []
        for n in nodes:
            if n.id in self._slot_of_id or n.id in seen:
                continue
            seen.add(n.id)
            fresh.append(n)
        if not fresh:
            return
        self._ensure_init(len(np.asarray(fresh[0].embedding)))
        for i in range(0, len(fresh), batch_size):
            self._insert_batch(fresh[i : i + batch_size])

    def bulk_build(
        self,
        ids: Sequence[int],
        embeddings: np.ndarray,
        query_chunk: int = 2048,
        cand_factor: int = 4,
        alpha: float = 1.0,
    ) -> None:
        """Bulk construction from exact k-NN tables computed by matmuls.

        Instead of replaying the reference's sequential insert loop
        (hnsw.py:279-287 — one beam search per node), the whole corpus is
        scored against itself with streaming matmuls:

        1. per level, every node's exact ``cand_factor * M`` nearest
           neighbors among level->=l nodes (one pass of tiled matmul+top-k);
        2. occlusion-prune (HNSW-paper heuristic — deliberately stronger
           than the reference's naive closest-M, hnsw.py:136-141) down to M
           forward edges per node, batched on device;
        3. add reverse edges, keep the closest ``m_limit`` per row (2M at
           level 0, M above — same caps as the reference, hnsw.py:48-50).

        Edges are exact rather than beam-approximated, so graph quality
        upper-bounds incremental construction; level sampling and entry
        semantics are unchanged. Requires an empty index; streaming inserts
        still use ``insert_nodes``.
        """
        from vector_db_tpu.ops.graph_build import build_forward_edges

        if self.size > 0:
            raise ValueError("bulk_build requires an empty index")
        embeddings = np.asarray(embeddings, np.float32)
        ids = list(ids)
        if len(set(ids)) != len(ids):  # keep first occurrence per id
            seen: Set[int] = set()
            keep = []
            for i, nid in enumerate(ids):
                if nid not in seen:
                    seen.add(nid)
                    keep.append(i)
            ids = [ids[i] for i in keep]
            embeddings = embeddings[keep]
        n = embeddings.shape[0]
        if n == 0:
            return
        self._ensure_init(embeddings.shape[1])
        self._store.grow_to(n)

        slots = self._store.take_slots(list(ids))
        levels_np = np.array([self.sample_level() for _ in range(n)], np.int32)
        self._store.write(slots, embeddings)

        ncols = K.ncols(self.M, self.l_max)
        # neighbor table assembled ON DEVICE: per level only the (slots,
        # mapped-rows) pair crosses the host boundary (small above level
        # 0; level 0 at clustered scale never leaves the device at all).
        # A host-side assembly would ship the full [capacity, ncols]
        # table once per build plus the level-0 edge tables both ways.
        nb_dev = jnp.full((self._capacity, ncols), -1, jnp.int32)
        levels_full = np.full((self._capacity,), -1, np.int32)
        levels_full[slots] = levels_np
        self._levels_host = levels_full.copy()

        host_threshold = BULK_HOST_THRESHOLD
        exact_threshold = BULK_EXACT_THRESHOLD
        for level in range(self.l_max):
            if level == 0:
                sub = np.arange(n)
            else:
                sub = np.nonzero(levels_np >= level)[0]
            if sub.size <= 1:
                continue
            width = K.level_width(level, self.M)
            deg = min(self.M, sub.size - 1)

            if sub.size > exact_threshold:
                # build at full row width (2M at level 0): wider forward
                # edges + NN-descent rounds recover the recall a cluster-
                # partitioned build loses vs exact kNN. The corpus is
                # already device-resident in the store — everything in
                # this branch stays on device (edges, reverse merge,
                # slot mapping); only the tiny slot list goes up.
                slots_dev = jnp.asarray(slots[sub])
                src_dev = self._store.emb[slots_dev]
                fwd_d, fwd_i = _clustered_forward(
                    src_dev, min(width, sub.size - 1), seed=level,
                    return_device=True,
                )
                if alpha != 1.0:
                    # diversify to M alpha-occluded forward edges (the
                    # exact path's shape: reverse merge refills rows back
                    # to `width` with backlinks). alpha=1.0 keeps the
                    # legacy plain closest-K rows.
                    from vector_db_tpu.ops.graph_build import (
                        occlusion_prune_tiled,
                    )

                    p_chunk = 2048
                    p_pad = (-sub.size) % p_chunk
                    fd_p = jnp.concatenate(
                        [fwd_d, jnp.full((p_pad, fwd_d.shape[1]),
                                         np.float32(3e38))]) \
                        if p_pad else fwd_d
                    fi_p = jnp.concatenate(
                        [fwd_i, jnp.full((p_pad, fwd_i.shape[1]), -1,
                                         jnp.int32)]) if p_pad else fwd_i
                    pe_src = jnp.concatenate(
                        [src_dev,
                         jnp.zeros((p_pad, embeddings.shape[1]),
                                   jnp.float32)]) if p_pad else src_dev
                    od, oi = occlusion_prune_tiled(
                        pe_src, fd_p, fi_p, deg=deg, chunk=p_chunk,
                        alpha=alpha)
                    fwd_d = od[: sub.size]
                    fwd_i = oi[: sub.size]
                from vector_db_tpu.ops.graph_build import (
                    reverse_merge as _reverse_merge_dev,
                )

                import jax as _jax

                rows_dev = _jax.jit(
                    _reverse_merge_dev, static_argnames=("width",)
                )(fwd_d, fwd_i, width=width)
                mapped = jnp.where(
                    rows_dev >= 0, slots_dev[jnp.maximum(rows_dev, 0)], -1
                )
                start = K.level_col_start(level, self.M)
                nb_dev = nb_dev.at[
                    slots_dev, start : start + width].set(mapped)
                continue
            elif sub.size <= host_threshold:
                # tiny level: plain numpy, naive closest-deg selection (the
                # reference's own selection rule, hnsw.py:136-141)
                se = embeddings[sub]
                sq = (se * se).sum(-1)
                d = sq[:, None] - 2.0 * (se @ se.T) + sq[None, :]
                np.fill_diagonal(d, np.inf)
                part = np.argpartition(d, min(deg, d.shape[1] - 1), axis=1)[:, :deg]
                pd = np.take_along_axis(d, part, axis=1)
                order = np.take_along_axis(part, np.argsort(pd, axis=1), axis=1)
                fwd_i = order.astype(np.int32)
                fwd_d = np.take_along_axis(d, order, axis=1).astype(np.float32)
            else:
                k_cand = min(cand_factor * self.M, sub.size - 1)
                # whole level as ONE device program (zero per-chunk host
                # round-trips — they dominate wall time on remote devices);
                # chunk sized so the [chunk, n] distance tile stays ~512MB
                chunk = min(
                    query_chunk, max(128, (1 << 27) // max(sub.size, 1))
                )
                chunk = 1 << (chunk.bit_length() - 1)  # power of two
                pad = (-sub.size) % chunk
                pe = np.zeros((sub.size + pad, embeddings.shape[1]), np.float32)
                pe[: sub.size] = embeddings[sub]
                pv = np.zeros((sub.size + pad,), bool)
                pv[: sub.size] = True
                fd, fi = build_forward_edges(
                    jnp.asarray(pe), jnp.asarray(pv), deg=deg,
                    k_cand=k_cand, chunk=chunk, alpha=alpha,
                )
                fwd_d = device_pull(fd)[: sub.size]
                fwd_i = device_pull(fi)[: sub.size]

            rows = _reverse_merge(fwd_i, fwd_d, width)
            mapped = np.where(rows >= 0, slots[sub][np.maximum(rows, 0)], -1)
            start = K.level_col_start(level, self.M)
            nb_dev = nb_dev.at[
                jnp.asarray(slots[sub]), start : start + width
            ].set(jnp.asarray(mapped))

        entry_idx = int(np.argmax(levels_np))
        self.graph = K.Graph(
            neighbors=nb_dev,
            levels=jnp.asarray(levels_full),
            entry=jnp.int32(slots[entry_idx]),
            entry_level=jnp.int32(levels_np[entry_idx]),
        )

    def insert_arrays(
        self,
        ids: Sequence[int],
        embeddings: np.ndarray,
        batch_size: int = 1024,
    ) -> None:
        """Array-level bulk ingest: graph + device table only, skipping the
        per-Node storage round-trip (benchmark / engine-internal path; node
        payloads can be attached to storage separately)."""
        embeddings = np.asarray(embeddings, np.float32)
        seen: Set[int] = set()
        keep = []
        for i, nid in enumerate(ids):
            if nid in self._slot_of_id or nid in seen:
                continue
            seen.add(nid)
            keep.append(i)
        if not keep:
            return
        self._ensure_init(embeddings.shape[1])
        for s in range(0, len(keep), batch_size):
            sel = keep[s : s + batch_size]
            self._insert_rows(
                [int(ids[i]) for i in sel], embeddings[sel]
            )

    def _insert_batch(self, batch: List[Node]) -> None:
        self._insert_rows(
            [n.id for n in batch],
            np.stack([np.asarray(n.embedding, np.float32) for n in batch]),
        )

    def _insert_rows(self, ids: List[int], embs_np: np.ndarray) -> None:
        b = len(ids)
        # pad the batch to a power-of-two bucket so partial batches reuse
        # compiled kernels; padded items carry slot -1 (a full no-op in the
        # commit kernel)
        b_pad = max(8, 1 << (b - 1).bit_length())
        slots = np.full((b_pad,), -1, np.int32)
        slots[:b] = self._store.take_slots(ids)
        levels = np.zeros((b_pad,), np.int32)
        levels[:b] = [self.sample_level() for _ in ids]
        embs_p = np.zeros((b_pad, embs_np.shape[1]), np.float32)
        embs_p[:b] = embs_np
        self._store.write(slots, embs_p)
        if getattr(self, "_levels_host", None) is not None:
            self._levels_host[slots[:b]] = levels[:b]

        # search + commit as ONE device program: one dispatch per batch
        if self.construction_mode == "exact":
            tile = min(self._capacity, 32768)  # capacities are powers of 2
            self.graph = K.insert_step_exact(
                self.graph, self._emb, self._has_emb,
                jnp.asarray(embs_p), jnp.asarray(slots), jnp.asarray(levels),
                M=self.M, l_max=self.l_max,
                ef_construction=self.ef_construction,
                ef_upper=min(self.ef_construction, 64), tile=tile,
                commit=self.commit_mode,
            )
        else:
            expand = max(1, int(self.insert_expand))
            max_steps = self.max_steps or (2 * self.ef_construction + 16)
            max_steps = max(48, max_steps // expand)
            self.graph = K.insert_step(
                self.graph, self._emb, self._has_emb,
                jnp.asarray(embs_p), jnp.asarray(slots), jnp.asarray(levels),
                M=self.M, l_max=self.l_max,
                ef_construction=self.ef_construction, max_steps=max_steps,
                commit=self.commit_mode, expand=expand,
            )

    # ------------------------------------------------------------------
    def delete_node(self, node_id: int) -> None:
        """Delete (reference delete_node, hnsw.py:227-277): unlink edges,
        re-elect entry, drop from storage too."""
        slot = self._store.release(node_id)
        if slot is None:
            return
        if getattr(self, "_levels_host", None) is not None:
            self._levels_host[slot] = -1
        self.graph = K.delete_slot(
            self.graph, jnp.int32(slot), M=self.M, l_max=self.l_max
        )
        if hasattr(self.storage, "delete"):
            self.storage.delete(node_id)

    # ------------------------------------------------------------------
    def enable_pq(self, chunks: int = 16, ksub: int = 256, seed: int = 0,
                  restarts: int = 2, opq_iters: int = 0) -> None:
        """Attach a product-quantized traversal path: train per-subspace
        codebooks on the current corpus and encode every stored vector.
        Subsequent ``search_batch(..., pq=True)`` traverses on ADC
        distances and reranks the final candidates exactly. (The reference
        accepts a ``pq_chunks`` search param but never uses it,
        api/models.py:18 vs hnsw.py:330-341.)

        ``opq_iters`` > 0 trains an OPQ rotation first (see PQCodec.train)
        — one extra matmul per encode/query, large ADC recall gain on
        correlated data."""
        from vector_db_tpu.index.pq import PQCodec, _encode_scan

        if self._dim is None or self.size == 0:
            raise ValueError("enable_pq requires a populated index")
        ksub = min(ksub, max(2, self.size))
        self._pq = PQCodec(k=ksub, chunks=chunks, dim=self._dim)
        # train on a bounded sample of live rows (k-means cost is linear in
        # rows; 128k is plenty for 256 centroids per subspace)
        live_slots = np.asarray(sorted(self._slot_of_id.values()))
        rng = np.random.default_rng(seed)
        if live_slots.size > 131072:
            live_slots = rng.choice(live_slots, 131072, replace=False)
        sample = device_pull(self._emb[jnp.asarray(live_slots)])
        self._pq.train(sample, seed=seed, restarts=restarts,
                       opq_iters=opq_iters)
        # encode the whole device table in one streaming program (invalid
        # rows get garbage codes; has_emb masks them at query time)
        enc_chunk = 8192
        pad = (-self._capacity) % enc_chunk
        emb_enc = (
            jnp.concatenate(
                [self._emb, jnp.zeros((pad, self._dim), jnp.float32)]
            )
            if pad else self._emb
        )
        self._pq_codes = _encode_scan(
            emb_enc, self._pq.codebooks, chunk=enc_chunk,
            rotation=self._pq.rotation,
        )[: self._capacity]

    def enable_rp(self, dims: int = 128, train_sample: int = 131072,
                  seed: int = 0) -> None:
        """Projected-traversal mode (pHNSW-style): beam steps gather a PCA
        bf16 mirror x̂ = R^T x (``dims`` columns) instead of full f32 rows —
        dim·4/(dims·2)× less HBM traffic in the gather-bound hot loop —
        scored by the unbiased estimate ‖x‖² − 2 q̂·x̂ (+‖q‖² const) with
        exact f32 rerank of the final ef pool. The mirror re-projects
        lazily (one matmul) whenever the device table changes."""
        if self.graph is None or self.size == 0:
            raise ValueError("index must contain vectors before enable_rp")
        dims = int(min(dims, self._dim))
        # device-side covariance: only [dim, dim] comes to the host
        # (see _pca_proj)
        self._rp_proj = self._pca_proj(dims)
        self._rp_src = None  # force mirror rebuild

    def _rp_tables(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(x̂ bf16[capacity, dims], ‖x‖² f32[capacity]) — identity-tracked
        lazy rebuild, like the bf16 traversal mirror."""
        src = self._store.emb
        if getattr(self, "_rp_src", None) is not src:
            self._rp_table = jnp.dot(
                src, self._rp_proj, preferred_element_type=jnp.float32
            ).astype(jnp.bfloat16)
            self._rp_xsq = jnp.sum(src * src, axis=-1)
            self._rp_src = src
        return self._rp_table, self._rp_xsq

    def search_batch_rp(
        self,
        queries: np.ndarray,
        k: int,
        ef: int = 50,
        expand: int = 1,
        bucket: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Projected-traversal search (requires enable_rp). Same contract
        as search_batch."""
        if getattr(self, "_rp_proj", None) is None:
            raise ValueError("call enable_rp() first")
        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self.graph is None:
            return (np.full((b_orig, k), np.inf, np.float32),
                    np.full((b_orig, k), -1, np.int64))
        ef = max(ef, k)
        if bucket:
            def up2(v: int, lo: int = 8) -> int:
                return max(lo, 1 << (int(v) - 1).bit_length())

            ef = up2(ef, lo=16)
            k = min(up2(k, lo=8), ef)
            b_pad = up2(b_orig, lo=8) - b_orig
            if b_pad:
                queries = np.concatenate(
                    [queries,
                     np.zeros((b_pad, queries.shape[1]), np.float32)]
                )
        rp, xsq = self._rp_tables()
        q_dev = jnp.asarray(queries)
        qp = jnp.dot(q_dev, self._rp_proj,
                     preferred_element_type=jnp.float32)
        d_sq, slots = K.search_batch_rp(
            self.graph, rp, xsq, self._emb, self._has_emb, q_dev, qp,
            M=self.M, l_max=self.l_max, ef=ef, k=k,
            max_steps=self.max_steps or (2 * ef + 16), expand=expand,
        )
        d_sq = np.asarray(d_sq)[:b_orig, :k_orig]
        slots = np.asarray(slots)[:b_orig, :k_orig]
        ids = np.where(slots >= 0, self._id_of_slot[np.maximum(slots, 0)], -1)
        dists = np.where(slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)), np.inf)
        return dists.astype(np.float32), ids

    # ------------------------------------------------------------------
    def _pca_proj(self, dims: int) -> jnp.ndarray:
        """PCA projection [dim, dims] from the DEVICE-side covariance.

        The covariance ([dim, dim] ~ 2 MB) is the only thing that crosses
        to host, where a raw sample would be a ~400 MB device->host
        transfer."""
        import jax as _jax

        @_jax.jit
        def cov_fn(emb, valid):
            e = jnp.where(valid[:, None], emb, 0.0)
            c = jnp.dot(e.T, e, preferred_element_type=jnp.float32)
            return c, jnp.sum(valid.astype(jnp.float32))

        c, n = cov_fn(self._emb, self._has_emb)
        cov = device_pull(c) / max(1.0, float(n))
        _, v = np.linalg.eigh(cov.astype(np.float64))
        return jnp.asarray(v[:, ::-1][:, :dims].astype(np.float32))

    def enable_wide(self, dims: int | None = 120, seeds: int = 4096,
                    train_sample: int = 131072, seed: int = 0,
                    inline: bool = False) -> None:
        """Activate wide-beam search (see index/wide_beam.py): builds the
        PCA projection for the augmented bf16 scoring mirror and picks the
        seed set (the highest-level graph nodes — the same navigation
        hierarchy the reference's greedy descent uses, reference
        hnsw.py:356-358, scored here in one matmul instead).

        ``dims=None`` mirrors the full embedding (no projection) — exact
        bf16 traversal scores. The mirror itself rebuilds lazily per
        search when the table or the graph changed.

        Default dims=120 keeps the augmented row (dims + 8) at exactly
        128 elements, a power of two: 256-byte bf16 rows for the
        mirror-row gathers and score matmuls in the hot loop."""
        if self.graph is None or self.size == 0:
            raise ValueError("index must contain vectors before enable_wide")
        if dims is None or dims >= self._dim:
            self._wb_proj = None
        else:
            self._wb_proj = self._pca_proj(int(dims))
        self._wb_n_seeds = int(seeds)
        # inline neighbor replication: capacity*2M*dims bytes of int8 for
        # ~W x fewer gather issues in the hot loop (see
        # wide_beam.build_inline_tables); worth it below ~2M rows
        self._wb_inline = bool(inline)
        self._wb_src = None  # force mirror + seed rebuild

    def _wide_tables(self):
        """(aug mirror, seed slots) — identity-tracked lazy rebuild: any
        functional update swaps the emb/neighbors array objects, which
        invalidates the mirror (stale mirrors would score the wrong
        rows after edges move)."""
        from vector_db_tpu.index import wide_beam as WB

        src = (self._store.emb, self.graph.neighbors)
        prev = getattr(self, "_wb_src", None)
        if prev is None or prev[0] is not src[0] or prev[1] is not src[1]:
            self._wb_aug = WB.build_aug_table(
                self._store.emb, self._has_emb, self._wb_proj)
            if getattr(self, "_wb_inline", False):
                self._wb_inline_tabs = WB.build_inline_tables(
                    self.graph.neighbors[:, : 2 * self.M],
                    self._store.emb, self._has_emb, self._wb_proj)
            else:
                self._wb_inline_tabs = None
            levels = device_pull(self.graph.levels)
            live = np.nonzero(levels >= 0)[0]
            order = live[np.argsort(-levels[live], kind="stable")]
            s = min(self._wb_n_seeds, order.size)
            seeds = np.full((max(s, 1),), -1, np.int64)
            seeds[:s] = order[:s]
            self._wb_seeds = jnp.asarray(seeds.astype(np.int32))
            self._wb_src = src
        return self._wb_aug, self._wb_seeds

    def _wide_tables_pq(self):
        """PQ-decoded aug mirror (ADC traversal scores) + seeds; lazy,
        identity-tracked on the code table."""
        from vector_db_tpu.index import wide_beam as WB

        codes = self._pq_codes
        prev = getattr(self, "_wb_pq_src", None)
        if prev is None or prev is not codes:
            self._wb_pq_aug = WB.build_aug_table_pq(
                codes, self._pq.codebooks, self._pq.rotation,
                self._has_emb, self._wb_proj)
            self._wb_pq_src = codes
        self._wide_tables()  # seeds (+ exact mirror) stay fresh
        return self._wb_pq_aug, self._wb_seeds

    def search_batch_wide(
        self,
        queries: np.ndarray,
        k: int,
        ef: int = 256,
        frontier: int = 0,
        steps: int = 0,
        rerank_k: int = 0,
        bucket: bool = True,
        score: str = "exact",
        dedup_window: int = 16,
        seen_mask: bool = True,
        schedule=None,
        filter_ids=None,
        qchunk: int | None = None,
        early_exit: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Wide-beam search (requires enable_wide). Same contract as
        search_batch: (L2 dists f32[B, k], node ids int64[B, k]).
        ``schedule`` = ((F1, T1), (F2, T2), ...) overrides the fixed
        frontier/steps with a per-segment frontier width (wide early,
        narrow late — see wide_beam.wide_search).
        ``qchunk`` splits the query batch into host-side chunks of that
        size: wide frontiers gather [B, F*M, dims] candidate blocks, whose
        temporaries grow with max_frontier * chunk (about 16 GB at F=320,
        B=1024, 1M x 768). Default None auto-chunks to keep
        max_frontier * chunk <= 224 * 1024; 0 disables.
        ``filter_ids`` applies the reference's filter contract
        (hnsw.py:81-88): non-matching nodes navigate but never enter
        results (two-pool wide-beam; widen ``rerank_k``/``ef`` for very
        selective filters).

        ``score="pq"`` traverses on ADC estimates from the PQ-decoded
        mirror (requires enable_pq too) — the HNSW-over-PQ hybrid with
        wide-beam mechanics; final distances are exact either way.
        ``seen_mask=False`` drops the pre-merge pool-membership compare
        (the window dedup still kills duplicates)."""
        from vector_db_tpu.index import wide_beam as WB

        if not hasattr(self, "_wb_n_seeds"):
            raise ValueError("call enable_wide() first")
        if score == "pq" and getattr(self, "_pq", None) is None:
            raise ValueError("score='pq' requires enable_pq()")
        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self.graph is None:
            return (np.full((b_orig, k), np.inf, np.float32),
                    np.full((b_orig, k), -1, np.int64))
        if qchunk is None:
            # auto: bound max_frontier * padded_chunk by 224*1024
            fmax = frontier or max(16, min(((ef // 6 + 31) // 32) * 32,
                                           ef))
            if schedule is not None:
                fmax = max(int(f) for f, _ in schedule)
            # inline-gathering exact traversal moves [B, F*M, dims] bf16
            # blocks; PQ/aug-only traversal moves ~8x less per candidate
            inline = (getattr(self, "_wb_inline", False)
                      and score == "exact")
            budget = 262144 if inline else 1 << 20
            qchunk = 0
            if fmax * (1 << max(3, (b_orig - 1).bit_length())) > budget:
                qchunk = max(128, budget // max(1, fmax))
                qchunk = 1 << (qchunk.bit_length() - 1)
        if qchunk > 0 and b_orig > qchunk:
            parts = [
                self.search_batch_wide(
                    queries[s:s + qchunk], k=k, ef=ef, frontier=frontier,
                    steps=steps, rerank_k=rerank_k, bucket=bucket,
                    score=score, dedup_window=dedup_window,
                    seen_mask=seen_mask, schedule=schedule,
                    filter_ids=filter_ids, early_exit=early_exit)
                for s in range(0, b_orig, qchunk)
            ]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        ef = max(ef, k)
        if bucket:
            def up2(v: int, lo: int = 8) -> int:
                return max(lo, 1 << (int(v) - 1).bit_length())

            ef = up2(ef, lo=64)
            k = min(up2(k, lo=8), ef)
            b_pad = up2(b_orig, lo=8) - b_orig
            if b_pad:
                queries = np.concatenate(
                    [queries,
                     np.zeros((b_pad, queries.shape[1]), np.float32)])
        # auto (frontier/steps = 0): frontier ~ ef/6 (32-aligned),
        # 10 steps
        if not frontier:
            frontier = max(16, min(((ef // 6 + 31) // 32) * 32, ef))
        if not steps:
            steps = 10
        rerank_k = rerank_k or min(ef, max(4 * k, 64))
        if score == "pq":
            aug, seeds = self._wide_tables_pq()
        else:
            aug, seeds = self._wide_tables()
        q_dev = jnp.asarray(queries)
        qa = WB.aug_queries(q_dev, self._wb_proj, aug.shape[1])
        nbr0 = self.graph.neighbors[:, : 2 * self.M]
        inline_tabs = (getattr(self, "_wb_inline_tabs", None)
                       if score == "exact" else None)
        # mirror-row scoring: cap the per-step [B, F*W, dpa] gather temp
        # at ~2M rows (one-shot at B=1024, F=256 is a 4 GB padded gather
        # + f32 convert)
        score_chunks = 1
        seg_fs = ([f for f, _ in schedule] if schedule else [frontier])
        f_max = max(seg_fs)
        if inline_tabs is None:
            # chunk count must divide every segment's F*W candidate width
            rows = queries.shape[0] * f_max * nbr0.shape[1]
            while (rows // score_chunks > 2_097_152
                   and all((f * nbr0.shape[1]) % (2 * score_chunks) == 0
                           for f in seg_fs)):
                score_chunks *= 2
        res_mask = (jnp.asarray(self._store.filter_mask(filter_ids))
                    if filter_ids is not None else None)
        d_sq, slots = WB.wide_search(
            nbr0, aug, self._emb, self._has_emb, seeds, q_dev, qa,
            ef=ef, F=frontier, T=steps, k=k, rerank_k=rerank_k,
            dedup_window=dedup_window, seen_mask=seen_mask,
            inline_tabs=inline_tabs, score_chunks=score_chunks,
            schedule=(tuple(tuple(map(int, s)) for s in schedule)
                      if schedule else None),
            res_mask=res_mask,
            early_exit=early_exit,
        )
        d_sq = np.asarray(d_sq)[:b_orig, :k_orig]
        slots = np.asarray(slots)[:b_orig, :k_orig]
        ids = np.where(slots >= 0, self._id_of_slot[np.maximum(slots, 0)], -1)
        dists = np.where(slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)), np.inf)
        return dists.astype(np.float32), ids

    def search_batch_beam(
        self,
        queries: np.ndarray,
        k: int,
        frontier: int = 224,
        steps: int = 12,
        rerank_k: int = 0,
        hist: int = 2,
        bucket: bool = True,
        score: str = "exact",
        filter_ids=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pool-free beam search (requires enable_wide): the merge-light
        wide-beam variant — see :func:`wide_beam.beam_search`. Same
        contract as search_batch; ``score="pq"`` traverses on ADC
        estimates from the PQ-decoded mirror. ``filter_ids`` masks the
        emitted trajectory (navigation unfiltered, reference contract);
        very selective filters prefer search_batch_wide's two-pool
        mode."""
        from vector_db_tpu.index import wide_beam as WB

        if not hasattr(self, "_wb_n_seeds"):
            raise ValueError("call enable_wide() first")
        if score == "pq" and getattr(self, "_pq", None) is None:
            raise ValueError("score='pq' requires enable_pq()")
        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self.graph is None:
            return (np.full((b_orig, k), np.inf, np.float32),
                    np.full((b_orig, k), -1, np.int64))
        if bucket:
            def up2(v: int, lo: int = 8) -> int:
                return max(lo, 1 << (int(v) - 1).bit_length())

            k = up2(k, lo=8)
            b_pad = up2(b_orig, lo=8) - b_orig
            if b_pad:
                queries = np.concatenate(
                    [queries,
                     np.zeros((b_pad, queries.shape[1]), np.float32)])
        rerank_k = rerank_k or max(4 * k, 64)
        if score == "pq":
            aug, seeds = self._wide_tables_pq()
        else:
            aug, seeds = self._wide_tables()
        q_dev = jnp.asarray(queries)
        qa = WB.aug_queries(q_dev, self._wb_proj, aug.shape[1])
        nbr0 = self.graph.neighbors[:, : 2 * self.M]
        inline_tabs = (getattr(self, "_wb_inline_tabs", None)
                       if score == "exact" else None)
        res_mask = (jnp.asarray(self._store.filter_mask(filter_ids))
                    if filter_ids is not None else None)
        d_sq, slots = WB.beam_search(
            nbr0, aug, self._emb, self._has_emb, seeds, q_dev, qa,
            F=frontier, T=steps, k=k, rerank_k=rerank_k, hist=hist,
            inline_tabs=inline_tabs, res_mask=res_mask,
        )
        d_sq = np.asarray(d_sq)[:b_orig, :k_orig]
        slots = np.asarray(slots)[:b_orig, :k_orig]
        ids = np.where(slots >= 0, self._id_of_slot[np.maximum(slots, 0)], -1)
        dists = np.where(slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)), np.inf)
        return dists.astype(np.float32), ids

    def search_batch_scan(
        self,
        queries: np.ndarray,
        k: int,
        mode: str = "bf16",
        filter_ids=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact/bf16 corpus scan over THIS index's device table — no
        graph traversal. Batched scans amortize every byte read over the
        whole query batch, where a traversal reads per query. Serving
        one HNSW index can therefore pick per request: wide-beam for
        latency, this scan for batch throughput — same table, no second
        index. ``mode``: "bf16" (approximate top-k + exact rescore) or
        "exact" (f32 HIGHEST, recall 1.0).
        ``mode="blocksel"`` runs the two-phase block-min scan
        (ops.exact.block_select_search): bf16 streaming block minima +
        exact block rerank — lossless w.r.t. phase-1 scores at
        blocks_k>=k, between the other two modes on the QPS/recall
        curve. Same return contract as search_batch."""
        from vector_db_tpu.ops.exact import (approx_search_tiled,
                                             block_select_search,
                                             exact_search_tiled,
                                             rescore_exact)

        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self._emb is None:
            return (np.full((b_orig, k), np.inf, np.float32),
                    np.full((b_orig, k), -1, np.int64))
        # pow2-bucket B and k: each distinct (shape, static) combination
        # is a cold compile
        def up2(v: int, lo: int = 8) -> int:
            return max(lo, 1 << (int(v) - 1).bit_length())

        k = up2(k, lo=8)
        b_pad = up2(b_orig, lo=8) - b_orig
        if b_pad:
            queries = np.concatenate(
                [queries, np.zeros((b_pad, queries.shape[1]), np.float32)])
        q = jnp.asarray(queries)
        valid = self._has_emb
        if filter_ids is not None:
            valid = valid & jnp.asarray(self._store.filter_mask(filter_ids))
        cap = self._emb.shape[0]
        if mode == "bf16":
            emb16, x_sq = self._scan_mirror()
            d_sq, slots = approx_search_tiled(
                q, emb16, valid, k, tile=min(cap, 125000), x_sq=x_sq)
            d_sq, slots = rescore_exact(q, self._emb, slots)
        elif mode == "blocksel":
            emb16, x_sq = self._scan_mirror()
            # any pow2 tile >= 128 works (the kernel pads the corpus to
            # a tile multiple; block=128 only needs tile % 128 == 0)
            tile = min(131072, max(128, 1 << (cap - 1).bit_length()))
            d_sq, slots = block_select_search(
                q, emb16, q, x_sq, self._emb, valid, k,
                tile=tile, blocks_k=2 * k)
        else:
            d_sq, slots = exact_search_tiled(q, self._emb, valid, k,
                                             tile=min(cap, 32768))
        d_sq = np.asarray(d_sq)[:b_orig, :k_orig]
        slots = np.asarray(slots)[:b_orig, :k_orig]
        ids = np.where(slots >= 0,
                       self._id_of_slot[np.maximum(slots, 0)], -1)
        dists = np.where(slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)),
                         np.inf)
        return dists.astype(np.float32), ids

    def _scan_mirror(self):
        """Cached bf16 mirror + f32 norms for search_batch_scan; rebuilt
        when the table generation changes (inserts/deletes swap arrays).
        Keyed on the source ARRAY identity, holding the reference —
        ``id()`` alone can be recycled by a later allocation after the
        old table is freed (same bug class _emb16_src avoids)."""
        cached = getattr(self, "_scan_mirror_cache", None)
        if cached is not None and cached[0] is self._emb:
            return cached[1], cached[2]
        emb16 = self._emb.astype(jnp.bfloat16)
        x_sq = jnp.sum(self._emb * self._emb, axis=-1)
        self._scan_mirror_cache = (self._emb, emb16, x_sq)
        return emb16, x_sq

    def refresh_pq_codes(self) -> None:
        """Re-encode the device table with the existing codebooks (call
        after inserts/deletes when PQ traversal is active; encoding streams
        the whole table in one program — retraining is NOT repeated)."""
        if getattr(self, "_pq", None) is None:
            return
        from vector_db_tpu.index.pq import _encode_scan

        enc_chunk = 8192
        pad = (-self._capacity) % enc_chunk
        emb_enc = (
            jnp.concatenate(
                [self._emb, jnp.zeros((pad, self._dim), jnp.float32)]
            )
            if pad else self._emb
        )
        self._pq_codes = _encode_scan(
            emb_enc, self._pq.codebooks, chunk=enc_chunk,
            rotation=self._pq.rotation,
        )[: self._capacity]

    def search_batch_pq(
        self,
        queries: np.ndarray,
        k: int,
        ef: int = 50,
        expand: int = 1,
        rerank: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """PQ-traversal search (requires enable_pq). Same contract as
        search_batch."""
        if getattr(self, "_pq", None) is None:
            raise ValueError("call enable_pq() first")
        if self.size == 0:
            b = np.asarray(queries).shape[0]
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int64))
        ef = max(ef, k)
        q_dev = jnp.asarray(np.asarray(queries, np.float32))
        d_sq, slots = K.search_batch_pq(
            self.graph, self._pq_codes, self._pq.codebooks,
            self._emb, self._has_emb,
            q_dev, self._pq.rotate_queries(q_dev),
            M=self.M, l_max=self.l_max, ef=ef, k=k,
            max_steps=self.max_steps or (2 * ef + 16),
            pool=ef, expand=expand, rerank=rerank,
        )
        d_sq = np.asarray(d_sq)
        slots = np.asarray(slots)
        ids = np.where(slots >= 0, self._id_of_slot[np.maximum(slots, 0)], -1)
        dists = np.where(slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)), np.inf)
        return dists.astype(np.float32), ids

    def _emb_traverse(self) -> jnp.ndarray:
        """Embedding table for beam traversal: the f32 source, or a lazily
        rebuilt bf16 mirror (identity-tracked — functional updates swap the
        f32 array object, which invalidates the mirror)."""
        if self.precision != "bf16":
            return self._emb
        src = self._store.emb
        if self._emb16_src is not src:
            self._emb16 = src.astype(jnp.bfloat16)
            self._emb16_src = src
        return self._emb16

    def sync_storage(self) -> None:
        """Re-check which graph nodes still exist in storage and mask out
        the missing ones (reference semantics: nodes deleted from storage
        behind the index's back are skipped at query time, hnsw.py:117-121).
        """
        if self.graph is None:
            return
        # vectorized membership test (np.isin) — no per-id storage calls
        live = np.asarray(self.storage.get_all_ids(), np.int64)
        ids_arr = np.asarray(self._id_of_slot, np.int64)
        has = (ids_arr >= 0) & np.isin(ids_arr, live)
        self._has_emb = jnp.asarray(has)

    # ------------------------------------------------------------------
    def search(
        self, query: np.ndarray, k: int, **kwargs
    ) -> List[Tuple[Node, float]]:
        """Reference-shaped search (hnsw.py:330-374): returns [(Node, L2)]
        ascending. kwargs: ef (default 50), filter_ids (set of node ids);
        unknown kwargs ignored, as in the reference."""
        ef = int(kwargs.get("ef", 50) or 50)
        filter_ids = kwargs.get("filter_ids")
        dists, ids = self.search_batch(
            np.asarray(query, np.float32)[None, :], k, ef=ef,
            filter_ids=filter_ids,
        )
        out: List[Tuple[Node, float]] = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.storage.get(int(nid))
            if node is not None:
                out.append((node, float(d)))
        return out

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        ef: int = 50,
        filter_ids: Optional[Set[int]] = None,
        pool: int = 0,
        max_steps: int = 0,
        expand: int = 1,
        bucket: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Device fast path: (L2 dists f32[B, k], node ids int64[B, k]);
        missing results padded with (inf, -1).

        ``bucket=True`` (default) rounds the compile-relevant shapes — query
        batch B, ef, k — up to power-of-two buckets and slices the result,
        so a service sees a handful of kernel compiles instead of one per
        distinct request shape. Semantics are unaffected: a larger ef only
        improves recall, and padded queries/columns are discarded.
        """
        queries = np.asarray(queries, np.float32)
        b_orig, k_orig = queries.shape[0], k
        if self.size == 0 or self.graph is None:
            return (
                np.full((b_orig, k), np.inf, np.float32),
                np.full((b_orig, k), -1, np.int64),
            )
        ef = max(ef, k)
        if bucket:
            def up2(v: int, lo: int = 8) -> int:
                return max(lo, 1 << (int(v) - 1).bit_length())

            ef = up2(ef, lo=16)
            k = min(up2(k, lo=8), ef)
            b_pad = up2(b_orig, lo=8) - b_orig
            if b_pad:
                queries = np.concatenate(
                    [queries, np.zeros((b_pad, queries.shape[1]), np.float32)]
                )
        use_filter = filter_ids is not None
        filter_mask = (
            jnp.asarray(self._store.filter_mask(filter_ids))
            if use_filter else None
        )
        max_steps = max_steps or self.max_steps or (2 * ef + 16)
        q_dev = jnp.asarray(np.asarray(queries, np.float32))
        d_sq, slots = K.search_batch(
            self.graph, self._emb_traverse(), self._has_emb,
            q_dev, filter_mask,
            M=self.M, l_max=self.l_max, ef=ef, k=k,
            max_steps=max_steps, use_filter=use_filter, pool=max(pool, ef),
            expand=expand,
        )
        # re-score the k survivors from the f32 table at HIGHEST precision:
        # traversal scores only SELECT (DEFAULT-precision matvecs — the
        # 6-pass multiply slowed builds/search 2.7x); reported
        # order/distances must honor the exactness contract
        from vector_db_tpu.ops.exact import rescore_exact

        d_sq, slots = rescore_exact(q_dev, self._emb, slots)
        d_sq = np.asarray(d_sq)[:b_orig, :k_orig]
        slots = np.asarray(slots)[:b_orig, :k_orig]
        ids = np.where(slots >= 0, self._id_of_slot[np.maximum(slots, 0)], -1)
        dists = np.where(slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)), np.inf)
        return dists.astype(np.float32), ids

    # ------------------------------------------------------------------
    @property
    def entry_node_id(self) -> Optional[int]:
        if self.graph is None:
            return None
        e = int(self.graph.entry)
        return int(self._id_of_slot[e]) if e >= 0 else None

    @property
    def max_level(self) -> int:
        return int(self.graph.entry_level) if self.graph is not None else -1

    def neighbors_of(self, node_id: int, level: int) -> List[int]:
        """Introspection: the node's neighbor ids at ``level`` (used by
        graph-structural tests, mirrors reference InternalNode.neighbors)."""
        slot = self._slot_of_id.get(node_id)
        if slot is None or self.graph is None:
            return []
        start = K.level_col_start(level, self.M)
        width = K.level_width(level, self.M)
        row = np.asarray(self.graph.neighbors[slot, start : start + width])
        return [int(self._id_of_slot[s]) for s in row if s >= 0]

    # ------------------------------------------------------------------
    def snapshot_for_save(self) -> Optional[dict]:
        """Capture a consistent point-in-time view of the index for a
        (possibly deferred) checkpoint write. The device->host pull
        happens HERE, on the calling thread: device arrays are immutable
        jnp values so holding refs would be a valid snapshot, but pulling
        them from the background flush worker would have two threads
        drive the device at once. The caller pays the pull; the flush
        worker only writes the npz."""
        if self.index_file is None or self.graph is None:
            return None
        # split adjacency checkpoint: only ~1/M of nodes have any
        # level>=1 row, so the dense [capacity, M*(l_max+2)] table is
        # ~70% -1 padding. Pulling/writing the level-0 block for every
        # row plus a gathered upper block for just the multi-level slots
        # cuts checkpoint bytes ~3x — this is the per-flush cost on the
        # post-threshold ingest path.
        # levels are sampled host-side at every insert (and -1'd on
        # delete), so the host mirror is authoritative — no pull needed
        levels_np = getattr(self, "_levels_host", None)
        if levels_np is None:
            levels_np = device_pull(self.graph.levels)
        else:
            levels_np = levels_np.copy()
        upper = np.flatnonzero(levels_np >= 1).astype(np.int32)
        # pad the gather to a power-of-two bucket so flush-after-flush
        # reuses one compiled program per bucket
        u_pad = max(8, 1 << (max(1, upper.size) - 1).bit_length())
        upper_padded = np.full((u_pad,), 0, np.int32)
        upper_padded[: upper.size] = upper
        m2 = 2 * self.M
        cap = self.graph.neighbors.shape[0]
        rest = self.graph.neighbors.shape[1] - m2
        packed = device_pull(_pack_snapshot(
            self.graph.neighbors, jnp.asarray(upper_padded),
            self.graph.entry, self.graph.entry_level, m2=m2))
        n0 = cap * m2
        snap = {
            "neighbors0": packed[2 : 2 + n0].reshape(cap, m2),
            "neighbors_up": packed[2 + n0:].reshape(u_pad, rest)
            [: upper.size],
            "upper_slots": upper,
            "levels": levels_np,
            "entry": np.asarray(packed[0]),
            "entry_level": np.asarray(packed[1]),
            "id_of_slot": self._id_of_slot.copy(),
            "M": self.M,
            "ef_construction": self.ef_construction,
            "l_max": self.l_max,
        }
        # trained auxiliary state (same pattern as IvfIndex save_index):
        # PCA projections and PQ codebooks are minutes of training at 1M
        # scale — a reloaded index must not silently retrain on first
        # search. Mirrors/codes regenerate from the embedding table in
        # one streaming device program.
        if getattr(self, "_rp_proj", None) is not None:
            snap["rp_proj"] = self._rp_proj
        if getattr(self, "_wb_proj", None) is not None:
            snap["wb_proj"] = self._wb_proj
        if hasattr(self, "_wb_n_seeds"):
            snap["wb_n_seeds"] = np.asarray(self._wb_n_seeds)
        pq = getattr(self, "_pq", None)
        if pq is not None and pq.codebooks is not None:
            snap["pq_codebooks"] = pq.codebooks
            if pq.rotation is not None:
                snap["pq_rotation"] = pq.rotation
        for k, v in snap.items():
            if not isinstance(v, (int, float, np.ndarray)):
                snap[k] = device_pull(v)
        return snap

    def write_snapshot(self, snap: dict) -> None:
        """Write a snapshot from :meth:`snapshot_for_save` to the index
        file. Heavy half of a checkpoint (device->host pull + npz write);
        safe to run off-thread. Writes to a temp file then renames, so a
        crash mid-write never corrupts the previous checkpoint."""
        self.index_file.parent.mkdir(parents=True, exist_ok=True)
        f32_keys = ("rp_proj", "wb_proj", "pq_codebooks", "pq_rotation")
        arrays = {}
        for k, v in snap.items():
            if not isinstance(v, (int, float, np.ndarray)):
                v = device_pull(v)
            arrays[k] = v.astype(np.float32) if k in f32_keys else v
        # uncompressed: threshold flushes fire once per ingest batch, and
        # zlib over a 1M-capacity int32 graph costs seconds per flush —
        # write time matters more than disk bytes on the serving path
        tmp = self.index_file.with_name(self.index_file.name + ".tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, self.index_file)

    def save_index(self) -> None:
        """Persist graph structure + hyperparams (reference save_index,
        hnsw.py:376-398 — pickle there, npz of the tables here). Embeddings
        are NOT saved: they live in storage, as in the reference."""
        snap = self.snapshot_for_save()
        if snap is not None:
            self.write_snapshot(snap)

    def load_index(self) -> None:
        """Load graph structure; embeddings re-fetched from storage per live
        id (reference load_index, hnsw.py:400-423 + reopen test pattern)."""
        if self.index_file is None or not self.index_file.exists():
            return
        with np.load(self.index_file) as z:
            self.M = int(z["M"])
            self.M_max = self.M
            self.M_max0 = self.M * 2
            self.ef_construction = int(z["ef_construction"])
            self.l_max = int(z["l_max"])
            self.level_mult = 1.0 / math.log(self.M) if self.M > 1 else 1.0
            if "neighbors" in z:  # dense legacy checkpoints
                neighbors = np.asarray(z["neighbors"])
            else:  # split format (see snapshot_for_save)
                nbr0 = np.asarray(z["neighbors0"])
                nbr_up = np.asarray(z["neighbors_up"])
                upper = np.asarray(z["upper_slots"])
                cap = nbr0.shape[0]
                neighbors = np.full(
                    (cap, K.ncols(self.M, self.l_max)), -1, np.int32)
                neighbors[:, : 2 * self.M] = nbr0
                if upper.size:
                    neighbors[upper, 2 * self.M:] = nbr_up
            levels = np.asarray(z["levels"])
            entry = np.asarray(z["entry"])
            entry_level = np.asarray(z["entry_level"])
            id_of_slot = np.asarray(z["id_of_slot"])
            aux = {name: np.asarray(z[name]) for name in
                   ("rp_proj", "wb_proj", "wb_n_seeds", "pq_codebooks",
                    "pq_rotation") if name in z}

        self.graph = K.Graph(
            neighbors=jnp.asarray(neighbors),
            levels=jnp.asarray(levels),
            entry=jnp.asarray(entry),
            entry_level=jnp.asarray(entry_level),
        )
        self._store = DeviceVectorStore(
            capacity=neighbors.shape[0], on_grow=self._grow_graph
        )
        self._store.import_id_map(id_of_slot)
        self._levels_host = levels.copy()

        # hydrate the device embedding table from storage in ONE bulk read
        # (per-id get_embedding loops cost minutes at 1M capacity); ids
        # missing from storage — deleted behind the index's back — stay
        # invalid, matching the reference's skip-at-query-time tolerance
        if self._slot_of_id:
            ids = np.fromiter(self._slot_of_id.keys(), np.int64,
                              count=len(self._slot_of_id))
            slots = np.fromiter(self._slot_of_id.values(), np.int64,
                                count=len(self._slot_of_id))
            rows, found = self.storage.get_embeddings(ids)
            if found.any():
                dim = rows.shape[1]
                self._store.ensure_dim(dim)
                emb = np.zeros((self._capacity, dim), np.float32)
                has = np.zeros((self._capacity,), bool)
                emb[slots[found]] = rows[found]
                has[slots[found]] = True
                self._store.emb = jnp.asarray(emb)
                self._store.valid = jnp.asarray(has)

        # restore trained auxiliary state WITHOUT retraining: mirrors
        # rebuild lazily (identity-tracked); PQ codes re-encode in one
        # streaming program
        if "rp_proj" in aux:
            self._rp_proj = jnp.asarray(aux["rp_proj"])
            self._rp_src = None
        if "wb_proj" in aux or "wb_n_seeds" in aux:
            self._wb_proj = (jnp.asarray(aux["wb_proj"])
                             if "wb_proj" in aux else None)
            self._wb_n_seeds = int(aux.get("wb_n_seeds", 4096))
            self._wb_src = None
        if "pq_codebooks" in aux and self._dim is not None:
            from vector_db_tpu.index.pq import PQCodec

            cb = aux["pq_codebooks"]
            pq = PQCodec(k=cb.shape[1], chunks=cb.shape[0],
                         dim=self._dim)
            pq.codebooks = jnp.asarray(cb)
            if "pq_rotation" in aux:
                pq.rotation = jnp.asarray(aux["pq_rotation"])
            self._pq = pq
            self.refresh_pq_codes()

        self.recover_unlinked()

    def recover_unlinked(self) -> int:
        """Crash-consistency repair: link storage rows the graph never
        committed. ``insert_nodes`` is two-phase (storage ``save_many``
        first — reference hnsw.py:150 — then the graph edge commit); a
        crash between the phases, or after any insert but before the
        next threshold flush, leaves rows durable in storage but absent
        from the checkpointed graph. Rescanning storage on resume made
        them LOOK live while no traversal could ever reach them. On
        load, re-insert every such row (idempotent: already-linked ids
        are skipped by insert_arrays). Returns the number repaired."""
        if self.graph is None:
            return 0
        try:
            live = np.asarray(self.storage.get_all_ids(), np.int64)
        except Exception:
            return 0
        if live.size == 0:
            return 0
        missing = [int(i) for i in live if int(i) not in self._slot_of_id]
        if not missing:
            return 0
        get_embeddings = getattr(self.storage, "get_embeddings", None)
        if get_embeddings is not None:
            rows, found = get_embeddings(np.asarray(missing, np.int64))
            ids = [m for m, f in zip(missing, found) if f]
            embs = rows[found]
        else:
            pairs = [(m, self.storage.get(m)) for m in missing]
            ids = [m for m, n in pairs if n is not None]
            if not ids:
                return 0
            embs = np.stack([np.asarray(n.embedding, np.float32)
                             for _, n in pairs if n is not None])
        if not ids:
            return 0
        self.insert_arrays(ids, embs)
        return len(ids)
