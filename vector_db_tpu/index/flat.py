"""Flat (exact brute-force) index — fused matmul + top-k.

No reference analog (the reference's only exact path is the in-test brute
force used as recall ground truth, tests/indexing/test_hnsw.py:127-153);
here it is a first-class index: the recall oracle for every ANN mode and a
production path in its own right — one matmul scores a whole query
batch against the corpus.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

import jax.numpy as jnp
import numpy as np

from vector_db_tpu.runtime import device_pull
from vector_db_tpu.ops.exact import (
    approx_search_tiled,
    exact_search,
    exact_search_tiled,
    rescore_exact,
)
from vector_db_tpu.storage import InMemoryNodeStorage, NodeStorage
from vector_db_tpu.storage.device_store import DeviceVectorStore
from vector_db_tpu.types import Node

MIN_CAPACITY = 256
# Above this corpus size, stream the corpus in tiles instead of one matmul.
SINGLE_TILE_LIMIT = 262144


class FlatIndex:
    def __init__(
        self,
        storage: Optional[NodeStorage] = None,
        capacity: int = MIN_CAPACITY,
        index_file=None,
        metric: str = "l2",
        precision: str = "f32",
        bf16_guard: str = "warn",
        bf16_guard_recall: float = 0.9,
    ) -> None:
        if metric not in ("l2", "cosine"):
            raise ValueError(f"Unknown metric: {metric}")
        if precision not in ("f32", "bf16", "blocksel", "blocksel2p"):
            raise ValueError(f"Unknown precision: {precision}")
        # cosine: rows are L2-normalized at insert and queries at search, so
        # the same fused matmul kernel serves both metrics; on normalized
        # vectors cos_dist = l2_sq / 2. (The reference is L2-only,
        # util/distance.py:3-4; its default MiniLM embedder normalizes, so
        # L2 ranking there is already cosine ranking — here it's explicit.)
        self.metric = metric
        # precision="bf16": scan a bf16 mirror of the table with an
        # approximate top-k (lax.approx_min_k), then rescore exactly. The
        # mirror refreshes lazily (one cast pass) after mutations; f32
        # rows remain the source of truth.
        # precision="blocksel" / "blocksel2p": three- / two-phase
        # block-select scans over a PCA bf16 mirror (ops/exact.py
        # block_select_search_3p / _2p, phase 1 the block top-m scan of
        # ops/pallas/block_topm.py) with exact reported distances. The
        # mirror (PCA projection + projected table) rebuilds lazily after
        # mutations.
        self.precision = precision
        if bf16_guard not in ("warn", "refuse", "off"):
            raise ValueError(f"Unknown bf16_guard: {bf16_guard}")
        # bf16 selection noise exceeds neighbor gaps on unnormalized
        # low-dim corpora (a SIFT-like 128-d corpus loses far more recall
        # than clustered 768-d — the truncation error scales with
        # ||x||^2 while neighbor gaps don't). A user
        # who pins precision="bf16" without autotune gets no signal, so
        # the mirror self-calibrates: live rows are queried against
        # both the bf16 and the exact path and the measured recall is
        # kept in ``bf16_calibration``; below ``bf16_guard_recall`` the
        # guard warns (default) or refuses.
        self.bf16_guard = bf16_guard
        self.bf16_guard_recall = float(bf16_guard_recall)
        self.bf16_calibration: Optional[float] = None
        self._calibrated_size = 0
        self.storage = storage or InMemoryNodeStorage()
        self.index_file = Path(index_file) if index_file else None
        self._store = DeviceVectorStore(capacity=capacity)
        self._mirror = None  # (emb_bf16, x_sq) cache
        self._mirror_stale = True
        self._proj = None  # (proj, tab_bf16, x_sq) blocksel mirror
        self._proj_stale = True

    @property
    def size(self) -> int:
        return self._store.size

    def insert_nodes(self, nodes: Sequence[Node]) -> None:
        if not nodes:
            return
        self.storage.save_many(nodes)
        seen: Set[int] = set()
        fresh = []
        for n in nodes:  # dedupe against the store AND within the batch
            if n.id in self._store or n.id in seen:
                continue
            seen.add(n.id)
            fresh.append(n)
        if not fresh:
            return
        embs = np.stack([np.asarray(n.embedding, np.float32) for n in fresh])
        if self.metric == "cosine":
            embs = embs / np.maximum(
                np.linalg.norm(embs, axis=1, keepdims=True), 1e-12
            )
        self._store.ensure_dim(embs.shape[1])
        slots = self._store.take_slots([n.id for n in fresh])
        self._store.write(slots, embs)
        self._mirror_stale = True
        self._proj_stale = True

    def insert_node(self, node: Node) -> None:
        self.insert_nodes([node])

    def build_index(self, nodes: Sequence[Node]) -> None:
        self.insert_nodes(nodes)

    def delete_node(self, node_id: int) -> None:
        if self._store.release(node_id) is None:
            return
        self._mirror_stale = True
        self._proj_stale = True
        if hasattr(self.storage, "delete"):
            self.storage.delete(node_id)

    def _bf16_mirror(self):
        """bf16 copy of the table + f32 row norms, refreshed after
        mutations (one streaming cast over the table)."""
        if self._mirror is None or self._mirror_stale:
            import jax

            from vector_db_tpu.ops.distance import squared_norms

            emb = self._store.emb
            self._mirror = (
                emb.astype(jnp.bfloat16),
                jax.jit(squared_norms)(emb),
            )
            self._mirror_stale = False
        return self._mirror

    def _proj_mirror(self, dims: int = 128):
        """(proj f32[dim, ds], tab bf16[rows, ds], x_sq f32[rows]) — PCA
        mirror for the blocksel scan, its rows the capacity padded once to
        the block top-m kernel's tiles (``block_topm.pad_mirror``); the
        covariance is computed on the device, so only [dim, dim] comes to
        the host."""
        if self._proj is None or self._proj_stale:
            import jax

            from vector_db_tpu.ops.pallas.block_topm import pad_mirror

            emb = self._store.emb
            valid = self._store.valid

            @jax.jit
            def cov_fn(e, v):
                e = jnp.where(v[:, None], e, 0.0)
                return jnp.dot(e.T, e, preferred_element_type=jnp.float32)

            cov = device_pull(cov_fn(emb, valid)) / max(1, self.size)
            _, v = np.linalg.eigh(cov.astype(np.float64))
            ds = min(dims, emb.shape[1])
            proj = jnp.asarray(v[:, ::-1][:, :ds].astype(np.float32))
            tab = jnp.dot(emb, proj,
                          preferred_element_type=jnp.float32
                          ).astype(jnp.bfloat16)
            x_sq = jnp.sum(emb * emb, axis=-1)
            tab, x_sq = pad_mirror(tab, x_sq)
            self._proj = (proj, tab, x_sq)
            self._proj_stale = False
        return self._proj

    def _calibrate_bf16(self) -> None:
        """Self-check the bf16 mirror: recall@10 of bf16 selection vs the
        exact scan on up to 64 live rows, re-run when the corpus doubles.
        Warns (or refuses, per ``bf16_guard``) below ``bf16_guard_recall``
        — the failure this catches is silent: bf16 truncation noise
        exceeding neighbor gaps on unnormalized corpora."""
        if self.bf16_guard == "off" or self.size < 256:
            return
        if self._calibrated_size and self.size < 2 * self._calibrated_size:
            return
        import warnings

        nq, kcal = 64, 10
        valid = self._store.valid
        slots = jnp.nonzero(valid, size=nq, fill_value=0)[0]
        qcal = self._store.emb[slots]
        emb16, x_sq = self._bf16_mirror()
        _, approx = approx_search_tiled(
            qcal, emb16, valid, kcal,
            tile=min(self._store.capacity, 125000), x_sq=x_sq)
        _, exact = exact_search_tiled(
            qcal, self._store.emb, valid, kcal,
            tile=min(self._store.capacity, 65536))
        a, e = device_pull(approx), device_pull(exact)
        hits = sum(
            len(set(a[i].tolist()) & set(e[i].tolist())) for i in range(nq)
        )
        want = int((e >= 0).sum())
        self.bf16_calibration = hits / max(1, want)
        self._calibrated_size = self.size
        if self.bf16_calibration < self.bf16_guard_recall:
            msg = (
                f"bf16 scan calibration recall@{kcal} = "
                f"{self.bf16_calibration:.3f} < {self.bf16_guard_recall} "
                f"on {self.size} live rows: bf16 truncation noise exceeds "
                "this corpus's neighbor gaps (typical on unnormalized "
                "low-dim data). Use precision='blocksel' (exact, "
                "comparable QPS) or 'f32', or normalize the corpus. Set "
                "bf16_guard='off' to silence."
            )
            if self.bf16_guard == "refuse":
                raise RuntimeError(msg)
            warnings.warn(msg, stacklevel=3)

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_ids: Optional[Set[int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(dists f32[B, k], node ids int64[B, k]), (inf, -1) padded;
        distances are L2 (metric='l2') or cosine distance (metric='cosine')."""
        q = np.asarray(queries, np.float32)
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        if self.size == 0:
            return (
                np.full((q.shape[0], k), np.inf, np.float32),
                np.full((q.shape[0], k), -1, np.int64),
            )
        valid = self._store.valid
        if filter_ids is not None:
            valid = valid & jnp.asarray(self._store.filter_mask(filter_ids))
        if self.precision == "bf16":
            self._calibrate_bf16()
            emb16, x_sq = self._bf16_mirror()
            d_sq, slots = approx_search_tiled(
                jnp.asarray(q), emb16, valid, k,
                tile=min(self._store.capacity, 125000), x_sq=x_sq,
            )
            # selection ran in bf16; report full-precision distances
            d_sq, slots = rescore_exact(jnp.asarray(q), self._store.emb, slots)
        elif self.precision == "blocksel":
            from vector_db_tpu.ops.exact import block_select_search_3p

            proj, tab, x_sq = self._proj_mirror()
            qd = jnp.asarray(q)
            qp = jnp.dot(qd, proj, preferred_element_type=jnp.float32)
            d_sq, slots = block_select_search_3p(
                qd, tab, qp, x_sq, self._store.emb, valid, k,
                blocks_k=max(2 * k, 20), rows_k=max(8 * k, 80),
            )
        elif self.precision == "blocksel2p":
            # two-phase successor: the block top-m scan emits row
            # candidates directly (no block selection / mirror block
            # gather / re-score pass) — same exact final distances
            from vector_db_tpu.ops.exact import block_select_search_2p

            proj, tab, x_sq = self._proj_mirror()
            qd = jnp.asarray(q)
            qp = jnp.dot(qd, proj, preferred_element_type=jnp.float32)
            # the rank-m in-block condition only bites when >m true
            # neighbors share one 128-row slot block, so m scales with k
            # rather than paying 2x the scan's output at small k
            d_sq, slots = block_select_search_2p(
                qd, tab, qp, x_sq, self._store.emb, valid, k,
                block=128, m=2 if k <= 16 else 4, rows_k=max(8 * k, 80),
            )
        elif self._store.capacity <= SINGLE_TILE_LIMIT:
            d_sq, slots = exact_search(
                jnp.asarray(q), self._store.emb, valid, k
            )
        else:
            d_sq, slots = exact_search_tiled(
                jnp.asarray(q), self._store.emb, valid, k
            )
        d_sq = np.asarray(d_sq)
        slots = np.asarray(slots)
        ids = self._store.ids_of(slots)
        if self.metric == "cosine":
            # on unit vectors: cos_dist = 1 - cos = ||a-b||^2 / 2
            dists = np.where(slots >= 0, np.maximum(d_sq, 0.0) / 2.0, np.inf)
        else:
            dists = np.where(
                slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)), np.inf
            )
        return dists.astype(np.float32), ids

    def save_index(self) -> None:
        """Persist the slot->id map; embeddings rehydrate from storage."""
        if self.index_file is None or self._store.emb is None:
            return
        self.index_file.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            self.index_file, id_of_slot=self._store.export_id_map()
        )

    def load_index(self) -> None:
        if self.index_file is None or not self.index_file.exists():
            return
        with np.load(self.index_file) as z:
            id_of_slot = np.asarray(z["id_of_slot"])
        nodes = []
        for nid in id_of_slot[id_of_slot >= 0]:
            node = self.storage.get(int(nid))
            if node is not None:
                nodes.append(node)
        self.insert_nodes(nodes)

    def search(self, query: np.ndarray, k: int, **kwargs) -> List[Tuple[Node, float]]:
        dists, ids = self.search_batch(
            np.asarray(query, np.float32)[None, :], k,
            filter_ids=kwargs.get("filter_ids"),
        )
        out = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.storage.get(int(nid))
            if node is not None:
                out.append((node, float(d)))
        return out
