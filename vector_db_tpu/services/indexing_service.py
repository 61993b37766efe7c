"""HNSW index lifecycle service.

Parity target: reference ``IndexingService``
(src/vector_db/services/indexing_service.py:14-144): loads M /
ef_construction / flush_threshold from the YAML config, seeds the level rng
with 42, derives a default index file from the storage base path, tracks
``_index_loaded`` / ``_index_modified``, and flushes the index to disk once
``index_size >= flush_threshold`` (after which every insert saves, matching
the reference's observable behavior, indexing_service.py:85-89,137-144).

Additions over the reference: ``insert_nodes`` batched ingest (single
device program per batch) and ``search_batch`` passthrough.
"""

from __future__ import annotations

import logging
import random
import threading
from pathlib import Path
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from vector_db_tpu.config import load_config
from vector_db_tpu.index.hnsw import HNSW
from vector_db_tpu.index.ivf import DEFAULT_ADC, check_adc
from vector_db_tpu.storage import MMapNodeStorage, NodeStorage
from vector_db_tpu.types import Node

logger = logging.getLogger(__name__)


class IndexingService:
    def __init__(
        self,
        storage: NodeStorage,
        config_path: Union[str, Path, Mapping[str, Any]],
        index_file: Optional[str] = None,
    ) -> None:
        """``config_path`` is a YAML file or an already-parsed config
        mapping (merged over the defaults either way)."""
        self.storage = storage
        config = load_config(config_path)
        index_config = config.get("index", {})
        M = index_config.get("M", 16)
        ef_construction = index_config.get("ef_construction", 200)
        # Index family selection — the reference's API accepts IVF params
        # (QueryRequest.n_probe, api/models.py:20) but only ever builds HNSW
        # (indexing_service.py:56-64); here `index.type` actually selects.
        self.index_type = str(index_config.get("type", "hnsw")).lower()

        if index_file:
            self.index_file = Path(index_file)
        elif isinstance(storage, MMapNodeStorage):
            base = storage.embedding_file.parent / storage.embedding_file.stem.replace(
                ".embeddings", ""
            )
            self.index_file = base.with_suffix(".index.npz")
        else:
            raise ValueError(
                "index_file is required for non-mmap storage backends"
            )

        # Optional PQ acceleration (config: index.pq: {chunks, ksub,
        # min_size}): once the index holds min_size nodes, codebooks train
        # and HNSW traversal switches to ADC scoring with exact rerank.
        # (The reference accepts a pq_chunks search param but never uses it,
        # api/models.py:18 vs hnsw.py:330-341 — here it works.)
        pq_cfg = index_config.get("pq") or {}
        self._pq_chunks = int(pq_cfg.get("chunks", 0) or 0)
        self._pq_ksub = int(pq_cfg.get("ksub", 256))
        self._pq_min_size = int(pq_cfg.get("min_size", 4096))
        # OPQ rotation iterations (0 = plain PQ); big ADC recall gain on
        # correlated data for one extra matmul per query/encode
        self._pq_opq_iters = int(pq_cfg.get("opq_iters", 0))
        # residual IVFADC is the recall-correct default for index.type: ivf
        self._pq_residual = bool(pq_cfg.get("residual", True))
        # probe-mode LUT scoring formulation (IvfIndex.search_batch adc=),
        # one of ivf.ADC_MODES; refused at load when unknown
        self._pq_adc = check_adc(str(pq_cfg.get("adc", DEFAULT_ADC)))
        self._pq_active = False
        # Residual-projection scoring (config: index.rp: {dims, min_size}) —
        # the gather-free bf16 IVF mode; preferred over pq when both are set
        rp_cfg = index_config.get("rp") or {}
        self._rp_dims = int(rp_cfg.get("dims", 0) or 0)
        self._rp_min_size = int(rp_cfg.get("min_size", 4096))
        self._rp_active = False
        # Wide-beam traversal (config: index.wide: {dims, seeds, frontier,
        # steps, min_size}) — the frontier-parallel graph search
        # (index/wide_beam.py); preferred over rp/pq for unfiltered hnsw
        # queries once active. dims: 0 = full-dim mirror.
        wide_cfg = index_config.get("wide") or {}
        self._wide_on = bool(wide_cfg.get("enabled", bool(wide_cfg)))
        # 120 keeps the augmented mirror row at exactly 128 elements (see
        # HNSW.enable_wide)
        self._wide_dims = int(wide_cfg.get("dims", 120) or 0) or None
        self._wide_seeds = int(wide_cfg.get("seeds", 4096))
        self._wide_frontier = int(wide_cfg.get("frontier", 0))
        self._wide_steps = int(wide_cfg.get("steps", 0))
        # window dedup alone by default; set seen_mask: true to keep the
        # pre-merge pool-membership compare
        self._wide_seen = bool(wide_cfg.get("seen_mask", False))
        if "merge_kernel" in wide_cfg:
            raise ValueError(
                "index.wide.merge_kernel is no longer supported: the pool "
                "merge always runs lax.approx_min_k; remove the key")
        self._wide_min_size = int(wide_cfg.get("min_size", 4096))
        # mode: "pool" (wide_search, ef-wide best-so-far pool) or "beam"
        # (beam_search — pool-free, merge-light; see index/wide_beam.py)
        self._wide_mode = str(wide_cfg.get("mode", "pool"))
        self._wide_hist = int(wide_cfg.get("hist", 2))
        # optional frontier schedule [[F1, T1], [F2, T2], ...] (pool
        # mode): overrides frontier/steps — wide early, narrow late
        sched = wide_cfg.get("schedule")
        self._wide_schedule = (
            tuple((int(f), int(t)) for f, t in sched) if sched else None)
        # batch sizes >= this route to the bf16 scan instead of the
        # graph (scans amortize device-memory reads over the batch; 0
        # disables). Same table.
        self._scan_batch_threshold = int(
            index_config.get("scan_batch_threshold", 0) or 0)
        # Filtered-query engine (index.filtered_engine: scan | graph).
        # "scan" (default) serves filter_ids queries with the masked
        # bf16 corpus scan: the scan computes every row's distance
        # anyway, so masking non-matching rows is free and it returns
        # the TRUE filtered top-k, where a selective filter starves the
        # two-pool wide graph's result pool. "graph" keeps the
        # reference's navigate-but-exclude traversal
        # (reference hnsw.py:89-134 filter contract) for parity.
        self._filtered_engine = str(
            index_config.get("filtered_engine", "scan"))
        self._wide_active = False
        # Calibrated mode routing (config: index.autotune: {target_recall,
        # sample, k, ef_ladder, min_size}) — measures each mode's recall
        # and cost against on-device exact ground truth and serves the
        # cheapest one meeting the target (services/autotune.py).
        # Takes precedence over scan_batch_threshold/wide for unfiltered
        # hnsw queries; per-request override via params.target_recall.
        at_cfg = index_config.get("autotune") or {}
        self._autotune = None
        self._autotune_min_size = int(at_cfg.get("min_size", 4096))
        if at_cfg.get("enabled", bool(at_cfg)):
            from vector_db_tpu.services.autotune import AutoTuner

            self._autotune = AutoTuner(
                target_recall=float(at_cfg.get("target_recall", 0.95)),
                sample=int(at_cfg.get("sample", 256)),
                k=int(at_cfg.get("k", 10)),
                ef_ladder=tuple(
                    int(e) for e in at_cfg.get(
                        "ef_ladder", (64, 128, 256, 512, 1024))),
            )

        rng = random.Random(42)
        if self.index_type == "hnsw":
            self.index = HNSW(
                M=M,
                ef_construction=ef_construction,
                rng=rng,
                storage=storage,
                index_file=self.index_file,
                precision=str(index_config.get("precision", "f32")),
            )
        elif self.index_type == "flat":
            from vector_db_tpu.index.flat import FlatIndex

            self.index = FlatIndex(
                storage=storage, index_file=self.index_file,
                metric=str(index_config.get("metric", "l2")),
                precision=str(index_config.get("precision", "f32")),
                bf16_guard=str(index_config.get("bf16_guard", "warn")),
                bf16_guard_recall=float(
                    index_config.get("bf16_guard_recall", 0.9)),
            )
            if self.index_file.exists():
                self.index.load_index()
        elif self.index_type == "ivf":
            from vector_db_tpu.index.ivf import IvfIndex

            self.ivf_k = int(index_config.get("ivf_k", 100))
            self.index = IvfIndex(
                k=self.ivf_k, storage=storage, index_file=self.index_file
            )
            # the service owns persistence (threshold flush); per-add
            # npz rewrites are O(corpus) and redundant under it
            self.index.autosave = False
            self._ivf_pending: List[Node] = []
        elif self.index_type == "sharded-hnsw":
            from vector_db_tpu.parallel.sharded import ShardedHNSW

            dim = int(config.get("embedding", {}).get("dimension", 384))
            cap_total = int(config.get("vector_db", {}).get(
                "capacity", 1_000_000
            ))
            import jax as _jax

            n_dev = len(_jax.devices())
            # index.slices > 1 builds the multi-slice ("slice", "shard")
            # mesh: hierarchical merges send only B·k pairs per slice
            # across the outer axis
            n_slices = int(index_config.get("slices", 1) or 1)
            mesh = None
            if n_slices > 1:
                from vector_db_tpu.parallel.mesh import make_mesh_2d

                if n_dev % n_slices:
                    raise ValueError(
                        f"index.slices={n_slices} must divide the "
                        f"{n_dev} visible devices"
                    )
                mesh = make_mesh_2d(n_slices, n_dev // n_slices)
            self.index = ShardedHNSW(
                M=M, ef_construction=ef_construction, dim=dim, mesh=mesh,
                capacity_per_shard=max(256, cap_total // n_dev),
            )
            if self.index_file.exists():
                self.index.load_index(self.index_file)
        else:
            raise ValueError(f"Unknown index type: {self.index_type}")
        self._index_loaded = self.index_file.exists()
        self._index_modified = False
        self.flush_threshold = index_config.get("flush_threshold", 1000)
        # Host-side ingest lock: device state updates are functional, but
        # the id<->slot maps and storage mutate in place (the reference has
        # no locking at all, SURVEY.md §5 — concurrent writers would race).
        self._lock = threading.RLock()
        # Async threshold flush for BATCHED inserts (index.flush_async,
        # default on): checkpoint writes pull multi-MB graph tables
        # device->host — serializing that into every post-threshold batch
        # would stall ingest.
        # A single worker writes the latest snapshot (latest-wins; device
        # arrays are immutable so a snapshot is just refs + an id-map
        # copy). The reference-parity single-node path still flushes
        # synchronously (reference indexing_service.py:137-144: file
        # exists as soon as the threshold-crossing insert returns).
        self._flush_async = bool(index_config.get("flush_async", True))
        self._flush_cv = threading.Condition()
        self._flush_pending: Optional[dict] = None
        self._flush_busy = False
        self._flush_thread: Optional[threading.Thread] = None

    def is_index_loaded(self) -> bool:
        return self._index_loaded

    def insert_node(self, node: Node) -> None:
        self.insert_nodes([node])

    def insert_nodes(self, nodes: Sequence[Node]) -> None:
        """Batched ingest: one construction-search + commit program per
        batch instead of one per node."""
        if not nodes:
            return
        with self._lock:
            self._insert_nodes_locked(nodes, batched=len(nodes) > 1)

    def _insert_nodes_locked(self, nodes: Sequence[Node],
                             batched: bool = False) -> None:
        if self.index_type == "ivf":
            self._ivf_insert(nodes)
        elif (
            self.index_type == "hnsw"
            and self.index.size == 0
            and len(nodes) >= 4096
        ):
            # initial load: exact/clustered matmul bulk construction
            # beats streaming inserts and yields better graphs
            self._save_nodes(nodes)
            self.index.bulk_build(
                [n.id for n in nodes],
                np.stack([np.asarray(n.embedding, np.float32)
                          for n in nodes]),
            )
        elif self.index_type == "sharded-hnsw":
            self._save_nodes(nodes)
            self.index.insert(
                [n.id for n in nodes],
                np.stack([np.asarray(n.embedding, np.float32)
                          for n in nodes]),
            )
        else:
            self.index.insert_nodes(list(nodes))
        self._index_modified = True
        self._pq_stale = True
        if self._should_flush():
            if batched and self._flush_async:
                self._schedule_flush()
            else:
                self.save_index()

    def _save_nodes(self, nodes: Sequence[Node]) -> None:
        """Persist a batch through storage.save_many (one flush per memmap
        layer per batch, not two msyncs per node)."""
        self.storage.save_many(list(nodes))

    def _ivf_insert(self, nodes: Sequence[Node]) -> None:
        """IVF needs centroids before it can route adds: queue until
        ivf_k nodes exist, then k-means-build, then stream adds."""
        if self.index.centroids is None:
            self._ivf_pending.extend(nodes)
            self._save_nodes(nodes)
            if len(self._ivf_pending) >= self.ivf_k:
                self.index.build_index(self._ivf_pending)
                self._ivf_pending = []
        else:
            for node in nodes:
                self.index.add(node)

    def delete_node(self, node_id: int) -> None:
        with self._lock:
            self._delete_node_locked(node_id)

    def _delete_node_locked(self, node_id: int) -> None:
        if self.index_type == "ivf":
            self.index.delete(node_id)
            self._ivf_pending = [
                n for n in getattr(self, "_ivf_pending", []) if n.id != node_id
            ]
        elif self.index_type == "sharded-hnsw":
            self.index.delete(node_id)
            if hasattr(self.storage, "delete"):
                self.storage.delete(node_id)
        else:
            self.index.delete_node(node_id)
        self._index_modified = True
        self._pq_stale = True

    def _maybe_enable_pq(self, requested_chunks: Optional[int]) -> bool:
        """Activate PQ traversal when configured (or explicitly requested
        via the search's pq_chunks param) and the corpus is big enough to
        train codebooks. Returns whether PQ search should be used.

        For ``index.type: ivf`` this turns probing into residual IVFADC
        (codes stay current incrementally — IvfIndex.add encodes on the
        spot — so no stale-refresh pass is needed)."""
        if self.index_type not in ("hnsw", "ivf"):
            return False
        chunks = self._pq_chunks or int(requested_chunks or 0)
        if chunks <= 0:
            return False
        if not self._pq_active:
            if self.index.size < max(self._pq_min_size, self._pq_ksub):
                return False
            dim = self.index._dim or 0
            if dim == 0 or dim % chunks != 0:
                return False
            with self._lock:
                if not self._pq_active:
                    if self.index_type == "ivf":
                        self.index.enable_pq(
                            chunks=chunks, ksub=self._pq_ksub,
                            opq_iters=self._pq_opq_iters,
                            residual=self._pq_residual,
                        )
                    else:
                        self.index.enable_pq(
                            chunks=chunks, ksub=self._pq_ksub,
                            opq_iters=self._pq_opq_iters,
                        )
                    self._pq_active = True
                    self._pq_stale = False
        elif self.index_type == "hnsw" and getattr(self, "_pq_stale", False):
            # inserts/deletes since the last encode: refresh codes (one
            # streaming device program; codebooks are not retrained)
            with self._lock:
                if self._pq_stale:
                    self.index.refresh_pq_codes()
                    self._pq_stale = False
        return self._pq_active

    def _maybe_enable_rp(self) -> bool:
        """Activate residual-projection probing for index.type: ivf when
        configured and the corpus is big enough for the PCA train pass.
        Rows added later stay current (IvfIndex.add projects in place)."""
        if self.index_type != "ivf" or self._rp_dims <= 0:
            return False
        if not self._rp_active:
            if (self.index.centroids is None
                    or self.index.size < self._rp_min_size):
                return False
            with self._lock:
                if not self._rp_active:
                    self.index.enable_rp(dims=self._rp_dims)
                    self._rp_active = True
        return self._rp_active

    def _maybe_enable_hnsw_rp(self) -> bool:
        """Activate projected traversal for index.type: hnsw when
        index.rp is configured (the PCA mirror re-projects lazily on
        table change, so later inserts stay current)."""
        if self.index_type != "hnsw" or self._rp_dims <= 0:
            return False
        if not self._rp_active:
            if self.index.size < self._rp_min_size:
                return False
            with self._lock:
                if not self._rp_active:
                    self.index.enable_rp(dims=self._rp_dims)
                    self._rp_active = True
        return self._rp_active

    def _autotune_ready(self, kwargs) -> bool:
        """Calibrated routing applies to unfiltered hnsw/ivf queries once
        the corpus is big enough for the mode ranking to be meaningful
        (tiny corpora: every mode is exact-ish and microseconds apart).
        For ivf the tuner picks n_probe (recall at fixed n_probe swings
        wildly with the corpus), overriding the request's raw n_probe
        knob.
        Filtered hnsw queries calibrate per selectivity bucket (the
        scan/graph ranking flips with match fraction); filtered ivf
        keeps the direct path (probe lists already fold the mask)."""
        if self._autotune is None:
            return False
        if self.index_type == "ivf":
            return (kwargs.get("filter_ids") is None
                    and self.index.centroids is not None
                    and self.index.size >= self._autotune_min_size)
        return (self.index_type == "hnsw"
                and self.index.size >= self._autotune_min_size)

    def _maybe_enable_wide(self) -> bool:
        """Activate wide-beam traversal for index.type: hnsw when
        index.wide is configured and the corpus crossed min_size."""
        if self.index_type != "hnsw" or not self._wide_on:
            return False
        if not self._wide_active:
            if self.index.size < self._wide_min_size:
                return False
            with self._lock:
                if not self._wide_active:
                    self.index.enable_wide(
                        dims=self._wide_dims, seeds=self._wide_seeds)
                    self._wide_active = True
        return self._wide_active

    def search(
        self, query: np.ndarray, k: int, **kwargs: Any
    ) -> List[Tuple[Node, float]]:
        if self.index_type == "ivf":
            return self._ivf_search(query, k, **kwargs)
        if self.index_type == "sharded-hnsw":
            return self._sharded_search(query, k, **kwargs)
        if self._autotune_ready(kwargs):
            dists, ids = self._autotune.route(
                self, np.asarray(query, np.float32)[None, :], k,
                kwargs.get("target_recall"),
                filter_ids=kwargs.get("filter_ids"))
            return self._resolve(dists, ids, k)
        if self._maybe_enable_wide():
            ef = int(kwargs.get("ef", 50) or 50)
            dists, ids = self._wide_dispatch(
                np.asarray(query, np.float32)[None, :], k, ef,
                kwargs.get("filter_ids"))
            return self._resolve(dists, ids, k)
        if kwargs.get("filter_ids") is None and self._maybe_enable_hnsw_rp():
            ef = int(kwargs.get("ef", 50) or 50)
            dists, ids = self.index.search_batch_rp(
                np.asarray(query, np.float32)[None, :], k, ef=max(ef, k),
                expand=4,
            )
            return self._resolve(dists, ids, k)
        if (
            kwargs.get("filter_ids") is None
            and self._maybe_enable_pq(kwargs.get("pq_chunks"))
        ):
            ef = int(kwargs.get("ef", 50) or 50)
            dists, ids = self.index.search_batch_pq(
                np.asarray(query, np.float32)[None, :], k, ef=max(ef, k),
                expand=4,
            )
            return self._resolve(dists, ids, k)
        return self.index.search(query, k=k, **kwargs)

    def _resolve(self, dists, ids, k):
        out = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.index.storage.get(int(nid))
            if node is not None:
                out.append((node, float(d)))
        return out[:k]

    def _sharded_search(self, query, k, **kwargs):
        filter_ids = kwargs.get("filter_ids")
        ef = int(kwargs.get("ef", 50) or 50)
        dists, ids = self.index.search_batch(
            np.asarray(query, np.float32)[None, :], k=k, ef=ef,
            filter_ids=filter_ids,
        )
        out = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.storage.get(int(nid))
            if node is not None:
                out.append((node, float(d)))
        return out[:k]

    def _ivf_search(self, query, k, **kwargs):
        filter_ids = kwargs.get("filter_ids")
        if self.index.centroids is None:
            # not built yet: brute-force the pending queue (exact)
            import numpy as _np

            cands = [
                (float(_np.linalg.norm(query - n.embedding)), n)
                for n in getattr(self, "_ivf_pending", [])
                if filter_ids is None or n.id in filter_ids
            ]
            cands.sort(key=lambda t: t[0])
            return [(n, d) for d, n in cands[:k]]
        if self._autotune_ready(kwargs):
            dists, ids = self._autotune.route(
                self, np.asarray(query, np.float32)[None, :], k,
                kwargs.get("target_recall"))
            out = []
            for nid, d in zip(ids[0], dists[0]):
                if nid < 0:
                    continue
                node = self.storage.get(int(nid))
                if node is not None:
                    out.append((node, float(d)))
            return out[:k]
        n_probe = int(kwargs.get("n_probe", 10) or 10)
        n_probe = max(1, min(n_probe, self.index.k))
        # RP/PQ probing when configured; filters fold into the validity
        # mask inside the approximate kernels (IvfIndex.search_batch)
        use_rp = self._maybe_enable_rp()
        use_pq = (not use_rp
                  and self._maybe_enable_pq(kwargs.get("pq_chunks")))
        dists, ids = self.index.search_batch(
            np.asarray(query, np.float32)[None, :], n_probe=n_probe,
            top_k=k, filter_ids=filter_ids, pq=use_pq, rp=use_rp,
            adc=self._pq_adc,
        )
        results = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.storage.get(int(nid))
            if node is not None:
                results.append((node, float(d)))
        return results[:k]

    def search_batch(self, queries: np.ndarray, k: int, **kwargs: Any):
        n_probe = kwargs.pop("n_probe", None)
        if self.index_type == "ivf":
            if self._autotune_ready(kwargs):
                return self._autotune.route(
                    self, np.asarray(queries, np.float32), k,
                    kwargs.get("target_recall"))
            n_probe = int(n_probe or 10)
            n_probe = max(1, min(n_probe, self.index.k))
            # filters implement tenancy/ACL — forward them (mirrors
            # _ivf_search; a dropped filter silently leaks excluded docs)
            filter_ids = kwargs.get("filter_ids")
            use_rp = self._maybe_enable_rp()
            use_pq = (not use_rp
                      and self._maybe_enable_pq(kwargs.get("pq_chunks")))
            return self.index.search_batch(
                queries, n_probe=n_probe, top_k=k,
                filter_ids=filter_ids, pq=use_pq, rp=use_rp,
                adc=self._pq_adc,
            )
        if self.index_type == "flat":
            # exact search has no ef/beam knobs
            return self.index.search_batch(
                queries, k, filter_ids=kwargs.get("filter_ids")
            )
        if self._autotune_ready(kwargs):
            return self._autotune.route(
                self, np.asarray(queries, np.float32), k,
                kwargs.get("target_recall"),
                filter_ids=kwargs.get("filter_ids"))
        if (self.index_type == "hnsw"
                and self._scan_batch_threshold
                and len(queries) >= self._scan_batch_threshold
                and self.index.size >= self._wide_min_size):
            # batch-throughput mode: the bf16 scan over the same table
            return self.index.search_batch_scan(
                queries, k, filter_ids=kwargs.get("filter_ids"))
        if (self.index_type == "hnsw" and self._maybe_enable_wide()):
            ef = int(kwargs.get("ef", 50) or 50)
            return self._wide_dispatch(queries, k, ef,
                                       kwargs.get("filter_ids"))
        return self.index.search_batch(queries, k, **kwargs)

    def _wide_dispatch(self, queries: np.ndarray, k: int, ef: int,
                       filter_ids=None):
        """Route an hnsw batch to the configured wide-beam formulation
        (index.wide.mode: pool | beam). Filtered queries default to the
        masked bf16 scan (index.filtered_engine: scan — true filtered
        top-k at scan QPS; see __init__ comment); filtered_engine:
        graph runs the two-pool wide path in pool mode / the trajectory
        mask in beam mode (the reference navigate-but-exclude
        contract)."""
        if filter_ids is not None and self._filtered_engine == "scan":
            return self.index.search_batch_scan(
                queries, k, filter_ids=filter_ids)
        if self._wide_mode == "beam":
            return self.index.search_batch_beam(
                queries, k, frontier=self._wide_frontier or 224,
                steps=self._wide_steps or 12, hist=self._wide_hist,
                filter_ids=filter_ids,
            )
        return self.index.search_batch_wide(
            queries, k, ef=max(4 * max(ef, k), 64),
            frontier=self._wide_frontier, steps=self._wide_steps,
            seen_mask=self._wide_seen, filter_ids=filter_ids,
            schedule=self._wide_schedule,
        )

    def save_index(self) -> None:
        self.wait_for_flush()  # one checkpoint writer at a time
        with self._lock:
            if self._index_modified:
                self._do_save()
                self._index_modified = False

    def force_save_index(self) -> None:
        self.wait_for_flush()
        self._do_save()
        self._index_modified = False

    # -- async threshold flush (batched ingest path) ----------------------
    def _schedule_flush(self) -> None:
        """Queue the current index state for a background checkpoint write
        (latest-wins). Falls back to a synchronous save for index types
        without snapshot support. Called under self._lock."""
        snapshot = getattr(self.index, "snapshot_for_save", None)
        if snapshot is None:
            self.save_index()
            return
        snap = snapshot()
        if snap is None:
            return
        with self._flush_cv:
            self._flush_pending = snap
            if self._flush_thread is None or not self._flush_thread.is_alive():
                self._flush_thread = threading.Thread(
                    target=self._flush_worker, daemon=True,
                    name="vdb-flush")
                self._flush_thread.start()
            self._flush_cv.notify_all()
        self._index_modified = False

    def _flush_worker(self) -> None:
        while True:
            with self._flush_cv:
                while self._flush_pending is None:
                    self._flush_cv.wait()
                snap = self._flush_pending
                self._flush_pending = None
                self._flush_busy = True
            try:
                self.index.write_snapshot(snap)
            except Exception:  # pragma: no cover - logged, not fatal
                logger.exception("async index flush failed")
            finally:
                with self._flush_cv:
                    self._flush_busy = False
                    self._flush_cv.notify_all()

    def wait_for_flush(self) -> None:
        """Block until no background checkpoint write is queued or in
        flight (used before shutdown / reopen / synchronous saves)."""
        with self._flush_cv:
            while self._flush_pending is not None or self._flush_busy:
                self._flush_cv.wait()

    def _do_save(self) -> None:
        if self.index_type == "sharded-hnsw":
            self.index.save_index(self.index_file)
        else:
            self.index.save_index()

    def get_index_size(self) -> int:
        if self.index_type == "ivf":
            built = self.index.get_cluster_stats()["total_vectors"]
            return built + len(getattr(self, "_ivf_pending", []))
        return self.index.size

    def _should_flush(self) -> bool:
        return self.get_index_size() >= self.flush_threshold
