"""Sharded indexes: SPMD per-shard search + all-gather top-k merge.

Replaces the reference's scale-out story (docker-compose full-copy
``replicas``, README.md:123-126) with true sharding over a device mesh:

- the corpus splits row-wise across the ``shard`` mesh axis — each device
  owns ``cap`` embedding rows (plus, for HNSW, its own fixed-degree
  neighbor tables over those rows);
- queries are replicated; every shard answers its local top-k in parallel
  under ``shard_map``; per-shard results merge with one ``all_gather`` +
  top-k — the only cross-device traffic is B×k×(distance, id) pairs;
- streaming inserts route round-robin to shards host-side and commit SPMD:
  every shard runs the same construction-search + commit program on its own
  (padded) sub-batch.

Global addressing: a result's global slot is ``shard * cap + local_slot``;
the host maps global slots back to user node ids.
"""

from __future__ import annotations

import functools
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vector_db_tpu.index import hnsw_kernels as K
from vector_db_tpu.runtime import device_pull
from vector_db_tpu.ops.distance import BIG, l2_sq_pairwise
from vector_db_tpu.ops.topk import masked_top_k_smallest
from vector_db_tpu.parallel.mesh import SHARD_AXIS, make_mesh

Axis = SHARD_AXIS


# ======================================================================
# sharded exact search
# ======================================================================

def _merge_gathered(local_d, local_gslots, k, axes=(Axis,)):
    """Hierarchical all_gather + top-k merge, innermost axis first.

    For a 1-D ("shard",) mesh this is one all_gather + top-k. For a
    2-D ("slice", "shard") mesh, the merge runs per axis from innermost
    (within a slice) outward (across slices): each stage gathers only the
    previous stage's [B, k] winners, so the outer stage carries B·k pairs
    per slice instead of B·k·shards_per_slice.
    """
    b = local_d.shape[0]
    for a in reversed(axes):
        all_d = jax.lax.all_gather(local_d, a)      # [S_a, B, k]
        all_s = jax.lax.all_gather(local_gslots, a)  # [S_a, B, k]
        d = jnp.transpose(all_d, (1, 0, 2)).reshape(b, -1)
        s = jnp.transpose(all_s, (1, 0, 2)).reshape(b, -1)
        local_d, local_gslots = masked_top_k_smallest(d, s, k)
    return local_d, local_gslots


def _globalize(slots: jnp.ndarray, cap: int, axes=(Axis,),
               sizes=None) -> jnp.ndarray:
    """Local slot -> global slot: linear device index (row-major over the
    mesh axes) × cap + slot."""
    idx = jax.lax.axis_index(axes[0])
    if len(axes) > 1:
        for a, size in zip(axes[1:], sizes[1:]):
            idx = idx * size + jax.lax.axis_index(a)
    return jnp.where(slots >= 0, slots + idx * cap, -1)


class ShardedFlatIndex:
    """Row-sharded exact search: per-shard fused matmul + top-k, all-gather
    merge. The recall ground truth at any scale."""

    def __init__(self, mesh: Optional[Mesh] = None, dim: int = 384,
                 capacity_per_shard: int = 4096) -> None:
        self.mesh = mesh or make_mesh()
        # row-sharding over EVERY mesh axis: a 1-D ("shard",) mesh splits
        # over its devices; a 2-D ("slice", "shard") mesh splits over
        # slices too, and merges run per axis (see _merge_gathered)
        axes = tuple(self.mesh.axis_names)
        sizes = tuple(self.mesh.shape[a] for a in axes)
        self._axes, self._axis_sizes = axes, sizes
        self.n_shards = self.mesh.devices.size
        self.cap = int(capacity_per_shard)
        self.dim = int(dim)
        total = self.n_shards * self.cap
        sh = NamedSharding(self.mesh, P(axes))
        self._emb = jax.device_put(jnp.zeros((total, self.dim), jnp.float32), sh)
        self._valid = jax.device_put(jnp.zeros((total,), bool), sh)
        self._id_of_gslot = np.full((total,), -1, np.int64)
        self._gslot_of_id: Dict[int, int] = {}
        self._next_in_shard = [0] * self.n_shards
        self._rr = 0  # round-robin cursor

        @functools.partial(
            jax.jit, static_argnames=("k",),
        )
        def _search(emb, valid, queries, k):
            def per_shard(emb_s, valid_s, q):
                # HIGHEST: this index is the exact ground truth; DEFAULT
                # precision may run f32 products in TF32 on the GPU
                d = l2_sq_pairwise(q, emb_s,
                                   precision=jax.lax.Precision.HIGHEST)
                d = jnp.where(valid_s[None, :], d, BIG)
                ids = jnp.arange(emb_s.shape[0], dtype=jnp.int32)
                ld, ls = masked_top_k_smallest(d, ids, min(k, emb_s.shape[0]))
                return _merge_gathered(
                    ld, _globalize(ls, self.cap, axes, sizes), k, axes)

            return jax.shard_map(
                per_shard, mesh=self.mesh,
                in_specs=(P(axes), P(axes), P()),
                out_specs=(P(), P()),
                check_vma=False,
            )(emb, valid, queries)

        self._search_fn = _search

        @jax.jit
        def _write(emb, valid, gslots, vecs):
            cap_total = emb.shape[0]
            safe = jnp.where(gslots >= 0, gslots, cap_total)
            emb = emb.at[safe].set(vecs, mode="drop")
            valid = valid.at[safe].set(True, mode="drop")
            return emb, valid

        self._write_fn = _write

    @property
    def size(self) -> int:
        return len(self._gslot_of_id)

    def _route(self, node_id: int) -> int:
        shard = self._rr % self.n_shards
        self._rr += 1
        if self._next_in_shard[shard] >= self.cap:
            # find any shard with room
            for s in range(self.n_shards):
                if self._next_in_shard[s] < self.cap:
                    shard = s
                    break
            else:
                raise RuntimeError("Sharded index full")
        slot = self._next_in_shard[shard]
        self._next_in_shard[shard] += 1
        g = shard * self.cap + slot
        self._gslot_of_id[node_id] = g
        self._id_of_gslot[g] = node_id
        return g

    def insert(self, ids: Sequence[int], embeddings: np.ndarray) -> None:
        embeddings = np.asarray(embeddings, np.float32)
        # look up per element as routing proceeds so a duplicate id within
        # one batch reuses the slot allocated for its first occurrence
        gslots = np.empty((len(ids),), np.int64)
        for j, nid in enumerate(ids):
            g = self._gslot_of_id.get(int(nid), -1)
            gslots[j] = g if g >= 0 else self._route(int(nid))
        self._emb, self._valid = self._write_fn(
            self._emb, self._valid, jnp.asarray(gslots, jnp.int32),
            jnp.asarray(embeddings),
        )

    def delete(self, node_id: int) -> None:
        g = self._gslot_of_id.pop(node_id, None)
        if g is None:
            return
        self._valid = self._valid.at[g].set(False)
        self._id_of_gslot[g] = -1

    def search_batch(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        q = jnp.asarray(np.asarray(queries, np.float32))
        d_sq, gslots = self._search_fn(self._emb, self._valid, q, k)
        d_sq, gslots = np.asarray(d_sq), np.asarray(gslots)
        ids = np.where(
            gslots >= 0, self._id_of_gslot[np.maximum(gslots, 0)], -1
        )
        dists = np.where(gslots >= 0, np.sqrt(np.maximum(d_sq, 0)), np.inf)
        return dists.astype(np.float32), ids


# ======================================================================
# sharded IVF
# ======================================================================

class ShardedIVF(ShardedFlatIndex):
    """Row-sharded IVF: replicated coarse centroids, per-shard padded
    inverted lists over local rows, SPMD probe + all-gather top-k merge.

    Sharded scale-out for the reference's library-only IVF
    (reference src/vector_db/indexing/ivf.py:13-241): k-means trains once
    on a replicated sample, every shard keeps inverted lists over the rows
    it owns (local slot ids, -1 padded), and one shard_map program probes
    the same ``n_probe`` cells on all shards — the only cross-device
    traffic is the B×k merged winners. Deletes inherit the flat index's
    valid-mask semantics (a dead slot is masked in-kernel, no list edit).
    """

    def __init__(self, mesh: Optional[Mesh] = None, dim: int = 384,
                 capacity_per_shard: int = 4096, k_cells: int = 16,
                 max_list: Optional[int] = None) -> None:
        super().__init__(mesh=mesh, dim=dim,
                         capacity_per_shard=capacity_per_shard)
        self.k_cells = int(k_cells)
        self.max_list = int(max_list or max(
            8, 2 * capacity_per_shard // k_cells))
        self._centroids: Optional[jnp.ndarray] = None
        self._lists: Optional[jnp.ndarray] = None
        axes, sizes, cap = self._axes, self._axis_sizes, self.cap

        @functools.partial(jax.jit, static_argnames=("n_probe", "k"))
        def _probe(cent, lists, emb, valid, queries, n_probe, k):
            from vector_db_tpu.index.ivf import _ivf_search_batch

            def per_shard(lists_s, emb_s, valid_s, q):
                ld, ls = _ivf_search_batch(
                    cent, lists_s, emb_s, valid_s, q, valid_s,
                    n_probe, k)
                return _merge_gathered(
                    ld, _globalize(ls, cap, axes, sizes), k, axes)

            return jax.shard_map(
                per_shard, mesh=self.mesh,
                in_specs=(P(axes), P(axes), P(axes), P()),
                out_specs=(P(), P()),
                check_vma=False,
            )(lists, emb, valid, queries)

        self._probe_fn = _probe

    def build(self, ids: Sequence[int], embeddings: np.ndarray,
              seed: int = 0) -> None:
        """Insert rows, train the coarse quantizer, build per-shard lists."""
        from vector_db_tpu.ops.kmeans import assign_tiled, kmeans

        self.insert(ids, embeddings)
        x = np.asarray(embeddings, np.float32)
        sample = x[: min(len(x), 65536)]
        cents, _ = kmeans(jnp.asarray(sample), self.k_cells,
                          jax.random.PRNGKey(seed), iters=25)
        self._centroids = cents
        labels = np.asarray(assign_tiled(jnp.asarray(x), cents)[:, 0])
        lists_np = np.full(
            (self.n_shards, self.k_cells, self.max_list), -1, np.int32)
        fill = np.zeros((self.n_shards, self.k_cells), np.int32)
        for j, nid in enumerate(ids):
            g = self._gslot_of_id[int(nid)]
            s, slot = divmod(g, self.cap)
            c = int(labels[j])
            if fill[s, c] < self.max_list:
                lists_np[s, c, fill[s, c]] = slot
                fill[s, c] += 1
        sh = NamedSharding(self.mesh, P(self._axes))
        self._lists = jax.device_put(
            jnp.asarray(lists_np.reshape(-1, self.max_list)), sh)

    def search_batch(
        self, queries: np.ndarray, k: int, n_probe: int = 4
    ) -> Tuple[np.ndarray, np.ndarray]:
        assert self._centroids is not None, "build() first"
        q = jnp.asarray(np.asarray(queries, np.float32))
        d_sq, gslots = self._probe_fn(
            self._centroids, self._lists, self._emb, self._valid, q,
            min(n_probe, self.k_cells), k)
        d_sq, gslots = np.asarray(d_sq), np.asarray(gslots)
        ids = np.where(
            gslots >= 0, self._id_of_gslot[np.maximum(gslots, 0)], -1)
        dists = np.where(gslots >= 0, np.sqrt(np.maximum(d_sq, 0)), np.inf)
        return dists.astype(np.float32), ids


# ======================================================================
# sharded HNSW
# ======================================================================

class ShardedHNSW:
    """Per-shard HNSW graphs under one SPMD program.

    Each shard owns an independent graph over its local rows (the standard
    sharded-ANN architecture); queries fan out to all shards and merge by
    distance, so recall matches a single graph of the union at equal ef.
    """

    def __init__(
        self,
        M: int = 16,
        ef_construction: int = 100,
        mesh: Optional[Mesh] = None,
        dim: int = 384,
        capacity_per_shard: int = 4096,
        l_max: int = 5,
        seed: int = 42,
    ) -> None:
        self.mesh = mesh or make_mesh()
        self._axes = tuple(self.mesh.axis_names)
        self._axis_sizes = tuple(self.mesh.shape[a] for a in self._axes)
        self.n_shards = int(self.mesh.devices.size)
        self.M = int(M)
        self.efc = int(ef_construction)
        self.l_max = int(l_max)
        self.cap = int(capacity_per_shard)
        self.dim = int(dim)
        self.rng = random.Random(seed)
        self.level_mult = 1.0 / math.log(self.M) if self.M > 1 else 1.0

        total = self.n_shards * self.cap
        ncols = K.ncols(self.M, self.l_max)
        shr = NamedSharding(self.mesh, P(self._axes))
        self._neighbors = jax.device_put(
            jnp.full((total, ncols), -1, jnp.int32), shr
        )
        self._levels = jax.device_put(jnp.full((total,), -1, jnp.int32), shr)
        self._entry = jax.device_put(
            jnp.full((self.n_shards,), -1, jnp.int32), shr
        )
        self._entry_level = jax.device_put(
            jnp.full((self.n_shards,), -1, jnp.int32), shr
        )
        self._emb = jax.device_put(jnp.zeros((total, self.dim), jnp.float32), shr)
        self._has_emb = jax.device_put(jnp.zeros((total,), bool), shr)

        self._id_of_gslot = np.full((total,), -1, np.int64)
        self._gslot_of_id: Dict[int, int] = {}
        self._next_in_shard = [0] * self.n_shards
        self._rr = 0

        self._insert_fn = self._build_insert_fn()
        self._search_fn = self._build_search_fn()

    # -- host-side routing ------------------------------------------------
    @property
    def size(self) -> int:
        return len(self._gslot_of_id)

    def sample_level(self) -> int:
        lvl = int(-math.log(self.rng.random()) * self.level_mult)
        return min(lvl, self.l_max - 1)

    def _route(self, node_id: int) -> Tuple[int, int]:
        shard = self._rr % self.n_shards
        self._rr += 1
        if self._next_in_shard[shard] >= self.cap:
            for s in range(self.n_shards):
                if self._next_in_shard[s] < self.cap:
                    shard = s
                    break
            else:
                raise RuntimeError("Sharded index full")
        slot = self._next_in_shard[shard]
        self._next_in_shard[shard] += 1
        g = shard * self.cap + slot
        self._gslot_of_id[node_id] = g
        self._id_of_gslot[g] = node_id
        return shard, slot

    # -- SPMD programs ------------------------------------------------------
    def _build_insert_fn(self):
        M, efc, l_max, cap = self.M, self.efc, self.l_max, self.cap
        mesh = self.mesh
        max_steps = 2 * efc + 16

        def per_shard(neighbors, levels, entry, entry_level, emb, has_emb,
                      new_emb, new_slots, new_levels):
            # rank-reduced views: entry [1] -> scalar
            graph = K.Graph(neighbors, levels, entry[0], entry_level[0])
            # write embeddings (padded slots -> dropped)
            safe = jnp.where(new_slots >= 0, new_slots, cap)
            emb = emb.at[safe].set(new_emb, mode="drop")
            has_emb = has_emb.at[safe].set(True, mode="drop")

            cd, cs = K.construction_search(
                graph, emb, has_emb, new_emb, new_levels,
                M=M, l_max=l_max, ef_construction=efc, max_steps=max_steps,
            )
            batch_d = l2_sq_pairwise(new_emb, new_emb)
            # padded items must not be intra-batch candidates
            pad = new_slots < 0
            batch_d = jnp.where(pad[None, :] | pad[:, None], BIG, batch_d)
            graph = K.commit_inserts(
                graph, emb, has_emb, new_slots, new_levels, cd, cs, batch_d,
                M=M, l_max=l_max, ef_construction=efc,
            )
            return (
                graph.neighbors, graph.levels, graph.entry[None],
                graph.entry_level[None], emb, has_emb,
            )

        spec = P(self._axes)

        @jax.jit
        def _insert(neighbors, levels, entry, entry_level, emb, has_emb,
                    new_emb, new_slots, new_levels):
            return jax.shard_map(
                per_shard, mesh=mesh,
                in_specs=(spec,) * 6 + (spec, spec, spec),
                out_specs=(spec,) * 6,
                check_vma=False,
            )(neighbors, levels, entry, entry_level, emb, has_emb,
              new_emb, new_slots, new_levels)

        return _insert

    def _build_search_fn(self):
        M, l_max, cap = self.M, self.l_max, self.cap
        mesh = self.mesh
        axes, sizes = self._axes, self._axis_sizes

        @functools.partial(jax.jit, static_argnames=("ef", "k", "use_filter"))
        def _search(neighbors, levels, entry, entry_level, emb, has_emb,
                    queries, fmask, ef, k, use_filter):
            max_steps = 2 * ef + 16

            def per_shard(neighbors, levels, entry, entry_level, emb,
                          has_emb, q, fm):
                graph = K.Graph(neighbors, levels, entry[0], entry_level[0])
                ld, ls = K.search_batch(
                    graph, emb, has_emb, q, fm,
                    M=M, l_max=l_max, ef=ef, k=k,
                    max_steps=max_steps, use_filter=use_filter,
                )
                return _merge_gathered(
                    ld, _globalize(ls, cap, axes, sizes), k, axes)

            spec = P(self._axes)
            return jax.shard_map(
                per_shard, mesh=mesh,
                in_specs=(spec,) * 6 + (P(), spec),
                out_specs=(P(), P()),
                check_vma=False,
            )(neighbors, levels, entry, entry_level, emb, has_emb, queries,
              fmask)

        return _search

    # -- wide-beam (frontier-parallel search) over the mesh ----------------
    def enable_wide(self, dims: Optional[int] = None,
                    seeds: int = 512) -> None:
        """Activate sharded wide-beam search. A SHARED PCA projection is
        trained from the mesh-wide covariance (per-shard partial covs
        psum'd over the axes — [dim, dim] crosses to host once, never the
        rows); per-shard augmented mirrors and seed sets stay sharded.
        ``dims=None`` scores from the full-dim bf16 mirror."""
        if dims is not None and dims < self.dim:
            mesh, axes = self.mesh, self._axes
            spec = P(axes)

            def per_shard(emb, has_emb):
                e = jnp.where(has_emb[:, None], emb, 0.0)
                c = jnp.dot(e.T, e, preferred_element_type=jnp.float32)
                n = jnp.sum(has_emb.astype(jnp.float32))
                for a in axes:
                    c = jax.lax.psum(c, a)
                    n = jax.lax.psum(n, a)
                return c[None], n[None]

            cov, n = jax.jit(lambda e, h: jax.shard_map(
                per_shard, mesh=mesh, in_specs=(spec, spec),
                out_specs=(P(axes), P(axes)), check_vma=False,
            )(e, h))(self._emb, self._has_emb)
            cov = np.asarray(cov)[0] / max(1.0, float(np.asarray(n)[0]))
            _, v = np.linalg.eigh(cov.astype(np.float64))
            self._wb_proj = jnp.asarray(
                v[:, ::-1][:, : int(dims)].astype(np.float32))
        else:
            self._wb_proj = None
        self._wb_seeds = int(seeds)
        self._wb_src = None
        self._wide_fn = self._build_wide_fn()
        self._beam_fn = None  # rebuilt lazily (captures the seed count)

    def _wide_aug(self):
        from vector_db_tpu.index import wide_beam as WB

        if getattr(self, "_wb_src", None) is not self._emb:
            mesh, spec = self.mesh, P(self._axes)
            proj = self._wb_proj

            def per_shard(emb, has_emb):
                return WB.build_aug_table(emb, has_emb, proj)

            self._wb_aug = jax.jit(lambda e, h: jax.shard_map(
                per_shard, mesh=mesh, in_specs=(spec, spec),
                out_specs=spec, check_vma=False,
            )(e, h))(self._emb, self._has_emb)
            self._wb_src = self._emb
        return self._wb_aug

    def _build_wide_fn(self):
        from vector_db_tpu.index import wide_beam as WB

        M, l_max, cap = self.M, self.l_max, self.cap
        mesh = self.mesh
        axes, sizes = self._axes, self._axis_sizes
        S = min(self._wb_seeds, cap)

        @functools.partial(
            jax.jit,
            static_argnames=("ef", "F", "T", "k", "rerank_k",
                             "use_filter"))
        def _wsearch(neighbors, levels, emb, has_emb, aug, queries, qa,
                     fmask, ef, F, T, k, rerank_k, use_filter=False):
            def per_shard(neighbors, levels, emb, has_emb, aug, q, qa,
                          fmask):
                # per-shard seeds: the shard's highest-level nodes (the
                # navigation hierarchy, selected on device)
                lv, seed_idx = jax.lax.top_k(levels, S)
                seed_slots = jnp.where(
                    lv >= 0, seed_idx.astype(jnp.int32), -1)
                ld, ls = WB.wide_search(
                    neighbors[:, : 2 * M], aug, emb, has_emb, seed_slots,
                    q, qa, ef=ef, F=F, T=T, k=k, rerank_k=rerank_k,
                    res_mask=fmask if use_filter else None,
                )
                return _merge_gathered(
                    ld, _globalize(ls, cap, axes, sizes), k, axes)

            spec = P(axes)
            return jax.shard_map(
                per_shard, mesh=mesh,
                in_specs=(spec,) * 5 + (P(), P(), spec),
                out_specs=(P(), P()),
                check_vma=False,
            )(neighbors, levels, emb, has_emb, aug, queries, qa, fmask)

        return _wsearch

    def _filter_gmask(self, filter_ids):
        """bool[n_shards*cap] device mask (sharded) from a set of ids.

        The unfiltered placeholder is cached: rebuilding + device_put'ing
        an n_shards*cap mask per call would add a host->device transfer
        to every unfiltered search (the same rule as
        IvfIndex._zero_mask)."""
        if filter_ids is None:
            zm = getattr(self, "_zero_gmask", None)
            if zm is None or zm.shape[0] != self.n_shards * self.cap:
                zm = jax.device_put(
                    jnp.zeros((self.n_shards * self.cap,), bool),
                    NamedSharding(self.mesh, P(self._axes)))
                self._zero_gmask = zm
            return zm
        mask = np.zeros((self.n_shards * self.cap,), bool)
        for nid in filter_ids:
            g = self._gslot_of_id.get(int(nid))
            if g is not None:
                mask[g] = True
        return jax.device_put(
            jnp.asarray(mask), NamedSharding(self.mesh, P(self._axes))
        )

    def search_batch_wide(
        self, queries: np.ndarray, k: int, ef: int = 256,
        frontier: int = 32, steps: int = 12, rerank_k: int = 0,
        filter_ids=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Wide-beam fan-out: every shard runs the frontier-parallel
        search, results merge hierarchically (within a slice first).
        Requires enable_wide(). ``filter_ids`` applies the two-pool
        filtered wide path per shard (navigate-but-exclude)."""
        from vector_db_tpu.index import wide_beam as WB

        if not hasattr(self, "_wb_seeds"):
            raise ValueError("call enable_wide() first")
        aug = self._wide_aug()
        q = jnp.asarray(np.asarray(queries, np.float32))
        qa = WB.aug_queries(q, self._wb_proj, aug.shape[1])
        rerank_k = rerank_k or min(ef, max(4 * k, 64))
        d_sq, gslots = self._wide_fn(
            self._neighbors, self._levels, self._emb, self._has_emb,
            aug, q, qa, self._filter_gmask(filter_ids),
            ef=max(ef, k), F=frontier, T=steps, k=k,
            rerank_k=rerank_k, use_filter=filter_ids is not None,
        )
        d_sq, gslots = np.asarray(d_sq), np.asarray(gslots)
        ids = np.where(
            gslots >= 0, self._id_of_gslot[np.maximum(gslots, 0)], -1
        )
        dists = np.where(gslots >= 0, np.sqrt(np.maximum(d_sq, 0)), np.inf)
        return dists.astype(np.float32), ids

    def _build_beam_fn(self):
        from vector_db_tpu.index import wide_beam as WB

        M, cap = self.M, self.cap
        mesh = self.mesh
        axes, sizes = self._axes, self._axis_sizes
        S = min(self._wb_seeds, cap)

        @functools.partial(
            jax.jit, static_argnames=("F", "T", "k", "rerank_k", "hist",
                                      "use_filter"))
        def _bsearch(neighbors, levels, emb, has_emb, aug, queries, qa,
                     fmask, F, T, k, rerank_k, hist, use_filter=False):
            def per_shard(neighbors, levels, emb, has_emb, aug, q, qa,
                          fmask):
                lv, seed_idx = jax.lax.top_k(levels, S)
                seed_slots = jnp.where(
                    lv >= 0, seed_idx.astype(jnp.int32), -1)
                ld, ls = WB.beam_search(
                    neighbors[:, : 2 * M], aug, emb, has_emb, seed_slots,
                    q, qa, F=F, T=T, k=k, rerank_k=rerank_k, hist=hist,
                    res_mask=fmask if use_filter else None,
                )
                return _merge_gathered(
                    ld, _globalize(ls, cap, axes, sizes), k, axes)

            spec = P(axes)
            return jax.shard_map(
                per_shard, mesh=mesh,
                in_specs=(spec,) * 5 + (P(), P(), spec),
                out_specs=(P(), P()),
                check_vma=False,
            )(neighbors, levels, emb, has_emb, aug, queries, qa, fmask)

        return _bsearch

    def search_batch_beam(
        self, queries: np.ndarray, k: int, frontier: int = 64,
        steps: int = 12, rerank_k: int = 0, hist: int = 2,
        filter_ids=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pool-free beam fan-out (see wide_beam.beam_search): every shard
        runs the merge-light traversal, results merge hierarchically.
        Requires enable_wide(). ``filter_ids`` masks each shard's emitted
        trajectory (navigate-but-exclude)."""
        from vector_db_tpu.index import wide_beam as WB

        if not hasattr(self, "_wb_seeds"):
            raise ValueError("call enable_wide() first")
        if getattr(self, "_beam_fn", None) is None:
            self._beam_fn = self._build_beam_fn()
        aug = self._wide_aug()
        q = jnp.asarray(np.asarray(queries, np.float32))
        qa = WB.aug_queries(q, self._wb_proj, aug.shape[1])
        rerank_k = rerank_k or max(4 * k, 64)
        d_sq, gslots = self._beam_fn(
            self._neighbors, self._levels, self._emb, self._has_emb,
            aug, q, qa, self._filter_gmask(filter_ids),
            F=frontier, T=steps, k=k, rerank_k=rerank_k,
            hist=hist, use_filter=filter_ids is not None,
        )
        d_sq, gslots = np.asarray(d_sq), np.asarray(gslots)
        ids = np.where(
            gslots >= 0, self._id_of_gslot[np.maximum(gslots, 0)], -1
        )
        dists = np.where(gslots >= 0, np.sqrt(np.maximum(d_sq, 0)), np.inf)
        return dists.astype(np.float32), ids

    def _build_bulk_fn(self, level_sizes: Tuple[int, ...]):
        """One SPMD bulk-construction program: every shard builds its own
        graph over its local rows concurrently (cells are independent —
        near-linear scaling over the mesh). ``level_sizes`` are static
        per-level prefix lengths (max over shards, pow2-bucketed); local
        slots are assigned level-descending so each level's nodes occupy a
        prefix and upper-level kNN passes touch only that prefix."""
        from vector_db_tpu.ops.graph_build import (
            build_forward_edges,
            reverse_merge,
        )

        M, l_max, cap = self.M, self.l_max, self.cap
        mesh = self.mesh

        def per_shard(emb, has_emb, levels_local):
            ncols_ = K.ncols(M, l_max)
            neighbors = jnp.full((cap, ncols_), -1, jnp.int32)
            for level, p in enumerate(level_sizes):
                if p < 2:
                    continue
                width = K.level_width(level, M)
                deg = min(M, p - 1, width)
                e = emb[:p]
                valid = has_emb[:p] & (levels_local[:p] >= level)
                chunk = min(512, p & (-p))  # largest pow2 divisor of p
                fd, fi = build_forward_edges(
                    e, valid, deg=deg, k_cand=min(4 * M, p - 1),
                    chunk=chunk, alpha=1.0,
                )
                rows = reverse_merge(fd, fi, width)
                start = K.level_col_start(level, M)
                neighbors = lax.dynamic_update_slice(
                    neighbors, rows, (0, start)
                )
            # local slot 0 holds the shard's highest-level node
            entry = jnp.where(has_emb[0], jnp.int32(0), jnp.int32(-1))
            entry_level = jnp.where(has_emb[0], levels_local[0],
                                    jnp.int32(-1))
            lv = jnp.where(has_emb, levels_local, -1)
            return neighbors, lv, entry[None], entry_level[None]

        spec = P(self._axes)

        @jax.jit
        def _bulk(emb, has_emb, levels_local):
            return jax.shard_map(
                per_shard, mesh=mesh,
                in_specs=(spec, spec, spec),
                out_specs=(spec, spec, spec, spec),
                check_vma=False,
            )(emb, has_emb, levels_local)

        return _bulk

    def bulk_build(self, ids: Sequence[int], embeddings: np.ndarray) -> None:
        """SPMD bulk construction (the 10M initial-load path): rows route
        round-robin to shards; every shard builds exact-kNN + occlusion-
        pruned + reverse-merged level graphs over its local rows in ONE
        program. Single-chip semantics preserved per shard
        (HNSW.bulk_build); search merges across shards as usual."""
        if self.size > 0:
            raise ValueError("bulk_build requires an empty index")
        embeddings = np.asarray(embeddings, np.float32)
        seen: Dict[int, None] = {}
        keep = []
        for j, nid in enumerate(ids):
            if int(nid) not in seen:
                seen[int(nid)] = None
                keep.append(j)
        idx = np.asarray(keep, np.int64)
        ids_arr = np.asarray([int(ids[j]) for j in keep], np.int64)
        embeddings = embeddings[idx]
        n = embeddings.shape[0]
        if n == 0:
            return
        if n > self.n_shards * self.cap:
            raise RuntimeError("Sharded index full")
        if self.dim != embeddings.shape[1]:
            raise ValueError(
                f"dim {embeddings.shape[1]} != index dim {self.dim}"
            )

        levels = np.asarray(
            [self.sample_level() for _ in range(n)], np.int32
        )
        shard_of = np.arange(n) % self.n_shards

        emb_np = np.zeros((self.n_shards, self.cap, self.dim), np.float32)
        has_np = np.zeros((self.n_shards, self.cap), bool)
        lvl_np = np.full((self.n_shards, self.cap), -1, np.int32)
        counts = np.zeros(self.n_shards, np.int64)
        for s in range(self.n_shards):
            mine = np.nonzero(shard_of == s)[0]
            # level-descending local slot order => per-level prefixes
            mine = mine[np.argsort(-levels[mine], kind="stable")]
            m = mine.size
            counts[s] = m
            emb_np[s, :m] = embeddings[mine]
            has_np[s, :m] = True
            lvl_np[s, :m] = levels[mine]
            self._next_in_shard[s] = int(m)
            for local, j in enumerate(mine):
                g = s * self.cap + local
                self._gslot_of_id[int(ids_arr[j])] = g
                self._id_of_gslot[g] = int(ids_arr[j])
        self._rr = int(n)

        # static per-level prefix sizes: max live count over shards,
        # bucketed to powers of two (compile-cache friendly)
        level_sizes = []
        for level in range(self.l_max):
            c = int(max(
                ((lvl_np[s] >= level).sum() for s in range(self.n_shards)),
                default=0,
            ))
            p = 0 if c < 2 else min(
                self.cap, 1 << (max(c, 2) - 1).bit_length()
            )
            level_sizes.append(p)

        shr = NamedSharding(self.mesh, P(self._axes))
        self._emb = jax.device_put(
            jnp.asarray(emb_np.reshape(-1, self.dim)), shr
        )
        self._has_emb = jax.device_put(jnp.asarray(has_np.reshape(-1)), shr)
        bulk = self._build_bulk_fn(tuple(level_sizes))
        (self._neighbors, self._levels, self._entry,
         self._entry_level) = bulk(
            self._emb, self._has_emb, jnp.asarray(lvl_np.reshape(-1))
        )

    # -- public API ---------------------------------------------------------
    def insert(self, ids: Sequence[int], embeddings: np.ndarray) -> None:
        """Streaming bulk insert: rows route round-robin to shards; all
        shards commit their sub-batches in one SPMD program."""
        embeddings = np.asarray(embeddings, np.float32)
        per_shard_items: List[List[Tuple[int, int]]] = [
            [] for _ in range(self.n_shards)
        ]
        for j, nid in enumerate(ids):
            if int(nid) in self._gslot_of_id:
                continue
            shard, slot = self._route(int(nid))
            per_shard_items[shard].append((j, slot))
        bp = max((len(x) for x in per_shard_items), default=0)
        if bp == 0:
            return
        new_emb = np.zeros((self.n_shards, bp, self.dim), np.float32)
        new_slots = np.full((self.n_shards, bp), -1, np.int32)
        new_levels = np.zeros((self.n_shards, bp), np.int32)
        for s, items in enumerate(per_shard_items):
            for p, (j, slot) in enumerate(items):
                new_emb[s, p] = embeddings[j]
                new_slots[s, p] = slot
                new_levels[s, p] = self.sample_level()

        (self._neighbors, self._levels, self._entry, self._entry_level,
         self._emb, self._has_emb) = self._insert_fn(
            self._neighbors, self._levels, self._entry, self._entry_level,
            self._emb, self._has_emb,
            jnp.asarray(new_emb.reshape(self.n_shards * bp, self.dim)),
            jnp.asarray(new_slots.reshape(-1)),
            jnp.asarray(new_levels.reshape(-1)),
        )

    def search_batch(
        self, queries: np.ndarray, k: int, ef: int = 50, filter_ids=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """filter_ids semantics match the single-chip index: non-matching
        nodes navigate but never enter results (per-shard device masks)."""
        q = jnp.asarray(np.asarray(queries, np.float32))
        use_filter = filter_ids is not None
        mask = np.zeros((self.n_shards * self.cap,), bool)
        if use_filter:
            for nid in filter_ids:
                g = self._gslot_of_id.get(int(nid))
                if g is not None:
                    mask[g] = True
        fmask = jax.device_put(
            jnp.asarray(mask), NamedSharding(self.mesh, P(self._axes))
        )
        d_sq, gslots = self._search_fn(
            self._neighbors, self._levels, self._entry, self._entry_level,
            self._emb, self._has_emb, q, fmask, ef=max(ef, k), k=k,
            use_filter=use_filter,
        )
        d_sq, gslots = np.asarray(d_sq), np.asarray(gslots)
        ids = np.where(
            gslots >= 0, self._id_of_gslot[np.maximum(gslots, 0)], -1
        )
        dists = np.where(gslots >= 0, np.sqrt(np.maximum(d_sq, 0)), np.inf)
        return dists.astype(np.float32), ids

    def _build_delete_fn(self):
        """SPMD batched delete with full edge unlink: single-chip
        ``delete_slot`` parity (hnsw_kernels.delete_slot) per shard — one
        gather pass clears every reference to any deleted slot (recycled
        slots can never alias stale edges), own rows/levels reset, entry
        re-elected to the highest-level survivor."""
        cap = self.cap
        mesh = self.mesh

        def per_shard(neighbors, levels, entry, entry_level, has_emb,
                      slots):
            present = slots >= 0
            safe = jnp.where(present, slots, cap)
            deleted = jnp.zeros((cap,), bool).at[safe].set(
                True, mode="drop"
            )
            hit = deleted[jnp.maximum(neighbors, 0)] & (neighbors >= 0)
            neighbors = jnp.where(hit, -1, neighbors)
            neighbors = neighbors.at[safe].set(-1, mode="drop")
            levels = levels.at[safe].set(-1, mode="drop")
            has_emb = has_emb.at[safe].set(False, mode="drop")
            e = entry[0]
            need = jnp.where(e >= 0, deleted[jnp.maximum(e, 0)], False)
            best = jnp.argmax(levels).astype(jnp.int32)
            any_left = levels[best] >= 0
            e2 = jnp.where(need, jnp.where(any_left, best, -1), e)
            el2 = jnp.where(
                need, jnp.where(any_left, levels[best], -1), entry_level[0]
            )
            return neighbors, levels, e2[None], el2[None], has_emb

        spec = P(self._axes)

        @jax.jit
        def _delete(neighbors, levels, entry, entry_level, has_emb, slots):
            return jax.shard_map(
                per_shard, mesh=mesh,
                in_specs=(spec,) * 6,
                out_specs=(spec,) * 5,
                check_vma=False,
            )(neighbors, levels, entry, entry_level, has_emb, slots)

        return _delete

    def delete_batch(self, node_ids: Sequence[int]) -> None:
        """Delete a batch of nodes across shards in ONE SPMD program with
        full edge unlink (single-chip ``delete_slot`` parity; tombstone-only
        deletes would leave edges to dead slots wasting beam expansion and
        aliasing recycled slots)."""
        per_shard: List[List[int]] = [[] for _ in range(self.n_shards)]
        for nid in node_ids:
            g = self._gslot_of_id.pop(int(nid), None)
            if g is None:
                continue
            self._id_of_gslot[g] = -1
            per_shard[g // self.cap].append(g % self.cap)
        d = max((len(x) for x in per_shard), default=0)
        if d == 0:
            return
        d = 1 << (d - 1).bit_length() if d > 1 else 1  # pow2 bucket
        slots = np.full((self.n_shards, d), -1, np.int32)
        for s, items in enumerate(per_shard):
            slots[s, : len(items)] = items
        if not hasattr(self, "_delete_fn"):
            self._delete_fn = self._build_delete_fn()
        (self._neighbors, self._levels, self._entry, self._entry_level,
         self._has_emb) = self._delete_fn(
            self._neighbors, self._levels, self._entry, self._entry_level,
            self._has_emb,
            jax.device_put(jnp.asarray(slots.reshape(-1)),
                           NamedSharding(self.mesh, P(self._axes))),
        )
        # freed local slots are NOT recycled: routing appends monotonically
        # per shard, so stale references (already cleared above) and id
        # aliasing are structurally impossible

    def delete(self, node_id: int) -> None:
        """Single delete: one-element :meth:`delete_batch` (full edge
        unlink + per-shard entry re-election)."""
        self.delete_batch([node_id])

    # -- persistence ---------------------------------------------------------
    def save_index(self, path) -> None:
        """Persist all shard tables + id map; mesh layout is re-applied on
        load (the file is layout-independent)."""
        import numpy as _np

        _np.savez_compressed(
            path,
            neighbors=device_pull(self._neighbors),
            levels=device_pull(self._levels),
            entry=device_pull(self._entry),
            entry_level=device_pull(self._entry_level),
            emb=device_pull(self._emb),
            has_emb=device_pull(self._has_emb),
            id_of_gslot=self._id_of_gslot,
            next_in_shard=device_pull(self._next_in_shard),
            rr=self._rr,
            M=self.M, efc=self.efc, l_max=self.l_max, cap=self.cap,
            n_shards=self.n_shards,
        )

    def load_index(self, path) -> None:
        shr = NamedSharding(self.mesh, P(self._axes))
        with np.load(path) as z:
            if int(z["n_shards"]) != self.n_shards or int(z["cap"]) != self.cap:
                raise ValueError(
                    "Mesh/capacity mismatch: index saved with "
                    f"{int(z['n_shards'])} shards x {int(z['cap'])}, "
                    f"this mesh has {self.n_shards} x {self.cap}"
                )
            self._neighbors = jax.device_put(jnp.asarray(z["neighbors"]), shr)
            self._levels = jax.device_put(jnp.asarray(z["levels"]), shr)
            self._entry = jax.device_put(jnp.asarray(z["entry"]), shr)
            self._entry_level = jax.device_put(
                jnp.asarray(z["entry_level"]), shr
            )
            self._emb = jax.device_put(jnp.asarray(z["emb"]), shr)
            self._has_emb = jax.device_put(jnp.asarray(z["has_emb"]), shr)
            self._id_of_gslot = np.asarray(z["id_of_gslot"])
            self._next_in_shard = [int(v) for v in z["next_in_shard"]]
            self._rr = int(z["rr"])
        self._gslot_of_id = {
            int(nid): g for g, nid in enumerate(self._id_of_gslot) if nid >= 0
        }
