"""Smoke run of the served search path on one NVIDIA GPU.

Drives the calls the REST handlers make (vector_db_tpu/api/app.py:
``save_many`` + ``insert_nodes`` for /embed/batch-docs,
``filter_by_metadata`` + ``search`` for /search, ``search_batch`` for
/search/batch) on StorageService / IndexingService, at the README's
1M x 768 shape, and checks every answer against a plain HIGHEST-precision
reference written here (chunked ``jnp.dot`` + ``lax.top_k`` over the f32
corpus; it imports none of the index code). Data comes from ``--seed``.

    python chip_smoke.py               # phases 0-4 on one GPU
    python chip_smoke.py --four-cards  # the sharded path on four GPUs only

Every phase prints one JSON line (its numbers, the card's name and power
limit); the last line is ``{"ok": true, "device": {...}}``. Any failure
raises and the process exits non-zero. Off-GPU it exits non-zero before
any phase runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

# 1M x 768: the README's headline corpus; 1M x 128 is the SIFT1M shape
N_EMB, DIM_EMB = 1_000_000, 768
N_SIFT, DIM_SIFT = 1_000_000, 128
N_STREAM, STREAM_BATCH = 1000, 100
BATCH, K = 1000, 10
N_TENANTS = 10
# content-layer row widths for the smoke's storage: the reference's
# 10240/5120-char widths take ~61 KB per row (61 GB at 1M rows); the
# documents here carry a short content string and a one-key tenant tag
CONTENT_CHARS, METADATA_CHARS = 64, 64
# recall@10 gates against the HIGHEST reference (ties allowed)
GATES = {"f32": 0.999, "blocksel": 0.999, "blocksel2p": 0.999, "bf16": 0.99}

CARD = "unknown"


def card_identity() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi reports them (a child
    process that stays off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "card": CARD}), flush=True)


def note_cut(what: str, why: str) -> None:
    print(f"CUT: {what} -- {why}", flush=True)


# ----------------------------------------------------------------------
# reference: chunked HIGHEST-precision exact search
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k",))
def _ref_chunk(x, xsq, mask, q, k):
    cross = jnp.dot(q, x.T, precision=jax.lax.Precision.HIGHEST)
    d = xsq[None, :] - 2.0 * cross + jnp.sum(q * q, axis=-1)[:, None]
    d = jnp.where(mask[None, :], d, jnp.inf)
    neg, idx = jax.lax.top_k(-d, k)
    return -neg, idx


def reference_topk(corpus, queries, k, mask=None, qchunk=64):
    """Exact squared-L2 top-k of ``queries`` over the device ``corpus``
    (row index = node id). Returns numpy (d_sq [B, k], ids [B, k])."""
    xsq = jnp.sum(corpus * corpus, axis=-1)
    if mask is None:
        mask = jnp.ones((corpus.shape[0],), bool)
    mask = jnp.asarray(mask)
    q = np.asarray(queries, np.float32)
    pad = (-len(q)) % qchunk
    qp = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
    outs = [_ref_chunk(corpus, xsq, mask, jnp.asarray(qp[s:s + qchunk]), k)
            for s in range(0, len(qp), qchunk)]
    d = np.concatenate([np.asarray(o[0]) for o in outs])[: len(q)]
    i = np.concatenate([np.asarray(o[1]) for o in outs])[: len(q)]
    return d, i


def recall_at_k(ref_d, ref_i, got, corpus, queries, k=K) -> float:
    """recall@k with ties allowed: a returned id counts when it is among
    the reference ids, or when its exact distance is no larger than the
    reference's k-th (an equal-distance row ranks either way)."""
    got = np.asarray(got, np.int64)[:, :k]
    rows = corpus[jnp.asarray(np.maximum(got, 0))]
    q = jnp.asarray(np.asarray(queries, np.float32))
    dg = np.asarray(jnp.sum((rows - q[:, None, :]) ** 2, axis=-1))
    kth = ref_d[:, k - 1:k]
    tie = dg <= kth + 1e-5 * np.abs(kth) + 1e-6
    member = (got[:, :, None] == ref_i[:, None, :]).any(-1)
    hit = (got >= 0) & (member | tie)
    return float(hit.sum()) / float(got.shape[0] * k)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _service(storage_service, config, index_file):
    from vector_db_tpu.services import IndexingService

    return IndexingService(storage=storage_service.storage,
                           config_path=config, index_file=str(index_file))


def _config(dim, capacity, index, path):
    return {"device": "gpu", "embedding": {"dimension": dim},
            "index": dict(index),
            "vector_db": {"file_path": str(path), "dimension": dim,
                          "capacity": capacity}}


def _nodes(x, start_id, tenants):
    from vector_db_tpu.types import Node

    return [Node(id=start_id + i, embedding=x[i], content=f"doc {start_id + i}",
                 metadata={"tenant": f"t{int(tenants[i])}"})
            for i in range(len(x))]


def _storage(path, dim, capacity):
    from vector_db_tpu.services import StorageService

    return StorageService(file_path=str(path), dim=dim, capacity=capacity,
                          content_chars=CONTENT_CHARS,
                          metadata_chars=METADATA_CHARS)


# ----------------------------------------------------------------------
# phase 1: HNSW service (bulk load, streaming inserts, queries, restart)
# ----------------------------------------------------------------------

def phase_hnsw(x, queries, tenants, n_stream, stream_batch, workdir,
               n_single=20, k=K):
    """``x`` f32[n + n_stream, dim]: the first n rows are the initial
    load, the rest stream in. Returns (fields, corpus device array)."""
    n = len(x) - n_stream
    dim = x.shape[1]
    base = Path(workdir) / "hnsw" / "vdb"
    storage = _storage(base, dim, len(x))
    cfg = _config(dim, len(x), {"type": "hnsw", "M": 16,
                                "ef_construction": 200,
                                "flush_threshold": 1000}, base)
    index_file = base.with_suffix(".index.npz")
    svc = _service(storage, cfg, index_file)
    nodes = _nodes(x[:n], 0, tenants[:n])
    _, save_s = _timed(lambda: storage.save_many(nodes))
    _, build_s = _timed(lambda: svc.insert_nodes(nodes))
    del nodes
    t0 = time.perf_counter()
    for s in range(n, len(x), stream_batch):
        batch = _nodes(x[s:s + stream_batch], s, tenants[s:s + stream_batch])
        storage.save_many(batch)
        svc.insert_nodes(batch)
    svc.wait_for_flush()
    insert_s = time.perf_counter() - t0

    corpus = jnp.asarray(x)
    ref_d, ref_i = reference_topk(corpus, queries, k)

    ef = 50  # QueryRequest.ef default
    _, first_s = _timed(lambda: svc.search(queries[0], k=k, ef=ef))
    lat, single_ids = [], []
    for i in range(n_single):
        res, dt = _timed(lambda i=i: svc.search(queries[i], k=k, ef=ef))
        lat.append(dt)
        single_ids.append([node.id for node, _ in res]
                          + [-1] * (k - len(res)))
    single_recall = recall_at_k(ref_d[:n_single], ref_i[:n_single],
                                np.asarray(single_ids), corpus,
                                queries[:n_single], k)

    _, batch_first_s = _timed(lambda: svc.search_batch(queries, k, ef=ef))
    (_, ids), batch_s = _timed(lambda: svc.search_batch(queries, k, ef=ef))
    batch_recall = recall_at_k(ref_d, ref_i, ids, corpus, queries, k)

    fset = storage.filter_by_metadata({"tenant": "t3"})
    res, filt_s = _timed(lambda: svc.search(queries[0], k=k, ef=ef,
                                            filter_ids=fset))
    fmask = np.asarray(tenants) == 3
    fd, fi = reference_topk(corpus, queries[:1], k, mask=fmask)
    got = np.asarray([[node.id for node, _ in res] + [-1] * (k - len(res))])
    filt_recall = recall_at_k(fd, fi, got, corpus, queries[:1], k)
    filt_ok = all(fmask[node.id] for node, _ in res)

    j = n // 2 + 7
    res = svc.search(x[j], k=k, ef=ef)
    self_hit = bool(res) and res[0][0].id == j and res[0][1] < 1e-3
    if not self_hit:
        raise AssertionError(f"self-query of node {j} returned {res[:2]}")
    if not filt_ok:
        raise AssertionError("filtered search returned a non-matching id")

    before = svc.search_batch(queries[:10], k, ef=ef)[1]
    svc.save_index()
    del svc
    gc.collect()
    svc2, reopen_s = _timed(lambda: _service(storage, cfg, index_file))
    loaded = svc2.is_index_loaded()
    after = svc2.search_batch(queries[:10], k, ef=ef)[1]
    if not loaded or not np.array_equal(before, after):
        raise AssertionError(
            f"restart: loaded={loaded}, ids equal="
            f"{np.array_equal(before, after)}")
    del svc2
    storage.close()
    gc.collect()
    lat_ms = sorted(1e3 * t for t in lat)
    return {
        "n": n, "dim": dim, "n_stream": n_stream,
        "save_many_s": save_s, "bulk_build_s": build_s,
        "stream_insert_s": insert_s,
        "stream_insert_vps": n_stream / insert_s,
        "single_first_call_s": first_s,
        "single_p50_ms": float(np.percentile(lat_ms, 50)),
        "single_p99_ms": float(np.percentile(lat_ms, 99)),
        "single_recall_at_10": single_recall,
        "batch_first_call_s": batch_first_s,
        "batch_s": batch_s, "batch_qps": len(queries) / batch_s,
        "batch_recall_at_10": batch_recall,
        "filtered_s": filt_s, "filtered_recall_at_10": filt_recall,
        "self_query_hit": self_hit,
        "restart_loaded": loaded, "restart_ids_equal": True,
        "restart_reopen_s": reopen_s,
    }, corpus


# ----------------------------------------------------------------------
# phase 2: flat service, one run per precision
# ----------------------------------------------------------------------

def phase_flat(x, queries, tenants, corpus, workdir, precisions, k=K):
    n, dim = x.shape
    base = Path(workdir) / "flat" / "vdb"
    storage = _storage(base, dim, n)
    nodes = _nodes(x, 0, tenants)
    ref_d, ref_i = reference_topk(corpus, queries, k)
    out = {"n": n, "dim": dim, "batch": len(queries), "k": k}
    failed = []
    for p in precisions:
        cfg = _config(dim, n, {"type": "flat", "precision": p,
                               "flush_threshold": 10 * n}, base)
        svc = _service(storage, cfg, f"{base}-{p}.index.npz")
        _, ins_s = _timed(lambda: svc.insert_nodes(nodes))
        _, first_s = _timed(lambda: svc.search_batch(queries, k))
        reps = []
        for _ in range(3):
            (_, ids), dt = _timed(lambda: svc.search_batch(queries, k))
            reps.append(dt)
        rec = recall_at_k(ref_d, ref_i, ids, corpus, queries, k)
        med = statistics.median(reps)
        out[p] = {"insert_s": ins_s, "first_call_s": first_s,
                  "median_s": med, "qps": len(queries) / med,
                  "recall_at_10": rec, "gate": GATES[p]}
        if rec < GATES[p]:
            failed.append(f"{p}: recall@10 {rec:.5f} < {GATES[p]}")
        del svc
        gc.collect()
    storage.close()
    if failed:
        emit("serve-flat", **out)
        raise AssertionError("recall gate failed: " + "; ".join(failed))
    return out


# ----------------------------------------------------------------------
# phase 3: IVF-PQ service on the SIFT1M shape
# ----------------------------------------------------------------------

def phase_ivfpq(base_x, queries, workdir, ivf_k, n_probe=16, k=K,
                codec_queries=32):
    """IVF-PQ through the service, then every probe formulation at the
    service's probe shape: ``ADC_MODES`` through ``IvfIndex.search_batch``
    (on the GPU "gather" is the Triton LUT scan) and ``gather_xla``, the
    XLA gather the kernel replaces there."""
    from vector_db_tpu.index.ivf import (
        ADC_MODES, _ivf_pq_probe_cells, probe_qblock)

    n, dim = base_x.shape
    path = Path(workdir) / "ivf" / "vdb"
    storage = _storage(path, dim, n)
    cfg = _config(dim, n, {"type": "ivf", "ivf_k": ivf_k,
                           "flush_threshold": 10 * n,
                           "pq": {"chunks": 16, "residual": True}}, path)
    svc = _service(storage, cfg, path.with_suffix(".index.npz"))
    nodes = _nodes(base_x, 0, np.zeros(n, np.int64))
    storage.save_many(nodes)
    _, build_s = _timed(lambda: svc.insert_nodes(nodes))
    del nodes
    # first search trains the PQ codebooks (index.pq) and encodes
    (_, ids), first_s = _timed(
        lambda: svc.search_batch(queries, k, n_probe=n_probe))
    corpus = jnp.asarray(base_x)
    ref_d, ref_i = reference_topk(corpus, queries, k)
    out = {"n": n, "dim": dim, "ivf_k": ivf_k, "n_probe": n_probe,
           "batch": len(queries), "build_s": build_s,
           "first_search_s": first_s,
           "service_adc": svc._pq_adc,
           "service_recall_at_10": recall_at_k(ref_d, ref_i, ids, corpus,
                                               queries, k)}
    index = svc.index
    cells = index._device_cells()[0]
    probe_p = n_probe * int(cells.shape[1])
    codes_bytes = len(queries) * probe_p * index._pq.chunks
    out["probe_candidates_per_query"] = probe_p
    out["codes_bytes_per_batch"] = codes_bytes
    out["codes_hbm_bound_s"] = codes_bytes / 3.35e12
    qd = jnp.asarray(queries)
    cells, codes, cell_s = index._device_cells()
    probe_args = (index._centroids_dev, cells, codes, cell_s,
                  index._pq.codebooks, index._emb, index._has_emb, qd,
                  index._pq.rotate_queries(qd))

    def gather_xla():
        d, slots = _ivf_pq_probe_cells(
            *probe_args, n_probe=n_probe, top_k=k, fetch=max(4 * k, 100),
            rerank=True, residual=getattr(index, "_pq_residual", False),
            qblock=probe_qblock(probe_p, index._pq.chunks,
                                lut_kernel=False))
        return np.asarray(d), index._store.ids_of(np.asarray(slots))

    runs = {a: (lambda a=a: index.search_batch(
        queries, n_probe=n_probe, top_k=k, pq=True, adc=a))
        for a in ADC_MODES}
    runs["gather_xla"] = gather_xla
    for a, run in runs.items():
        _, warm_s = _timed(run)
        reps = []
        for _ in range(3):
            (_, ids), dt = _timed(run)
            reps.append(dt)
        med = statistics.median(reps)
        out[f"adc_{a}"] = {
            "first_call_s": warm_s, "median_s": med,
            "qps": len(queries) / med,
            "recall_at_10": recall_at_k(ref_d, ref_i, ids, corpus,
                                        queries, k),
            "hbm_bound_share": out["codes_hbm_bound_s"] / med}
    # PQCodec.adc_search (full scan, off the served path): matmul vs gather
    codes = jnp.asarray(index._pq.encode(base_x), jnp.int32)
    qc = queries[:codec_queries]
    for mode in ("matmul", "gather"):
        def run(mode=mode):
            return index._pq.adc_search(qc, codes, top_k=k, mode=mode)
        run()
        reps = [_timed(run)[1] for _ in range(3)]
        out[f"codec_{mode}_median_s"] = statistics.median(reps)
    del svc, index, codes, cells, cell_s, probe_args
    storage.close()
    gc.collect()
    return out


# ----------------------------------------------------------------------
# phase 4: hand-written kernels next to their plain formulations
# ----------------------------------------------------------------------

def _median_time(fn, args, reps=7):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _memory(fn, args):
    ma = fn.lower(*args).compile().memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def _decide(name, out):
    winner = ("triton" if out["triton_median_s"] < out["xla_median_s"]
              else "xla")
    out["decision"] = (
        f"{name} on gpu: {winner} "
        f"(triton {out['triton_median_s'] * 1e3:.3f} ms vs xla "
        f"{out['xla_median_s'] * 1e3:.3f} ms)")
    print(out["decision"], flush=True)
    return out


def kernel_block_topm(seed, b=BATCH, n=N_EMB, ds=128, m=2, block=128,
                      interpret=False):
    """Block top-m scan: Triton kernel vs the plain XLA formulation at the
    blocksel2p serving shape (bf16 mirror, f32 accumulation).

    The table is padded once to the kernel's corpus tiles, as the flat
    index keeps its mirror (``block_topm.pad_mirror``), padded rows invalid.

    Tolerance: both sides multiply the same bf16 operands exactly and
    accumulate in f32, only in another order, so values agree to ~1e-5
    relative and row ids differ only where two rows of a block tie to that
    precision — an ordering of ties, not an error. Gate: value relative
    error <= 1e-4, and every differing id's value within that tolerance.
    """
    from vector_db_tpu.ops.pallas.block_topm import (
        block_topm_triton, block_topm_xla, pad_mirror)

    kq, kx = jax.random.split(jax.random.PRNGKey(seed))
    q = jax.random.normal(kq, (b, ds), jnp.float32)
    x = jax.random.normal(kx, (n, ds), jnp.float32)
    tab, xsq = pad_mirror(x.astype(jnp.bfloat16), jnp.sum(x * x, axis=-1),
                          block=block)
    xsq = jnp.where(jnp.arange(tab.shape[0]) < n, xsq, 2.0e38)
    del x
    tri = jax.jit(partial(block_topm_triton, block=block, m=m,
                          interpret=interpret))
    xla = jax.jit(partial(block_topm_xla, block=block, m=m))
    args = (q, tab, xsq)
    tv, ti = tri(*args)
    xv, xi = xla(*args)
    tv, ti, xv, xi = map(np.asarray, (tv, ti, xv, xi))
    rel = np.abs(tv - xv) / np.maximum(np.abs(xv), 1.0)
    same = ti == xi
    ties_ok = bool((rel[~same] <= 1e-4).all())
    out = {"b": b, "n": n, "rows_padded": int(tab.shape[0]), "ds": ds,
           "m": m, "block": block,
           "max_abs_err": float(np.abs(tv - xv).max()),
           "max_rel_err": float(rel.max()),
           "equal_id_share": float(same.mean()),
           "differing_ids_are_ties": ties_ok,
           "tolerance_rel": 1e-4}
    if out["max_rel_err"] > 1e-4 or not ties_ok:
        emit("kernels", block_topm=out)
        raise AssertionError("block top-m kernel disagrees with XLA form")
    out["triton_median_s"] = _median_time(tri, args)
    out["xla_median_s"] = _median_time(xla, args)
    out["triton_memory"] = _memory(tri, args)
    out["xla_memory"] = _memory(xla, args)
    return _decide("block top-m", out)


def kernel_lut_probe(seed, b=BATCH, k=1024, L=12932, m=16, ksub=256,
                     n_probe=16, qblock=8, interpret=False):
    """IVF-PQ probe LUT scan: Triton kernel vs the XLA gather formulation
    (``ivf.adc_scores``) at the SIFT-shape probe widths (1024 cells padded
    to the largest, 12,932 rows; m=16, ksub=256; n_probe 16), on synthetic
    codes with log-normal cell lengths. Both sum the same f32 LUT entries
    in another order: tolerance 1e-5 relative on the occupied rows; the
    kernel leaves padded rows unwritten (callers mask them)."""
    from vector_db_tpu.index.ivf import adc_scores
    from vector_db_tpu.ops.pallas.lut_probe import lut_probe_scores

    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(6.5, 0.8, k), 1, L).astype(np.int32)
    lens[0] = L
    codes = jnp.asarray(rng.integers(0, ksub, (k, L, m), dtype=np.uint8))
    lut = jnp.asarray(rng.random((b, m * ksub), dtype=np.float32))
    probe = jnp.asarray(
        rng.integers(0, k, (b, n_probe)).astype(np.int32))
    cell_len = jnp.asarray(lens)
    tri = jax.jit(partial(lut_probe_scores, interpret=interpret))

    @jax.jit
    def xla(probe, cell_len, codes, lut):
        def one(pr, lr):
            return adc_scores(lr, codes[pr].reshape(-1, m), ksub)
        return jax.lax.map(
            lambda a: jax.vmap(one)(*a),
            (probe.reshape(-1, qblock, n_probe),
             lut.reshape(-1, qblock, m * ksub))).reshape(b, -1)

    args = (probe, cell_len, codes, lut)
    live = np.asarray(
        (jnp.arange(L)[None, None, :] < cell_len[probe][:, :, None])
        .reshape(b, -1))
    t, x = np.asarray(tri(*args)), np.asarray(xla(*args))
    rel = np.abs(t[live] - x[live]) / np.maximum(np.abs(x[live]), 1.0)
    out = {"b": b, "cells": k, "cell_rows_max": L, "m": m, "ksub": ksub,
           "n_probe": n_probe, "occupied_share": float(live.mean()),
           "max_abs_err": float(np.abs(t[live] - x[live]).max()),
           "max_rel_err": float(rel.max()), "tolerance_rel": 1e-5}
    if out["max_rel_err"] > 1e-5:
        emit("kernels", lut_probe=out)
        raise AssertionError("LUT probe kernel disagrees with XLA gather")
    out["triton_median_s"] = _median_time(tri, args)
    out["xla_median_s"] = _median_time(xla, args)
    out["triton_memory"] = _memory(tri, args)
    out["xla_memory"] = _memory(xla, args)
    return _decide("lut probe scoring", out)


def phase_kernels(seed):
    return {"block_topm": kernel_block_topm(seed),
            "lut_probe": kernel_lut_probe(seed)}


# ----------------------------------------------------------------------
# --four-cards: the sharded path (index.type: sharded-hnsw)
# ----------------------------------------------------------------------

def _bytes_in_use():
    return [int((d.memory_stats() or {}).get("bytes_in_use", 0))
            for d in jax.local_devices()]


def phase_sharded_flat(x, queries, n_dev, k=K):
    from vector_db_tpu.parallel.mesh import make_mesh
    from vector_db_tpu.parallel.sharded import ShardedFlatIndex

    n, dim = x.shape
    idx = ShardedFlatIndex(mesh=make_mesh(n_dev), dim=dim,
                           capacity_per_shard=-(-n // n_dev))
    idx.insert(range(n), x)
    mem = _bytes_in_use()
    _, first_s = _timed(lambda: idx.search_batch(queries, k))
    (_, ids), dt = _timed(lambda: idx.search_batch(queries, k))
    corpus = jnp.asarray(x)
    ref_d, ref_i = reference_topk(corpus, queries, k)
    equal = float((ids == ref_i).mean())
    rec = recall_at_k(ref_d, ref_i, ids, corpus, queries, k)
    del corpus
    out = {"n": n, "dim": dim, "devices": n_dev, "batch": len(queries),
           "first_call_s": first_s, "search_s": dt,
           "equal_id_share": equal, "recall_at_10": rec,
           "bytes_in_use_per_card": mem}
    if rec < 1.0:
        emit("sharded-flat", **out)
        raise AssertionError("sharded flat ids differ from the reference")
    return out


def phase_sharded_hnsw(x, queries, n_dev, k=K, ef=50):
    from vector_db_tpu.parallel.mesh import make_mesh
    from vector_db_tpu.parallel.sharded import ShardedHNSW

    n, dim = x.shape
    idx = ShardedHNSW(M=16, ef_construction=200, mesh=make_mesh(n_dev),
                      dim=dim, capacity_per_shard=-(-n // n_dev))
    _, build_s = _timed(lambda: idx.bulk_build(range(n), x))
    mem = _bytes_in_use()
    _, first_s = _timed(lambda: idx.search_batch(queries, k, ef=ef))
    (_, ids), dt = _timed(lambda: idx.search_batch(queries, k, ef=ef))
    corpus = jnp.asarray(x)
    ref_d, ref_i = reference_topk(corpus, queries, k)
    return {"n": n, "dim": dim, "devices": n_dev, "build_s": build_s,
            "first_call_s": first_s, "search_s": dt,
            "recall_at_10": recall_at_k(ref_d, ref_i, ids, corpus,
                                        queries, k),
            "bytes_in_use_per_card": mem}


# ----------------------------------------------------------------------

def _embedding_corpus(n, dim, nq, seed):
    from vector_db_tpu.datasets import embedding_like

    x = embedding_like(n + nq, dim, seed)
    return x[:n], x[n:]


def run_one_card(seed: int) -> None:
    note_cut(f"storage content/metadata widths {CONTENT_CHARS}/"
             f"{METADATA_CHARS} chars (reference 10240/5120)",
             "the reference widths take ~61 KB per row, 61 GB of metadata "
             "file at 1M rows; the documents here are short")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        _run_one_card(seed, workdir)


def _run_one_card(seed: int, workdir: str) -> None:
    from vector_db_tpu.datasets import sift_like

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    x, queries = _embedding_corpus(N_EMB + N_STREAM, DIM_EMB, BATCH, seed)
    tenants = rng.integers(0, N_TENANTS, size=len(x))
    gen_s = time.perf_counter() - t0
    fields, corpus = phase_hnsw(x, queries, tenants, N_STREAM,
                                STREAM_BATCH, workdir)
    emit("serve-hnsw", data_gen_s=gen_s, **fields)

    t0 = time.perf_counter()
    flat = phase_flat(x[:N_EMB], queries, tenants[:N_EMB],
                      corpus[:N_EMB], workdir, list(GATES))
    del corpus, x
    gc.collect()
    emit("serve-flat", phase_s=time.perf_counter() - t0, **flat)

    t0 = time.perf_counter()
    sx, sq = sift_like(N_SIFT, DIM_SIFT, seed=seed, queries=BATCH)
    ivf = phase_ivfpq(sx, sq, workdir, ivf_k=1024)
    emit("serve-ivfpq", phase_s=time.perf_counter() - t0, **ivf)
    del sx, sq
    gc.collect()

    emit("kernels", **phase_kernels(seed))


def run_four_cards(seed: int) -> None:
    n_dev = 4
    if len(jax.devices()) < n_dev:
        raise RuntimeError(
            f"--four-cards needs {n_dev} GPUs, found {len(jax.devices())}")
    x, q = _embedding_corpus(4 * N_EMB, DIM_EMB, BATCH, seed)
    emit("sharded-flat", **phase_sharded_flat(x, q, n_dev))
    del x
    gc.collect()
    x, q = _embedding_corpus(N_EMB, DIM_EMB, BATCH, seed + 1)
    emit("sharded-hnsw", **phase_sharded_hnsw(x, q, n_dev))


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    from vector_db_tpu.runtime import apply_device, enable_compilation_cache

    try:
        apply_device("gpu")
    except (RuntimeError, ValueError) as e:
        print(f"chip_smoke: no GPU for JAX ({e})", file=sys.stderr)
        return 2
    cache_dir = enable_compilation_cache()
    CARD = card_identity()
    dev = jax.devices()[0]
    print(f"devices: {jax.devices()}", flush=True)
    print(f"jax {jax.__version__}; compile cache: {cache_dir}", flush=True)
    print(f"card: {CARD}", flush=True)
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), jax=jax.__version__,
         compile_cache=cache_dir)

    t0 = time.perf_counter()
    if args.four_cards:
        run_four_cards(args.seed)
    else:
        run_one_card(args.seed)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
