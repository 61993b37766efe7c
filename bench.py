#!/usr/bin/env python
"""Headline benchmark: query throughput at recall@10 >= 0.95, one GPU.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": <QPS at recall@10>=0.95 on 1M x 768-d>,
   "unit": "qps", "vs_baseline": <ours / reference, matched corpus>,
   "device": {platform, kind, count}, "card": "<name>, <power limit>"}

The engine serves a recall target with whichever index mode is fastest at
that target; the scan modes (f32-exact, bf16 + approximate top-k, and the
3- and 2-phase block-select scans) are measured at 1M x 768 against f32
ground truth, HNSW graph-mode operating points at BENCH_N.

vs_baseline is a matched head-to-head: the reference (pure-Python HNSW on
CPU — its only search path) and this engine run on the SAME corpus
(BENCH_REF_N vectors), each at its fastest mode reaching recall@10 >= 0.95
against exact ground truth; the ratio compares those operating points.

Data: synthetic "embedding-like" vectors — low intrinsic dimension
(rank-64 mixing + noise, L2-normalized), matching the structure of real
sentence-embedding corpora (the reference's default all-MiniLM-L6-v2 is
384-d L2-normalized; BASELINE.md config 1). See vector_db_tpu/datasets.py.

Every timed call ends in a host transfer of its result, after warm-up
calls that compile. Without a GPU the script fails.

Env knobs:
  BENCH_N          corpus for the HNSW detail numbers (default 100000)
  BENCH_HEADLINE_N corpus for the headline scan numbers (default 1000000)
  BENCH_REF_N      corpus size for the head-to-head (default 10000)
  BENCH_QUERIES    query batch (default 1000)
  BENCH_REF_SRC    the reference's ``src`` directory (measured when set)
  BENCH_REF_CACHE  path of the reference-measurement cache JSON

All diagnostics go to stderr; details are written to BENCH_DETAILS.json.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def recall_at_k(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    return float(
        np.mean([len(set(ids[i][:k]) & set(gt[i][:k])) / k
                 for i in range(len(gt))])
    )


REP_TIMES: dict = {}  # label -> per-rep wall times


def timed_qps(run, q, n_q: int, reps: int = 3, warmups: int = 2,
              label: str | None = None):
    """Median QPS of ``run(query_batch) -> result`` over ``reps`` calls
    after ``warmups`` untimed ones; ``run`` returns host (numpy) arrays,
    so each timed call includes the device work."""
    for _ in range(warmups):
        run(q)
    outs = []
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs.append(run(q))
        times.append(time.perf_counter() - t0)
    if label is not None:
        REP_TIMES[label] = times
    return n_q / float(np.median(times)), outs


EF_SWEEP = [100, 150, 200, 300, 400, 600]


def bench_ours(x: np.ndarray, q: np.ndarray, k: int, target: float):
    """Build + tune + measure this engine. Returns dict of results."""
    import jax
    import jax.numpy as jnp

    from vector_db_tpu.index import hnsw_kernels as K
    from vector_db_tpu.index.hnsw import HNSW
    from vector_db_tpu.ops.exact import exact_search_tiled

    n = x.shape[0]
    t0 = time.perf_counter()
    index = HNSW(M=16, ef_construction=200, rng=random.Random(42),
                 capacity=n, l_max=5)
    index.bulk_build(list(range(n)), x)
    jax.block_until_ready(index.graph.neighbors)
    build_s = time.perf_counter() - t0

    qd = jnp.asarray(q)
    gt = np.asarray(
        exact_search_tiled(qd, index._emb, index._has_emb, k, tile=25088)[1]
    )

    def run_exact(qv):
        return np.asarray(exact_search_tiled(
            qv, index._emb, index._has_emb, k, tile=25088)[1])

    exact_qps, _ = timed_qps(run_exact, qd, len(q), label=f"exact_n{n}")

    chosen = None
    for ef in EF_SWEEP:
        ms = 2 * ef + 16

        def run(qv):
            return np.asarray(K.search_batch(
                index.graph, index._emb, index._has_emb, qv, None,
                M=16, l_max=5, ef=ef, k=k, max_steps=ms,
                use_filter=False, pool=ef, expand=4,
            )[1])

        qps, outs = timed_qps(run, qd, len(q), label=f"hnsw_n{n}_ef{ef}")
        rec = recall_at_k(outs[-1], gt, k)
        log(f"  ours n={n} ef={ef}: recall@{k}={rec:.3f} qps={qps:.0f}")
        chosen = {"ef": ef, "recall": rec, "qps": qps}
        if rec >= target:
            break
    chosen["build_s"] = build_s
    chosen["build_vps"] = n / build_s
    chosen["exact_qps"] = exact_qps

    # wide-beam graph mode (frontier-parallel traversal): one operating
    # point at the same corpus/ground truth
    index.enable_wide()
    ef_w = 512

    def run_wide(qv):
        return index.search_batch_wide(np.asarray(qv), k=k, ef=ef_w)[1]

    qps_w, outs_w = timed_qps(run_wide, qd, len(q), label=f"hnsw_wide_n{n}")
    rec_w = recall_at_k(outs_w[-1], gt, k)
    log(f"  ours(wide) n={n} ef={ef_w}: recall@{k}={rec_w:.3f} qps={qps_w:.0f}")
    chosen["wide"] = {"ef": ef_w, "recall": rec_w, "qps": qps_w}

    # pool-free beam variant (merge-light traversal) at the same corpus
    def run_beam(qv):
        return index.search_batch_beam(np.asarray(qv), k=k, frontier=64,
                                       steps=12)[1]

    qps_b, outs_b = timed_qps(run_beam, qd, len(q), label=f"hnsw_beam_n{n}")
    rec_b = recall_at_k(outs_b[-1], gt, k)
    log(f"  ours(beam) n={n} F=64 T=12: recall@{k}={rec_b:.3f} "
        f"qps={qps_b:.0f}")
    chosen["beam"] = {"F": 64, "T": 12, "recall": rec_b, "qps": qps_b}
    return chosen


def bench_reference(x: np.ndarray, q: np.ndarray, k: int, target: float,
                    cache_path: Path, ref_src: str | None):
    """Measure the reference HNSW (pure Python, CPU) at the same config,
    from ``ref_src`` when given, else from the cache."""
    key = f"n{x.shape[0]}_d{x.shape[1]}_M16_efc200_q{len(q)}"
    if cache_path.exists():
        cached = json.loads(cache_path.read_text())
        if cached.get("key") == key:
            log(f"  reference: using cached measurement {cached}")
            return cached
    if not ref_src:
        log("  reference: no cache and no BENCH_REF_SRC -> vs_baseline null")
        return None

    sys.path.insert(0, ref_src)
    from vector_db.indexing.hnsw import HNSW as RefHNSW  # noqa: E402
    from vector_db.types import Node as RefNode  # noqa: E402

    n = x.shape[0]
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :k]

    t0 = time.perf_counter()
    ref = RefHNSW(M=16, ef_construction=200, rng=random.Random(42))
    for i in range(n):
        ref.insert_node(RefNode(id=i, embedding=x[i], metadata={}, content=None))
        if i and i % 2000 == 0:
            log(f"  reference build {i}/{n} "
                f"({i / (time.perf_counter() - t0):.0f} vec/s)")
    build_s = time.perf_counter() - t0

    result = None
    for ef in EF_SWEEP:
        t0 = time.perf_counter()
        all_ids = []
        for qi in range(len(q)):
            res = ref.search(q[qi], k=k, ef=ef)
            all_ids.append([node.id for node, _ in res])
        el = time.perf_counter() - t0
        rec = float(np.mean(
            [len(set(all_ids[i]) & set(gt[i])) / k for i in range(len(q))]
        ))
        qps = len(q) / el
        log(f"  reference ef={ef}: recall@{k}={rec:.3f} qps={qps:.0f}")
        result = {"key": key, "ef": ef, "recall": rec, "qps": qps,
                  "build_s": build_s, "build_vps": n / build_s}
        if rec >= target:
            break
    cache_path.write_text(json.dumps(result))
    return result


def bench_scan_headline(n: int, dim: int, n_q: int, k: int):
    """Scan-mode QPS at the north-star corpus shape: f32-exact (recall 1.0
    by construction), the bf16 + approximate top-k scan and the 3- and
    2-phase block-select scans, measured against the f32 ground truth."""
    import jax
    import jax.numpy as jnp

    from vector_db_tpu.datasets import embedding_like
    from vector_db_tpu.ops.exact import (
        approx_search_tiled,
        block_select_search_2p,
        block_select_search_3p,
        exact_search_tiled,
    )

    log(f"generating {n}x{dim} headline corpus...")
    data = embedding_like(n + n_q, dim, seed=1, intrinsic=64)
    x = jnp.asarray(data[:n])
    q = jnp.asarray(data[n:])
    valid = jnp.ones((n,), bool)
    x_bf16 = x.astype(jnp.bfloat16)
    x_sq = jnp.sum(x * x, axis=-1)
    jax.block_until_ready((x_bf16, x_sq))
    tile = 31250 if n % 31250 == 0 else 25000
    tile16 = 125000 if n % 125000 == 0 else tile
    cov = np.asarray(jax.jit(
        lambda e: jnp.dot(e.T, e, preferred_element_type=jnp.float32))(x)
    ) / n
    _, vecs = np.linalg.eigh(cov.astype(np.float64))
    proj = jnp.asarray(vecs[:, ::-1][:, :128].astype(np.float32))
    ptab = jnp.dot(x, proj,
                   preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    jax.block_until_ready(ptab)

    def run_exact(qv):
        return np.asarray(exact_search_tiled(qv, x, valid, k, tile=tile)[1])

    def run_bf16(qv):
        return np.asarray(approx_search_tiled(
            qv, x_bf16, valid, k, tile=tile16, x_sq=x_sq)[1])

    def run_3p(qv):
        qp = jnp.dot(qv, proj, preferred_element_type=jnp.float32)
        return np.asarray(block_select_search_3p(
            qv, ptab, qp, x_sq, x, valid, k, blocks_k=2 * k,
            rows_k=4 * k, p2_chunk=2)[1])

    def run_2p(qv):
        qp = jnp.dot(qv, proj, preferred_element_type=jnp.float32)
        return np.asarray(block_select_search_2p(
            qv, ptab, qp, x_sq, x, valid, k, block=128, m=2,
            rows_k=8 * k)[1])

    gt = run_exact(q)
    out = {"n": n, "dim": dim}
    for name, run in (("exact_f32", run_exact), ("bf16_scan", run_bf16),
                      ("blocksel_3p", run_3p), ("blocksel_2p", run_2p)):
        qps, outs = timed_qps(run, q, n_q, label=f"headline_{name}_{n}")
        rec = recall_at_k(outs[-1], gt, k)
        log(f"  {name} {n // 1000}k x {dim}d: {qps:.0f} qps "
            f"(recall@{k}={rec:.4f} vs f32 exact)")
        out[name] = {"qps": qps, "recall": rec}
    return out


def main() -> None:
    from vector_db_tpu.runtime import apply_device, enable_compilation_cache

    apply_device("gpu")  # raises without a GPU: no CPU fallback
    enable_compilation_cache()
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"devices: {jax.devices()} card: {card}")

    n = int(os.environ.get("BENCH_N", 100_000))
    headline_n = int(os.environ.get("BENCH_HEADLINE_N", 1_000_000))
    ref_n = int(os.environ.get("BENCH_REF_N", 10_000))
    n_q = int(os.environ.get("BENCH_QUERIES", 1000))
    ref_q = min(n_q, 200)  # reference is ~ms per query; keep its sweep sane
    cache_path = Path(os.environ.get("BENCH_REF_CACHE", ".bench_ref.json"))
    dim, k, target = 384, 10, 0.95

    from vector_db_tpu.datasets import embedding_like

    log(f"bench: hnsw_N={n} headline_N={headline_n} ref_N={ref_n} "
        f"queries={n_q} target recall@{k}>={target}")
    data = embedding_like(n + n_q, dim, seed=0)
    x, q = data[:n], data[n:]

    log("== ours: HNSW detail @ N ==")
    ours_hnsw = bench_ours(x, q, k, target)

    log("== ours @ head-to-head N (hnsw + exact) ==")
    ours_small = bench_ours(x[:ref_n], q, k, target)
    ours_small_best = max(ours_small["qps"], ours_small["exact_qps"])

    log("== reference @ head-to-head N ==")
    ref = bench_reference(x[:ref_n], q[:ref_q], k, target, cache_path,
                          os.environ.get("BENCH_REF_SRC"))

    log("== headline: scan modes @ north-star corpus ==")
    headline = bench_scan_headline(headline_n, 768, n_q, k)
    modes = {m: headline[m]
             for m in ("bf16_scan", "blocksel_3p", "blocksel_2p",
                       "exact_f32")
             if headline[m]["recall"] >= target}
    best_mode = max(modes, key=lambda m: modes[m]["qps"]) \
        if modes else "exact_f32"
    best = headline[best_mode]

    vs_baseline = (ours_small_best / ref["qps"]) if ref else None

    details = {
        "device": device, "card": card,
        "config": {"hnsw_N": n, "headline_N": headline_n, "ref_N": ref_n,
                   "dim": dim, "k": k, "target_recall": target,
                   "M": 16, "ef_construction": 200},
        "headline_1M_768": headline,
        "ours_hnsw_detail": ours_hnsw,
        "ours_matched": {**ours_small, "best_mode_qps": ours_small_best},
        "reference": ref,
        "vs_baseline": vs_baseline,
        "rep_times_s": REP_TIMES,
    }
    Path("BENCH_DETAILS.json").write_text(json.dumps(details, indent=2))
    log(json.dumps(details, indent=2))

    mode_names = {
        "bf16_scan": "bf16 scan + approximate top-k",
        "blocksel_3p": "3-phase block-select scan",
        "blocksel_2p": "2-phase block-select scan (block top-m kernel)",
        "exact_f32": "f32-exact scan",
    }
    print(json.dumps({
        "metric": (
            f"QPS/GPU at recall@10>=0.95 on {headline_n:,} x 768-d "
            f"(best mode: "
            f"{mode_names[best_mode]}, recall {best['recall']:.4f} vs f32 "
            "exact; f32-exact recall-1.0 mode = "
            f"{headline['exact_f32']['qps']:.0f} qps); vs_baseline = "
            f"best-mode QPS ratio vs reference on matched {ref_n // 1000}k "
            "corpus"
        ),
        "value": best["qps"],
        "unit": "qps",
        "vs_baseline": vs_baseline,
        "device": device,
        "card": card,
    }))


if __name__ == "__main__":
    main()
