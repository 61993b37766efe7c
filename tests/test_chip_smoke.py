"""chip_smoke.py at tiny sizes on the CPU: its phase functions, its
reference and recall, and its refusal to run without a GPU."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    from vector_db_tpu.datasets import embedding_like

    x = embedding_like(700 + 32, 32, seed=0)
    return x[:700], x[700:], np.arange(700) % 10


def test_main_exits_nonzero_off_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_reference_and_recall(cs, rng):
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    d, i = cs.reference_topk(jnp.asarray(x), q, 5, qchunk=4)
    full = ((q[:, None] - x[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i, np.argsort(full, 1)[:, :5])
    np.testing.assert_allclose(d, np.sort(full, 1)[:, :5], rtol=1e-4)
    corpus = jnp.asarray(x)
    assert cs.recall_at_k(d, i, i, corpus, q, 5) == 1.0
    # a duplicate of a neighbor row is a tie, and counts as a hit
    dup = np.concatenate([x, x[i[:, :1]].reshape(-1, 16)])
    got = i.copy()
    got[:, 0] = 300 + np.arange(9)
    assert cs.recall_at_k(d, i, got, jnp.asarray(dup), q, 5) == 1.0
    got[:, 0] = -1
    assert cs.recall_at_k(d, i, got, corpus, q, 5) == pytest.approx(0.8)


def test_phase_hnsw_tiny(cs, data, tmp_path):
    x, q, tenants = data
    out, corpus = cs.phase_hnsw(x, q, tenants, 100, 50, tmp_path,
                                n_single=4)
    assert out["self_query_hit"] and out["restart_loaded"]
    assert out["batch_recall_at_10"] > 0.9
    assert corpus.shape == x.shape


def test_phase_flat_tiny(cs, data, tmp_path):
    x, q, tenants = data
    out = cs.phase_flat(x, q, tenants, jnp.asarray(x), tmp_path,
                        ["f32", "bf16", "blocksel"])
    for p in ("f32", "bf16", "blocksel"):
        assert out[p]["recall_at_10"] >= cs.GATES[p]
    json.dumps(out)


def test_phase_ivfpq_tiny(cs, tmp_path):
    from vector_db_tpu.datasets import sift_like

    x, q = sift_like(4096, 32, seed=0, queries=16)
    out = cs.phase_ivfpq(x, q, tmp_path, ivf_k=16, n_probe=4,
                         codec_queries=4)
    for a in ("gather", "gather_xla"):
        assert out[f"adc_{a}"]["recall_at_10"] > 0.5
    assert out["service_adc"] == "gather"
    json.dumps(out)


def test_kernel_block_topm_tiny(cs):
    out = cs.kernel_block_topm(0, b=40, n=1000, ds=32, interpret=True)
    assert out["max_rel_err"] <= 1e-4 and out["differing_ids_are_ties"]
    assert out["decision"].startswith("block top-m on gpu:")


def test_kernel_lut_probe_tiny(cs):
    out = cs.kernel_lut_probe(0, b=16, k=8, L=300, m=4, ksub=16,
                              n_probe=3, qblock=4, interpret=True)
    assert out["max_rel_err"] <= 1e-5
    assert out["decision"].startswith("lut probe scoring on gpu:")


def test_phase_sharded_tiny(cs, data):
    x, q, _ = data
    flat = cs.phase_sharded_flat(x, q, 4)
    assert flat["recall_at_10"] == 1.0 and flat["devices"] == 4
    hnsw = cs.phase_sharded_hnsw(x, q, 4)
    assert hnsw["recall_at_10"] > 0.9
