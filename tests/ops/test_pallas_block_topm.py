"""Block top-m scan (ops/pallas/block_topm.py) vs a numpy oracle.

The XLA formulation runs as compiled on the CPU; the Triton kernel runs in
the Pallas interpreter (``interpret=True``). Its compiled form runs only
on the GPU, where chip_smoke.py compares it with the XLA form at the
serving shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_tpu.ops.pallas import block_topm as BT
from vector_db_tpu.ops.pallas.block_topm import block_topm_scan


def _oracle(q, tab, xsq_eff, block, m):
    """Per-block top-m values + global row ids, computed the slow way:
    [B, ceil(N/block)*m], a partial last block padded with +inf."""
    n = tab.shape[0]
    qb = np.asarray(jnp.asarray(q).astype(tab.dtype), np.float32)
    d = np.asarray(xsq_eff)[None, :] - 2.0 * qb @ np.asarray(
        tab, np.float32).T
    nb = -(-n // block)
    d = np.pad(d, ((0, 0), (0, nb * block - n)), constant_values=np.inf)
    db = d.reshape(d.shape[0], nb, block)
    order = np.argsort(db, axis=-1, kind="stable")[..., :m]
    vals = np.take_along_axis(db, order, axis=-1)      # [b, nb, m]
    rows = order + (np.arange(nb) * block)[None, :, None]
    return vals.reshape(d.shape[0], -1), rows.reshape(d.shape[0], -1)


def _case(n, ds, b, seed=0, invalid_every=13):
    rng = np.random.default_rng(seed)
    tab = jnp.asarray(
        rng.standard_normal((n, ds)).astype(np.float32)
    ).astype(jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((b, ds)).astype(np.float32))
    xsq = jnp.asarray((rng.random(n) * 10).astype(np.float32))
    vm = np.ones(n, bool)
    vm[::invalid_every] = False
    return q, tab, jnp.where(jnp.asarray(vm), xsq, 2.0e38)


def _check(vals, rows, ov, orw):
    vals, rows = np.asarray(vals), np.asarray(rows)
    assert vals.shape == ov.shape and rows.shape == orw.shape
    live = ov < 1e37
    # dot order differs from numpy's: f32 accumulation, ~1e-5 relative
    np.testing.assert_allclose(vals[live], ov[live], rtol=2e-5, atol=2e-4)
    assert (vals[~live] >= 1e37).all()
    # ids agree wherever values are distinct; a differing id is a tie
    mism = (rows != orw) & live
    if mism.any():
        np.testing.assert_allclose(vals[mism], ov[mism], rtol=2e-5,
                                   atol=2e-4)


@pytest.mark.parametrize("n,ds,b,m", [(4096 + 512, 64, 37, 4),
                                      (2048, 128, 8, 2)])
def test_matches_xla_oracle(n, ds, b, m):
    q, tab, xsq_eff = _case(n, ds, b)
    vals, rows = block_topm_scan(q, tab, xsq_eff, block=128, m=m)
    _check(vals, rows, *_oracle(q, tab, xsq_eff, 128, m))


# N not a block multiple, B not a query-tile multiple, ds not a power of
# two, m in {1, 2, 4}
EDGE_CASES = [(1000, 32, 37, 1), (300, 24, 5, 2), (1100, 64, 70, 4)]


@pytest.mark.parametrize("n,ds,b,m", EDGE_CASES)
def test_xla_matches_oracle_edge_shapes(n, ds, b, m):
    q, tab, xsq_eff = _case(n, ds, b, seed=n)
    vals, rows = BT.block_topm_xla(q, tab, xsq_eff, block=128, m=m,
                                   tile=256)
    _check(vals, rows, *_oracle(q, tab, xsq_eff, 128, m))


@pytest.mark.parametrize("n,ds,b,m", EDGE_CASES + [(2048, 128, 8, 2)])
def test_triton_interpret_matches_oracle(n, ds, b, m):
    q, tab, xsq_eff = _case(n, ds, b, seed=n + 1)
    vals, rows = BT.block_topm_triton(q, tab, xsq_eff, block=128, m=m,
                                      qtile=16, groups=2, interpret=True)
    _check(vals, rows, *_oracle(q, tab, xsq_eff, 128, m))


def test_triton_fully_invalid_block():
    q, tab, _ = _case(512, 32, 4)
    xsq_eff = jnp.where(jnp.arange(512) < 128, 2.0e38, 1.0)
    vals, _ = BT.block_topm_triton(q, tab, xsq_eff, block=128, m=2,
                                   qtile=16, groups=2, interpret=True)
    vals = np.asarray(vals)
    assert (vals[:, :2] > 1.0e37).all()
    assert (vals[:, 2:] < 1.0e37).all()


@pytest.mark.parametrize("platform,fn", [("gpu", "block_topm_triton"),
                                         ("cpu", "block_topm_xla")])
def test_impl_per_platform(platform, fn):
    assert BT.block_topm_impl(platform) is getattr(BT, fn)


@pytest.mark.parametrize("platform", ["metal", "rocm"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no formulation"):
        BT.block_topm_impl(platform)


def test_scan_routes_by_backend_and_interpret(monkeypatch):
    calls = []

    def fake(name):
        def f(*a, **kw):
            calls.append((name, kw.get("interpret", False)))
            return "out"
        return f

    monkeypatch.setattr(BT, "block_topm_triton", fake("triton"))
    monkeypatch.setattr(BT, "block_topm_xla", fake("xla"))
    monkeypatch.setattr(BT, "_BY_PLATFORM",
                        {"gpu": BT.block_topm_triton,
                         "cpu": BT.block_topm_xla})
    assert jax.default_backend() == "cpu"
    block_topm_scan(None, None, None)
    block_topm_scan(None, None, None, interpret=True)
    assert calls == [("xla", False), ("triton", True)]


def test_two_phase_matches_exact():
    from vector_db_tpu.ops.exact import (
        block_select_search_2p,
        exact_search_tiled,
    )

    rng = np.random.default_rng(3)
    n, d_dim, b, k = 8192, 64, 16, 5
    a = rng.standard_normal((24, d_dim)).astype(np.float32)
    x = (rng.standard_normal((n, 24)).astype(np.float32) @ a
         + 0.01 * rng.standard_normal((n, d_dim)).astype(np.float32))
    q = (rng.standard_normal((b, 24)).astype(np.float32) @ a
         + 0.01 * rng.standard_normal((b, d_dim)).astype(np.float32))
    emb, qd = jnp.asarray(x), jnp.asarray(q)
    valid = jnp.ones((n,), bool)
    xsq = jnp.sum(emb * emb, -1)
    cov = np.asarray(jnp.dot(emb.T, emb)) / n
    _, v = np.linalg.eigh(cov.astype(np.float64))
    proj = jnp.asarray(v[:, ::-1][:, :32].astype(np.float32))
    tab = jnp.dot(emb, proj).astype(jnp.bfloat16)
    qp = jnp.dot(qd, proj)
    gd, gi = exact_search_tiled(qd, emb, valid, k, tile=1024)
    dd, ii = block_select_search_2p(qd, tab, qp, xsq, emb, valid, k,
                                    block=128, m=4, rows_k=64)
    np.testing.assert_array_equal(np.asarray(ii), np.asarray(gi))
    np.testing.assert_allclose(np.asarray(dd), np.asarray(gd), rtol=1e-5)


def test_deleted_rows_never_returned():
    from vector_db_tpu.ops.exact import block_select_search_2p

    rng = np.random.default_rng(7)
    n, d_dim, b, k = 2048, 32, 8, 10
    emb = jnp.asarray(rng.standard_normal((n, d_dim)).astype(np.float32))
    qd = emb[:b] + 0.01  # queries near deleted rows
    valid = jnp.asarray(np.arange(n) % 2 == 1)  # evens deleted (incl. 0..b)
    xsq = jnp.sum(emb * emb, -1)
    tab = emb.astype(jnp.bfloat16)
    dd, ii = block_select_search_2p(qd, tab, qd, xsq, emb, valid, k,
                                    block=128, m=4, rows_k=64)
    ids = np.asarray(ii)
    assert ((ids == -1) | (ids % 2 == 1)).all()
    assert (ids >= 0).any()  # and it does return live neighbors


@pytest.mark.parametrize("n", [1000, 2048, 4100])
def test_pad_mirror_whole_kernel_tiles(n):
    """pad_mirror leaves the Triton wrapper nothing to pad: rows become a
    multiple of every corpus tile it may choose (groups * block)."""
    tab = jnp.ones((n, 16), jnp.bfloat16)
    x_sq = jnp.ones((n,), jnp.float32)
    t, s = BT.pad_mirror(tab, x_sq)
    assert t.shape[0] % (BT._GROUPS * 128) == 0 and t.shape[0] >= n
    assert s.shape == (t.shape[0],)
    np.testing.assert_array_equal(np.asarray(t[n:], np.float32), 0.0)
    assert (t.shape[0] == n) == (n % (BT._GROUPS * 128) == 0)
