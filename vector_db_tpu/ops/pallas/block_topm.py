"""Block top-m scan: phase 1 of the two-phase exact search.

For every ``block`` consecutive corpus rows, each query gets the ``m``
smallest mirror distances ``xsq_eff - 2 q·x`` and their global row ids.
One global ``lax.top_k`` over the ``[B, N/block * m]`` estimates then
yields the exact-rescore candidate set (ops/exact.py
block_select_search_2p) — no block gather, no mirror re-score, no second
selection.

Candidate-set contract: a true top-k row survives iff it is among the best
``m`` mirror rows of its own 128-row block AND among the best ``rows_k``
emitted estimates globally. Blocks are slot-order (insertion order),
uncorrelated with query neighborhoods, so >m of a query's true top-k
landing in one block is the only structural failure mode.

Two formulations with one output contract:

- :func:`block_topm_xla` — plain ``jnp``/``lax``: tile matmul, reshape to
  ``[B, nb, block]``, ``lax.top_k``. It writes the f32 ``[B, tile]``
  distance panel to device memory and reads it back for the selection.
  The CPU path, and the reference the kernel is measured against.
- :func:`block_topm_triton` — Pallas through Triton, the GPU path. Each
  program takes one query tile and ``groups`` corpus blocks, runs the
  bf16 dot with f32 accumulation, adds the norms, and makes ``m`` masked
  min/argmin passes per block in registers. Only the ``[N/block*m, B]``
  values and ids reach device memory — 1/64 of the panel at m=2.

:func:`block_topm_scan` picks one by platform (``gpu`` -> Triton, ``cpu``
-> XLA, anything else an error); ``interpret=True`` runs the Triton
kernel in the Pallas interpreter, as the CPU tests do.

Masking: callers fold validity into ``xsq_eff`` (invalid rows ~2e38); the
kernels stay pure arithmetic and invalid rows carry estimates >= 1e37.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_BIG = 3.0e38
_PAD_XSQ = 2.0e38
# Triton launch shape: the fastest of a sweep over warps {4, 8} x stages
# {2, 3} at B=1000, N=1M, ds=128, m=2 on an H100 (PERF.md)
_NUM_WARPS, _NUM_STAGES = 8, 2
# corpus blocks per Triton program (block_topm_triton ``groups``)
_GROUPS = 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_mirror(tab, x_sq, block: int = 128):
    """A mirror table and its row norms padded with zero rows to a whole
    number of the Triton kernel's corpus tiles, so that no call pads (and
    copies) the table. Callers mark the padded rows invalid, as the
    block-select scans of ops/exact.py do by zero-extending ``valid``."""
    n_pad = _round_up(tab.shape[0], _GROUPS * block)
    pad = n_pad - tab.shape[0]
    if not pad:
        return tab, x_sq
    return (jnp.concatenate([tab, jnp.zeros((pad, tab.shape[1]), tab.dtype)]),
            jnp.concatenate([x_sq, jnp.zeros((pad,), x_sq.dtype)]))


def _pad_rows(tab, xsq_eff, n_pad):
    pad = n_pad - tab.shape[0]
    if pad:
        tab = jnp.concatenate([tab, jnp.zeros((pad, tab.shape[1]), tab.dtype)])
        xsq_eff = jnp.concatenate(
            [xsq_eff, jnp.full((pad,), _PAD_XSQ, xsq_eff.dtype)])
    return tab, xsq_eff


@functools.partial(jax.jit, static_argnames=("block", "m", "tile"))
def block_topm_xla(
    score_q: jnp.ndarray,   # [B, ds] queries in score space (any float)
    tab: jnp.ndarray,       # bf16|f32[N, ds] mirror table
    xsq_eff: jnp.ndarray,   # f32[N] row norms with invalid rows ~2e38
    block: int = 128,
    m: int = 2,
    tile: int = 65536,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-block top-``m`` of ``xsq_eff - 2 q·x`` in plain XLA.

    Returns ``(vals f32[B, NB*m], rows int32[B, NB*m])`` with
    ``NB = ceil(N / block)``; entry ``bi * m + j`` is the j-th best row of
    block ``bi`` (ascending within a block). ``rows`` are global row ids
    and may point past ``N`` for a partial last block — those carry
    vals >= 1e37 and must be masked by the caller. The rank-invariant
    ``q_sq`` term is omitted; the -2 is folded into the query operand.
    """
    b = score_q.shape[0]
    n = tab.shape[0]
    nb = -(-n // block)
    tile = min(_round_up(tile, block), nb * block)
    n_pad = _round_up(n, tile)
    tab, xsq_eff = _pad_rows(tab, xsq_eff, n_pad)
    q = (score_q * -2.0).astype(tab.dtype)
    n_tiles = n_pad // tile

    def body(_, xs):
        t_tab, t_xsq = xs
        d = jnp.dot(q, t_tab.T, preferred_element_type=jnp.float32)
        d = (d + t_xsq[None, :]).reshape(b, tile // block, block)
        neg, pos = jax.lax.top_k(-d, m)                 # [B, tile/block, m]
        return None, (-neg, pos.astype(jnp.int32))

    _, (vals, pos) = jax.lax.scan(
        body, None,
        (tab.reshape(n_tiles, tile, -1), xsq_eff.reshape(n_tiles, tile)))
    # [n_tiles, B, tile/block, m] -> [B, n_blocks_padded, m]
    vals = jnp.moveaxis(vals, 0, 1).reshape(b, -1, m)[:, :nb]
    pos = jnp.moveaxis(pos, 0, 1).reshape(b, -1, m)[:, :nb]
    rows = pos + (jnp.arange(nb, dtype=jnp.int32) * block)[None, :, None]
    return vals.reshape(b, nb * m), rows.reshape(b, nb * m)


def _triton_kernel(q_ref, x_ref, xsq_ref, vals_ref, idx_ref, *, block, m,
                   groups):
    q = q_ref[...]                             # [BQ, ds], pre-scaled by -2
    lane = jax.lax.broadcasted_iota(jnp.int32, (q.shape[0], block), 1)
    base = pl.program_id(1) * (groups * block)

    def one_block(g, carry):
        rs = pl.ds(g * block, block)
        x = x_ref[rs, :]                       # [block, ds]
        d = pl.dot(q, x, trans_b=True) + xsq_ref[rs][None, :]  # f32
        for j in range(m):
            mv = jnp.min(d, axis=1)                            # [BQ]
            # first-match argmin: smallest lane attaining the min
            mi = jnp.min(jnp.where(d == mv[:, None], lane, block), axis=1)
            vals_ref[g * m + j, :] = mv
            idx_ref[g * m + j, :] = mi + (base + g * block)
            if j + 1 < m:
                d = jnp.where(lane == mi[:, None], _BIG, d)
        return carry

    jax.lax.fori_loop(0, groups, one_block, 0)


@functools.partial(jax.jit, static_argnames=(
    "block", "m", "qtile", "groups", "interpret"))
def block_topm_triton(
    score_q: jnp.ndarray,   # [B, ds] queries in score space (any float)
    tab: jnp.ndarray,       # bf16|f32[N, ds] mirror table
    xsq_eff: jnp.ndarray,   # f32[N] row norms with invalid rows ~2e38
    block: int = 128,
    m: int = 2,
    qtile: int = 128,
    groups: int = _GROUPS,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Same contract as :func:`block_topm_xla`, as a Pallas-Triton kernel.

    Grid: query tiles on the fastest axis, so the programs in flight share
    one corpus tile from L2 and the corpus streams from device memory
    about once per call. A table whose rows are not a whole number of
    corpus tiles is padded by a copy on every call; indexes keep their
    mirror padded (:func:`pad_mirror`) so that copy is never made. ``ds``
    is zero-padded to a power of two >= 16 (Triton's block and dot
    constraints); zero columns leave every dot unchanged. ``qtile`` and
    ``groups`` default to the launch shape chosen with ``_NUM_WARPS`` /
    ``_NUM_STAGES`` (PERF.md).
    """
    b, ds = score_q.shape
    n = tab.shape[0]
    nb = -(-n // block)
    dsp = max(16, pl.next_power_of_2(ds))
    qtile = max(16, min(qtile, pl.next_power_of_2(b)))
    groups = max(1, min(groups, pl.next_power_of_2(nb)))
    span = groups * block
    n_pad = _round_up(n, span)
    b_pad = _round_up(b, qtile)
    tab, xsq_eff = _pad_rows(tab, xsq_eff.astype(jnp.float32), n_pad)
    q = (score_q * -2.0).astype(tab.dtype)
    q = jnp.pad(q, ((0, b_pad - b), (0, dsp - ds)))
    if dsp != ds:
        tab = jnp.pad(tab, ((0, 0), (0, dsp - ds)))
    grid = (b_pad // qtile, n_pad // span)

    vals, idx = pl.pallas_call(
        functools.partial(_triton_kernel, block=block, m=m, groups=groups),
        grid=grid,
        in_specs=[
            pl.BlockSpec((qtile, dsp), lambda qi, ti: (qi, 0)),
            pl.BlockSpec((span, dsp), lambda qi, ti: (ti, 0)),
            pl.BlockSpec((span,), lambda qi, ti: (ti,)),
        ],
        out_specs=[
            pl.BlockSpec((groups * m, qtile), lambda qi, ti: (ti, qi)),
            pl.BlockSpec((groups * m, qtile), lambda qi, ti: (ti, qi)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_pad // block * m, b_pad), jnp.float32),
            jax.ShapeDtypeStruct((n_pad // block * m, b_pad), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES),
        interpret=interpret,
        name="block_topm",
    )(q, tab, xsq_eff)
    return vals[: nb * m, :b].T, idx[: nb * m, :b].T


_BY_PLATFORM = {"gpu": block_topm_triton, "cpu": block_topm_xla}


def block_topm_impl(platform: str):
    """The formulation that serves ``platform``: the Triton kernel on
    ``gpu`` (it beats the XLA form at the serving shape, see PERF.md), the
    plain XLA form on ``cpu``. Any other platform is an error."""
    try:
        return _BY_PLATFORM[platform]
    except KeyError:
        raise ValueError(
            f"block top-m scan has no formulation for platform "
            f"{platform!r}; supported: {sorted(_BY_PLATFORM)}") from None


def block_topm_scan(
    score_q: jnp.ndarray,
    tab: jnp.ndarray,
    xsq_eff: jnp.ndarray,
    block: int = 128,
    m: int = 2,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-block top-``m`` on the default backend's formulation;
    ``interpret=True`` runs the Triton kernel in the Pallas interpreter."""
    if interpret:
        return block_topm_triton(score_q, tab, xsq_eff, block=block, m=m,
                                 interpret=True)
    fn = block_topm_impl(jax.default_backend())
    return fn(score_q, tab, xsq_eff, block=block, m=m)
