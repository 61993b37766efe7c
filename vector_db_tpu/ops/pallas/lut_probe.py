"""IVF-PQ probe LUT scan as a Pallas-Triton kernel.

Scores the codes of every probed cell against the query's ADC lookup
table: ``d[b, p*L + i] = sum_j lut[b, j*ksub + codes[probe[b, p], i, j]]``
— the "gather" formulation of ``index/ivf.py:adc_scores``.

The cell table is padded to the largest cell (``L``), so the XLA form
scores ``n_probe * L`` candidates per query however few rows the probed
cells hold. Here each program takes one (query, probed cell), reads the
cell's length and loops over its occupied ``tl``-row tiles only; the
query's LUT row (16 KB at m=16, ksub=256) is read by gathers that hit in
L1/L2. Entries past a cell's length are left unwritten: callers mask them
(``cell_slots < 0``) as they mask padding in the XLA form.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton


def _kernel(probe_ref, len_ref, codes_ref, lut_ref, out_ref, *, tl, m,
            ksub, L):
    b = pl.program_id(0)
    p = pl.program_id(1)
    c = probe_ref[b, p]
    offs = jax.lax.broadcasted_iota(jnp.int32, (tl, m), 1) * ksub
    row = jax.lax.broadcasted_iota(jnp.int32, (tl,), 0)

    def tile(t, carry):
        start = t * tl
        ok = (start + row) < L
        codes = pltriton.load(codes_ref.at[c, pl.ds(start, tl), :],
                              mask=ok[:, None], other=0)
        vals = lut_ref[b, codes.astype(jnp.int32) + offs]       # [tl, m]
        pltriton.store(out_ref.at[b, pl.ds(p * L + start, tl)],
                       jnp.sum(vals, axis=1), mask=ok)
        return carry

    jax.lax.fori_loop(0, (len_ref[c] + tl - 1) // tl, tile, 0)


@functools.partial(jax.jit, static_argnames=("tl", "interpret"))
def lut_probe_scores(
    probe: jnp.ndarray,       # int32[B, n_probe] probed cell ids
    cell_len: jnp.ndarray,    # int32[k] occupied rows per cell
    cell_codes: jnp.ndarray,  # uint8[k, L, m] cell-contiguous PQ codes
    lut: jnp.ndarray,         # f32[B, m * ksub] flat per-query LUTs
    tl: int = 128,
    interpret: bool = False,
) -> jnp.ndarray:
    """f32[B, n_probe * L] LUT sums; entries at or past a probed cell's
    ``cell_len`` are undefined and must be masked by the caller."""
    b, n_probe = probe.shape
    _, L, m = cell_codes.shape
    return pl.pallas_call(
        functools.partial(_kernel, tl=tl, m=m, ksub=lut.shape[1] // m, L=L),
        grid=(b, n_probe),
        out_shape=jax.ShapeDtypeStruct((b, n_probe * L), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="lut_probe",
    )(probe, cell_len, cell_codes, lut)
