"""PQCodec.adc_search formulations: LUT gather vs one-hot matmul, and the
refusal of removed modes."""

import pytest

from vector_db_tpu.index.pq import PQCodec


def _codec(rng):
    emb = rng.standard_normal((600, 32)).astype("float32")
    codec = PQCodec(k=16, chunks=4, dim=32)
    codec.train(emb, seed=0)
    return codec, codec.encode(emb)


def test_adc_search_pallas_mode_matches_matmul(rng):
    """The default gather formulation must agree with the one-hot matmul
    formulation."""
    codec, codes = _codec(rng)
    q = rng.standard_normal((5, 32)).astype("float32")
    d_m, i_m = codec.adc_search(q, codes, top_k=8, mode="matmul")
    d_g, i_g = codec.adc_search(q, codes, top_k=8)
    assert (i_m == i_g).mean() > 0.9  # f32 sum-order ties may differ


@pytest.mark.parametrize("mode", ["pallas", "pallas_interp", "onehot8"])
def test_adc_search_refuses_unknown_mode(rng, mode):
    codec, codes = _codec(rng)
    q = rng.standard_normal((2, 32)).astype("float32")
    with pytest.raises(ValueError, match="unknown adc_search mode"):
        codec.adc_search(q, codes, top_k=4, mode=mode)
