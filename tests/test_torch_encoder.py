"""Port parity: ``pathway_tpu_torch.models.encoder.TorchSentenceEncoder``
against the reference ``JaxSentenceEncoder`` with the reference's weights
(carried over by ``params_from_jax``), on the CPU, at a tiny width.

Tolerances:
- bf16 compute: cosine >= 0.999 per row. The two frameworks round bf16 at
  different points (XLA may round each op of a softmax or GELU to bf16,
  torch computes those in f32 and rounds once).
- f32 weights and compute: atol 1e-5 (same arithmetic, other summation
  order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models.encoder import EncoderConfig as RefConfig
from pathway_tpu.models.encoder import JaxSentenceEncoder
from pathway_tpu_torch.models.encoder import (
    EncoderConfig,
    TorchSentenceEncoder,
    params_from_jax,
)

# one intra-op thread: the suite runs files in parallel beside timing-sensitive
# cluster tests, and these tensors are small
torch.set_num_threads(1)

_TINY = dict(vocab_size=4096, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)


def _texts(n: int = 24, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    vocab = [f"tok{i}" for i in range(700)]
    return [" ".join(rng.choice(vocab, rng.integers(1, 60))) for _ in range(n)]


def _pair(dtype: str, **kw):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    wdt = "bfloat16" if dtype == "bf16" else "float32"
    xfer = "float16" if dtype == "bf16" else "float32"
    ref = JaxSentenceEncoder(
        config=RefConfig(**_TINY, dtype=jdt), weights_dtype=wdt, transfer_dtype=xfer, seed=3
    )
    params = params_from_jax(jax.tree.map(np.asarray, ref.params))
    port = TorchSentenceEncoder(
        config=EncoderConfig(**_TINY, dtype=tdt), weights_dtype=wdt, transfer_dtype=xfer,
        device="cpu", params=params, **kw,
    )
    return ref, port


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_params_from_jax_keeps_bf16_bits():
    ref, port = _pair("bf16")
    sd = port.model.state_dict()
    assert sd["word_embeddings.weight"].dtype == torch.bfloat16
    assert sd["embeddings_norm.scale"].dtype == torch.float32
    want = np.asarray(ref.params["params"]["layer_0"]["attention"]["query"]["kernel"])
    got = sd["layers.0.attention.query.weight"].T.reshape(want.shape)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_bf16_embeddings_match_reference_cosine():
    ref, port = _pair("bf16")
    texts = _texts()
    a = ref.encode(texts)
    b = port.encode(texts)
    assert a.shape == b.shape == (len(texts), 64)
    assert _cosine(a, b).min() >= 0.999


def test_f32_embeddings_match_reference_atol():
    ref, port = _pair("f32")
    texts = _texts(seed=1)
    np.testing.assert_allclose(port.encode(texts), ref.encode(texts), atol=1e-5, rtol=0)


def test_pipelined_encode_matches_reference_pipelined():
    ref, port = _pair("f32")
    texts = _texts(40, seed=2)
    a, ref_stats = ref.encode_pipelined(texts, sub_batch=8)
    b, stats = port.encode_pipelined(texts, sub_batch=8)
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    assert stats["padded_tokens"] == ref_stats["padded_tokens"]
    assert stats["real_tokens"] == ref_stats["real_tokens"]
    assert stats["sub_batches"] == ref_stats["sub_batches"]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_all_pad_rows_pool_to_zeros(dtype):
    _ref, port = _pair(dtype)
    ids = np.zeros((8, 16), dtype=np.int32)
    ids[0, :4] = [101, 2500, 2600, 102]
    out = port._dispatch(ids, (ids != 0).astype(np.int32)).float()
    assert not torch.isnan(out).any()
    assert torch.count_nonzero(out[1:]) == 0
    assert torch.count_nonzero(out[0]) > 0


def test_quant_encode_rows_on_int8_lattice(monkeypatch):
    monkeypatch.setenv("PATHWAY_IVF_QUANT_ENCODE", "on")
    ref, port = _pair("bf16")
    assert port.quant_encode and port.quant_tag == ref.quant_tag == "quant:int8"
    texts = _texts(seed=4)
    # the f16 wire moves a lattice point by up to ~3% of a step; read the
    # lattice itself in f32 (codes within f32 rounding of integers)
    port.transfer_dtype = torch.float32
    out = port.encode(texts)
    s = np.abs(out).max(axis=1, keepdims=True) / 127.0
    codes = out / s
    assert np.abs(codes - np.round(codes)).max() < 1e-3
    assert np.abs(np.round(codes)).max() == 127
    assert _cosine(out, ref.encode(texts)).min() >= 0.999


def test_canonicalize_matches_reference():
    ref, port = _pair("f32")
    for t in ("  Hello   World\tAGAIN ", "", "a\nb"):
        assert port.canonicalize(t) == ref.canonicalize(t)
