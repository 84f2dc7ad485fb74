"""Port parity: the pure-Python XXH32 and the hash tokenizer of
``pathway_tpu_torch.models.encoder`` against ``xxhash`` and the reference
``pathway_tpu.models.encoder.HashTokenizer``. Exact equality throughout."""

from __future__ import annotations

import numpy as np
import xxhash

from pathway_tpu.models.encoder import HashTokenizer as RefHashTokenizer
from pathway_tpu_torch.models.encoder import HashTokenizer, xxh32

_ALPHABET = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.,'")
_ALPHABET += list("éüßøçñ日本語中文한국어ÅΩжёالعربية🙂🚀")


def _words(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 40, n)  # 0..39 chars: every XXH32 tail / stripe path
    return ["".join(rng.choice(_ALPHABET, k)) for k in lens]


def test_xxh32_matches_xxhash_on_10k_words():
    words = _words(10_000, seed=0)
    assert any(len(w.encode()) >= 16 for w in words)  # the 16-byte stripe loop runs
    assert any(not w.isascii() for w in words)
    got = [xxh32(w) for w in words]
    want = [xxhash.xxh32_intdigest(w) for w in words]
    assert got == want


def test_xxh32_seeded_and_bytes():
    for w in _words(200, seed=1):
        b = w.encode()
        assert xxh32(b, seed=7) == xxhash.xxh32_intdigest(b, seed=7)


def test_hash_tokenizer_ids_and_mask_identical():
    rng = np.random.default_rng(2)
    vocab = _words(3000, seed=3)
    texts = [" ".join(rng.choice(vocab, rng.integers(0, 150))) for _ in range(64)]
    texts += ["", "   ", "Mixed CASE words  and\ttabs\nnewlines"]
    for vocab_size, max_length in ((30522, 128), (4096, 16)):
        ref = RefHashTokenizer(vocab_size, max_length)
        port = HashTokenizer(vocab_size, max_length)
        ri, rm = ref(texts)
        pi, pm = port(texts)
        assert ri.dtype == pi.dtype and rm.dtype == pm.dtype
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pm, rm)
