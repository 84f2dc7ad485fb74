"""Sentence encoder (MiniLM / BERT family) in PyTorch.

Port of ``pathway_tpu/models/encoder.py``: token ids in, mean-pooled,
L2-normalised sentence embeddings out. Architecture = all-MiniLM-L6-v2
defaults (6 layers, hidden 384, 12 heads, FFN 1536, vocab 30522).

The forward mirrors the reference Flax module's precision points, so weights
carried over with :func:`params_from_jax` give the reference's embeddings:

- embeddings are looked up in the weights' dtype; word + position is
  rounded to that dtype and the token-type row is added in f32 (what the
  jitted reference computes: XLA folds the second bf16 rounding into the
  f32 LayerNorm), normalised in f32, then cast to the compute dtype;
- every dense layer casts input, kernel and bias to the compute dtype
  (bf16 by default) and rounds the product before adding the bias;
- attention is plain matmul → masked softmax → matmul in the compute dtype.
  The query is divided by ``sqrt(head_dim)`` rounded to the compute dtype
  (a Python float: no tensor is made, so a CUDA graph capture neither
  syncs nor copies there), and masked logits take the dtype's finite
  minimum, so an all-pad row attends uniformly and pools to zeros instead
  of NaN;
- LayerNorm computes in f32 with the fast variance ``E[x²] − E[x]²`` and
  returns f32, so the residual stream after the first layer is f32.

On the card the query path (``encode_device``, batches up to
:data:`GRAPH_MAX_BATCH` rows) replays one CUDA graph per pow2 (batch, seq)
bucket: the encoder service's pre-warm captures them, and a bucket it did
not cover is captured on first use. The ingest path (``encode_pipelined``)
and the CPU stay eager.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch.device import GRAPH_CAPTURE_LOCK, graph_streams, resolve_device
from pathway_tpu_torch.internals.shapes import next_pow2


def quant_encode_enabled() -> bool:
    """``PATHWAY_IVF_QUANT_ENCODE``: round embeddings onto the per-row int8
    lattice. ``auto`` (default) follows the index's mode
    (:func:`~pathway_tpu_torch.ops.knn_quant.quant_mode`, which refuses an
    unknown or reserved mode with ``QuantConfigError``)."""
    mode = os.environ.get("PATHWAY_IVF_QUANT_ENCODE", "auto").strip().lower()
    if mode in ("on", "1", "true", "yes", "int8"):
        return True
    if mode in ("off", "0", "false", "no"):
        return False
    from pathway_tpu_torch.ops.knn_quant import quant_mode

    return quant_mode() == "int8"


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16  # compute dtype of matmuls and attention


# the largest batch bucket the query path replays from a CUDA graph: the encoder
# service's ticks dispatch at most 64 rows (its sub-batch), and its pre-warm
# walks the buckets up to 64 rows
GRAPH_MAX_BATCH = 64


# -- XXH32 (the hash the reference tokenizer uses, via the xxhash package) ----

_P1, _P2, _P3, _P4, _P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes | str, seed: int = 0) -> int:
    """XXH32 of ``data`` (str is hashed as UTF-8), equal to
    ``xxhash.xxh32_intdigest``."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P1) & _M32
        limit = n - 16
        while i <= limit:
            a, b, c, d = (
                int.from_bytes(data[i + o : i + o + 4], "little") for o in (0, 4, 8, 12)
            )
            v1 = (_rotl((v1 + a * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + b * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + c * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + d * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        h = (_rotl((h + int.from_bytes(data[i : i + 4], "little") * _P3) & _M32, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M32, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


class HashTokenizer:
    """Deterministic word-hash tokenizer for zero-egress environments: each
    lower-cased whitespace word maps to ``2000 + xxh32(word) % (vocab - 3000)``,
    framed by [CLS]=101 / [SEP]=102, trimmed to the batch's longest row. The
    word→id hash is memoised."""

    _WORD_CACHE_MAX = 1 << 20  # unbounded ingest vocab must not grow the memo forever

    def __init__(self, vocab_size: int = 30522, max_length: int = 128):
        if vocab_size <= 3000:
            raise ValueError("hash ids live in [2000, vocab_size-1000): vocab_size must be > 3000")
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._word_ids: dict[str, int] = {}

    def _id_of(self, word: str) -> int:
        return 2000 + (xxh32(word) % (self.vocab_size - 3000))

    def __call__(self, texts: list[str]) -> Tuple[np.ndarray, np.ndarray]:
        n = len(texts)
        limit = self.max_length - 2
        words_per = [str(t).lower().split()[:limit] for t in texts]
        cache = self._word_ids
        missing = {w for ws in words_per for w in ws if w not in cache}
        if missing:
            if len(cache) + len(missing) > self._WORD_CACHE_MAX:
                # overflow reset: re-hash every word of the current batch
                cache.clear()
                missing = {w for ws in words_per for w in ws}
            for w in missing:
                cache[w] = self._id_of(w)
        lens = np.fromiter((len(ws) for ws in words_per), dtype=np.int64, count=n)
        width = int(lens.max()) + 2 if n else 2
        cols = np.arange(width)
        mask = (cols[None, :] < (lens + 2)[:, None]).astype(np.int32)
        ids = np.zeros((n, width), dtype=np.int32)
        if n:
            ids[:, 0] = 101  # [CLS]
            total = int(lens.sum())
            flat = np.fromiter(
                (cache[w] for ws in words_per for w in ws), dtype=np.int32, count=total
            )
            inner = cols[None, 1:] < (lens + 1)[:, None]
            ids[:, 1:][inner] = flat  # row-major boolean scatter keeps word order
            ids[np.arange(n), lens + 1] = 102  # [SEP]
        return ids, mask


# -- the module ---------------------------------------------------------------


class LayerNorm(nn.Module):
    """Flax-style LayerNorm: f32 statistics with the fast variance, f32 out."""

    def __init__(self, size: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        mu2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return (xf - mu) * mul + self.bias.float()


class Dense(nn.Module):
    """``y = x @ W.T + b`` in the compute dtype, the product rounded before
    the bias add (Flax ``Dense`` with ``dtype`` set). ``weight`` is (out, in)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.matmul(x.to(dtype), self.weight.to(dtype).T) + self.bias.to(dtype)


class Attention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        # sqrt(head_dim) rounded to the compute dtype, kept as a Python float
        self.sqrt_hd = float(torch.tensor(math.sqrt(h // cfg.num_heads)).to(cfg.dtype))
        self.query = Dense(h, h)
        self.key = Dense(h, h)
        self.value = Dense(h, h)
        self.out = Dense(h, h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, n, h = x.shape
        nh = self.num_heads
        hd = h // nh
        q = self.query(x, dtype).reshape(b, n, nh, hd)
        k = self.key(x, dtype).reshape(b, n, nh, hd)
        v = self.value(x, dtype).reshape(b, n, nh, hd)
        q = q / self.sqrt_hd
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = w.masked_fill(~mask[:, None, None, :], torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, h)
        return self.out(o, dtype)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = Attention(cfg)
        self.attention_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.output_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        attention_out = self.attention(hidden, mask, dt)
        hidden = self.attention_norm(_promote_add(hidden, attention_out))
        ff = self.intermediate(hidden, dt)
        ff = torch.nn.functional.gelu(ff, approximate="none")
        ff = self.output(ff, dt)
        return self.output_norm(_promote_add(hidden, ff))


def _promote_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` in the wider of the two dtypes (jnp promotion)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) + b.to(dt)


class SentenceEncoder(nn.Module):
    """BERT-style encoder with mean pooling + L2 normalisation."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig()):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.embeddings_norm = LayerNorm(h, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        emb = self.word_embeddings(input_ids) + self.position_embeddings(positions)
        emb = emb.float() + self.token_type_embeddings(torch.zeros_like(input_ids)).float()
        hidden = self.embeddings_norm(emb).to(cfg.dtype)
        mask = attention_mask.bool()
        for layer in self.layers:
            hidden = layer(hidden, mask)
        hidden = hidden.float()
        mask_f = attention_mask[:, :, None].float()
        pooled = torch.sum(hidden * mask_f, dim=1) / torch.clamp(
            torch.sum(mask_f, dim=1), min=1e-9
        )
        norm = torch.linalg.norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)


# names of the parameters that the bf16 weight mode stores in bf16
def _is_matmul_weight(name: str) -> bool:
    return name.endswith(".weight")


def _init_params(model: SentenceEncoder, seed: int) -> None:
    """Seeded random weights (no checkpoint is ever downloaded): lecun-normal
    kernels, N(0, 1/sqrt(hidden)) embeddings, zero biases, unit norms."""
    gen = torch.Generator().manual_seed(seed)
    h = model.cfg.hidden_size
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif "embeddings" in name:
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(h))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1]))


def _to_torch(arr: Any) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, viewed bitwise) → torch."""
    a = np.array(arr)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference ``JaxSentenceEncoder.params`` (a nested dict of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, enc.params)``) as this module's
    ``state_dict``. Attention kernels are Flax ``DenseGeneral`` shaped
    (h, nh, hd) and the output projection (nh, hd, h); torch keeps (out, in)."""
    p = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{name}.weight"] = _to_torch(p[name]["embedding"])
    sd["embeddings_norm.scale"] = _to_torch(p["embeddings_norm"]["scale"])
    sd["embeddings_norm.bias"] = _to_torch(p["embeddings_norm"]["bias"])
    i = 0
    while f"layer_{i}" in p:
        lp = p[f"layer_{i}"]
        pre = f"layers.{i}."
        att = lp["attention"]
        for nm in ("query", "key", "value"):
            k = _to_torch(att[nm]["kernel"])
            h = k.shape[0]
            sd[pre + f"attention.{nm}.weight"] = k.reshape(h, -1).T.contiguous()
            sd[pre + f"attention.{nm}.bias"] = _to_torch(att[nm]["bias"]).reshape(-1)
        ko = _to_torch(att["out"]["kernel"])
        sd[pre + "attention.out.weight"] = ko.reshape(-1, ko.shape[-1]).T.contiguous()
        sd[pre + "attention.out.bias"] = _to_torch(att["out"]["bias"])
        for nm in ("intermediate", "output"):
            sd[pre + f"{nm}.weight"] = _to_torch(lp[nm]["kernel"]).T.contiguous()
            sd[pre + f"{nm}.bias"] = _to_torch(lp[nm]["bias"])
        for nm in ("attention_norm", "output_norm"):
            sd[pre + f"{nm}.scale"] = _to_torch(lp[nm]["scale"])
            sd[pre + f"{nm}.bias"] = _to_torch(lp[nm]["bias"])
        i += 1
    return sd


class TorchSentenceEncoder:
    """Batched text → embedding: tokenize on the host, encode on the device.

    Counterpart of the reference ``JaxSentenceEncoder``: pow2 (batch, seq)
    buckets with floor 8, ``canonicalize``, length-sorted
    ``encode_pipelined``, f16 embeddings on the wire, bf16 matmul weights, and
    the int8 lattice round of the quantized query-tower mode.

    ``params``: a ``state_dict`` (e.g. from :func:`params_from_jax`); without
    one the weights are a seeded random init — nothing is downloaded."""

    def __init__(
        self,
        model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
        config: EncoderConfig | None = None,
        max_length: int = 128,
        seed: int = 0,
        transfer_dtype: str = "float16",
        weights_dtype: str = "bfloat16",
        device: Any = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        quant_encode: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        self.model_name = model_name
        self.config = config or EncoderConfig()
        self.max_length = max_length
        self._tokenize = HashTokenizer(self.config.vocab_size, max_length)
        model = SentenceEncoder(self.config)
        if params is None:
            _init_params(model, seed)
        if weights_dtype == "bfloat16":
            # kernels and embeddings in bf16; norms and biases stay f32
            for name, p in model.named_parameters():
                if _is_matmul_weight(name):
                    p.data = p.data.to(torch.bfloat16)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.transfer_dtype = torch.float16 if transfer_dtype == "float16" else torch.float32
        self.quant_encode = quant_encode_enabled() if quant_encode is None else quant_encode
        self.quant_tag = "quant:int8" if self.quant_encode else ""
        # query-path CUDA graphs: (batch, seq) -> (graph, static ids, static out),
        # all in one memory pool (replays never overlap: they hold the lock)
        self._graphs: Dict[Tuple[int, int], Tuple[Any, torch.Tensor, torch.Tensor]] = {}
        self._graph_lock = threading.Lock()
        self._graph_pool: Any = None
        self.dispatches = 0  # forward launches, eager or replayed
        self._dispatches_lock = threading.Lock()

    @property
    def dim(self) -> int:
        return self.config.hidden_size

    def canonicalize(self, text: str) -> str:
        """Tokenizer-equivalence canonical form: the hash tokenizer splits on
        any whitespace run and lower-cases, so texts equal under this form
        encode to identical ids."""
        return " ".join(str(text).split()).lower()

    @torch.inference_mode()
    def _encode_ids(self, ids: torch.Tensor) -> torch.Tensor:
        out = self.model(ids, (ids != 0).to(torch.int32)).float()
        if self.quant_encode:
            # per-row symmetric int8 lattice: s = max|v| / 127, v -> round(v/s)*s
            s = torch.clamp(out.abs().amax(dim=1, keepdim=True), min=1e-30) / 127.0
            out = torch.round(out / s) * s
        return out.to(self.transfer_dtype)

    # -- CUDA graphs of the query path -----------------------------------------

    def _graph_locked(self, batch: int, seq: int) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """The bucket's graph, captured now if it is missing (the caller holds
        ``_graph_lock``). A failed capture raises; nothing falls back to the
        eager forward."""
        key = (batch, seq)
        cached = self._graphs.get(key)
        if cached is not None:
            return cached
        dev = self.device
        try:
            with torch.cuda.device(dev):
                static_ids = torch.zeros((batch, seq), dtype=torch.int64, device=dev)
                stream = torch.cuda.current_stream(dev)
                # one kept side stream for every warm-up on the device (cuBLAS
                # keeps a workspace per stream it has run on) and a capture
                # stream that no other thread is handed
                side, capture = graph_streams(dev)
                side.wait_stream(stream)
                with torch.cuda.stream(side):  # lazy initialisation stays out of the capture
                    for _ in range(2):
                        self._encode_ids(static_ids)
                stream.wait_stream(side)
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                with GRAPH_CAPTURE_LOCK, torch.cuda.graph(
                    graph, pool=self._graph_pool, stream=capture,
                    capture_error_mode="thread_local",
                ):
                    static_out = self._encode_ids(static_ids)
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture of the encoder bucket ({batch}, {seq}) failed: {exc}"
            ) from exc
        cached = self._graphs[key] = (graph, static_ids, static_out)
        return cached

    def prewarm_bucket(self, batch: int, seq: int) -> None:
        """Make the (batch, seq) bucket ready before a query needs it: on the
        card capture its CUDA graph, on the CPU run its forward once."""
        if self.device.type == "cuda":
            with self._graph_lock:
                self._graph_locked(batch, seq)
        else:
            self._encode_ids(torch.zeros((batch, seq), dtype=torch.int64))

    @property
    def graphs_captured(self) -> int:
        return len(self._graphs)

    def reserved_bytes(self) -> int:
        """Card memory the caching allocator holds once idle blocks are
        released (0 on the CPU): the pre-warm's graph pools are the change
        of this across it."""
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return int(torch.cuda.memory_reserved(self.device))

    def encode_ids(self, ids: Any, *, graph: bool) -> torch.Tensor:
        """The forward of one padded (batch, seq) bucket of token ids (pad id
        0): replayed from the bucket's CUDA graph (``graph=True``, the card
        only) or run eagerly. A replay returns a copy of the graph's output
        buffer, so the next replay cannot overwrite rows handed out."""
        host = torch.as_tensor(ids, dtype=torch.int64)
        if not graph:
            return self._encode_ids(host.to(self.device, non_blocking=True))
        if self.device.type != "cuda":
            raise ValueError("CUDA graphs need the encoder on the card")
        batch, seq = host.shape
        with self._graph_lock, torch.inference_mode():
            g, static_ids, static_out = self._graph_locked(batch, seq)
            static_ids.copy_(host, non_blocking=True)
            g.replay()
            return static_out.clone()

    def _dispatch(self, ids: np.ndarray, mask: np.ndarray, *, graphs: bool = False) -> torch.Tensor:
        """Pad a tokenized batch to pow2 (batch, seq) buckets (floor 8) and
        launch the forward; on the card this does not wait for the result.
        Rows beyond ``ids.shape[0]`` are zero padding. ``graphs``: replay the
        bucket's CUDA graph when on the card and the batch bucket is at most
        :data:`GRAPH_MAX_BATCH` (the query path)."""
        seq = next_pow2(ids.shape[1], floor=8)
        batch = next_pow2(ids.shape[0], floor=8)
        ids_p = np.zeros((batch, seq), dtype=np.int64)
        ids_p[: ids.shape[0], : ids.shape[1]] = ids * mask  # padding -> id 0
        with self._dispatches_lock:
            self.dispatches += 1
        use_graph = graphs and self.device.type == "cuda" and batch <= GRAPH_MAX_BATCH
        return self.encode_ids(ids_p, graph=use_graph)

    def encode_device(self, texts: list[str]) -> torch.Tensor:
        """(n, dim) embeddings left on the device, in the transfer dtype: the
        query path (a CUDA graph replay per bucket on the card)."""
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        ids, mask = self._tokenize(texts)
        return self._dispatch(ids, mask, graphs=True)[: ids.shape[0]]

    def encode(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return self.encode_device(texts).float().cpu().numpy()

    def encode_pipelined(
        self, texts: list[str], sub_batch: int = 128
    ) -> Tuple[np.ndarray, Dict[str, float]]:
        """Length-sorted encode: rows sort by word count and split into
        ``sub_batch``-row sub-batches, each padded only to its own pow2 seq
        bucket. Launches do not wait, so host tokenization of sub-batch k+1
        overlaps the device's forward of k; the one sync is the final fetch.

        Returns ``(embeddings (n, dim) float32 in input order, stats)`` with
        ``padded_tokens`` / ``real_tokens`` / ``tokenize_s`` / ``sub_batches``."""
        n = len(texts)
        stats: Dict[str, float] = {
            "padded_tokens": 0.0, "real_tokens": 0.0, "tokenize_s": 0.0,
            "sub_batches": 0.0,
        }
        out = np.empty((n, self.dim), dtype=np.float32)
        if n == 0:
            return out, stats
        step = max(1, sub_batch)
        order = sorted(range(n), key=lambda i: len(str(texts[i]).split()))
        inflight = []
        for start in range(0, n, step):
            idx = order[start : start + step]
            t0 = time.perf_counter()
            ids, mask = self._tokenize([texts[i] for i in idx])
            stats["tokenize_s"] += time.perf_counter() - t0
            dev = self._dispatch(ids, mask)
            stats["padded_tokens"] += float(dev.shape[0] * next_pow2(ids.shape[1], floor=8))
            stats["real_tokens"] += float(mask.sum())
            stats["sub_batches"] += 1
            inflight.append((dev[: len(idx)], idx))
        for dev, idx in inflight:
            out[idx] = dev.float().cpu().numpy()
        return out, stats
