"""Device resolution and the numeric settings every CUDA entry point relies on.

Every entry point of the port takes a ``device`` argument. ``None`` means the
card: when CUDA is absent that is an error, never a quiet fall back to the
CPU. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import threading
from typing import Any, NamedTuple

import torch

_FLAGS_SET = False

#: held around every CUDA graph capture of the package: a capture starts with
#: a device-wide synchronize, which fails while another thread's capture is
#: open (the encoder service's pre-warm and the IVF scorer's work-list graph
#: can be captured at the same time on two threads)
GRAPH_CAPTURE_LOCK = threading.Lock()

#: the two streams of every capture site, by device (:func:`graph_streams`)
_GRAPH_STREAMS: dict = {}
_GRAPH_STREAMS_LOCK = threading.Lock()


class GraphStreams(NamedTuple):
    side: Any  # the warm-up before a capture (lazy initialisation stays out of it)
    capture: Any  # the capture itself, touched only under GRAPH_CAPTURE_LOCK


def graph_streams(dev: Any) -> GraphStreams:
    """The streams every CUDA graph capture of the package on ``dev`` runs
    on, made once per device and kept.

    PyTorch hands out streams from a per-device pool, 32 per priority,
    round robin, and ``torch.cuda.graph`` captures on one such stream unless
    it is given one. A site that took a new pool stream for each warm-up was
    handed, once the pool wrapped, the very stream that another thread was
    capturing on, and its ``wait_stream`` then made a capturing stream wait
    on uncaptured work (``cudaErrorStreamCaptureIsolation``). So a capture
    runs on a stream of the high-priority pool, from which the package takes
    nothing else, and warm-ups on one kept side stream of the normal pool,
    which no capture uses."""
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    with _GRAPH_STREAMS_LOCK:
        streams = _GRAPH_STREAMS.get(dev)
        if streams is None:
            streams = _GRAPH_STREAMS[dev] = GraphStreams(
                side=torch.cuda.Stream(dev), capture=torch.cuda.Stream(dev, priority=-1)
            )
    return streams


def set_precision_flags() -> None:
    """Full-precision float32 matmuls on the card, set once per process.

    - TF32 keeps about three decimal digits; the IVF scores and the k-means
      one-hot sums are compared with the reference at f32 precision, so it is
      off for matmuls and for cuDNN.
    - Reduced-precision reductions inside bf16/f16 GEMMs round partial sums to
      16 bits; the reference's XLA matmuls accumulate in f32, so they are off.
    """
    global _FLAGS_SET
    if _FLAGS_SET:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    _FLAGS_SET = True


def resolve_device(device: Any = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pathway_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        set_precision_flags()
    return dev
