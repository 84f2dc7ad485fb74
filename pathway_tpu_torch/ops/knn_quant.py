"""Quantized retrieval tower: per-page symmetric int8 rows with an exact fp32
rescore epilogue (port of ``pathway_tpu/ops/knn_quant.py``).

- **Per-page symmetric int8.** Each 128-row page carries one fp32 scale
  (``max|v| / 127``) and a zero-point slot (always ``0.0``: the field is
  reserved for asymmetric / fp8 formats).
- **Exact integer dots.** Every product of two codes is an integer
  ``<= 127^2`` and every partial sum of a ``dim <= 1040`` dot stays below
  ``2^24``, so the dot is exact in f32 whatever the summation order; the
  card kernels accumulate it in int32 (``csrc/score_blocks.cu``), which is
  exact at any width. Residency moves and batch shapes therefore never
  change a score.
- **Exact fp32 rescore.** The int8 pass only builds a
  ``PATHWAY_IVF_RESCORE_K``-deep shortlist; the returned scores are
  recomputed from the fp32 source rows by :func:`rescore_pairs`, on the
  host, as in the reference.

Quantization stays on the host in numpy, line for line the reference's, so
the codes and scales are the reference's bit for bit. The card kernels that
replace the reference's jitted ``quant_probe_kernel`` and
``quant_score_block_kernel`` are :func:`quant_probe` (here) and
:func:`~pathway_tpu_torch.ops.score_blocks.quant_score_blocks`; their plain
PyTorch versions are :func:`quant_probe_plain` and
:func:`quant_score_block_plain`, which repeat the reference's order of
operations so that the CPU path is bitwise the reference's host path.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np
import torch

from pathway_tpu_torch.ops import _cuda

PAGE = 128  # one scale/zero-point pair per 128-row page (the residency unit)

#: largest dim for which the f32-accumulated int8 dot is exact: every partial
#: sum is an integer bounded by dim * 127^2 and f32 represents integers up to
#: 2^24 exactly, so accumulation order cannot change the result
_INT8_EXACT_DIM_LIMIT = (1 << 24) // (127 * 127)

QUANT_PROBE = "quant_probe"
SCORE_BLOCKS_SOURCE = "score_blocks.cu"
_cuda.KERNEL_LAUNCHES.setdefault(QUANT_PROBE, 0)


class QuantConfigError(RuntimeError):
    """Typed misconfiguration of the quantized tower (unknown or reserved
    ``PATHWAY_IVF_QUANT`` mode): callers triage by type, never by repr."""


def quant_mode(raw: "str | None" = None) -> str:
    """Resolve the quantization mode: ``off`` (default) or ``int8``.

    ``fp8`` is a reserved mode (the sidecar format carries zero-points for
    it): asking for it is a typed refusal, not a silent fp32 fallback, and
    so is any unknown value: a misspelled mode silently serving full
    precision would defeat the budget the operator configured."""
    if raw is None:
        raw = os.environ.get("PATHWAY_IVF_QUANT", "off")
    mode = (raw or "off").strip().lower()
    if mode in ("off", "0", "false", "no", "none", ""):
        return "off"
    if mode == "int8":
        return "int8"
    if mode == "fp8":
        raise QuantConfigError(
            "PATHWAY_IVF_QUANT=fp8 is reserved: the sidecar format supports "
            "it but no fp8 kernel ships yet — use int8 or off"
        )
    raise QuantConfigError(
        f"unknown PATHWAY_IVF_QUANT mode {raw!r}: expected off|int8 (fp8 reserved)"
    )


def rescore_k() -> int:
    """``PATHWAY_IVF_RESCORE_K``: exact-rescore shortlist depth (default 64).
    The effective depth is ``max(k, PATHWAY_IVF_RESCORE_K)`` clamped to the
    candidate count: the shortlist is never shallower than the answer."""
    try:
        return max(1, int(os.environ.get("PATHWAY_IVF_RESCORE_K", "") or 64))
    except ValueError:
        return 64


# ---------------------------------------------------------------------------
# per-page quantization (host, deterministic)
# ---------------------------------------------------------------------------


def page_scale(rows: np.ndarray) -> float:
    """Symmetric scale of one page: ``max|v| / 127`` (1.0 for an all-zero
    page so dequantization stays well-defined)."""
    m = float(np.max(np.abs(rows))) if rows.size else 0.0
    return (m / 127.0) if m > 0.0 else 1.0


def quantize_rows(rows: np.ndarray, scale: float) -> np.ndarray:
    """Round-to-nearest int8 codes of ``rows`` at ``scale`` (clipped to
    [-127, 127]; -128 is never produced so negation stays closed)."""
    return np.clip(np.rint(rows / np.float32(scale)), -127, 127).astype(np.int8)


def quantize_block(
    vecs: np.ndarray, pages: "range | np.ndarray | None" = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize a (cap, dim) block per page. Returns ``(qvecs int8 (cap,
    dim), qscale f32 (cap // PAGE,), qzero f32 (cap // PAGE,))``; ``pages``
    limits the work to the named page indices."""
    cap = vecs.shape[0]
    n_pages = max(1, cap // PAGE)
    qvecs = np.zeros((cap, vecs.shape[1]), dtype=np.int8)
    qscale = np.ones(n_pages, dtype=np.float32)
    qzero = np.zeros(n_pages, dtype=np.float32)
    todo = range(n_pages) if pages is None else pages
    for p in todo:
        lo, hi = p * PAGE, min((p + 1) * PAGE, cap)
        if lo >= cap:
            continue
        s = page_scale(vecs[lo:hi])
        qscale[p] = np.float32(s)
        qvecs[lo:hi] = quantize_rows(vecs[lo:hi], s)
    return qvecs, qscale, qzero


def row_scales(qscale: np.ndarray, cap: int) -> np.ndarray:
    """Broadcast (n_pages,) page scales to (cap,) per-row scales."""
    return np.repeat(qscale, PAGE)[:cap].astype(np.float32)


# ---------------------------------------------------------------------------
# int8 scoring (host path: exact integer dots, order-invariant)
# ---------------------------------------------------------------------------


def quantize_queries(q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 query codes: ``(codes int8 (nq, dim), scales
    f32 (nq,))``. Queries that already sit on the int8 lattice (the
    encoder's quantized mode) re-quantize with zero extra rounding error:
    the row max is itself a lattice point, so the scale reproduces."""
    q = np.asarray(q, dtype=np.float32)
    m = np.max(np.abs(q), axis=1)
    scales = np.where(m > 0.0, m / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(q / scales[:, None]), -127, 127).astype(np.int8)
    return codes, scales


def int8_dot(q_codes: np.ndarray, d_codes: np.ndarray) -> np.ndarray:
    """Exact (nq, rows) integer dot of int8 code matrices: f32 BLAS over the
    cast codes for ``dim <= _INT8_EXACT_DIM_LIMIT`` (every partial sum is an
    exactly representable integer), int32 accumulation beyond."""
    if q_codes.shape[1] <= _INT8_EXACT_DIM_LIMIT:
        return (
            q_codes.astype(np.float32, copy=False)
            @ d_codes.astype(np.float32, copy=False).T
        )
    return (
        q_codes.astype(np.int32) @ d_codes.astype(np.int32).T
    ).astype(np.float32)


def approx_scores(
    q_codes: np.ndarray,
    q_scales: np.ndarray,
    qn: np.ndarray,
    d_codes: np.ndarray,
    d_row_scales: np.ndarray,
    d_norms: np.ndarray,
    metric: str,
    maskadd: "np.ndarray | None" = None,
    negnorm: "np.ndarray | None" = None,
) -> np.ndarray:
    """Approximate metric scores from int8 codes (they build the shortlist only).

    l2sq folds the 2x into the query scales (an exact power-of-two multiply)
    and omits the per-query ``-|q|^2`` shift (rank-invariant); ``negnorm`` is
    the pre-fused ``maskadd - d_norms`` vector, bitwise the unfused order
    (adding exact 0 is a no-op, ``0 - x`` is exact negation, -inf absorbs
    every finite add). ``maskadd`` is the 0 / -inf additive validity mask."""
    dot = int8_dot(q_codes, d_codes)
    if metric == "l2sq":
        dot *= (2.0 * q_scales)[:, None] * d_row_scales[None, :]
        if negnorm is not None:
            dot += negnorm[None, :]
        else:
            dot -= d_norms[None, :]
            if maskadd is not None:
                dot += maskadd[None, :]
        return dot
    if metric == "cos":
        dot *= q_scales[:, None] * d_row_scales[None, :]
        dot /= np.maximum(
            np.sqrt(qn)[:, None] * np.sqrt(d_norms)[None, :], 1e-30
        )
    else:  # ip
        dot *= q_scales[:, None] * d_row_scales[None, :]
    if maskadd is not None:
        dot += maskadd[None, :]
    return dot


# ---------------------------------------------------------------------------
# exact fp32 epilogues (host): the pinned rescore contract
# ---------------------------------------------------------------------------


def host_metric_scores(
    q: np.ndarray, vecs: np.ndarray, norms: np.ndarray, qn: np.ndarray, metric: str
) -> np.ndarray:
    """The exact fp32 block scores ``(group_q, rows)`` on the host (the
    recall audit's exact scan)."""
    s = q @ vecs.T
    if metric == "l2sq":
        s = 2.0 * s - norms[None, :] - qn[:, None]
    elif metric == "cos":
        s = s / np.maximum(np.sqrt(qn)[:, None] * np.sqrt(norms)[None, :], 1e-30)
    return s


def rescore_pairs(
    q_rows: np.ndarray, vecs: np.ndarray, norms: np.ndarray, qn_rows: np.ndarray,
    metric: str,
) -> np.ndarray:
    """The exact rescore epilogue: fp32 scores of (query, document) pairs,
    one per row of the stacked inputs. The tiered store computes its
    returned scores through this function and nothing else."""
    dot = np.einsum(
        "ij,ij->i", q_rows.astype(np.float32), vecs.astype(np.float32)
    )
    if metric == "l2sq":
        return (2.0 * dot - norms - qn_rows).astype(np.float32)
    if metric == "cos":
        return (
            dot / np.maximum(np.sqrt(qn_rows) * np.sqrt(norms), 1e-30)
        ).astype(np.float32)
    return dot.astype(np.float32)


def coarse_affinity(
    q_codes: np.ndarray, q_scales: np.ndarray, qcents: np.ndarray,
    cscales: np.ndarray, cn: np.ndarray,
) -> np.ndarray:
    """Host int8 coarse affinity ``2 (q·c) - |c|^2`` (the reference's host
    twin of its probe kernel)."""
    dot = int8_dot(q_codes, qcents) * (q_scales[:, None] * cscales[None, :])
    return 2.0 * dot - cn[None, :]


# ---------------------------------------------------------------------------
# plain PyTorch versions of the reference's jitted kernels
# ---------------------------------------------------------------------------


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root: torch's vectorised CPU ``sqrt`` is
    not (about 1% of values are an ulp off); numpy's, CUDA's
    ``__fsqrt_rn`` and the f64 root rounded to f32 are."""
    return torch.sqrt(x.double()).float()


def code_dot(q_codes: torch.Tensor, d_codes: torch.Tensor) -> torch.Tensor:
    """Exact (nq, rows) f32 dot of int8 codes (see :func:`int8_dot`)."""
    if q_codes.shape[1] <= _INT8_EXACT_DIM_LIMIT:
        return q_codes.float() @ d_codes.float().T
    return (q_codes.to(torch.int64) @ d_codes.to(torch.int64).T).float()


def quant_score_block_plain(
    qvecs: torch.Tensor,     # (n, dim) int8 codes
    scales: torch.Tensor,    # (n,) f32 per-row (page-broadcast) scales
    norms: torch.Tensor,     # (n,) f32 exact norms
    mask: torch.Tensor,      # (n,) additive 0 / -inf validity mask
    q_codes: torch.Tensor,   # (g, dim) int8 query codes
    q_scales: torch.Tensor,  # (g,) f32 query scales
    qn: torch.Tensor,        # (g,) f32 exact query norms
    metric: str,
) -> torch.Tensor:
    """Plain version of the reference's ``quant_score_block_kernel``: the
    exact int8 dot, then the epilogue in :func:`approx_scores`' order of
    operations (l2sq: ``dot * ((2 qs) * s) + (mask - norms)``)."""
    dot = code_dot(q_codes, qvecs)
    if metric == "l2sq":
        dot = dot * ((2.0 * q_scales)[:, None] * scales[None, :])
        return dot + (mask - norms)[None, :]
    dot = dot * (q_scales[:, None] * scales[None, :])
    if metric == "cos":
        dot = dot / torch.clamp(sqrt_rn(qn)[:, None] * sqrt_rn(norms)[None, :], min=1e-30)
    return dot + mask[None, :]


def quant_probe_plain(
    qcents: torch.Tensor,    # (C_pad, dim) int8 centroid codes
    cscales: torch.Tensor,   # (C_pad,) f32 per-centroid scales
    cn: torch.Tensor,        # (C_pad,) f32 exact |c|^2 (+inf on pad rows)
    q_codes: torch.Tensor,   # (q_pad, dim) int8 query codes
    q_scales: torch.Tensor,  # (q_pad,) f32 query scales
) -> torch.Tensor:
    """Plain version of the reference's ``quant_probe_kernel``: the int8
    coarse affinity ``2 (dot (qs cs)) - |c|^2``; pad centroids carry
    ``cn = +inf`` and score -inf."""
    dot = code_dot(q_codes, qcents) * (q_scales[:, None] * cscales[None, :])
    return 2.0 * dot - cn[None, :]


class ProbeTable:
    """The coarse probe's int8 centroid table on one device: codes
    ``qcents`` (C_pad, dim), per-centroid ``cscales`` and exact ``cn`` =
    ``|c|^2`` (+inf on pad rows, which score -inf). On the card it is
    checked once, here (type, shape, device, contiguity, a 4-byte start),
    so that each probe checks only its queries; the tiered store makes one
    whenever its centroids move and drops it with them."""

    __slots__ = ("qcents", "cscales", "cn")

    def __init__(self, qcents: torch.Tensor, cscales: torch.Tensor, cn: torch.Tensor):
        if qcents.device.type == "cuda":
            c_pad, dim = qcents.shape
            _check_probe_tensor("qcents", qcents, qcents, torch.int8, (c_pad, dim))
            _check_probe_tensor("cscales", cscales, qcents, torch.float32, (c_pad,))
            _check_probe_tensor("cn", cn, qcents, torch.float32, (c_pad,))
            if dim % 4 or dim <= 0:
                raise ValueError(f"unsupported probe width dim={dim}: a multiple of 4 is needed")
        self.qcents, self.cscales, self.cn = qcents, cscales, cn

    def __iter__(self):
        return iter((self.qcents, self.cscales, self.cn))

    def scores(self, q_codes: torch.Tensor, q_scales: torch.Tensor, stream=None) -> torch.Tensor:
        """The int8 coarse affinity (q_pad, C_pad) of the query codes and
        scales: the CUDA kernel for a table on the card (on ``stream``, the
        device's current stream, when the caller has it already), the plain
        version for one on the CPU."""
        if self.qcents.device.type == "cpu":
            return quant_probe_plain(*self, q_codes, q_scales)
        launch, out = self.launcher(q_codes, q_scales, stream)
        launch()
        _cuda.count_launch(QUANT_PROBE)
        return out

    def launcher(self, q_codes: torch.Tensor, q_scales: torch.Tensor, stream=None):
        """The query checks of one probe on the card, done once. Returns
        ``(launch, out)``: each ``launch()`` runs ``csrc/score_blocks.cu``'s
        probe kernel into ``out`` on ``stream`` (by default the stream that
        was current when the launcher was made), and counts nothing (for
        timing the kernel alone)."""
        dev = self.qcents.device
        if dev.type != "cuda":
            raise ValueError(f"quant_probe_cuda needs CUDA tensors, got {dev}")
        c_pad, dim = self.qcents.shape
        q_pad = q_codes.shape[0]
        _check_probe_tensor("q_codes", q_codes, self.qcents, torch.int8, (q_pad, dim))
        _check_probe_tensor("q_scales", q_scales, self.qcents, torch.float32, (q_pad,))
        if c_pad * q_pad >= 2**31:
            raise ValueError(f"unsupported probe shape C={c_pad} q={q_pad} dim={dim}")
        fn = _cuda.load(SCORE_BLOCKS_SOURCE).pw_quant_probe
        if fn.argtypes is None:  # first call: pointers must not be cut to 32 bits
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        out = torch.empty((q_pad, c_pad), dtype=torch.float32, device=dev)
        stream = stream or torch.cuda.current_stream(dev)
        args = (
            self.qcents.data_ptr(), self.cscales.data_ptr(), self.cn.data_ptr(),
            q_codes.data_ptr(), q_scales.data_ptr(), out.data_ptr(), c_pad, q_pad, dim,
            stream.device_index, stream.cuda_stream,
        )
        keep = (self, q_codes, q_scales, out)

        def launch() -> None:
            _cuda.check(fn(*args), QUANT_PROBE)
            len(keep)  # the closure keeps its tensors alive

        return launch, out


def _check_probe_tensor(name: str, t: torch.Tensor, like: torch.Tensor, dtype: torch.dtype,
                        shape: Tuple[int, ...]) -> None:
    if t.get_device() != like.get_device() or t.dtype is not dtype or t.shape != shape:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"expected {dtype} {shape} on {like.device}")
    if not t.is_contiguous() or t.data_ptr() % 4:
        raise ValueError(f"{name} must be contiguous and start on a 4-byte boundary")


def quant_probe(
    qcents: torch.Tensor, cscales: torch.Tensor, cn: torch.Tensor,
    q_codes: torch.Tensor, q_scales: torch.Tensor,
) -> torch.Tensor:
    """The int8 coarse affinity (q_pad, C_pad): the CUDA kernel for tensors
    on the card, the plain version for tensors on the CPU."""
    return ProbeTable(qcents, cscales, cn).scores(q_codes, q_scales)


def quant_probe_cuda(
    qcents: torch.Tensor, cscales: torch.Tensor, cn: torch.Tensor,
    q_codes: torch.Tensor, q_scales: torch.Tensor,
) -> torch.Tensor:
    """Launch ``csrc/score_blocks.cu``'s probe kernel on the current stream:
    a warp per centroid row, read in coalesced words, against the batch's
    codes staged in shared memory, an int32 ``dp4a`` dot, the reference's
    epilogue with round-to-nearest multiplies (no FMA). ``dim`` must be a
    multiple of 4 (four codes per ``dp4a`` word)."""
    if qcents.device.type != "cuda":
        raise ValueError(f"quant_probe_cuda needs CUDA tensors, got {qcents.device}")
    return ProbeTable(qcents, cscales, cn).scores(q_codes, q_scales)


def quant_probe_launcher(
    qcents: torch.Tensor, cscales: torch.Tensor, cn: torch.Tensor,
    q_codes: torch.Tensor, q_scales: torch.Tensor,
):
    """Every check of one probe, done once: :meth:`ProbeTable.launcher`."""
    return ProbeTable(qcents, cscales, cn).launcher(q_codes, q_scales)


def empty_launcher(device: torch.device):
    """``launch()`` of ``csrc/score_blocks.cu``'s empty kernel on the
    stream current now, through the ctypes path the probe takes: the launch
    floor that a kernel of that file cannot go below. For timing only;
    counts nothing."""
    fn = _cuda.load(SCORE_BLOCKS_SOURCE).pw_empty
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device)
    args = (stream.device_index, stream.cuda_stream)

    def launch() -> None:
        _cuda.check(fn(*args), "empty")

    return launch
