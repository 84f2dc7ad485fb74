"""pathway_tpu_torch — the PyTorch / CUDA port of ``pathway_tpu``.

The first slice serves the retrieval path end to end on one NVIDIA H100:
documents → parse → split → sentence encoder → IVF index → ``/v1/retrieve``.
The IVF candidate-page scorer is a hand-written CUDA kernel for ``sm_90a``
(``csrc/score_pages.cu``); everything around it is plain PyTorch.

The package imports ``torch`` and ``numpy`` only. It never imports ``jax`` or
anything from ``pathway_tpu``: it keeps its own copies of the host code it
needs. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Importing the package is cheap: submodules load on first use.
"""

from __future__ import annotations

__all__ = ["device"]
