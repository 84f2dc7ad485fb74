"""ML stdlib (port of ``pathway_tpu/stdlib/ml``): ``KNNIndex``. The HMM,
fuzzy-match and dataset modules are not ported."""

from pathway_tpu_torch.stdlib.ml import index
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = ["KNNIndex", "index"]
