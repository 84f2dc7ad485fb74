"""ML stdlib (port of ``pathway_tpu/stdlib/ml``): ``KNNIndex`` and the HMM
reducer. The fuzzy-match and dataset modules are not ported."""

from pathway_tpu_torch.stdlib.ml import hmm, index
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = ["KNNIndex", "hmm", "index"]
