"""Dataset loaders (port of ``pathway_tpu/stdlib/ml/datasets``)."""

from pathway_tpu_torch.stdlib.ml.datasets.classification import (
    load_mnist_sample,
    load_synthetic_classification,
)

__all__ = ["load_mnist_sample", "load_synthetic_classification"]
