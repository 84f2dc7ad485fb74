"""Classification dataset loaders (port of
``pathway_tpu/stdlib/ml/datasets/classification``): train / test tables of
(data, label). pandas and scikit-learn are imported when a loader is called
(the GPU machine has neither)."""

from __future__ import annotations

import numpy as np

from pathway_tpu_torch.debug import table_from_pandas
from pathway_tpu_torch.internals.schema import import_pandas


def _tables_from_arrays(X_train, y_train, X_test, y_test):
    pd = import_pandas("the dataset loaders")
    X_train_table = table_from_pandas(pd.DataFrame({"data": [np.asarray(x) for x in X_train]}))
    y_train_table = table_from_pandas(pd.DataFrame({"label": list(y_train)}))
    X_test_table = table_from_pandas(pd.DataFrame({"data": [np.asarray(x) for x in X_test]}))
    y_test_table = table_from_pandas(pd.DataFrame({"label": list(y_test)}))
    return X_train_table, y_train_table, X_test_table, y_test_table


def load_mnist_sample(sample_size: int = 70_000):
    """MNIST from OpenML, split 6:1 into train and test tables of (data,
    label). Needs scikit-learn and network access."""
    try:
        from sklearn.datasets import fetch_openml
    except ImportError as e:
        raise ImportError(
            "scikit-learn is required for load_mnist_sample; for an offline "
            "dataset use load_synthetic_classification"
        ) from e
    X, y = fetch_openml("mnist_784", version=1, return_X_y=True, as_frame=False)
    X = X / 255.0
    train_size = int(sample_size * 6 / 7)
    test_size = sample_size // 7
    return _tables_from_arrays(
        X[:60_000][:train_size],
        y[:60_000][:train_size],
        X[60_000:70_000][:test_size],
        y[60_000:70_000][:test_size],
    )


def load_synthetic_classification(
    n_train: int = 600, n_test: int = 100, dim: int = 16, n_classes: int = 4, seed: int = 0
):
    """An offline stand-in with the table contract of ``load_mnist_sample``:
    Gaussian blobs, one cluster per class."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(n_classes, dim))

    def make(n):
        labels = rng.integers(0, n_classes, n)
        data = centers[labels] + rng.normal(size=(n, dim))
        return data.astype(np.float64), [str(l) for l in labels.tolist()]

    X_train, y_train = make(n_train)
    X_test, y_test = make(n_test)
    return _tables_from_arrays(X_train, y_train, X_test, y_test)
