"""Utility stdlib (port of ``pathway_tpu/stdlib/utils``): bucketing, col,
filtering and the pandas transformer."""

from pathway_tpu_torch.stdlib.utils import bucketing, col, filtering, pandas_transformer
