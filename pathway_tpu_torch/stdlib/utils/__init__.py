"""Utility stdlib (port of ``pathway_tpu/stdlib/utils``): bucketing, col,
filtering, the pandas transformer and the async transformer."""

from pathway_tpu_torch.stdlib.utils import (
    async_transformer,
    bucketing,
    col,
    filtering,
    pandas_transformer,
)
