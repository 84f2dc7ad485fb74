"""Utility stdlib (port of ``pathway_tpu/stdlib/utils``): bucketing, col, filtering."""

from pathway_tpu_torch.stdlib.utils import bucketing, col, filtering
