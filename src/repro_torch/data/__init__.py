"""Synthetic tables on a device (see :mod:`repro_torch.data.datasets`)."""
from repro_torch.data.datasets import (build_table, make_tpch_like,
                                       widen_columns)

__all__ = ["build_table", "make_tpch_like", "widen_columns"]
