"""Synthetic tables on a device (see :mod:`repro_torch.data.datasets`) and
the on-disk partition store (:mod:`repro_torch.data.partition_store`)."""
from repro_torch.data import partition_store
from repro_torch.data.datasets import (build_table, make_tpch_like,
                                       widen_columns)
from repro_torch.data.partition_store import PartitionStore

__all__ = ["PartitionStore", "build_table", "make_tpch_like",
           "partition_store", "widen_columns"]
