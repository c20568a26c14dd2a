"""Synthetic tables on a device (see :mod:`repro_torch.data.datasets`) and
the on-disk partition store (:mod:`repro_torch.data.partition_store`)."""
from repro_torch.data import partition_store
from repro_torch.data.datasets import (DATASETS, build_table,
                                       make_telemetry_like, make_tpcds_like,
                                       make_tpch_like, telemetry_templates,
                                       widen_columns)
from repro_torch.data.partition_store import PartitionStore

__all__ = ["DATASETS", "PartitionStore", "build_table",
           "make_telemetry_like", "make_tpcds_like", "make_tpch_like",
           "partition_store", "telemetry_templates", "widen_columns"]
