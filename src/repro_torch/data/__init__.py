"""Synthetic tables on a device (see :mod:`repro_torch.data.datasets`),
the on-disk partition store (:mod:`repro_torch.data.partition_store`) and
its crash-safe manifest log (:mod:`repro_torch.data.wal`)."""
from repro_torch.data import partition_store, wal
from repro_torch.data.datasets import (DATASETS, build_table,
                                       make_telemetry_like, make_tpcds_like,
                                       make_tpch_like, telemetry_templates,
                                       widen_columns)
from repro_torch.data.partition_store import PartitionStore
from repro_torch.data.wal import (INITIAL_STATE, ManifestWAL, apply_record,
                                  canonical_manifest, replay_records)

__all__ = ["DATASETS", "INITIAL_STATE", "ManifestWAL", "PartitionStore",
           "apply_record", "build_table", "canonical_manifest",
           "make_telemetry_like", "make_tpcds_like", "make_tpch_like",
           "partition_store", "replay_records", "telemetry_templates",
           "wal", "widen_columns"]
