"""Synthetic tables on a device (see :mod:`repro_torch.data.datasets`),
the on-disk partition store (:mod:`repro_torch.data.partition_store`), its
crash-safe manifest log (:mod:`repro_torch.data.wal`) and the OREO-managed
training-data pipeline (:mod:`repro_torch.data.pipeline`)."""
from repro_torch.data import partition_store, pipeline, wal
from repro_torch.data.datasets import (DATASETS, build_table,
                                       make_telemetry_like, make_tpcds_like,
                                       make_tpch_like, telemetry_templates,
                                       widen_columns)
from repro_torch.data.partition_store import PartitionStore
from repro_torch.data.pipeline import (OreoDataPipeline, PipelineStats,
                                       mixture_recipe, synth_corpus)
from repro_torch.data.wal import (INITIAL_STATE, ManifestWAL, apply_record,
                                  canonical_manifest, replay_records)

__all__ = ["DATASETS", "INITIAL_STATE", "ManifestWAL", "OreoDataPipeline",
           "PartitionStore", "PipelineStats", "apply_record", "build_table",
           "canonical_manifest", "make_telemetry_like", "make_tpcds_like",
           "make_tpch_like", "mixture_recipe", "partition_store", "pipeline",
           "replay_records", "synth_corpus", "telemetry_templates", "wal",
           "widen_columns"]
