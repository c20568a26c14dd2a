"""Launch: production meshes (:mod:`~repro_torch.launch.mesh`), the
production-mesh dry run on fake tensors (:mod:`~repro_torch.launch.dryrun`,
:mod:`~repro_torch.launch.cells`), the op-level FLOP, byte and collective
counter (:mod:`~repro_torch.launch.op_cost`, the counterpart of the
reference's ``hlo_cost``), the H100 roofline
(:mod:`~repro_torch.launch.roofline`) and per-op breakdown
(:mod:`~repro_torch.launch.breakdown`), the training driver
(:mod:`~repro_torch.launch.train`) and process-parallel shard hosting for
the routing plane (:mod:`~repro_torch.launch.shard_host`); import
submodules directly -- this package stays import-light and opens no
process group."""
