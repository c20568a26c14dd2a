"""Launch: process-parallel shard hosting for the routing plane
(:mod:`repro_torch.launch.shard_host`) and the training driver
(:mod:`repro_torch.launch.train`); import submodules directly -- this
package stays import-light."""
