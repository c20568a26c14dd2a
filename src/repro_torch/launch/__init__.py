"""Launch: process-parallel shard hosting for the routing plane
(:mod:`repro_torch.launch.shard_host`; import submodules directly — this
package stays import-light)."""
