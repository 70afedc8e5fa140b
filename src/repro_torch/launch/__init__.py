"""Launch layer (counterpart of `repro.launch`): the train and serve
steps (`launch.steps`), the training command line (`launch.train`), the
LM serving command line (`launch.serve`), the federated serving one
(`launch.fedserve`), the production meshes (`launch.mesh`), the sharding
rules (`launch.sharding`), the multi-process bootstrap
(`launch.distributed`) and the dry run on a fake 256- or 512-rank world
(`launch.dryrun`), with the lane and shard meshes over the local cards
(`launch.mesh.make_lane_mesh`, `make_shard_mesh`,
`launch.sharding.lane_specs`).  Not carried over: `launch.hlo_stats`,
which parses XLA's HLO text (the port produces none)."""
