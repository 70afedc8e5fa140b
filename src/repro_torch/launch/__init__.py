"""Launch layer (counterpart of `repro.launch`): the train and serve
steps (`launch.steps`), the training command line (`launch.train`), the
LM serving command line (`launch.serve`) and the federated serving one
(`launch.fedserve`); the dry-run and the multi-host layer wait for
ROADMAP.md §1 item 5.  The reference's lane mesh (`launch.mesh.make_lane_mesh`,
`launch.sharding.lane_specs`) is not carried over: on one card it has
size 1, and the sweep and serving engines run their lanes in turn."""
