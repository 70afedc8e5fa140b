"""Launch layer (counterpart of `repro.launch`): the serve steps, the LM
serving command line (`launch.serve`) and the federated serving one
(`launch.fedserve`); training and the dry-run wait for ROADMAP.md §1
item 8.  The reference's lane mesh (`launch.mesh.make_lane_mesh`,
`launch.sharding.lane_specs`) is not carried over: on one card it has
size 1, and the sweep and serving engines run their lanes in turn."""
