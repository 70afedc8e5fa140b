"""Launch layer (counterpart of `repro.launch`): the serve steps and the
serving command line so far; training, the mesh and the dry-run wait
for ROADMAP.md item 13."""
