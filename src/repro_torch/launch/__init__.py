"""Launch drivers of the port (`serve`, `train`, `mesh`) and its tooling (`roofline`, `dryrun`, `perf`, `report`)."""
