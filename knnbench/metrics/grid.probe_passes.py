"""grid.probe_passes: resolutions that the grid sizing probes tried in the
warm-up (``timings["grid_probe_passes"]`` summed over the warm-up's calls;
one device sort and bincount each).  None where the warm-up's timings
lack it."""


def read(run):
    return run.warmup_timings.get("grid_probe_passes")
