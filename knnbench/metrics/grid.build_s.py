"""grid.build_s: the program's own clock of its grid builds
(``timings["grid_build_seconds"]``) summed over the warm-up's direct
queries.  It reads the host probe and the enqueued binning; the binning's
device tail is not synchronised and not counted."""


def read(run):
    if not run.warmup_grid_builds:
        return None
    return run.warmup_grid_build_s
