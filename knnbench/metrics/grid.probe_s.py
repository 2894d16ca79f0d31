"""grid.probe_s: the program's own clock of its grid sizing probes
(``timings["grid_probe_seconds"]``, wall seconds of the probes that
missed the memo, their reads from the card included) summed over the
warm-up's calls.  The probes run inside the grid builds that
``grid.build_s`` times.  None where the warm-up's timings lack it."""


def read(run):
    return run.warmup_timings.get("grid_probe_seconds")
