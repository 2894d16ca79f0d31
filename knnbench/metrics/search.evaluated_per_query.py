"""search.evaluated_per_query: distances the grid-round and brute kernels
computed per query row in the window (``timings["d2_evaluated"]`` summed
over the batches, over their rows): in rounds that walked a sub-grid the
walk's own count, elsewhere one a test, so it reads as
``search.tests_per_query`` where no round walked.  None where a batch's
``timings`` lack it (a program without the counter, the host loop,
another backend)."""


def read(run):
    counts = [b["timings"].get("d2_evaluated") for b in run.batches]
    rows = sum(b["rows"] for b in run.batches)
    if not counts or None in counts or not rows:
        return None
    return sum(counts) / rows
