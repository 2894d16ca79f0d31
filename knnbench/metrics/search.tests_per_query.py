"""search.tests_per_query: distance tests per query row in the window
(``KNNResult.n_tests`` summed over the batches, over their rows)."""


def read(run):
    rows = sum(b["rows"] for b in run.batches)
    if not rows:
        return None
    return sum(b["n_tests"] for b in run.batches) / rows
