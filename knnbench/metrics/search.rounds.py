"""search.rounds: mean rounds per batch in the window (the length of
``KNNResult.rounds``: grid rounds that ran, and the brute tail)."""


def read(run):
    if not run.batches:
        return None
    return sum(len(b["rounds"]) for b in run.batches) / len(run.batches)
