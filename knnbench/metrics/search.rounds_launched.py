"""search.rounds_launched: mean ``grid_round`` launches per batch in the
window, the fused loop's own count (``timings["rounds_launched"]``: every
round of the schedule, launched before the one host sync, including
those that run after every row has resolved).  None where a batch's
``timings`` lack it (another backend, or the host loop)."""


def read(run):
    counts = [b["timings"].get("rounds_launched") for b in run.batches]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts)
