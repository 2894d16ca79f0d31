"""sor.filter_s: the program's own clock of the outlier filter's host
work (``timings["sor_filter_seconds"]``: the ``repro_torch.sor.filter``
span's wall seconds, the reduction of the returned lists to mean
distances, the threshold and the keep mask), the mean over the window's
batches that have it.  None where no batch has it."""


def read(run):
    found = [b["timings"]["sor_filter_seconds"] for b in run.batches
             if "sor_filter_seconds" in b["timings"]]
    if not found:
        return None
    return sum(found) / len(found)
