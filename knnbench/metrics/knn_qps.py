"""knn_qps: query rows whose answers reached the host in the window, over
the window's length (host clock); the window runs whole batches until
``--seconds`` have passed, and its length is the time they took."""


def read(run):
    if not run.batches or not run.window_s > 0:
        return None
    return run.rows_done / run.window_s
