"""grid_round_roofline: percent of its roofline that the grid_round
kernels reach in the traced window: the bytes the window's grid rounds
have to move (``roofline.rounds_bytes``, rows a round from ``RoundStats``)
at the H100's published HBM rate, over the device seconds of every kernel
whose name holds ``grid_round``."""

from knnbench.roofline import H100, rounds_bytes


def read(run):
    if run.trace is None or not run.batches:
        return None
    seconds = run.trace.kernel_seconds("grid_round")
    if not seconds > 0:
        return None
    moved = sum(rounds_bytes(b["rounds"], run.n_points, run.dim, run.k)
                for b in run.batches)
    return 100.0 * moved / H100["hbm_bytes_per_s"] / seconds
