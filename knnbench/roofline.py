"""The H100's published peaks and the bytes that a grid round needs.

Peaks: NVIDIA's data sheet for the H100 SXM5 80 GB at its 700 W limit,
dense rates.  A round's bytes are counted from what it has to move,
whatever the kernel reads again: its query rows' coordinates read once,
the cloud's coordinates read once, and its output lists written once (k
float32 distances and k int32 indices a row).  Distance tests are not
counted as work: how many a round makes is the grid's choice, not what
the answer needs.
"""

from __future__ import annotations

__all__ = ["H100", "round_bytes", "rounds_bytes"]

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
    "tf32_flops_per_s": 495e12,
    "bf16_flops_per_s": 989e12,
    "hbm_bytes": 80e9,
    "power_w": 700.0,
}

F32 = 4
I32 = 4


def round_bytes(rows: int, n_points: int, dim: int, k: int) -> int:
    """Bytes one grid round over ``rows`` query rows has to move."""
    return (rows * dim * F32 + n_points * dim * F32
            + rows * k * (F32 + I32))


def rounds_bytes(rounds, n_points: int, dim: int, k: int) -> int:
    """Bytes of every grid round in ``rounds`` (``(rows, radius)`` pairs;
    the brute tail, at an infinite radius, runs another kernel and is left
    out)."""
    return sum(round_bytes(rows, n_points, dim, k)
               for rows, radius in rounds if radius != float("inf"))
