"""Engines of the port: grid binning, fixed-radius rounds, the fused round
loop, the exact brute engine and the Alg. 2 sampler (torch; the kernels
they launch live in ``repro_torch.kernels`` and ``csrc/``).  The public
search surface is ``repro_torch.api``."""

from .datasets import DATASETS, make_dataset
from .result import KNNResult, RangeResult, RoundStats

__all__ = ["DATASETS", "make_dataset", "KNNResult", "RangeResult",
           "RoundStats"]
