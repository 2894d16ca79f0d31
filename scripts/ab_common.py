"""What the kernel A/B scripts share: the card's name and power limit, a
timing with CUDA events, and a second build of the kernels from another
checkout's sources (``scripts/pairwise_ab.py``, ``scripts/grid_round_ab.py``).
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RADIUS = 0.122349  # chip_smoke.py phase 4: median 8th-NN distance
N = 1 << 20  # kitti points
FP32_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores, as chip_smoke.py
REPS = 5
SLOW_MS = 100.0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def other_extension(other: str | Path):
    """The kernels built from the sources of the checkout at ``other``,
    into ``build/ab_other`` of this one."""
    from repro_torch.kernels import build

    return build.load_sources(
        Path(other) / "src" / "repro_torch" / "csrc",
        "repro_torch_kernels_other", ROOT / "build" / "ab_other")


def median_ms(fn, setup=lambda: None, reps: int = REPS,
              slow_ms: float = SLOW_MS):
    """Device ms of ``fn(setup())`` by CUDA events: one warm-up call, then
    the median of ``reps`` calls, or one call where the warm-up took longer
    than ``slow_ms``.  ``setup`` runs untimed before each call.  Returns
    (ms, what the last ``setup`` returned)."""
    import torch

    def once():
        arg = setup()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        b.synchronize()
        return a.elapsed_time(b), arg

    warm, _ = once()
    if warm > slow_ms:
        return once()
    runs = [once() for _ in range(reps)]
    return statistics.median(r[0] for r in runs), runs[-1][1]
