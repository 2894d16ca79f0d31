"""Build and load the port's CUDA kernels, and count their launches.

The kernels (``csrc/pairwise_topk.cu``, ``csrc/grid_round.cu``) and their
binding (``csrc/binding.cpp``, the one source that includes PyTorch's
headers) are built by one ``torch.utils.cpp_extension.load`` call for
``sm_90a`` into ``build/torch_ext/`` at the root of the checkout.  ``load``
compiles the sources in parallel with ninja, and loads an unchanged build
as it is.

Nothing is built when this module is imported: ``extension()`` builds on
first use.

``LAUNCHES`` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show which
kernels its path went through (``reset_launches`` / ``launch_counts``).
``WIDE_LAUNCHES`` counts apart each kernel's launches at k > 32, whose
lists are kept by a warp with several entries a lane or in memory rows.
A replayed CUDA graph adds the launches its capture counted
(``launches_since``, ``add_launches``).
"""

from __future__ import annotations

import threading
from pathlib import Path

__all__ = [
    "LAUNCHES",
    "WIDE_LAUNCHES",
    "BUILD_DIR",
    "extension",
    "load_sources",
    "count_launch",
    "launch_counts",
    "launch_snapshot",
    "launches_since",
    "add_launches",
    "reset_launches",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = ("binding.cpp", "pairwise_topk.cu", "grid_round.cu")
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

LAUNCHES = {"pairwise_topk": 0, "grid_round": 0}
WIDE_LAUNCHES = {"pairwise_topk": 0, "grid_round": 0}  # k > 32, a part
_EXT = None
_LOCK = threading.Lock()


def count_launch(name: str, wide: bool = False) -> None:
    LAUNCHES[name] += 1
    if wide:
        WIDE_LAUNCHES[name] += 1


def launch_counts() -> dict:
    return dict(LAUNCHES)


def launch_snapshot() -> tuple:
    """Both tallies as they stand, for ``launches_since``."""
    return dict(LAUNCHES), dict(WIDE_LAUNCHES)


def launches_since(snapshot: tuple) -> tuple:
    """The launches counted since ``snapshot``, per tally and kernel."""
    return tuple({name: now[name] - then[name] for name in now}
                 for now, then in zip(launch_snapshot(), snapshot))


def add_launches(delta: tuple, sign: int = 1) -> None:
    """Add (``sign`` -1: take away) a ``launches_since`` delta: a replayed
    CUDA graph launches what its capture counted."""
    for counts, add in zip((LAUNCHES, WIDE_LAUNCHES), delta):
        for name, n in add.items():
            counts[name] += sign * n


def reset_launches() -> None:
    for counts in (LAUNCHES, WIDE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def load_sources(csrc: Path, name: str, build_dir: Path):
    """Build the ``SOURCES`` under ``csrc`` as the extension ``name`` in
    ``build_dir`` (or load an unchanged build there) and return it."""
    from torch.utils.cpp_extension import load

    build_dir.mkdir(parents=True, exist_ok=True)  # load() does not
    return load(
        name=name,
        sources=[str(csrc / s) for s in SOURCES],
        build_directory=str(build_dir),
        extra_cflags=["-O3"],
        extra_cuda_cflags=list(NVCC_FLAGS),
        verbose=False,
    )


def extension():
    """The loaded extension module (built on first use); raises if the
    build fails."""
    global _EXT
    with _LOCK:
        if _EXT is None:
            _EXT = load_sources(CSRC, "repro_torch_kernels", BUILD_DIR)
        return _EXT
