"""Production meshes (port of ``repro.launch.mesh``).  Functions, not
module constants: importing this module touches no device.

Single pod: 16x16 = 256 positions ("data", "model").
Multi-pod:  2x16x16 = 512 positions ("pod", "data", "model") — the "pod"
axis composes with "data" for batch/FSDP.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.distributed import DeviceMesh

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """The 16x16 (or 2x16x16) ``DeviceMesh`` over ``devices`` (a sequence
    of at least 256 / 512 devices, the first taken in row-major order),
    by default the visible cards.  Too few devices raise ``ValueError``
    naming the count needed, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(
            f"the {'x'.join(map(str, shape))} mesh {axes} needs {need} "
            f"devices, {len(devices)} given")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return DeviceMesh(grid.reshape(shape), axes)


def make_host_mesh(device="cuda"):
    """Degenerate 1x1 ("data", "model") mesh on one device, for the
    sharded code paths on one card or the CPU."""
    return DeviceMesh([[device]], ("data", "model"))
