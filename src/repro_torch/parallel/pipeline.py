"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro.parallel.pipeline``).

Stages hold contiguous layer groups; microbatches stream through the
stages, activations moving to the next stage's device each tick.  The
schedule is the classic (n_micro + n_stages - 1)-tick wavefront: tick t
has stage s working on microbatch (t - s), bubbles at the ends, steady-
state utilization n_micro / (n_micro + n_stages - 1).

The reference runs the wavefront under ``shard_map``, every stage
computing every tick and ``ppermute`` shifting activations.  The port
drives the same ticks from the host: "ppermute" is ``.to(next stage's
device)``, and a bubble tick (stage s outside microbatches 0..n_micro-1)
launches nothing, since its output is never parked.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core.distributed import DeviceMesh

__all__ = ["pipeline_apply"]


def pipeline_apply(
    mesh: DeviceMesh,
    stage_fn: Callable,  # (stage_params, x) -> x, applied by every stage
    n_micro: int,
    *,
    axis: str = "stage",
):
    """Returns fn(stage_params, xs) -> ys.

    stage_params: a sequence with one entry per stage; entry s lives on
    the device of position s along ``axis`` (the other coordinates 0).
    xs: (n_micro, mb, ...) microbatches.  ys: (n_micro, mb, ...) — all
    stages applied in order to each microbatch, the last stage's parked
    buffer, on the mesh's first device.  ``fn.schedule`` holds the
    wavefront's ``ticks``, the stage-ticks that compute (``busy``) and the
    idle ones (``bubbles``)."""
    n_stages = mesh.shape[axis]
    dim = mesh.axis_names.index(axis)
    devices = []
    for s in range(n_stages):
        pos = [0] * len(mesh.axis_names)
        pos[dim] = s
        devices.append(mesh.devices[tuple(pos)])
    n_ticks = n_micro + n_stages - 1

    def fn(stage_params: Sequence, xs: torch.Tensor) -> torch.Tensor:
        if len(stage_params) != n_stages:
            raise ValueError(f"{len(stage_params)} stage params for "
                             f"{n_stages} stages")
        if xs.shape[0] != n_micro:
            raise ValueError(f"xs has {xs.shape[0]} microbatches, not "
                             f"{n_micro}")
        buf = [None] * n_micro  # outputs parking (on the last stage)
        carry = [None] * n_stages  # activation arriving at each stage
        for t in range(n_ticks):
            out = [None] * n_stages
            for s in range(n_stages):
                m = t - s
                if not 0 <= m < n_micro:
                    continue  # bubble
                x_in = xs[m].to(devices[0]) if s == 0 else carry[s]
                out[s] = stage_fn(stage_params[s], x_in)
            # the last stage parks finished microbatch t - n_stages + 1
            m_out = t - (n_stages - 1)
            if 0 <= m_out < n_micro:
                buf[m_out] = out[-1]
            # shift activations to the next stage
            carry = [None] + [None if y is None else y.to(devices[s + 1])
                              for s, y in enumerate(out[:-1])]
        return torch.stack([b.to(mesh.first_device) for b in buf])

    fn.schedule = {"ticks": n_ticks, "busy": n_stages * n_micro,
                   "bubbles": n_stages * n_ticks - n_stages * n_micro}
    return fn
