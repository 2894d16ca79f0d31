"""Distributed backend (port of ``repro.api.backends.distributed``) —
mesh-sharded points, hypercube top-k merge.  ``backend="distributed"``.

Wraps ``repro_torch.core.distributed.distributed_trueknn``: points live
sharded over the mesh's point axis for the lifetime of the index (placed
once at build), queries stream through the multi-round driver.  One
process drives every mesh position; a ``DeviceMesh`` may name one device
at several positions, so one card or the CPU serves a mesh of any pow2
width.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from ...core.distributed import DeviceMesh, distributed_trueknn, place_shards
from ...core.result import KNNResult
from ...core.sampling import sample_start_radius
from ..index import NeighborIndex
from ..metrics import Metric
from ..query import KnnSpec
from ..registry import register_backend

__all__ = ["DistributedIndex"]


def _default_mesh(point_axis: str, device: torch.device) -> DeviceMesh:
    """Every visible card on one point axis, cut to the largest pow2
    prefix; one position on the CPU."""
    if device.type == "cpu":
        return DeviceMesh([device], (point_axis,))
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    p = 1 << (len(devs).bit_length() - 1)  # largest pow2 prefix
    if p < len(devs):
        warnings.warn(
            f"distributed backend: using {p} of {len(devs)} available "
            f"devices (the hypercube top-k merge needs a power-of-2 shard "
            f"count); pass an explicit mesh to choose which devices serve",
            RuntimeWarning,
            stacklevel=3,
        )
    return DeviceMesh(devs[:p], (point_axis,))


@register_backend("distributed")
class DistributedIndex(NeighborIndex):
    """Multi-round unbounded kNN over mesh-sharded points.

    cfg: ``mesh`` (a ``DeviceMesh``; default: every visible card on one
    ``point_axis``, or one CPU position with ``device="cpu"``), ``growth``,
    ``max_rounds``, ``point_axis``, ``device`` (the index's own device: its
    resident cloud, the Alg. 2 sampler and the planner's generic routes;
    the mesh's devices must be of its type).  ``use_kernel`` is accepted so
    cfg dicts written for the reference build this index, and is ignored:
    the device chooses the engine, as everywhere in the port (the
    ``pairwise_topk`` kernel on the card, its plain version on the CPU),
    so ``stats()`` does not report it.
    """

    def __init__(
        self,
        points,
        *,
        mesh: Optional[DeviceMesh] = None,
        growth: float = 2.0,
        max_rounds: int = 32,
        use_kernel: bool = False,
        point_axis: str = "model",
        device="cuda",
    ):
        super().__init__(points, device)
        self._mesh = (mesh if mesh is not None
                      else _default_mesh(point_axis, self._device))
        if self._mesh.device_type != self._device.type:
            raise ValueError(
                f"mesh devices are {self._mesh.device_type} but the index "
                f"is on {self._device}"
            )
        del use_kernel  # accepted for the reference's cfg dicts, ignored
        self._growth = float(growth)
        self._max_rounds = int(max_rounds)
        self._point_axis = point_axis
        # the build: shard the cloud over the point axis once, keep it
        # device-resident for the life of the index
        self._pts_device = place_shards(self._pts_t, self._mesh, point_axis)
        self._sampled_r: Optional[float] = None
        self._queries_served = 0
        self._batches = 0
        self._total_tests = 0

    def supports_knn_spec(self, spec: KnnSpec) -> bool:
        # no radius schedule to stop: the planner routes stop_radius specs
        # to the companion-trueknn fallback (plan tag "knn_fallback") at
        # plan-construction time
        return spec.stop_radius is None

    def execute_knn(self, queries, spec: KnnSpec, metric: Metric,
                    ctx=None) -> KNNResult:
        """Native kNN over the sharded cloud (L2 only; range/hybrid specs
        and reducible metrics arrive through the planner's generic plans)."""
        if spec.stop_radius is not None:
            # belt and braces for direct hook calls; the planner never
            # routes here (supports_knn_spec said no)
            raise NotImplementedError(
                "distributed backend has no native stop_radius path"
            )
        k = spec.k
        radius = spec.start_radius
        t0 = time.perf_counter()
        if radius is None:
            # Alg.-2 sampling depends only on the resident cloud: pay it once
            if self._sampled_r is None:
                self._sampled_r = sample_start_radius(self._pts_t)
            radius = self._sampled_r
        dists, idxs, rounds, n_tests = distributed_trueknn(
            self._pts,
            k,
            self._mesh,
            queries=queries,
            start_radius=radius,
            growth=self._growth,
            max_rounds=self._max_rounds,
            points_device=self._pts_device,
            point_axis=self._point_axis,
        )
        self._queries_served += dists.shape[0]
        self._batches += 1
        self._total_tests += int(n_tests)
        return KNNResult(
            dists=np.asarray(dists),
            idxs=np.asarray(idxs),
            # the dense sharded engine evaluates every (padded query, point)
            # pair each round, so this count is exact for it (padding rows
            # included — they are real work on the mesh)
            n_tests=int(n_tests),
            backend=self.backend_name,
            metric=metric.name,
            timings={
                "query_seconds": time.perf_counter() - t0,
                "mesh_rounds": rounds,
            },
            start_radius=radius,
        )

    def stats(self) -> dict:
        s = super().stats()
        s.update(
            mesh_shape=dict(self._mesh.shape),
            queries_served=self._queries_served,
            batches=self._batches,
            total_tests=self._total_tests,
        )
        return s
