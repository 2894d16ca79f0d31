"""The graph workloads over the port's sharded fabric against the JAX
package's: ``build_knn_graph`` in its three symmetrize modes, ``dbscan``
(whole and chunked) and ``AllPairsSpec`` (whole, chunked, range) over
``backend="sharded"`` with ``placement="host"`` and with
``placement="devices"`` on 1, 2 and 4 positions, each ``np.array_equal``
to ``repro.workloads`` on the same inputs.

JAX fixes its device count when it starts, so the reference runs in one
subprocess per device count (``--xla_force_host_platform_device_count``,
all started together) and saves what ``torch_workload_cases.run_all``
returns; the port runs the same cases on a P-position CPU
``DeviceMesh``."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.workloads as port_workloads
from repro_torch import DeviceMesh, make_dataset
from torch_workload_cases import GROUPS, run_all

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
DEVICE_COUNTS = (1, 2, 4)
PLACEMENTS = ("host",) + tuple(f"devices-{p}" for p in DEVICE_COUNTS)

_REFERENCE = r"""
import pickle, sys
sys.path.insert(0, {test_dir!r})
import jax
import repro.api as api
import repro.workloads as workloads
from repro.core import make_dataset
from torch_workload_cases import run_all

assert len(jax.devices()) == {p}, jax.devices()
with open(sys.argv[1], "wb") as f:
    pickle.dump(run_all(api, workloads, make_dataset, {placements!r}), f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """P -> the reference's outputs (host placement in the P = 1 run)."""
    tmp = tmp_path_factory.mktemp("workloads")
    procs = {}
    for p in DEVICE_COUNTS:
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={p}")
        placements = ("host", "devices") if p == 1 else ("devices",)
        script = _REFERENCE.format(test_dir=str(Path(__file__).parent), p=p,
                                   placements=placements)
        procs[p] = subprocess.Popen(
            [sys.executable, "-c", script, str(tmp / f"ref{p}.pkl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    for p, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        with open(tmp / f"ref{p}.pkl", "rb") as f:
            out[p] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def port():
    cache = {}

    def get(p, placement):
        if (p, placement) not in cache:
            cache[p, placement] = run_all(
                repro_torch, port_workloads, make_dataset, (placement,),
                device="cpu", mesh=DeviceMesh(["cpu"] * p))
        return cache[p, placement]

    return get


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("where", PLACEMENTS)
def test_sharded_workloads_equal_reference(ref, port, where, group):
    placement, p = (("host", 1) if where == "host"
                    else ("devices", int(where.split("-")[1])))
    want, got = ref[p], port(p, placement)
    keys = [k for k in want
            if k.split("/")[0] == group and k.split("/")[1] == placement]
    assert keys and set(keys) <= set(got), group
    for key in keys:
        a, b = want[key], got[key]
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and a.dtype == b.dtype, key
            assert np.array_equal(a, b), key
        else:
            assert a == b, (key, a, b)


def test_placed_workloads_equal_host_placement(port):
    """Placing the shards on 1-4 positions changes no workload bit."""
    host = port(1, "host")
    for p in DEVICE_COUNTS:
        placed = port(p, "devices")
        for key, want in host.items():
            other = key.replace("/host", "/devices", 1)
            if "/stats/" in key or key.endswith("/plan"):
                continue
            if isinstance(want, np.ndarray):
                assert np.array_equal(want, placed[other]), (p, key)
            elif not key.endswith("n_tests"):
                assert want == placed[other], (p, key)
