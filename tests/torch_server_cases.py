"""Shared helpers of the port's serving tests (``test_torch_server*.py``,
``test_torch_apps.py``): the two packages as interchangeable namespaces,
and comparisons of what their servers serve.

Each case runs the same inputs through the JAX package and through the
port on the CPU; served rows, CSRs, tickets' timings tags and the
servers' counters must be equal.  Meters that hold seconds (latency
percentiles, service and request seconds) are compared by structure
only.
"""

import numpy as np

import repro.api as ref_api
import repro.api.server as ref_server
import repro.core as ref_core
import repro_torch.api as port_api
import repro_torch.api.server as port_server
import repro_torch.core as port_core


class Pkg:
    """One package's serving surface: ``api`` names, ``core`` names,
    ``server`` (the server module) and ``build`` (``build_index`` with
    the package's device knob)."""

    def __init__(self, name, api, core, server, **kw):
        self.name, self.core, self.server, self.kw = name, core, server, kw
        self._api = api

    def build(self, pts, backend="brute", **cfg):
        return self._api.build_index(pts, backend=backend, **self.kw, **cfg)

    def __getattr__(self, name):
        return getattr(self._api, name)


REF = Pkg("repro", ref_api, ref_core, ref_server)
PORT = Pkg("repro_torch", port_api, port_core, port_server, device="cpu")
PKGS = (REF, PORT)

#: timings a served result carries that are not seconds
TAGS = ("plan", "server_batch_rows", "server_cache_hits")
#: meter keys that hold seconds
SECONDS = ("latency_p50_ms", "latency_p99_ms")


def served(res):
    """The comparable content of a served (or direct) result."""
    out = {"n_tests": int(res.n_tests), "backend": res.backend,
           "metric": res.metric,
           "timings": {k: res.timings[k] for k in TAGS if k in res.timings}}
    keys = (("offsets", "idxs", "dists", "truncated") if hasattr(res, "offsets")
            else ("dists", "idxs", "found"))
    for key in keys:
        v = getattr(res, key)
        out[key] = None if v is None else np.asarray(v)
    if hasattr(res, "offsets"):
        out["radius"] = float(res.radius)
    return out


def meters(stats):
    """A server's ``stats()`` without its seconds and without the tenants'
    own index stats (backend-specific); every counter kept."""
    out = {k: v for k, v in stats.items() if k != "indexes"}
    out["buckets"] = {
        name: {k: v for k, v in b.items() if k not in SECONDS}
        for name, b in stats["buckets"].items()
    }
    return out


def same(a, b, path="out"):
    """Deep equality: arrays bitwise with their dtype, floats exactly."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert a.shape == b.shape and np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (
            path, sorted(a), sorted(b))
        for key in a:
            same(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def both(case, *args):
    """Run ``case(pkg, *args)`` on both packages and require equal
    outputs; returns the port's."""
    want, got = (case(pkg, *args) for pkg in PKGS)
    same(want, got)
    return got
