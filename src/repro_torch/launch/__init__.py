"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``, and the mesh factories."""

# NOTE: do not import dryrun here — it is meant to run as the entry module
# (python -m repro_torch.launch.dryrun), as the reference's is.
from .mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
