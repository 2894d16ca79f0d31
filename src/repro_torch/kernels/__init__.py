"""Hand-written CUDA kernels of the port, their builds and their wrappers.

``pairwise_topk`` (``csrc/pairwise_topk.cu``) replaces the JAX package's
one Pallas kernel; the grid-stencil round (``csrc/grid_round.cu``) is
wrapped in ``repro_torch.core.fixed_radius``.  Nothing is compiled at
import time (see ``build``).
"""
