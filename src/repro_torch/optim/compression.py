"""Error-feedback int8 gradient compression (port of
``repro.optim.compression``).

Each gradient tensor is quantized to int8 with a per-tensor f32 scale; the
quantization residual is carried in an error-feedback accumulator
(Karimireddy et al., 2019) so the bias vanishes over steps.
``compress_grads_ef`` quantizes and dequantizes an already-averaged
``{name: tensor}`` gradient dict: the end-to-end numerics of compressing
before an all-reduce.  The scale is per tensor of the dict: for an LM's
gradients that is per layer parameter, where the reference's is per
stacked leaf (all of a scanned period's layers under one scale).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CompressionState:
    error: dict  # {name: f32 residual}, mirrors grads


def init_compression(grads) -> CompressionState:
    return CompressionState(
        error={n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
               for n, g in grads.items()}
    )


def _quantize(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    # torch.round, like jnp.round, rounds half to even
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads_ef(grads, state: CompressionState):
    """Quantize(+EF) each tensor; returns (dequantized grads, new state)."""
    deq, err = {}, {}
    for n, g in grads.items():
        x = g.float() + state.error[n]
        q, scale = _quantize(x)
        deq[n] = q.float() * scale
        err[n] = x - deq[n]
    return deq, CompressionState(error=err)
