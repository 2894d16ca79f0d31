"""Device resolution for the port: one place decides where an index lives.

Entry points default to the card (``"cuda"``).  Asking for ``cuda`` on a
machine without one raises — there is no silent fallback to the CPU, so a
run that was meant to measure the card can never quietly measure the host.
The tests pass ``device="cpu"`` explicitly, which runs every kernel's plain
PyTorch version.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "device_scope"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or ``torch.device``) as a validated ``torch.device``.

    Only ``cpu`` and ``cuda`` are accepted; ``cuda`` requires a visible
    card and is pinned to an explicit ordinal so tensors compare equal.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


def device_scope(device, stream=None):
    """A context in which this thread's torch ops run on ``device``: for a
    card, it is the thread's current CUDA device (a thread starts on card
    0), and ``stream``, when given, its current stream.  A no-op for the
    CPU or None."""
    stack = contextlib.ExitStack()
    if device is not None and torch.device(device).type == "cuda":
        stack.enter_context(torch.cuda.device(device))
        if stream is not None:
            stack.enter_context(torch.cuda.stream(stream))
    return stack
