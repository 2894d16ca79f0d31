"""The port's LM stack: ten architectures' decoders (dense GQA, MLA,
MoE, Mamba-2 SSD, RG-LRU, sliding-window and modality-prefix variants)
as ``nn.Module`` parameter containers and the reference's functional
API (port of ``repro.models``)."""

from .common import ModelConfig
from .model import (
    LM,
    decode_step,
    forward,
    init_params,
    loss_fn,
    make_decode_caches,
    prefill,
)

__all__ = [
    "LM",
    "ModelConfig",
    "decode_step",
    "forward",
    "init_params",
    "loss_fn",
    "make_decode_caches",
    "prefill",
]
