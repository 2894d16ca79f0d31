"""Optimizer substrate of the port (port of ``repro.optim``): AdamW with
decoupled weight decay and global-norm clipping, the cosine schedule, and
error-feedback int8 gradient compression."""

from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule
from .compression import compress_grads_ef, CompressionState

__all__ = [
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "compress_grads_ef",
    "CompressionState",
]
