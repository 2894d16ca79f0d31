"""Assigned input-shape cells and their stand-ins for the dry-run (port of
``repro.launch.shapes``).

Cells (per the assignment):
  train_4k     seq 4096   global_batch 256   -> train_step
  prefill_32k  seq 32768  global_batch 32    -> prefill_step
  decode_32k   seq 32768  global_batch 128   -> serve (decode) step
  long_500k    seq 524288 global_batch 1     -> serve (decode) step,
               sub-quadratic archs only (SSM / hybrid / local:global)

The stand-ins are tensors on the ``meta`` device — the reference's shapes
and dtypes, no storage — the port's counterpart of ShapeDtypeStructs.
[audio]/[vlm] archs get a stubbed modality prefix (precomputed
frame/patch embeddings) carved out of the sequence budget.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.common import ModelConfig

__all__ = ["ShapeCell", "CELLS", "LONG_OK", "cell_applicable", "input_specs",
           "cache_specs", "params_specs", "opt_specs"]

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention state.  Run for SSM/hybrid (O(1) or
# windowed state); skip for archs where every layer holds a full-seq KV cache.
LONG_OK = {"mamba2-1.3b", "recurrentgemma-9b", "gemma3-27b"}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple:
    """(ok, reason)."""
    if cell.name == "long_500k" and cfg.name not in LONG_OK:
        return False, "pure full-attention arch: 500k KV cache per layer is quadratic-regime; skipped per assignment"
    return True, ""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Meta stand-ins for every model input of this cell."""
    b, s = cell.global_batch, cell.seq_len
    p = cfg.prefix_len or 0
    if cell.kind == "train":
        spec = {
            "tokens": _meta((b, s - p), torch.int32),
            "labels": _meta((b, s - p), torch.int32),
        }
        if p:
            spec["prefix_embeds"] = _meta((b, p, cfg.d_model), cfg.cdtype())
        return spec
    if cell.kind == "prefill":
        spec = {"tokens": _meta((b, s - p), torch.int32)}
        if p:
            spec["prefix_embeds"] = _meta((b, p, cfg.d_model), cfg.cdtype())
        spec["caches"] = cache_specs(cfg, b, s)
        return spec
    if cell.kind == "decode":
        return {
            "token": _meta((b, 1), torch.int32),
            "pos": _meta((), torch.int32),
            "caches": cache_specs(cfg, b, s),
        }
    raise ValueError(cell.kind)


def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> list:
    """The per-layer decode caches on the meta device."""
    from ..models.transformer import init_caches

    return init_caches(cfg, batch, seq, cfg.cdtype(), META)


def params_specs(cfg: ModelConfig):
    """An ``LM`` on the meta device (its parameters are the stand-ins)."""
    from ..models.model import LM

    return LM(cfg, META)


def opt_specs(params):
    """AdamW's state of ``params`` on the meta device."""
    from ..optim import adamw_init

    return adamw_init(params)
