"""Roofline terms for the dry-run (port of ``repro.launch.analysis``).

Hardware model: one NVIDIA H100 SXM per mesh position (constants below,
each with its source).  The port has no compiled program to read, so:

  * flops come from ``torch.utils.flop_counter.FlopCounterMode`` over the
    step run on the meta device (products only: mm, bmm, addmm, sdpa,
    conv);
  * collective bytes come from a collective log — a list of (kind, bytes)
    entries that the sharded train step and ``compressed_psum_mean``
    append to, each one position's result bytes (the reference sums the
    result shapes of its per-device HLO) — or from ``step_collectives``,
    the closed form of what the sharded step logs.
"""

from __future__ import annotations

import math

from ..parallel.sharding import _axes, _named_leaves

#: bf16 dense tensor-core peak, no sparsity (NVIDIA H100 SXM data sheet)
PEAK_FLOPS = 989e12
#: HBM3 bandwidth (NVIDIA H100 SXM data sheet; the figure chip_smoke.py's
#: HBM_BYTES_PER_S uses)
HBM_BW = 3.35e12
#: a 256-card mesh spans nodes: per card, one 400 Gb/s NDR InfiniBand
#: link (NVIDIA ConnectX-7), 50e9 B/s — the across-node fabric, not
#: NVLink inside a node
LINK_BW = 50e9

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def collective_bytes(log) -> dict:
    """Per-collective-kind bytes summed over a collective log (a list of
    (kind, bytes))."""
    out = {c: 0 for c in COLLECTIVES}
    count = {c: 0 for c in COLLECTIVES}
    for kind, nbytes in log:
        if kind not in out:
            raise ValueError(f"unknown collective {kind!r}")
        out[kind] += int(nbytes)
        count[kind] += 1
    return {"bytes": out, "counts": count, "total_bytes": sum(out.values())}


def _nbytes(shape, dtype) -> int:
    return math.prod(int(d) for d in shape) * dtype.itemsize


def step_collectives(p_sh, o_sh, b_sh, kind: str):
    """The collective log of one sharded train step in closed form: what
    ``train.make_sharded_train_step`` appends, parameter by parameter.

    ``p_sh``: the parameters' shardings (``param_shardings``, which
    records each tensor's shape and dtype); ``o_sh``: the moments' (role
    "opt"; the whole AdamW state's or its ``mu``); ``b_sh``: the
    batch's; ``kind``: "train", "prefill" or "decode".  Per parameter, in
    order:

      * all-gather of the whole weight when it has more than one slice
        (each data row computes on whole weights, ROADMAP B13);
      * when the batch spans several data rows: the gradient's reduction
        over them to the moment's slice, a reduce-scatter when the
        moment's spec splits over a batch axis, else an all-reduce;
      * where the moment has more slices than the parameter (ZeRO-1):
        all-gather of the updated parameter's slice.

    Bytes are one position's result bytes.  A prefill or decode cell
    returns None: the port has no sharded serving step (``prefill``,
    ``decode_step`` and ``BatchedServer`` take no mesh), so nothing is
    logged for it."""
    if kind != "train":
        return None
    p_leaves = dict(_named_leaves(p_sh))
    mesh = next(iter(p_leaves.values())).mesh
    tokens = next(iter(dict(_named_leaves(b_sh)).values()))
    batch = set(_axes(tokens.spec[0] if len(tokens.spec) else None))
    rows = math.prod(mesh.shape[a] for a in batch)
    o_leaves = dict(_named_leaves(o_sh.get("mu", o_sh)))
    log = []
    for name, sh in p_leaves.items():
        if sh.n_slices > 1:
            log.append(("all-gather", _nbytes(sh.shape, sh.dtype)))
        osh = o_leaves[name]
        if rows > 1:
            split = math.prod(mesh.shape[a] for e in osh.spec
                              for a in _axes(e) if a in batch) > 1
            log.append(("reduce-scatter" if split else "all-reduce",
                        _nbytes(osh.local_shape(sh.shape), sh.dtype)))
        if osh.n_slices > sh.n_slices:
            log.append(("all-gather",
                        _nbytes(sh.local_shape(sh.shape), sh.dtype)))
    return log


def roofline(cost: dict, coll_total_bytes: int, n_chips: int, *,
             per_device_hlo: bool = True) -> dict:
    """Three roofline terms in seconds.

    ``per_device_hlo``: ``cost`` is one position's (flops, bytes), so the
    chips term divides only the collective bytes (each card drives its
    own link).  ``coll_total_bytes`` None (a cell with no sharded step in
    the port) makes the collective term None and leaves it out of
    ``dominant``."""
    flops = float(cost.get("flops", 0.0) or 0.0)
    bytes_ = float(
        cost.get("bytes accessed", cost.get("bytes accessed0{}", 0.0)) or 0.0
    )
    chips = 1 if per_device_hlo else n_chips
    compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = bytes_ / (chips * HBM_BW)
    collective_s = (None if coll_total_bytes is None
                    else coll_total_bytes / (chips * LINK_BW))
    global_flops = flops * n_chips if per_device_hlo else flops
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max((k for k, v in terms.items() if v is not None), key=terms.get)
    return {
        **terms,
        "dominant": dom,
        "hlo_flops_per_device": flops if per_device_hlo else flops / n_chips,
        "hlo_flops_global": global_flops,
        "hlo_bytes_per_device": bytes_ if per_device_hlo else bytes_ / n_chips,
        "collective_bytes": coll_total_bytes,
        "n_chips": n_chips,
    }


def model_memory_bytes(cfg, cell, n_chips: int) -> float:
    """Analytic per-chip HBM-traffic LOWER BOUND for one step of this cell.

    The LB counts the irreducible streams:
      train:   params read (fwd+bwd) + grads written + Adam moments rw
               + activations written-then-read once (no remat assumed)
      prefill: params read + KV cache written + activations once
      decode:  params read + KV cache read/updated (the decode wall)
    """
    pbytes = 2.0  # bf16 params
    n_local = active_params(cfg) / n_chips  # active: routed experts stream once
    d = cfg.d_model
    if cell.kind == "train":
        tokens_local = cell.global_batch * cell.seq_len / n_chips
        act = tokens_local * d * cfg.n_layers * 2 * 2.0  # write+read, bf16
        return n_local * (2 * pbytes + 2 + 8 + 8) + act  # p,p | g | mu,nu
    if cell.kind == "prefill":
        tokens_local = cell.global_batch * cell.seq_len / n_chips
        act = tokens_local * d * cfg.n_layers * 2.0
        kv = _kv_bytes(cfg, cell, n_chips)
        return n_local * pbytes + act + kv
    # decode: stream params + whole KV cache once per token
    return n_local * pbytes + _kv_bytes(cfg, cell, n_chips)


def _kv_bytes(cfg, cell, n_chips: int) -> float:
    b, s = cell.global_batch, cell.seq_len
    if cfg.attn_type == "mla":
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
        n_full = cfg.n_layers
    elif cfg.attn_type == "none":
        # SSM state, seq-independent
        d_inner = cfg.ssm_expand * cfg.d_model
        return cfg.n_layers * b * (d_inner / cfg.ssm_head_dim) \
            * cfg.ssm_head_dim * cfg.ssm_state * 4 / n_chips
    else:
        kinds = cfg.layer_kinds
        n_full = sum(1 for k in kinds if k == "attn")
        n_local_attn = sum(1 for k in kinds if k == "local")
        n_rglru = sum(1 for k in kinds if k == "rglru")
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
        full = n_full * b * s * per_tok * 2.0
        loc = n_local_attn * b * min(s, cfg.local_window) * per_tok * 2.0
        rg = n_rglru * b * cfg.rglru_expand * cfg.d_model * 4.0
        return (full + loc + rg) / n_chips
    return n_full * b * s * per_tok * 2.0 / n_chips


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N*D tokens (dense) / 6*N_active*D (MoE); decode cells
    use D = batch tokens (one step)."""
    n_active = active_params(cfg)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch


def active_params(cfg) -> int:
    """Active-per-token params (MoE discounts unrouted experts)."""
    total = cfg.param_count()
    if not cfg.n_experts:
        return total
    d, de = cfg.d_model, (cfg.d_expert or cfg.d_ff)
    per_expert = 3 * d * de
    n_moe_layers = sum(
        1 for i in range(cfg.n_layers) if i >= cfg.first_k_dense
    )
    routed_total = cfg.n_experts * per_expert * n_moe_layers
    routed_active = cfg.experts_per_token * per_expert * n_moe_layers
    return int(total - routed_total + routed_active)
