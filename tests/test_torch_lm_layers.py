"""The port's mixing layers against the reference's functions on the same
weights and inputs, and against the oracles ``tests/test_models.py``
holds the reference to: SSD chunked vs the naive recurrence, the RG-LRU
scan vs its sequential decode, MLA absorbed vs materialized (and the
decode write that the reference's dynamic slice clamps), the MoE
routing integers (top-k ties, the stable sort, capacity drops), the
masks, the sliding window and a ring cache that wraps, and
``bf16_norm``.

Tolerances: float32 results of the same recurrence in another float
order are held to the reference's own oracle tolerances
(``tests/test_models.py:130,156``: rtol 1e-3 / atol 1e-4 against the
naive SSD recurrence, rtol 1e-4 / atol 1e-5 scan vs sequential);
float32 port vs reference on the same formula to rtol 1e-4 / atol 1e-5
(the products and the chunk's exp-of-segsum sum in another order);
integers and masks exactly."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as ref_common
import repro.models.mla as ref_mla
import repro.models.moe as ref_moe
import repro.models.rglru as ref_rglru
import repro.models.ssm as ref_ssm
import repro_torch.models as port_models
import repro_torch.models.common as port_common
import repro_torch.models.mla as port_mla
import repro_torch.models.moe as port_moe
import repro_torch.models.rglru as port_rglru
import repro_torch.models.ssm as port_ssm
from repro import models as ref_models
from repro.configs import get_config, smoke_config
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import smoke_config as port_smoke_config
from repro_torch.convert import lm_params_from_reference

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
SAME_FORMULA = dict(rtol=1e-4, atol=1e-5)


def _cfgs(name, **changes):
    ref = dataclasses.replace(smoke_config(get_config(name)), **changes)
    port = dataclasses.replace(port_smoke_config(port_get_config(name)),
                               **changes)
    return ref, port


def _load(module, tree):
    """Copy a reference layer's parameter dict (jax leaves) into ``module``."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = torch.from_numpy(np.array(v))

    walk(tree, "")
    module.load_state_dict(flat, strict=True)
    return module


def _ref_init(cfg):
    return jax.jit(ref_models.init_params, static_argnums=1)(KEY, cfg)


def _np(x):
    return np.asarray(x) if not torch.is_tensor(x) else x.detach().numpy()


# -- SSD --------------------------------------------------------------------


def _ssd_inputs(rng, b=2, s=32, h=3, p=8, n=5):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, h))) * 0.5).astype(np.float32)
    a = (-np.abs(rng.normal(size=(h,))) * 0.5).astype(np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a, bb, cc


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_naive_recurrence_and_reference(chunk):
    x, dt, a, bb, cc = _ssd_inputs(np.random.default_rng(0))
    y, hlast = port_ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, cc)),
                                    chunk=chunk)
    ry, rh = ref_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)),
                                 chunk=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(ry), **SAME_FORMULA)
    np.testing.assert_allclose(_np(hlast), np.asarray(rh), **SAME_FORMULA)

    b, s, h, p = x.shape
    hstate = np.zeros((b, h, p, bb.shape[-1]), np.float64)
    ys = np.zeros((b, s, h, p), np.float64)
    for t in range(s):
        da = np.exp(dt[:, t] * a[None, :])
        xdt = x[:, t] * dt[:, t][..., None]
        hstate = hstate * da[..., None, None] + np.einsum(
            "bhp,bn->bhpn", xdt, bb[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", hstate, cc[:, t])
    np.testing.assert_allclose(_np(y), ys, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(hlast), hstate, rtol=1e-3, atol=1e-4)


def test_ssd_segsum_equals_reference():
    log_a = -np.abs(np.random.default_rng(1).normal(size=(2, 3, 8))).astype(
        np.float32)
    got = _np(port_ssm._segsum(torch.from_numpy(log_a)))
    want = np.asarray(ref_ssm._segsum(jnp.asarray(log_a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               **SAME_FORMULA)


def test_ssm_layer_prefill_and_decode_equal_reference():
    """The whole Mamba-2 block (projection, causal conv with state, SSD,
    gate, norm) through prefill and then decode steps that carry the
    conv and recurrent state."""
    rcfg, pcfg = _cfgs("mamba2-1.3b")
    rp = jax.jit(ref_ssm.init_ssm, static_argnums=1)(KEY, rcfg)
    prefill = jax.jit(functools.partial(ref_ssm.ssm_prefill, cfg=rcfg))
    decode = jax.jit(functools.partial(ref_ssm.ssm_decode, cfg=rcfg))
    pp = _load(port_ssm.SSM(pcfg, "cpu"), rp)
    u = (np.random.default_rng(2).normal(size=(2, 16, rcfg.d_model)) * 0.3
         ).astype(np.float32)
    rc = ref_ssm.init_ssm_cache(rcfg, 2, jnp.float32)
    pc = port_ssm.init_ssm_cache(pcfg, 2, torch.float32, "cpu")
    ro, rc = prefill(rp, jnp.asarray(u[:, :12]), cache=rc)
    with torch.no_grad():
        po, pc = port_ssm.ssm_prefill(pp, torch.from_numpy(u[:, :12]), pcfg,
                                      pc)
        np.testing.assert_allclose(_np(po), np.asarray(ro), **SAME_FORMULA)
        for t in range(12, 16):
            ro, rc = decode(rp, jnp.asarray(u[:, t:t + 1]), cache=rc)
            po, pc = port_ssm.ssm_decode(pp, torch.from_numpy(u[:, t:t + 1]),
                                         pcfg, pc)
            np.testing.assert_allclose(_np(po), np.asarray(ro), **SAME_FORMULA)
        for key in ("conv", "state"):
            np.testing.assert_allclose(_np(pc[key]), np.asarray(rc[key]),
                                       **SAME_FORMULA)


# -- RG-LRU -----------------------------------------------------------------


def test_rglru_scan_matches_sequential_and_reference():
    rcfg, pcfg = _cfgs("recurrentgemma-9b")
    rp = jax.jit(ref_rglru.init_rglru, static_argnums=1)(KEY, rcfg)
    pp = _load(port_rglru.RGLRU(pcfg, "cpu"), rp)
    x = (np.asarray(jax.random.normal(KEY, (2, 10, rcfg.d_model))) * 0.1
         ).astype(np.float32)
    with torch.no_grad():
        y_scan = _np(port_rglru.rglru_apply(pp, torch.from_numpy(x), pcfg))
        cache = port_rglru.init_rglru_cache(pcfg, 2, torch.float32, "cpu")
        ys = []
        for t in range(10):
            yt, cache = port_rglru.rglru_decode(
                pp, torch.from_numpy(x[:, t:t + 1]), pcfg, cache)
            ys.append(_np(yt))
    np.testing.assert_allclose(y_scan, np.concatenate(ys, 1), rtol=1e-4,
                               atol=1e-5)
    want = np.asarray(jax.jit(functools.partial(
        ref_rglru.rglru_apply, cfg=rcfg))(rp, jnp.asarray(x)))
    np.testing.assert_allclose(y_scan, want, **SAME_FORMULA)


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
def test_linear_scan_matches_sequential(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.2, 1.0, size=(2, s, 5)).astype(np.float32)
    b = rng.normal(size=(2, s, 5)).astype(np.float32)
    h = np.zeros((2, 5), np.float64)
    want = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h.copy())
    got = _np(port_rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=1e-5, atol=1e-6)


# -- MLA --------------------------------------------------------------------


def test_mla_materialized_equals_absorbed_and_reference():
    """The materialized full-sequence path is the absorbed one in another
    contraction order (``test_models.py:230``), in the port as in the
    reference, on the reference's weights."""
    rcfg, pcfg = _cfgs("deepseek-v2-lite-16b")
    params = _ref_init(rcfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                     "cpu")
    tokens = np.asarray(jax.random.randint(KEY, (2, 16), 0, rcfg.vocab_size))
    pcfg_m = dataclasses.replace(pcfg, mla_materialize=True)
    with torch.no_grad():
        xa, _ = port_models.forward(model, pcfg, tokens)
        xm, _ = port_models.forward(model, pcfg_m, tokens)
        np.testing.assert_allclose(_np(xa), _np(xm), rtol=1e-4, atol=1e-5)
        ca = port_models.make_decode_caches(pcfg, 2, 20, device="cpu")
        cm = port_models.make_decode_caches(pcfg_m, 2, 20, device="cpu")
        la, ca = port_models.prefill(model, pcfg, tokens, ca)
        lm, cm = port_models.prefill(model, pcfg_m, tokens, cm)
    np.testing.assert_allclose(_np(la), _np(lm), rtol=1e-4, atol=1e-4)
    for key in ca[0]:  # the cache stays latent either way
        assert torch.equal(ca[0][key], cm[0][key])
        for c_a, c_m in zip(ca[1:], cm[1:]):
            np.testing.assert_allclose(_np(c_a[key]), _np(c_m[key]),
                                       **SAME_FORMULA)
    rx, _ = jax.jit(functools.partial(
        ref_models.forward, cfg=dataclasses.replace(rcfg,
                                                    mla_materialize=True)))(
        params, tokens=jnp.asarray(tokens))
    np.testing.assert_allclose(_np(xm), np.asarray(rx), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pos", [5, 7, 9])
def test_mla_decode_write_clamps_like_the_reference(pos):
    """A decode at or past the latent cache's last row writes that row,
    as ``jax.lax.dynamic_update_slice`` clamps its start; rows <= pos are
    visible (all of them past the end)."""
    rcfg, pcfg = _cfgs("deepseek-v2-lite-16b")
    rp = jax.jit(ref_mla.init_mla, static_argnums=1)(KEY, rcfg)
    pp = _load(port_mla.MLA(pcfg, "cpu"), rp)
    rng = np.random.default_rng(pos)
    x = (rng.normal(size=(2, 6, rcfg.d_model)) * 0.3).astype(np.float32)
    seq = 6
    rc = ref_mla.init_mla_cache(rcfg, 2, seq, jnp.float32)
    pc = port_mla.init_mla_cache(pcfg, 2, seq, torch.float32, "cpu")
    cos, sin = ref_common.rope_angles(jnp.arange(5), rcfg.qk_rope_dim,
                                      rcfg.rope_theta)
    pcos, psin = torch.from_numpy(np.array(cos)), torch.from_numpy(
        np.array(sin))
    _, rc = jax.jit(functools.partial(ref_mla.mla_prefill, cfg=rcfg))(
        rp, jnp.asarray(x[:, :5]), cos, sin, cache=rc)
    with torch.no_grad():
        _, pc = port_mla.mla_prefill(pp, torch.from_numpy(x[:, :5]), pcos,
                                     psin, pcfg, pc)
    cos1, sin1 = ref_common.rope_angles(jnp.asarray([pos]), rcfg.qk_rope_dim,
                                        rcfg.rope_theta)
    ro, rc = jax.jit(functools.partial(ref_mla.mla_decode, cfg=rcfg))(
        rp, jnp.asarray(x[:, 5:6]), cos1, sin1, cache=rc,
        pos=jnp.asarray(pos, jnp.int32))
    with torch.no_grad():
        po, pc = port_mla.mla_decode(
            pp, torch.from_numpy(x[:, 5:6]), torch.from_numpy(np.array(cos1)),
            torch.from_numpy(np.array(sin1)), pcfg, pc, pos)
    np.testing.assert_allclose(_np(po), np.asarray(ro), **SAME_FORMULA)
    for key in ("c", "kr"):
        np.testing.assert_allclose(_np(pc[key]), np.asarray(rc[key]),
                                   **SAME_FORMULA)


# -- MoE --------------------------------------------------------------------


def _ref_routing(p, xt, cfg):
    """The integers of ``repro.models.moe.moe_apply`` (moe.py:55-81), the
    same jax calls in the same order."""
    e, k = cfg.n_experts, cfg.experts_per_token
    t = xt.shape[0]
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt.astype(jnp.float32),
                                      p["router"]), axis=-1)
    _, expert = jax.lax.top_k(probs, k)
    cap = int(max(1, cfg.moe_capacity_factor * t * k / e))
    flat_e = expert.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=e)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(t * k) - starts[sorted_e]
    keep = rank < cap
    slot = sorted_e * cap + jnp.clip(rank, 0, cap - 1)
    return {"expert": expert, "order": order, "keep": keep, "slot": slot,
            "cap": cap}


@pytest.mark.parametrize("case", ["drops", "ties", "dropless"])
def test_moe_routing_integers_equal_reference(case):
    """Expert ids, the sort order, ``keep`` and ``slot`` equal exactly;
    the combined output to tolerance.  ``drops``: capacity 1.25 over 24
    tokens of skewed routing drops assignments; ``ties``: a router with
    repeated columns ties probabilities, which top-k breaks lower id
    first; ``dropless``: the reference's own oracle setting."""
    cf = {"drops": 1.25, "ties": 1.25, "dropless": 100.0}[case]
    rcfg, pcfg = _cfgs("deepseek-v2-lite-16b", moe_capacity_factor=cf)
    rp = ref_moe.init_moe(KEY, rcfg)
    rng = np.random.default_rng(3)
    if case == "ties":
        router = np.array(rp["router"])
        router[:, 1::2] = router[:, 0::2]  # experts 2i and 2i+1 tie
        rp = dict(rp, router=jnp.asarray(router))
    x = (rng.normal(size=(2, 12, rcfg.d_model)) * 0.3).astype(np.float32)
    x[1] = x[0] + 0.01 * x[1]  # skewed: both rows route alike
    pp = _load(port_moe.MoE(pcfg, "cpu"), rp)
    xt = x.reshape(-1, rcfg.d_model)
    want = _ref_routing(rp, jnp.asarray(xt), rcfg)
    with torch.no_grad():
        got = port_moe.moe_route(pp, torch.from_numpy(xt), pcfg)
    assert got["cap"] == want["cap"]
    for key in ("expert", "order", "keep", "slot"):
        assert np.array_equal(_np(got[key]), np.asarray(want[key])), key
    n_dropped = int((~np.asarray(want["keep"])).sum())
    if case == "drops":
        assert n_dropped > 0
    elif case == "dropless":
        assert n_dropped == 0
    else:
        ex = np.asarray(want["expert"])
        assert (ex[:, 0] % 2 == 0).all()  # the lower id of each tied pair
    out, aux = ref_moe.moe_apply(rp, jnp.asarray(x), rcfg)
    with torch.no_grad():
        pout, paux = port_moe.moe_apply(pp, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(_np(pout), np.asarray(out), **SAME_FORMULA)
    np.testing.assert_allclose(float(paux), float(aux), rtol=1e-5)


def test_moe_capacity_follows_the_batch_size():
    """``cap = int(max(1, 1.25 T k / E))`` grows with T, so a padded batch
    drops what a smaller one would not: the port keeps that."""
    _, pcfg = _cfgs("llama4-scout-17b-a16e")
    for t, want in ((1, 1), (8, 1), (13, 2), (64, 10)):
        xt = torch.zeros((t, pcfg.d_model))
        pp = port_moe.MoE(pcfg, "cpu")
        pp.init(torch.Generator().manual_seed(0))
        got = port_moe.moe_route(pp, xt, pcfg)["cap"]
        e, k = pcfg.n_experts, pcfg.experts_per_token
        assert got == want == int(max(1, 1.25 * t * k / e)), t


# -- masks, the sliding window and the ring ---------------------------------


@pytest.mark.parametrize("s_q,s_k,window,off", [(5, 5, 0, 0), (4, 9, 3, 5),
                                                (12, 12, 4, 0)])
def test_masks_equal_reference(s_q, s_k, window, off):
    got = port_common.causal_mask(s_q, s_k, off)
    assert np.array_equal(_np(got), np.asarray(
        ref_common.causal_mask(s_q, s_k, off)))
    if window:
        got = port_common.local_mask(s_q, s_k, window, off)
        assert np.array_equal(_np(got), np.asarray(
            ref_common.local_mask(s_q, s_k, window, off)))


def test_local_window_attention_masks_past():
    """Sliding-window arch: distant past tokens don't affect the output."""
    _, pcfg = _cfgs("gemma3-27b", pattern=("local",), n_layers=2,
                    local_window=4)
    model = port_models.init_params(pcfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    t1 = np.random.default_rng(0).integers(0, pcfg.vocab_size, (1, 12))
    t2 = t1.copy()
    t2[0, 0] = (t1[0, 0] + 1) % pcfg.vocab_size  # differs beyond the window
    with torch.no_grad():
        x1, _ = port_models.forward(model, pcfg, t1)
        x2, _ = port_models.forward(model, pcfg, t2)
    np.testing.assert_allclose(_np(x1[0, -1]), _np(x2[0, -1]), rtol=1e-4,
                               atol=1e-5)
    assert not torch.allclose(x1[0, 0], x2[0, 0])


@pytest.mark.parametrize("prompt", [3, 6])
def test_ring_cache_wraps_like_the_reference(prompt):
    """Local layers keep min(seq, window) = 4 slots; decoding 9 steps past
    a prompt of 3 or 6 (longer than the window: the prefill itself wraps)
    overwrites slots in turn.  Every decode's logits equal the
    reference's on its weights and the port's own full forward."""
    window = 4
    rcfg, pcfg = _cfgs("gemma3-27b", pattern=("local", "local", "attn"),
                       n_layers=3, local_window=window)
    params = _ref_init(rcfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                     "cpu")
    seq = np.random.default_rng(prompt).integers(0, rcfg.vocab_size,
                                                 (2, prompt + 9))
    size = prompt + 10
    rc = ref_models.make_decode_caches(rcfg, 2, size)
    pc = port_models.make_decode_caches(pcfg, 2, size, device="cpu")
    assert pc[0]["k"].shape[1] == window and pc[2]["k"].shape[1] == size
    rl, rc = jax.jit(functools.partial(ref_models.prefill, cfg=rcfg))(
        params, tokens=jnp.asarray(seq[:, :prompt]), caches=rc)
    decode = jax.jit(functools.partial(ref_models.decode_step, cfg=rcfg))
    with torch.no_grad():
        pl, pc = port_models.prefill(model, pcfg, seq[:, :prompt], pc)
        np.testing.assert_allclose(_np(pl), np.asarray(rl), rtol=1e-4,
                                   atol=1e-4)
        w = model.unembed
        for pos in range(prompt, prompt + 9):
            tok = seq[:, pos:pos + 1]
            rl, rc = decode(params, token=jnp.asarray(tok), pos=pos,
                            caches=rc)
            pl, pc = port_models.decode_step(model, pcfg, tok, pos, pc)
            np.testing.assert_allclose(_np(pl), np.asarray(rl), rtol=1e-4,
                                       atol=1e-4)
            x, _ = port_models.forward(model, pcfg, seq[:, :pos + 1])
            np.testing.assert_allclose(_np(pl), _np(x[:, -1] @ w), rtol=1e-4,
                                       atol=1e-3)
        assert np.array_equal(_np(pc[0]["pos"]), np.asarray(rc["body"][0][
            "pos"][0]))
        assert sorted(_np(pc[0]["pos"])) == list(range(prompt + 5,
                                                       prompt + 9))


# -- bf16 -------------------------------------------------------------------


@pytest.mark.parametrize("upcast", [True, False])
def test_rms_norm_bf16_equals_reference(upcast):
    """Both forms of rms_norm on bf16 inputs: the upcast one and the
    bf16_norm one (stream kept in bf16, variance in f32).  The variance's
    f32 sum may round otherwise, so outputs agree to one bf16 step."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 7, 64)) * 2).astype(np.float32)
    g = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    got = port_common.rms_norm(xb, gb, upcast=upcast)
    want = ref_common.rms_norm(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(g, jnp.bfloat16), upcast=upcast)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2**-7,
                               atol=0)


def test_bf16_norm_variant_close_to_f32():
    """bf16_norm keeps the stream bf16; outputs stay within bf16 tolerance
    (``test_models.py:250``), and the port's bf16 forward is within the
    same of the reference's."""
    rcfg, pcfg = _cfgs("qwen3-0.6b", param_dtype="bfloat16",
                       compute_dtype="bfloat16")
    params = _ref_init(rcfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                     "cpu")
    assert model.embed.dtype == torch.bfloat16
    tokens = np.asarray(jax.random.randint(KEY, (2, 16), 0, rcfg.vocab_size))
    with torch.no_grad():
        xa, _ = port_models.forward(model, pcfg, tokens)
        xb, _ = port_models.forward(
            model, dataclasses.replace(pcfg, bf16_norm=True), tokens)
    assert xa.dtype == xb.dtype == torch.bfloat16
    np.testing.assert_allclose(xa.float().numpy(), xb.float().numpy(),
                               rtol=0.1, atol=0.15)
    rb, _ = jax.jit(functools.partial(
        ref_models.forward, cfg=dataclasses.replace(rcfg, bf16_norm=True)))(
        params, tokens=jnp.asarray(tokens))
    np.testing.assert_allclose(xb.float().numpy(), np.asarray(rb, np.float32),
                               rtol=0.1, atol=0.15)


def test_embed_scale_rounds_to_the_compute_dtype():
    """``_embed`` scales by d_model**0.5 cast to the compute dtype first
    (``model.py:55``): at d_model 24 in bf16 that is 4.90625, not
    4.899; the port's bf16 embeddings equal the reference's bitwise."""
    from repro.models.model import _embed as ref_embed
    from repro_torch.models.model import LM, _embed

    rcfg, pcfg = _cfgs("smollm-135m", d_model=24, n_heads=4, n_kv_heads=2,
                       d_head=6, param_dtype="bfloat16",
                       compute_dtype="bfloat16")
    table = np.random.default_rng(0).normal(size=(rcfg.padded_vocab, 24))
    model = LM(pcfg, "meta").to_empty(device="cpu")
    with torch.no_grad():
        model.embed.copy_(torch.from_numpy(table))
    tokens = np.array([[1, 5, 7], [0, 2, 511]])
    got = _embed(model, pcfg, tokens)
    want = ref_embed({"embed": jnp.asarray(np.asarray(model.embed.detach()
                                                      .float()),
                                           jnp.bfloat16)},
                     rcfg, jnp.asarray(tokens))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.detach().float().numpy(),
                          np.asarray(want, np.float32))
