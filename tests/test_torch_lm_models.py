"""The port's LM stack against the JAX package's, one architecture at a
time: the reference's weights (``init_params(PRNGKey(0), smoke_config)``)
carried across with ``convert.lm_params_from_reference``, the same
tokens and prefix embeddings (numpy, from a seed), and ``forward``,
``loss_fn``, ``prefill`` and four greedy ``decode_step`` calls held
against the reference's.  Also the port's decode against its own
forward (as ``tests/test_models.py`` holds the reference's), the layer
order of the stacks and ``param_count`` of the ten full configs.

Tolerances: float32 on both sides, with other summation orders in the
products (torch's matmul vs XLA's dot), so hidden states are held to
rtol 1e-4 / atol 1e-5 and logits to rtol 1e-4 / atol 1e-4 (the
reference's own tolerances, ``tests/test_models.py:86``); greedy tokens
and every integer are equal exactly."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro_torch.configs as port_configs
import repro_torch.models as port_models
from repro_torch.convert import lm_params_from_reference
from repro_torch.models.model import _unembed_weight
from repro_torch.models.transformer import stack_plan

torch.set_num_threads(1)

ARCHS = sorted(ref_configs.ARCHS)
B, S = 2, 16
N_DECODE = 4
HIDDEN_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(cfg):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    labels[0, -3:] = -1  # masked positions carry no loss
    pe = None
    if cfg.prefix_len:
        pe = (rng.standard_normal((B, cfg.prefix_len, cfg.d_model))
              .astype(np.float32) * 0.02)
    return tokens, labels, pe


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's outputs for ``name`` at smoke size, computed once
    (each function under ``jax.jit``, the fast way to run it on the CPU):
    hidden states, aux, the loss and its metrics, prefill logits, then
    N_DECODE greedy decode steps (their tokens and logits)."""
    cfg = ref_configs.smoke_config(ref_configs.get_config(name))
    params = jax.jit(ref_models.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    tokens, labels, pe = _inputs(cfg)
    p_len = cfg.prefix_len

    @jax.jit
    def full(params, tokens, labels, pe):
        x, aux = ref_models.forward(params, cfg, tokens, pe)
        batch = {"tokens": tokens, "labels": labels}
        if pe is not None:
            batch["prefix_embeds"] = pe
        loss, metrics = ref_models.loss_fn(params, cfg, batch)
        caches = ref_models.make_decode_caches(cfg, B,
                                               p_len + S + N_DECODE + 1)
        lg, caches = ref_models.prefill(params, cfg, tokens, caches,
                                        prefix_embeds=pe)
        return x, aux, loss, metrics, lg, caches

    decode = jax.jit(functools.partial(ref_models.decode_step, cfg=cfg))
    x, aux, loss, metrics, lg, caches = full(
        params, jnp.asarray(tokens), jnp.asarray(labels),
        None if pe is None else jnp.asarray(pe))
    steps = [(None, np.asarray(lg))]
    for i in range(N_DECODE):
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        lg, caches = decode(params, token=tok, pos=p_len + S + i,
                            caches=caches)
        steps.append((np.asarray(tok), np.asarray(lg)))
    return {
        "tree": jax.tree.map(np.asarray, params),
        "x": np.asarray(x), "aux": float(aux), "loss": float(loss),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "steps": steps,
    }


@functools.lru_cache(maxsize=None)
def port(name):
    cfg = port_configs.smoke_config(port_configs.get_config(name))
    return cfg, lm_params_from_reference(reference(name)["tree"], cfg, "cpu")


def test_configs_equal_reference():
    assert sorted(port_configs.ARCHS) == ARCHS
    for name in ARCHS:
        for get in (lambda m: m.get_config(name),
                    lambda m: m.smoke_config(m.get_config(name))):
            assert (dataclasses.asdict(get(port_configs))
                    == dataclasses.asdict(get(ref_configs))), name
    assert (dataclasses.asdict(port_configs.TRUEKNN_CONFIG)
            == dataclasses.asdict(ref_configs.TRUEKNN_CONFIG))
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("gpt-2")


@pytest.mark.parametrize("name", ARCHS)
def test_forward_equals_reference(name):
    cfg, model = port(name)
    ref = reference(name)
    tokens, _, pe = _inputs(cfg)
    with torch.no_grad():
        x, aux = port_models.forward(model, cfg, tokens,
                                     None if pe is None else
                                     torch.from_numpy(pe))
    assert x.shape == (B, S + cfg.prefix_len, cfg.d_model)
    np.testing.assert_allclose(x.numpy(), ref["x"], **HIDDEN_TOL)
    np.testing.assert_allclose(float(aux), ref["aux"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_equals_reference(name):
    cfg, model = port(name)
    ref = reference(name)
    tokens, labels, pe = _inputs(cfg)
    batch = {"tokens": tokens, "labels": labels}
    if pe is not None:
        batch["prefix_embeds"] = torch.from_numpy(pe)
    with torch.no_grad():
        loss, metrics = port_models.loss_fn(model, cfg, batch)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["nll"]), ref["metrics"]["nll"],
                               rtol=1e-5)
    assert float(metrics["tokens"]) == ref["metrics"]["tokens"] == B * S - 3


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_greedy_decode_equal_reference(name):
    cfg, model = port(name)
    steps = reference(name)["steps"]
    tokens, _, pe = _inputs(cfg)
    p_len = cfg.prefix_len
    caches = port_models.make_decode_caches(cfg, B, p_len + S + N_DECODE + 1,
                                            device="cpu")
    with torch.no_grad():
        lg, caches = port_models.prefill(
            model, cfg, tokens, caches,
            prefix_embeds=None if pe is None else torch.from_numpy(pe))
        np.testing.assert_allclose(lg.numpy(), steps[0][1], **LOGIT_TOL)
        for i, (want_tok, want_lg) in enumerate(steps[1:]):
            tok = torch.argmax(lg, -1)[:, None]
            assert np.array_equal(tok.numpy(), want_tok), (name, i)
            lg, caches = port_models.decode_step(model, cfg, tok,
                                                 p_len + S + i, caches)
            assert lg.dtype == torch.float32
            assert lg.shape == (B, cfg.padded_vocab)
            np.testing.assert_allclose(lg.numpy(), want_lg, **LOGIT_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """Ring-cache prefill + one decode step == full forward (the port's
    own weights; dropless MoE capacity, as ``test_models.py:62``)."""
    cfg = dataclasses.replace(
        port_configs.smoke_config(port_configs.get_config(name)),
        moe_capacity_factor=8.0)
    model = port_models.init_params(
        cfg, torch.Generator().manual_seed(1), device="cpu")
    tokens, _, pe = _inputs(cfg)
    pe = None if pe is None else torch.from_numpy(pe)
    p_len = cfg.prefix_len
    w = _unembed_weight(model)
    with torch.no_grad():
        caches = port_models.make_decode_caches(cfg, B, p_len + S + 4,
                                                device="cpu")
        lg_pre, caches = port_models.prefill(model, cfg, tokens, caches,
                                             prefix_embeds=pe)
        x, _ = port_models.forward(model, cfg, tokens, pe)
        np.testing.assert_allclose(lg_pre.numpy(), (x[:, -1] @ w).numpy(),
                                   rtol=1e-4, atol=1e-4)
        tok = torch.full((B, 1), 3)
        lg_dec, _ = port_models.decode_step(model, cfg, tok, p_len + S,
                                            caches)
        x2, _ = port_models.forward(
            model, cfg, np.concatenate([tokens, np.full((B, 1), 3)], 1), pe)
        np.testing.assert_allclose(lg_dec.numpy(), (x2[:, -1] @ w).numpy(),
                                   rtol=1e-4, atol=1e-3)


def test_stacks_run_layers_in_the_references_order():
    """The reference visits prefix, then each scanned period's layers in
    pattern order, then the suffix; the port's loops visit layer 0..n-1.
    The two orders are the same for every architecture."""
    for name in ARCHS:
        for cfg in (port_configs.get_config(name),
                    port_configs.smoke_config(port_configs.get_config(name))):
            pre, scanned, suffix = stack_plan(cfg)
            n_periods = len(scanned[0]) if scanned and scanned[0] else 0
            order = pre + [scanned[j][i] for i in range(n_periods)
                           for j in range(cfg.period)] + suffix
            assert order == list(range(cfg.n_layers)), name


def test_param_count_equals_reference_for_full_configs():
    for name in ARCHS:
        want = ref_configs.get_config(name).param_count()
        assert port_configs.get_config(name).param_count() == want, name


def test_init_params_is_seeded_and_in_the_reference_distributions():
    cfg = port_configs.smoke_config(port_configs.get_config("qwen3-0.6b"))
    a = port_models.init_params(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    b = port_models.init_params(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    ref = reference("qwen3-0.6b")["tree"]
    # same shapes and dtypes as the reference's leaves, zero gains, and
    # normal draws at the reference's scales
    want = lm_params_from_reference(ref, cfg, "cpu")
    for (name, pa), pw in zip(a.named_parameters(), want.parameters()):
        assert pa.shape == pw.shape and pa.dtype == pw.dtype, name
        if "gamma" in name or "norm" in name:
            assert not pa.any(), name
    assert abs(float(a.embed.detach().std()) - cfg.d_model**-0.5) < 0.01
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_models.init_params(cfg)
