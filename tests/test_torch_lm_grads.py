"""The port's backward against ``jax.grad``, one architecture at a time:
the reference's weights (``init_params(PRNGKey(0), smoke_config)``)
carried across with ``convert.lm_params_from_reference``, the same tokens
and labels (and prefix embeddings for the audio and vision archs, from a
numpy seed), ``loss_fn`` differentiated by autograd in the port and by
``jax.grad`` under ``jax.jit`` in the reference, and the gradients held
leaf by leaf through ``convert.lm_named_leaves`` (which unstacks the
reference's scanned body into the port's per-layer names).  Also the
port's ``remat`` against no remat, and that remat recomputes exactly the
scanned periods' layers.

Tolerances: float32 on both sides, the same formulas, other summation
orders in the products (torch's matmul vs XLA's dot) and in the
backward's accumulations, so each leaf is held to rtol 1e-4 with atol
1e-4 times that leaf's largest |gradient| (measured: 1.3e-5 of it at
worst, mamba2's SSD leaves).  remat recomputes the same forward on the
same device, so its gradients are bitwise equal to no remat's."""

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
from repro_torch.convert import lm_named_leaves, lm_params_from_reference
from repro_torch.models import transformer
from repro_torch.models.transformer import stack_plan

torch.set_num_threads(1)

ARCHS = sorted(ref_configs.ARCHS)
B, S = 2, 16
REL_ATOL, RTOL = 1e-4, 1e-4


def _batch(cfg):
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    labels[1, :4] = -1  # masked positions carry no loss
    batch = {"tokens": tokens, "labels": labels}
    if cfg.prefix_len:
        batch["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32) * 0.02)
    return batch


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's weights, loss and ``jax.grad`` at smoke size."""
    cfg = ref_configs.smoke_config(ref_configs.get_config(name))
    params = jax.jit(ref_models.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_models.loss_fn(p, cfg, b)[0]))(params, batch)
    tree = jax.tree.map(np.asarray, params)
    return tree, float(loss), lm_named_leaves(jax.tree.map(np.asarray, grads),
                                              cfg)


def _port_grads(cfg, model):
    batch = _batch(cfg)
    if "prefix_embeds" in batch:
        batch["prefix_embeds"] = torch.from_numpy(batch["prefix_embeds"])
    loss, _ = port_models.loss_fn(model, cfg, batch)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


@pytest.mark.parametrize("name", ARCHS)
def test_loss_gradients_equal_jax_grad(name):
    tree, ref_loss, want = reference(name)
    cfg = port_configs.smoke_config(port_configs.get_config(name))
    model = lm_params_from_reference(tree, cfg, "cpu")
    assert all(p.requires_grad for p in model.parameters())
    loss, got = _port_grads(cfg, model)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert set(got) == set(want)
    for leaf, g in got.items():
        w = want[leaf]
        assert g.shape == w.shape and g.dtype == torch.float32, leaf
        np.testing.assert_allclose(
            g.numpy(), w, rtol=RTOL, atol=REL_ATOL * np.abs(w).max(),
            err_msg=f"{name} {leaf}")


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gradients_equal_no_remat(name, monkeypatch):
    """``remat=True`` checkpoints each scanned period: its backward runs
    each body layer's forward again (and no prefix or suffix layer), and
    the gradients are the same, bit for bit."""
    base = port_configs.smoke_config(port_configs.get_config(name))
    model = port_models.init_params(base, torch.Generator().manual_seed(2),
                                    device="cpu")
    _, plain = _port_grads(base, model)
    calls = []
    apply_layer = transformer.apply_layer
    monkeypatch.setattr(transformer, "apply_layer",
                        lambda *a, **kw: calls.append(1) or apply_layer(*a, **kw))
    _, remat = _port_grads(dataclasses.replace(base, remat=True), model)
    pre, scanned, suffix = stack_plan(base)
    body = sum(len(ids) for ids in scanned)
    assert len(calls) == base.n_layers + body, (len(calls), body)
    for leaf, g in plain.items():
        assert torch.equal(remat[leaf], g), (name, leaf)

