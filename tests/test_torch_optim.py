"""The port's optimizer substrate (``repro_torch.optim``): twins of
``tests/test_train.py``'s optimizer and compression cases, and each
function against the reference's on the same numpy inputs.

Bars and why:
  * ``adamw_update`` without clipping, f32 and bf16 params, 20 steps:
    bitwise against the reference run op by op (its float forms as
    written).  Under ``jax.jit`` XLA contracts the multiply-adds into
    FMAs (measured: 27,630 of 100,000 ``b1*mu + (1-b1)*g`` differ from
    op-by-op), so against the jitted update the bar is rtol 1e-5 on the
    moments and parameters (a few float32 roundings a step).
  * the global norm: the reference sums its leaves in pytree order, the
    port its tensors in dict order, and both sum each tensor in another
    order: rtol 1e-6 on the norm, and the clipped update then to rtol
    1e-5 (atol 1e-7 on parameters of order 1).
  * ``cosine_schedule``: a float32 tensor in the reference's op order;
    torch's and XLA's ``cos`` differ by an ulp on some inputs and the
    jitted reference turns divisions by constants into multiplications
    (6 ulp at most, measured), so rtol 1e-6; step 0 is exactly 0.0.
  * ``compress_grads_ef``: bitwise against the reference op by op (max,
    a division, round half to even, clip, one product, one difference);
    jitted, XLA fuses the error's product and difference into an FMA,
    so the deq stays bitwise and the error is held to an ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as ref_optim
from repro.optim.compression import CompressionState
from repro.optim.compression import init_compression as ref_init_compression
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_grads_ef,
    cosine_schedule,
)
from repro_torch.optim.compression import _quantize, init_compression

SHAPES = {"a": (64, 33), "b": (7,), "c": (3, 5, 9)}


def _np(x):
    """A reference array as float32 numpy."""
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


# ------------------------------------------------------------- optimizer


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw_update(
            params, grads, state, 0.05, weight_decay=0.0
        )
    assert float(params["w"].abs().max()) < 0.05


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 10.0), "b": torch.full((9,), 10.0)}
    clipped, gnorm = clip_by_global_norm(grads, 1.0)
    total = torch.sqrt(sum(torch.sum(g**2) for g in clipped.values()))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(gnorm), np.sqrt(13 * 100), rtol=1e-5)


def test_cosine_schedule_shape():
    lrs = [float(cosine_schedule(s, peak_lr=1.0, warmup_steps=10, total_steps=100))
           for s in range(100)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 1e-6
    assert lrs[99] < 0.2 and lrs[99] >= 0.1 - 1e-6  # min_ratio floor
    assert all(b <= a + 1e-9 for a, b in zip(lrs[10:], lrs[11:]))  # monotone decay


def test_bf16_params_f32_moments():
    params = {"w": torch.ones((8,), dtype=torch.bfloat16)}
    st = adamw_init(params)
    assert st["mu"]["w"].dtype == torch.float32
    p2, st2, _ = adamw_update(params, {"w": torch.ones((8,), dtype=torch.bfloat16)},
                              st, 1e-2)
    assert p2["w"].dtype == torch.bfloat16
    assert int(st2["count"]) == 1 and st2["count"].dtype == torch.int32


def test_adamw_init_keys_an_lm_by_parameter_name():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import init_params

    cfg = smoke_config(get_config("deepseek-v2-lite-16b"))
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    st = adamw_init(model)
    names = [n for n, _ in model.named_parameters()]
    assert list(st["mu"]) == names and list(st["nu"]) == names
    for n, p in model.named_parameters():
        assert st["mu"][n].shape == p.shape
        assert st["mu"][n].dtype == st["nu"][n].dtype == torch.float32
        assert not st["mu"][n].any() and not st["nu"][n].any()
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0


# ------------------------------------------------ against the reference


def _run_both(dtype, steps, *, jit, max_grad_norm, seed=0):
    """``steps`` AdamW updates of both packages on the same params and
    grads (numpy, from ``seed``); yields each step's (reference, port)
    params, moments, count and grad norm."""
    rng = np.random.default_rng(seed)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp = {k: jnp.asarray(rng.normal(size=s).astype(np.float32), jdt)
          for k, s in SHAPES.items()}
    tp = {k: _t(_np(v), tdt) for k, v in jp.items()}
    js, ts = ref_optim.adamw_init(jp), adamw_init(tp)

    def upd(p, g, s, lr):
        return ref_optim.adamw_update(p, g, s, lr, weight_decay=0.1,
                                      max_grad_norm=max_grad_norm)

    upd = jax.jit(upd) if jit else upd
    for it in range(steps):
        g = {k: jnp.asarray((rng.normal(size=s) * (0.3 if it % 2 else 3.0))
                            .astype(np.float32), jdt)
             for k, s in SHAPES.items()}
        lr = np.float32(1e-2 * (it + 1) / steps)
        jp, js, jm = upd(jp, g, js, lr)
        tg = {k: _t(_np(v), tdt) for k, v in g.items()}
        tp, ts, tm = adamw_update(tp, tg, ts, torch.tensor(lr),
                                  max_grad_norm=max_grad_norm)
        yield (jp, js, jm), (tp, ts, tm)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_update_equals_reference_bitwise(dtype):
    for (jp, js, _), (tp, ts, _) in _run_both(dtype, 20, jit=False,
                                              max_grad_norm=1e9):
        for k in SHAPES:
            assert tp[k].dtype == (torch.float32 if dtype == "f32"
                                   else torch.bfloat16)
            assert np.array_equal(tp[k].float().numpy(), _np(jp[k])), k
            assert np.array_equal(ts["mu"][k].numpy(), _np(js["mu"][k])), k
            assert np.array_equal(ts["nu"][k].numpy(), _np(js["nu"][k])), k
        assert int(ts["count"]) == int(js["count"])


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_update_with_clipping_equals_reference(dtype, jit):
    clipped = 0
    for (jp, js, jm), (tp, ts, tm) in _run_both(dtype, 20, jit=jit,
                                                max_grad_norm=1.0, seed=1):
        gn = float(jm["grad_norm"])
        clipped += gn > 1.0
        np.testing.assert_allclose(float(tm["grad_norm"]), gn, rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(ts["mu"][k].numpy(), _np(js["mu"][k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(ts["nu"][k].numpy(), _np(js["nu"][k]),
                                       rtol=1e-5, atol=1e-9)
            # a bf16 param may round to the neighbouring bf16 value
            np.testing.assert_allclose(
                tp[k].float().numpy(), _np(jp[k]),
                rtol=1e-5 if dtype == "f32" else 2**-7, atol=1e-7)
    assert clipped == 20  # every step's norm is above max_grad_norm


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_clip_by_global_norm_equals_reference(jit):
    rng = np.random.default_rng(3)
    g = {k: rng.normal(size=s).astype(np.float32) * 4 for k, s in SHAPES.items()}
    f = jax.jit(ref_optim.clip_by_global_norm, static_argnums=1) if jit \
        else ref_optim.clip_by_global_norm
    want, wn = f({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    got, gn = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                  1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for k in SHAPES:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("kw", [
    dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000),
    dict(peak_lr=1.0, warmup_steps=7, total_steps=53),
    dict(peak_lr=3e-3, warmup_steps=5, total_steps=60, min_ratio=0.0),
])
def test_cosine_schedule_equals_reference(kw, jit):
    f = jax.jit(lambda s: ref_optim.cosine_schedule(s, **kw)) if jit else \
        (lambda s: ref_optim.cosine_schedule(s, **kw))
    steps = list(range(0, kw["total_steps"] + 20, 1 if jit else 3))
    want = np.array([np.float32(f(s)) for s in steps])
    got = np.array([cosine_schedule(s, **kw).item() for s in steps],
                   np.float32)
    assert cosine_schedule(0, **kw).dtype == torch.float32
    assert got[0] == 0.0
    # atol: at the end of a min_ratio=0 decay 1 + cos(pi * t) cancels to
    # ~0, where an ulp of cos is all that is left
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * kw["peak_lr"])
    # a tensor step stays on its device and gives the same value
    assert cosine_schedule(torch.tensor(37), **kw).item() == \
        cosine_schedule(37, **kw).item()


# ------------------------------------------------------------ compression


def test_grad_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
    state = init_compression(g)
    acc = np.zeros(64)
    for _ in range(50):
        deq, state = compress_grads_ef(g, state)
        acc += deq["w"].numpy()
    # long-run average of EF-compressed grads converges to the true grad
    np.testing.assert_allclose(acc / 50, g["w"].numpy(), atol=0.02)


def test_grad_compression_int8_range():
    x = torch.tensor([-3.0, 0.0, 7.0])
    q, scale = _quantize(x)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(
        q.float().numpy() * float(scale), x.numpy(), atol=float(scale)
    )


def test_quantize_rounds_half_to_even_like_the_reference():
    from repro.optim.compression import _quantize as ref_quantize

    # max 127 -> scale 1.0: the halves round to even in both
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5, 3.49],
                 np.float32)
    q, scale = _quantize(torch.from_numpy(x))
    wq, ws = ref_quantize(jnp.asarray(x))
    assert float(scale) == float(ws) == 1.0
    assert q.tolist() == np.asarray(wq).tolist() == [127, 0, 2, 2, 0, -2,
                                                     -126, 3]


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_compress_grads_ef_equals_reference(jit):
    """Eight steps: op by op the reference's deq and error are equal bit
    for bit.  Jitted, XLA forms the error ``x - q*scale`` with one FMA
    (measured: 1816 of 2112 errors differ from op-by-op, by 1.2e-7 at
    most), so each step starts from the reference's error, the deq must
    be equal bit for bit and the error within 2^-23 of |x|'s max."""
    rng = np.random.default_rng(5)

    def f(g, error):  # the state's error tree in and out, for jax.jit
        deq, st = ref_optim.compress_grads_ef(g, CompressionState(error))
        return deq, st.error

    f = jax.jit(f) if jit else f
    g0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    ref_err = ref_init_compression(
        {k: jnp.asarray(v) for k, v in g0.items()}).error
    state = init_compression({k: torch.from_numpy(v) for k, v in g0.items()})
    for it in range(8):
        g = {k: rng.normal(size=s).astype(np.float32) * (it + 1)
             for k, s in SHAPES.items()}
        if jit:
            state.error = {k: torch.from_numpy(np.array(v))
                           for k, v in ref_err.items()}
        want, ref_err = f({k: jnp.asarray(v) for k, v in g.items()}, ref_err)
        got, state = compress_grads_ef(
            {k: torch.from_numpy(v) for k, v in g.items()}, state)
        for k in SHAPES:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (it, k)
            err, werr = state.error[k].numpy(), np.asarray(ref_err[k])
            if jit:
                np.testing.assert_allclose(
                    err, werr, rtol=0,
                    atol=2**-23 * np.abs(g[k]).max() * 2)
            else:
                assert np.array_equal(err, werr), (it, k)


def test_compression_scales_per_layer_where_the_reference_scales_per_stack():
    """On an LM's gradient dict the port takes one scale per layer
    parameter; the reference takes one per pytree leaf, and a scanned
    body leaf stacks all its periods' layers.  The port's result is the
    reference's on the unstacked tree, bit for bit, and differs from the
    reference's on the stacked one (ROADMAP §3 B10)."""
    import repro.configs as ref_configs
    import repro.models as ref_models
    from repro_torch.convert import lm_named_leaves

    cfg = ref_configs.smoke_config(ref_configs.get_config("qwen3-0.6b"))
    tree = jax.jit(ref_models.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), cfg)
    # jitted: one compile a tree; its deq is bitwise the op-by-op one's
    deq = jax.jit(lambda t: ref_optim.compress_grads_ef(
        t, ref_init_compression(t))[0])
    stacked = lm_named_leaves(jax.tree.map(np.asarray, deq(tree)), cfg)
    flat = {k: jnp.asarray(v) for k, v in
            lm_named_leaves(jax.tree.map(np.asarray, tree), cfg).items()}
    per_layer = deq(flat)
    grads = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    got, _ = compress_grads_ef(grads, init_compression(grads))
    assert set(got) == set(stacked)
    for k, g in got.items():
        assert np.array_equal(g.numpy(), np.asarray(per_layer[k])), k
    differs = [k for k, g in got.items()
               if not np.array_equal(g.numpy(), stacked[k])]
    assert differs and all(k.startswith("layers.") for k in differs)
