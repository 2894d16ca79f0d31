"""The port's training substrate (``repro_torch.train``,
``repro_torch.launch.train``): twins of ``tests/test_train.py``'s
checkpoint, trainer and NaN-guard cases, a bitwise bf16 round trip, ten
train steps against the reference's from carried-across weights and
optimizer state, and the launcher resuming from its checkpoint.

Bars and why:
  * checkpoints: every leaf bitwise (bf16 through its int16 bits).
  * a restart on the CPU replays the uninterrupted run exactly: the same
    restored state, the same batches, the same ops.
  * ten ``make_train_step`` steps against the reference's jitted ones:
    the gradients agree to ~1e-6 of their scale (test_torch_lm_grads.py)
    and AdamW normalizes each element by its own moment, so the losses
    are held to rtol 1e-5 (measured: 1.5e-7 at worst); ``bad_step`` and
    ``tokens`` exactly."""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.optim as ref_optim
import repro.train as ref_train
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (adamw_state_from_reference, lm_named_leaves,
                                 lm_params_from_reference)
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.train import (
    TrainConfig,
    Trainer,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)


# ------------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
        "opt": {"mu": {"w": torch.ones((2, 3))},
                "count": torch.tensor(7, dtype=torch.int32)},
    }
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 42, state)
    assert latest_step(d) == 42
    restored, manifest = restore_checkpoint(d, 42, state)
    assert manifest["step"] == 42 and manifest["format"] == 1
    assert manifest["n_leaves"] == 3
    flat = [state["params"]["w"], state["opt"]["mu"]["w"], state["opt"]["count"]]
    got = [restored["params"]["w"], restored["opt"]["mu"]["w"],
           restored["opt"]["count"]]
    for a, b in zip(flat, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention_and_atomicity(tmp_path):
    d = str(tmp_path / "ckpt")
    state = {"w": torch.zeros((4,))}
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(d, s, state, keep_last=2)
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]
    assert not any(x.endswith(".tmp") for x in os.listdir(d))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        restore_checkpoint(d, 1, {"w": torch.zeros((5,))})
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(d, 1, {"v": torch.zeros((4,))})


def test_checkpoint_restores_onto_an_explicit_device(tmp_path):
    """Restore onto a given device, whatever device ``like`` names (here
    the meta device, which holds shapes and dtypes only)."""
    d = str(tmp_path / "ckpt")
    state = {"w": torch.arange(8, dtype=torch.float32)}
    save_checkpoint(d, 1, state)
    like = {"w": torch.empty(8, dtype=torch.float32, device="meta")}
    restored, _ = restore_checkpoint(d, 1, like, device="cpu")
    assert restored["w"].device == torch.device("cpu")
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(8))


def test_checkpoint_bf16_roundtrip_is_bitwise(tmp_path):
    """Every bf16 bit pattern, NaN payloads and subnormals included, comes
    back as it went in."""
    bits = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16)
    state = {"b": bits.view(torch.bfloat16).reshape(256, 256),
             "f": torch.randn(3, 4, generator=torch.Generator().manual_seed(0))}
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, state)
    restored, manifest = restore_checkpoint(d, 3, state)
    assert manifest["dtypes"] == {"b": "bfloat16", "f": "float32"}
    assert restored["b"].dtype == torch.bfloat16
    assert torch.equal(restored["b"].view(torch.int16), state["b"].view(torch.int16))
    assert torch.equal(restored["f"], state["f"])


def test_checkpoint_loads_a_module_in_place(tmp_path):
    cfg = smoke_config(get_config("qwen3-0.6b"))
    a = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 5, {"params": a, "opt": adamw_init(a)})
    state, _ = restore_checkpoint(d, 5, {"params": b, "opt": adamw_init(b)})
    assert state["params"] is b
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb) and pb.requires_grad, name


# --------------------------------------------------------------- trainer


def _tiny_setup(tmp_path=None, total=60, seed=0):
    cfg = smoke_config(get_config("smollm-135m"))
    tcfg = TrainConfig(
        peak_lr=3e-3,
        warmup_steps=5,
        total_steps=total,
        checkpoint_every=20,
        checkpoint_dir=str(tmp_path / "ck") if tmp_path else None,
        log_every=1000,
    )
    model = init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    opt = adamw_init(model)
    stream = SyntheticLMStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    )
    return cfg, tcfg, model, opt, stream, make_train_step(cfg, tcfg)


def test_training_loss_decreases():
    cfg, tcfg, params, opt, stream, step_fn = _tiny_setup(total=60)
    tr = Trainer(cfg, tcfg, params, opt, stream, step_fn)
    hist = tr.run(60, log=lambda *_: None)
    first, last = np.mean(hist[:10]), np.mean(hist[-10:])
    assert last < first - 0.2, (first, last)


def test_trainer_checkpoint_restart_is_exact(tmp_path):
    cfg, tcfg, params, opt, stream, step_fn = _tiny_setup(tmp_path, total=40)
    tr = Trainer(cfg, tcfg, params, opt, stream, step_fn)
    tr.run(25, log=lambda *_: None)  # checkpoints at step 20
    expected_tail = tr.history[20:25]  # losses for steps 20..24

    # a fresh trainer (other initial weights) restores from step 20 and
    # replays 20..24 exactly
    cfg2, tcfg2, params2, opt2, stream2, step_fn2 = _tiny_setup(
        tmp_path, total=40, seed=9)
    tr2 = Trainer(cfg2, tcfg2, params2, opt2, stream2, step_fn2)
    assert tr2.maybe_restore() and tr2.step == 20
    assert int(tr2.opt_state["count"]) == 20
    tail2 = tr2.run(5, log=lambda *_: None)
    assert tail2 == expected_tail
    for pa, pb in zip(tr.params.parameters(), tr2.params.parameters()):
        assert torch.equal(pa, pb)


def test_nan_guard_skips_bad_step():
    cfg, tcfg, params, opt, stream, step_fn = _tiny_setup(total=10)
    tr = Trainer(cfg, tcfg, params, opt, stream, step_fn)
    tr.run(2, log=lambda *_: None)
    before = {n: p.detach().clone() for n, p in tr.params.named_parameters()}
    opt_before = {k: {n: t.clone() for n, t in tr.opt_state[k].items()}
                  for k in ("mu", "nu")}
    count = int(tr.opt_state["count"])

    # poison one batch -> non-finite loss; params and the whole optimizer
    # state must be untouched
    class Poison:
        def batch_at(self, step):
            b = stream.batch_at(step)
            return {
                "tokens": b["tokens"],
                "labels": b["labels"],
                "prefix_embeds": np.full((4, 1, cfg.d_model), np.nan, np.float32),
            }

    tr.stream = Poison()
    tr.run(1, log=lambda *_: None)
    for n, p in tr.params.named_parameters():
        assert torch.equal(p, before[n]) and p.grad is None, n
    for k in ("mu", "nu"):
        for n, t in tr.opt_state[k].items():
            assert torch.equal(t, opt_before[k][n]), (k, n)
    assert int(tr.opt_state["count"]) == count == 2
    assert tr.bad_streak == 1 and not np.isfinite(tr.history[-1])


def test_train_step_metrics():
    cfg, tcfg, model, opt, stream, step_fn = _tiny_setup(total=10)
    batch = {k: torch.from_numpy(v) for k, v in stream.batch_at(0).items()}
    model, opt, m = step_fn(model, opt, 3, batch)
    assert set(m) == {"loss", "nll", "aux", "tokens", "grad_norm", "lr",
                      "bad_step"}
    assert isinstance(m["loss"], float) and m["bad_step"] == 0
    assert float(m["tokens"]) == 4 * 32
    assert float(m["lr"]) == pytest.approx(3e-3 * 3 / 5)
    assert all(p.grad is None for p in model.parameters())


# -------------------------------------------------- against the reference


def test_ten_train_steps_equal_reference():
    """SmolLM smoke: the reference trains 3 steps (so the moments are not
    zero), its weights and optimizer state are carried across, then both
    packages run ``make_train_step`` on the same 10 batches."""
    name, warm, steps = "smollm-135m", 3, 10
    rcfg = ref_configs.smoke_config(ref_configs.get_config(name))
    tcfg = TrainConfig(peak_lr=3e-3, warmup_steps=5, total_steps=20)
    rtcfg = ref_train.TrainConfig(peak_lr=3e-3, warmup_steps=5,
                                  total_steps=20)
    stream = SyntheticLMStream(
        DataConfig(vocab_size=rcfg.vocab_size, seq_len=32, global_batch=4))
    params = jax.jit(ref_models.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    opt = ref_optim.adamw_init(params)
    ref_step = jax.jit(ref_train.make_train_step(rcfg, rtcfg))

    def batch(s):
        return {k: jnp.asarray(v) for k, v in stream.batch_at(s).items()}

    for s in range(warm):
        params, opt, _ = ref_step(params, opt, jnp.asarray(s), batch(s))
    cfg = smoke_config(get_config(name))
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     "cpu")
    state = adamw_state_from_reference(jax.tree.map(np.asarray, opt), cfg,
                                       "cpu")
    mu = lm_named_leaves(jax.tree.map(np.asarray, opt["mu"]), cfg)
    assert int(state["count"]) == warm and state["count"].dtype == torch.int32
    for n, t in state["mu"].items():
        assert np.array_equal(t.numpy(), mu[n]) and np.abs(mu[n]).max() > 0
    step_fn = make_train_step(cfg, tcfg)
    want, got = [], []
    for s in range(warm, warm + steps):
        params, opt, rm = ref_step(params, opt, jnp.asarray(s), batch(s))
        b = {k: torch.from_numpy(v) for k, v in stream.batch_at(s).items()}
        model, state, m = step_fn(model, state, s, b)
        want.append((float(rm["loss"]), int(rm["bad_step"]),
                     float(rm["tokens"])))
        got.append((m["loss"], m["bad_step"], float(m["tokens"])))
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-5)
    assert [g[1:] for g in got] == [w[1:] for w in want]
    assert int(state["count"]) == int(opt["count"]) == warm + steps


# ------------------------------------------------------------ the launcher


def _launch(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = launch_train.main(argv)
    return hist, out.getvalue()


def test_launcher_trains_then_resumes_from_its_checkpoint(tmp_path):
    ck = str(tmp_path / "run")
    argv = ["--preset", "smoke", "--steps", "3", "--device", "cpu",
            "--ckpt", ck]
    hist, text = _launch(argv)
    assert len(hist) == 3 and np.isfinite(hist).all()
    assert "arch=smollm-135m preset=smoke" in text and "resumed" not in text
    assert latest_step(ck) == 3
    hist2, text2 = _launch(argv)
    assert "resumed from step 3" in text2 and hist2 == []
    assert latest_step(ck) == 3


@pytest.mark.parametrize("mesh", ["prod", "prod-multi"])
def test_launcher_meshes_are_not_ported_yet(mesh):
    """The production meshes are ported now: on a host with fewer cards
    than the mesh has positions, the launcher raises the mesh's
    ``ValueError`` naming the count it needs."""
    if torch.cuda.device_count() >= 256:
        pytest.skip("enough cards for the production mesh")
    need = 512 if mesh == "prod-multi" else 256
    with pytest.raises(ValueError, match=f"needs {need} devices"):
        launch_train.main(["--mesh", mesh, "--device", "cpu"])


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--preset", "smoke", "--steps", "1"])
