"""The port's parallelism (``repro_torch.parallel`` and the sharded train
step) against the JAX package's.

Sharding rules are pure functions of names, shapes and a mesh: the
reference's specs come from a ``Mesh`` of this host's one CPU device
repeated (as ``tests/test_distributed.py`` builds its 16x16 mesh), the
port's from a ``DeviceMesh`` of ``meta`` positions, and they must be equal
spec for spec for all ten architectures at full width on both production
meshes.  ``convert.shardings_from_reference`` keys the reference's specs
by the port's names, the stacked body's leading ``None`` dropped.

What needs several devices — ``compressed_psum_mean`` under
``shard_map``, ``pipeline_apply`` and the ``jax.jit`` train step with
shardings — runs in one reference subprocess with
``--xla_force_host_platform_device_count=8``; the port runs the same
inputs on an 8-position CPU ``DeviceMesh``.  Tolerances: the compressed
mean bitwise; the pipeline 1e-6 of its O(1) outputs (XLA's and torch's
float32 products and ``tanh`` round differently), and bitwise to the
port's own sequential apply; the sharded step's losses and gradient norms
rtol 1e-5, its parameters rtol 1e-5 above a floor of 1e-3 of lr (the
rows' float32 partial gradients and B11's norm order).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.configs as ref_configs
import repro.launch.shapes as ref_shapes
import repro.parallel.sharding as ref_sharding
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.convert import (adamw_state_from_reference,
                                 lm_params_from_reference,
                                 shardings_from_reference)
from repro_torch.core.distributed import DeviceMesh
from repro_torch.launch import analysis, shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import adamw_init
from repro_torch.parallel import (NamedSharding, PartitionSpec,
                                  batch_shardings, cache_shardings,
                                  compressed_psum_mean, gather_tree,
                                  param_shardings, pipeline_apply,
                                  shard_tree)
from repro_torch.parallel.sharding import _named_leaves
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.trainer import make_sharded_train_step

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
STEP_TCFG = dict(peak_lr=3e-3, warmup_steps=1, total_steps=20)
N_STEPS = 3
#: the sharded step's reference cases: a dense arch and two MoE archs
#: (shared experts and a dense prefix; every other layer routed)
STEP_ARCHS = ("qwen3-0.6b", "deepseek-v2-lite-16b", "llama4-scout-17b-a16e")
STEP_ATOL = 1e-3 * STEP_TCFG["peak_lr"]


def ref_mesh(multi_pod):
    shape, axes = MESHES[multi_pod]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)


def port_mesh(multi_pod):
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def specs(tree):
    return {k: tuple(v.spec) for k, v in _named_leaves(tree)}


def ref_specs(tree, cfg):
    return {k: tuple(v) for k, v in shardings_from_reference(tree, cfg).items()}


# ------------------------------------------------------ sharding rules


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_shardings_equal_reference(arch):
    """Params and optimizer moments, with and without zero1, on 16x16 and
    2x16x16: every leaf's spec is the reference's."""
    for multi in (False, True):
        rmesh, tmesh = ref_mesh(multi), port_mesh(multi)
        for zero1 in (False, True):
            rcfg = dataclasses.replace(ref_configs.get_config(arch),
                                       zero1=zero1)
            cfg = dataclasses.replace(get_config(arch), zero1=zero1)
            rp = ref_shapes.params_specs(rcfg)
            tp = shapes.params_specs(cfg)
            for role in ("params", "opt"):
                want = ref_specs(
                    ref_sharding.param_shardings(rp, rcfg, rmesh, role=role),
                    cfg)
                got = specs(param_shardings(tp, cfg, tmesh, role=role))
                assert got == want, (arch, multi, zero1, role)
            ropt = ref_shapes.opt_specs(rp)
            osh = ref_sharding.param_shardings(ropt, rcfg, rmesh, role="opt")
            got = param_shardings(shapes.opt_specs(tp), cfg, tmesh, role="opt")
            assert specs(got["mu"]) == ref_specs(osh["mu"], cfg)
            assert specs(got["nu"]) == ref_specs(osh["nu"], cfg)
            assert tuple(got["count"].spec) == tuple(osh["count"].spec) == ()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_shardings_equal_reference(arch):
    rcfg, cfg = ref_configs.get_config(arch), get_config(arch)
    for multi in (False, True):
        for batch, seq in ((128, 2048), (1, 4096)):
            want = ref_specs(ref_sharding.cache_shardings(
                ref_shapes.cache_specs(rcfg, batch, seq), rcfg,
                ref_mesh(multi)), cfg)
            got = {f"layers.{k}": v for k, v in specs(cache_shardings(
                shapes.cache_specs(cfg, batch, seq), cfg,
                port_mesh(multi))).items()}
            assert got == want, (arch, multi, batch)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b",
                                  "internvl2-26b"])
def test_batch_shardings_equal_reference(arch):
    """Train and decode inputs, the (1, 1) token of
    ``test_distributed.py``'s indivisible case, the attention-free arch
    (batch over data and model) and a prefix arch's embeddings."""
    rcfg, cfg = ref_configs.get_config(arch), get_config(arch)
    for multi in (False, True):
        for cell in ("train_4k", "decode_32k", "long_500k"):
            rspec = ref_shapes.input_specs(rcfg, ref_shapes.CELLS[cell])
            tspec = shapes.input_specs(cfg, shapes.CELLS[cell])
            for d in (rspec, tspec):
                d.pop("caches", None)
                d.pop("pos", None)
            want = {k: tuple(v.spec) for k, v in ref_sharding.batch_shardings(
                rspec, rcfg, ref_mesh(multi)).items()}
            assert specs(batch_shardings(tspec, cfg, port_mesh(multi))) == want
    tok = {"token": torch.empty((1, 1), dtype=torch.int32, device="meta")}
    assert specs(batch_shardings(tok, cfg, port_mesh(False))) == {
        "token": (None, None)}


def test_shardings_divide_their_dims():
    """Every entry of every rule's spec divides its dim (the reference's
    ``test_sharding_divisibility_never_violated``), and ``local_shape``
    refuses a spec that does not."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for multi in (False, True):
            for key, sh in _named_leaves(param_shardings(
                    shapes.params_specs(cfg), cfg, port_mesh(multi))):
                local = sh.local_shape(sh.shape)
                assert len(local) == len(sh.shape), (arch, key)
    mesh = port_mesh(False)
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(mesh, PartitionSpec("model", None)).local_shape((24, 8))
    with pytest.raises(ValueError, match="not on mesh"):
        NamedSharding(mesh, PartitionSpec("pod"))


def test_shard_and_gather_are_inverse():
    mesh = DeviceMesh([["cpu"] * 4] * 2, ("data", "model"))
    x = torch.arange(8 * 16 * 3, dtype=torch.float32).reshape(8, 16, 3)
    for spec in (PartitionSpec(), PartitionSpec("data", "model"),
                 PartitionSpec(("data", "model"), None),
                 PartitionSpec(None, ("model", "data"))):
        sh = NamedSharding(mesh, spec)
        parts = sh.shard(x)
        assert len(parts) == 8
        assert all(p.shape == sh.local_shape(x.shape) for p in parts.values())
        assert torch.equal(sh.gather(parts), x)
        # positions holding one slice own separate copies
        ptrs = [p.data_ptr() for p in parts.values()]
        assert len(set(ptrs)) == len(ptrs)
    parts = NamedSharding(mesh, PartitionSpec(("data", "model"))).shard(x)
    assert torch.equal(parts[(1, 2)], x[6:7])  # data outer, model inner


def test_restore_checkpoint_reshards_onto_another_mesh(tmp_path):
    """Saved whole from a (2, 2) mesh, restored onto (1, 4): every slice
    bitwise, the elastic restore."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    from repro_torch.models import init_params

    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    named = {k: v.detach() for k, v in model.named_parameters()}
    opt = adamw_init(named)
    opt["mu"] = {k: torch.randn(v.shape, generator=torch.Generator()
                                .manual_seed(1)) for k, v in named.items()}
    m22 = DeviceMesh([["cpu"] * 2] * 2, ("data", "model"))
    sh22 = {"params": param_shardings(named, cfg, m22),
            "opt": param_shardings(opt, cfg, m22, role="opt")}
    placed = {k: shard_tree(v, sh22[k]) for k, v in (("params", named),
                                                     ("opt", opt))}
    save_checkpoint(tmp_path, 7, {k: gather_tree(v, sh22[k])
                                  for k, v in placed.items()})
    m14 = DeviceMesh([["cpu"] * 4], ("data", "model"))
    sh14 = {"params": param_shardings(named, cfg, m14),
            "opt": param_shardings(opt, cfg, m14, role="opt")}
    like = {"params": {k: torch.empty_like(v, device="meta")
                       for k, v in named.items()},
            "opt": {"mu": {k: torch.empty(v.shape, device="meta")
                           for k, v in named.items()},
                    "nu": {k: torch.empty(v.shape, device="meta")
                           for k, v in named.items()},
                    "count": torch.empty((), dtype=torch.int32,
                                         device="meta")}}
    state, _ = restore_checkpoint(tmp_path, 7, like, shardings=sh14)
    want = {k: shard_tree(v, sh14[k]) for k, v in (("params", named),
                                                   ("opt", opt))}
    assert set(state["params"]) == set(want["params"]) == {
        (0, i) for i in range(4)}
    for key in ("params", "opt"):
        for pos, tree in want[key].items():
            got = dict(_named_leaves(state[key][pos]))
            for name, t in _named_leaves(tree):
                assert got[name].dtype == t.dtype
                assert torch.equal(got[name], t), (key, pos, name)


def test_zero1_step_equals_the_fsdp_step_and_its_log():
    """Under ZeRO-1 the parameters are data-replicated and each position
    updates its moments' part, then gathers the rest: the parameters equal
    the plain FSDP step's bitwise (the same rows, the same gradients), and
    the log, with the extra gathers, equals the closed form."""
    from repro_torch.models import init_params

    mesh = DeviceMesh([["cpu"] * 2] * 2, ("data", "model"))
    tok = torch.randint(0, 512, (4, 16),
                        generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    out = {}
    for zero1 in (False, True):
        cfg = dataclasses.replace(smoke_config(get_config("qwen3-0.6b")),
                                  zero1=zero1)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        named = {k: v.detach().clone() for k, v in model.named_parameters()}
        opt = adamw_init(named)
        p_sh = param_shardings(named, cfg, mesh)
        o_sh = param_shardings(opt, cfg, mesh, role="opt")
        b_sh = batch_shardings(batch, cfg, mesh)
        step = make_sharded_train_step(cfg, TrainConfig(**STEP_TCFG), mesh,
                                       p_sh, o_sh, b_sh)
        params, state = shard_tree(named, p_sh), shard_tree(opt, o_sh)
        for s in range(2):
            params, state, m = step(params, state, s, batch)
        got = analysis.collective_bytes(m["collectives"])
        assert got == analysis.collective_bytes(
            analysis.step_collectives(p_sh, o_sh, b_sh, "train"))
        out[zero1] = gather_tree(params, p_sh), got
        if zero1:  # the data-replicated slices agree after the gather
            for name in named:
                assert torch.equal(params[(0, 0)][name],
                                   params[(1, 0)][name]), name
    for name, t in out[False][0].items():
        assert torch.equal(out[True][0][name], t), name
    fsdp, zero1 = out[False][1]["counts"], out[True][1]["counts"]
    assert zero1["all-gather"] > fsdp["all-gather"]
    assert zero1["reduce-scatter"] == fsdp["reduce-scatter"] > 0


def test_pipeline_schedule_and_bubbles():
    mesh = DeviceMesh(["cpu"] * 4, ("stage",))
    fn = pipeline_apply(mesh, lambda w, x: x * w, 3)
    assert fn.schedule == {"ticks": 6, "busy": 12, "bubbles": 12}
    ws = [torch.tensor(float(s + 2)) for s in range(4)]
    xs = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(fn(ws, xs), xs * 120.0)
    with pytest.raises(ValueError, match="stage params"):
        fn(ws[:3], xs)


def test_compressed_mean_is_close_to_the_exact_mean():
    """The reference's bound (``test_compressed_psum_shard_map_8dev``):
    relative error below 0.05, on a (2, 4) mesh over ``data``, every
    position of one data group holding the same mean."""
    mesh = DeviceMesh([["cpu"] * 4] * 2, ("data", "model"))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 64)).astype(np.float32)
    xs = {(d, m): torch.from_numpy(x[d, m]) for d in range(2)
          for m in range(4)}
    log = []
    got = compressed_psum_mean(xs, mesh, "data", log=log)
    for m in range(4):
        want = x[:, m].mean(0)
        assert torch.equal(got[(0, m)], got[(1, m)])
        err = np.abs(got[(0, m)].numpy() - want).max() / np.abs(want).max()
        assert err < 0.05
    # one position's result bytes: the scalar max and the int32 sum
    assert analysis.collective_bytes(log)["bytes"]["all-reduce"] == 4 + 64 * 4


# ------------------------------------------- the 8-device reference run


_REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_config, smoke_config
from repro.models import init_params
from repro.optim import adamw_init
from repro.parallel.collectives import compressed_psum_mean
from repro.parallel.pipeline import pipeline_apply
from repro.parallel.sharding import batch_shardings, param_shardings, replicated
from repro.train import TrainConfig, make_train_step

assert len(jax.devices()) == 8
out = {{}}
devs = np.array(jax.devices())
# (a) the compressed mean over an 8-position data axis
rng = np.random.default_rng(0)
x = (rng.normal(size=(8, 16, 64)) * rng.uniform(0.1, 3, (8, 1, 1))).astype(
    np.float32)
fn = jax.jit(shard_map(lambda v: compressed_psum_mean(v[0], "data")[None],
                       mesh=Mesh(devs, ("data",)), in_specs=P("data"),
                       out_specs=P("data"), check_rep=False))
out["cmean_x"], out["cmean"] = x, np.asarray(fn(x))
# (b) the pipeline on tests/test_pipeline.py's inputs
n_stages, n_micro, mb, d = 8, 6, 4, 16
rng = np.random.default_rng(0)
ws = rng.normal(size=(n_stages, d, d)).astype(np.float32) * 0.3
xs = rng.normal(size=(n_micro, mb, d)).astype(np.float32)
pipe = jax.jit(pipeline_apply(Mesh(devs, ("stage",)),
                              lambda w, v: jnp.tanh(v @ w), n_micro))
out["pipe_ws"], out["pipe_xs"] = ws, xs
out["pipe"] = np.asarray(pipe(jnp.asarray(ws), jnp.asarray(xs)))
# (c) the sharded train step, 8 x 32 tokens on (2, 4): smoke qwen3-0.6b
# and two MoE archs, whose routing couples the batch's rows
mesh = Mesh(devs.reshape(2, 4), ("data", "model"))
tcfg = TrainConfig(**{tcfg!r})
for arch in {step_archs!r}:
    cfg = smoke_config(get_config(arch))
    params = init_params(jax.random.PRNGKey(0), cfg)
    opt = adamw_init(params)
    run = out[arch] = {{}}
    run["params0"] = jax.tree.map(np.asarray, params)
    run["opt0"] = jax.tree.map(np.asarray, opt)
    rng = np.random.default_rng(1)
    batches = []
    for s in range({n_steps}):
        tok = rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
        batches.append({{"tokens": tok, "labels": np.roll(tok, -1, 1)}})
    run["batches"] = batches
    step = make_train_step(cfg, tcfg)
    p_sh = param_shardings(params, cfg, mesh)
    o_sh = param_shardings(opt, cfg, mesh, role="opt")
    b_sh = batch_shardings(batches[0], cfg, mesh)
    fn = jax.jit(step, in_shardings=(p_sh, o_sh, replicated(mesh), b_sh),
                 out_shardings=(p_sh, o_sh, None))
    losses, norms = [], []
    with mesh:
        p2 = jax.device_put(params, p_sh)
        o2 = jax.device_put(opt, o_sh)
        for s, b in enumerate(batches):
            b2 = {{k: jax.device_put(v, b_sh[k]) for k, v in b.items()}}
            p2, o2, m = fn(p2, o2, jnp.int32(s), b2)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    run["losses"], run["norms"] = losses, norms
    run["params"] = jax.tree.map(np.asarray, p2)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel") / "ref8.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    script = _REFERENCE.format(tcfg=STEP_TCFG, n_steps=N_STEPS,
                               step_archs=STEP_ARCHS)
    proc = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def test_compressed_psum_mean_equals_reference_bitwise(ref8):
    mesh = DeviceMesh(["cpu"] * 8, ("data",))
    x = ref8["cmean_x"]
    xs = {(i,): torch.from_numpy(x[i]) for i in range(8)}
    got = compressed_psum_mean(xs, mesh, "data")
    for i in range(8):
        assert np.array_equal(got[(i,)].numpy(), ref8["cmean"][i]), i


def test_pipeline_equals_reference(ref8):
    mesh = DeviceMesh(["cpu"] * 8, ("stage",))
    ws = [torch.from_numpy(w) for w in ref8["pipe_ws"]]
    xs = torch.from_numpy(ref8["pipe_xs"])

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    fn = pipeline_apply(mesh, stage_fn, xs.shape[0])
    got = fn(ws, xs)
    # XLA's float32 tanh and products round otherwise than torch's, and
    # eight stages carry it: 4.2e-7 at worst on these O(1) outputs, so the
    # 1e-6 bound is relative to the outputs' scale, not to each element
    np.testing.assert_allclose(got.numpy(), ref8["pipe"], rtol=1e-6,
                               atol=1e-6)
    seq = xs
    for w in ws:
        seq = stage_fn(w, seq)
    assert torch.equal(got, seq)
    assert fn.schedule == {"ticks": 13, "busy": 48, "bubbles": 56}


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_train_step_equals_reference(ref8, arch):
    """``make_sharded_train_step`` on a (2, 4) CPU mesh against the
    reference's ``jax.jit`` step with the same shardings, three steps from
    the reference's weights: losses and gradient norms rtol 1e-5, the
    updated parameters rtol 1e-5 with an absolute floor of a thousandth of
    one step's size (``STEP_ATOL``: AdamW divides each gradient element by
    its running RMS, so where an element's gradient is near zero the two
    partitionings' float32 roundings move its update by up to 7e-4 of lr;
    measured 2.2e-6 at worst, on qwen3's ``embed``); the collective log
    equal to ``step_collectives``.

    The MoE archs' step computes the whole batch in one group, so that
    the expert capacity and the aux loss are the global batch's (rows
    computed apart fail this test's loss bar).  Their losses and
    parameters are held against the port's one-device
    ``make_train_step`` from the same state, bitwise (one group computes
    what that step computes), because that step already departs from
    the reference's beyond the floor on a few elements of ``embed``:
    near-zero gradients that AdamW normalizes."""
    ref = ref8[arch]
    cfg = smoke_config(get_config(arch))
    model = lm_params_from_reference(ref["params0"], cfg, "cpu")
    opt = adamw_state_from_reference(ref["opt0"], cfg, "cpu")
    named = {k: v.detach().clone() for k, v in model.named_parameters()}
    mesh = DeviceMesh([["cpu"] * 4] * 2, ("data", "model"))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in ref["batches"]]
    p_sh = param_shardings(named, cfg, mesh)
    o_sh = param_shardings(opt, cfg, mesh, role="opt")
    b_sh = batch_shardings(batches[0], cfg, mesh)
    step = make_sharded_train_step(cfg, TrainConfig(**STEP_TCFG), mesh, p_sh,
                                   o_sh, b_sh)
    params, state = shard_tree(named, p_sh), shard_tree(opt, o_sh)
    losses, norms = [], []
    for s, b in enumerate(batches):
        params, state, m = step(params, state, s, b)
        losses.append(m["loss"])
        norms.append(float(m["grad_norm"]))
        assert m["bad_step"] == 0
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(norms, ref["norms"], rtol=1e-5)
    from repro_torch.convert import lm_named_leaves

    full = gather_tree(params, p_sh)
    start = lm_named_leaves(ref["params0"], cfg)
    if cfg.n_experts:
        one = make_train_step(cfg, TrainConfig(**STEP_TCFG))
        one_losses = []
        for s, b in enumerate(batches):
            model, opt, m1 = one(model, opt, s, b)
            one_losses.append(m1["loss"])
        assert losses == one_losses
        for name, p in model.named_parameters():
            assert torch.equal(full[name], p.detach()), name
        want = {k: v.detach().numpy() for k, v in model.named_parameters()}
    else:
        want = lm_named_leaves(ref["params"], cfg)
        for name, arr in want.items():
            np.testing.assert_allclose(full[name].numpy(), arr, rtol=1e-5,
                                       atol=STEP_ATOL, err_msg=name)
    moved = sum(not np.array_equal(arr, start[name])
                for name, arr in want.items())
    assert moved == len(want)
    assert all(int(st["count"]) == N_STEPS for st in state.values())
    assert analysis.collective_bytes(m["collectives"]) == \
        analysis.collective_bytes(
            analysis.step_collectives(p_sh, o_sh, b_sh, "train"))


def test_sharded_trainer_checkpoints_whole_and_resumes_elsewhere(tmp_path):
    """``Trainer`` over the sharded step: it checkpoints the whole state,
    and a trainer on a (1, 4) mesh resumes from a (2, 2) run's checkpoint
    and runs the same steps as the (2, 2) run continued."""
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import init_params
    from repro_torch.train import Trainer

    cfg = smoke_config(get_config("qwen3-0.6b"))
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=16, global_batch=4))

    def trainer(shape, ckpt):
        mesh = DeviceMesh([["cpu"] * shape[1]] * shape[0], ("data", "model"))
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        named = {k: v.detach() for k, v in model.named_parameters()}
        opt = adamw_init(named)
        tcfg = TrainConfig(**STEP_TCFG, checkpoint_every=2,
                           checkpoint_dir=str(ckpt), log_every=10**9)
        sh = {"params": param_shardings(named, cfg, mesh),
              "opt": param_shardings(opt, cfg, mesh, role="opt")}
        step = make_sharded_train_step(
            cfg, tcfg, mesh, sh["params"], sh["opt"],
            batch_shardings(stream.batch_at(0), cfg, mesh))
        return Trainer(cfg, tcfg, shard_tree(named, sh["params"]),
                       shard_tree(opt, sh["opt"]), stream, step,
                       shardings=sh)

    a = trainer((2, 2), tmp_path / "a")
    a.run(4, log=lambda *_: None)
    b = trainer((1, 4), tmp_path / "a")
    assert b.maybe_restore() and b.step == 4
    a_whole = gather_tree(a.params, a.shardings["params"])
    b_whole = gather_tree(b.params, b.shardings["params"])
    assert all(torch.equal(a_whole[k], b_whole[k]) for k in a_whole)
    assert set(b.params) == {(0, i) for i in range(4)}
    hist_b = b.run(2, log=lambda *_: None)
    hist_a = a.run(2, log=lambda *_: None)  # the whole history
    assert np.isfinite(hist_a).all() and len(hist_a) == 6
    np.testing.assert_allclose(hist_b, hist_a[4:], rtol=1e-5)


def test_launcher_prod_mesh_trains_sharded_and_resumes(tmp_path,
                                                        monkeypatch, capsys):
    """``launch.train --mesh prod`` on a stand-in mesh (the production
    mesh needs 256 cards): its losses are the one-device launcher's
    (rtol 1e-5), and it resumes from its whole checkpoint."""
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(
        launch_train, "make_production_mesh",
        lambda multi_pod: DeviceMesh([["cpu"] * 2] * 2, ("data", "model")))
    argv = ["--preset", "smoke", "--steps", "3", "--batch", "4", "--seq",
            "16", "--device", "cpu"]
    ckpt = ["--ckpt", str(tmp_path / "run"), "--ckpt-every", "2"]
    hist = launch_train.main(argv + ["--mesh", "prod"] + ckpt)
    one = launch_train.main(argv)
    assert len(hist) == 3 and np.isfinite(hist).all()
    np.testing.assert_allclose(hist, one, rtol=1e-5)
    assert launch_train.main(argv + ["--mesh", "prod"] + ckpt) == []
    assert "resumed from step 3" in capsys.readouterr().out
