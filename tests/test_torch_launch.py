"""The port's launch layer (``repro_torch.launch.{mesh,shapes,analysis,
dryrun}``) against the JAX package's.

``tests/test_launch.py``'s ten cases run on the port; its HLO-parser case
becomes the collective-log case (the port has no HLO), and the roofline
case runs on the port's H100 constants.  Beside them: the analytic
counts (``model_memory_bytes``, ``model_flops``, ``active_params``) equal
to the reference's for every arch and cell, ``params_specs`` equal leaf by
leaf in shape and dtype, ``lower_cell`` and ``probe_cell`` on the meta
device, the trueknn cell on the CPU held against the port's brute
backend, and the command line writing its records.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.launch.analysis as ref_analysis
import repro.launch.shapes as ref_shapes
from repro_torch import KnnSpec, build_index
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.trueknn import TrueKNNConfig
from repro_torch.convert import _named_layers
from repro_torch.core.distributed import DeviceMesh
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.shapes import (CELLS, cell_applicable, input_specs,
                                       params_specs)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KNN_SMALL = TrueKNNConfig(n_points=1 << 10, n_queries=1 << 10)


# ------------------------------------------ test_launch.py's cases, ported


def test_cells_cover_assignment():
    assert set(CELLS) == {"train_4k", "prefill_32k", "decode_32k", "long_500k"}
    assert CELLS["train_4k"].global_batch == 256
    assert CELLS["long_500k"].seq_len == 524288 and CELLS["long_500k"].global_batch == 1
    assert {k: dataclasses.asdict(v) for k, v in CELLS.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_shapes.CELLS.items()}


def test_all_40_cells_accounted():
    """10 archs x 4 shapes: every cell is either applicable or has a
    reason, the reference's."""
    n_ok = n_skip = 0
    for name, cfg in ARCHS.items():
        for cell in CELLS.values():
            ok, reason = cell_applicable(cfg, cell)
            assert (ok, reason) == ref_shapes.cell_applicable(
                ref_configs.get_config(name), ref_shapes.CELLS[cell.name])
            if ok:
                n_ok += 1
            else:
                n_skip += 1
                assert reason
    assert n_ok + n_skip == 40
    assert n_skip == 7  # long_500k on pure full-attention archs


def test_input_specs_no_allocation_and_shapes():
    cfg = get_config("qwen3-0.6b")
    spec = input_specs(cfg, CELLS["train_4k"])
    assert spec["tokens"].device.type == "meta"
    assert spec["tokens"].shape == (256, 4096)
    assert spec["tokens"].dtype == torch.int32
    dec = input_specs(cfg, CELLS["decode_32k"])
    assert dec["token"].shape == (128, 1)
    leaves = [t for layer in dec["caches"] for t in layer.values()]
    assert leaves and all(t.device.type == "meta" for t in leaves)


def test_prefix_archs_carve_sequence_budget():
    cfg = get_config("internvl2-26b")
    spec = input_specs(cfg, CELLS["train_4k"])
    s_tok = spec["tokens"].shape[1]
    s_pre = spec["prefix_embeds"].shape[1]
    assert s_tok + s_pre == 4096
    assert spec["prefix_embeds"].shape[2] == cfg.d_model


def test_params_specs_match_init_shapes():
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params

    cfg = smoke_config(get_config("smollm-135m"))
    sds = dict(params_specs(cfg).named_parameters())
    real = dict(init_params(cfg, torch.Generator().manual_seed(0),
                            "cpu").named_parameters())
    assert list(sds) == list(real)
    for k, a in sds.items():
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (real[k].shape, real[k].dtype)


def test_collective_log_sums():
    """The parser case's sums, from a collective log."""
    log = [("all-gather", 16 * 2048 * 2), ("all-reduce", 512 * 4),
           ("reduce-scatter", 32 * 4 * 4), ("collective-permute", 100),
           ("all-reduce", 2 * 8 * 4 * 4)]
    out = analysis.collective_bytes(log)
    assert out["bytes"]["all-gather"] == 16 * 2048 * 2
    assert out["bytes"]["all-reduce"] == 512 * 4 + 2 * 8 * 4 * 4
    assert out["bytes"]["reduce-scatter"] == 32 * 4 * 4
    assert out["bytes"]["collective-permute"] == 100
    assert out["counts"]["all-reduce"] == 2
    assert out["total_bytes"] == sum(out["bytes"].values())
    with pytest.raises(ValueError, match="unknown collective"):
        analysis.collective_bytes([("psum", 4)])


def test_roofline_terms_and_dominance():
    r = analysis.roofline({"flops": 989e12, "bytes accessed": 3.35e12},
                          50e9, 256)
    assert abs(r["compute_s"] - 1.0) < 1e-6
    assert abs(r["memory_s"] - 1.0) < 1e-6
    assert abs(r["collective_s"] - 1.0) < 1e-6
    r2 = analysis.roofline({"flops": 1, "bytes accessed": 1}, 50e9 * 10, 256)
    assert r2["dominant"] == "collective_s"
    assert set(r) == set(ref_analysis.roofline({}, 0, 1))
    r3 = analysis.roofline({"flops": 1, "bytes accessed": 2}, None, 256)
    assert r3["collective_s"] is None and r3["dominant"] == "memory_s"


def test_model_flops_moe_discounts_unrouted_experts():
    dense = get_config("deepseek-coder-33b")
    moe = get_config("deepseek-v2-lite-16b")
    assert analysis.active_params(dense) == dense.param_count()
    act = analysis.active_params(moe)
    assert act < moe.param_count() * 0.35  # 6+2 of 66 experts active
    cell = CELLS["train_4k"]
    assert analysis.model_flops(moe, cell) == pytest.approx(
        6.0 * act * 256 * 4096
    )


def test_model_memory_lb_sane():
    cfg = get_config("deepseek-coder-33b")
    lb_train = analysis.model_memory_bytes(cfg, CELLS["train_4k"], 256)
    lb_decode = analysis.model_memory_bytes(cfg, CELLS["decode_32k"], 256)
    # train streams params+grads+moments; decode streams params+KV once
    assert lb_train > cfg.param_count() / 256 * 10
    kv = 62 * 128 * 32768 * 2 * 8 * 128 * 2 / 256
    assert lb_decode == pytest.approx(
        analysis.active_params(cfg) / 256 * 2 + kv, rel=0.01
    )


def test_mesh_factories_are_lazy():
    # importing launch.mesh touches no device — the factory is a function
    import repro_torch.launch.mesh as m

    assert callable(m.make_production_mesh)


# ------------------------------------------------------------ beside them


@pytest.mark.parametrize("arch", list(ARCHS))
def test_analytic_counts_equal_reference(arch, monkeypatch):
    cfg, rcfg = get_config(arch), ref_configs.get_config(arch)
    # each count calls param_count (a model built on meta, the reference's
    # eval_shape) again; count once per package
    for c in (cfg, rcfg):
        n = c.param_count()
        monkeypatch.setattr(type(c), "param_count", lambda self, n=n: n)
    assert analysis.active_params(cfg) == ref_analysis.active_params(rcfg)
    for name, cell in CELLS.items():
        rcell = ref_shapes.CELLS[name]
        assert analysis.model_flops(cfg, cell) == ref_analysis.model_flops(
            rcfg, rcell)
        for n in (256, 512):
            assert analysis.model_memory_bytes(cfg, cell, n) == \
                ref_analysis.model_memory_bytes(rcfg, rcell, n)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_specs_equal_reference_leaf_by_leaf(arch):
    cfg, rcfg = get_config(arch), ref_configs.get_config(arch)
    want = _named_layers(
        ref_shapes.params_specs(rcfg), cfg,
        lambda a, i: jax.ShapeDtypeStruct(a.shape[1:], a.dtype))
    got = dict(params_specs(cfg).named_parameters())
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k


def test_production_meshes():
    for multi, need, shape in ((False, 256, {"data": 16, "model": 16}),
                               (True, 512, {"pod": 2, "data": 16,
                                            "model": 16})):
        mesh = make_production_mesh(multi_pod=multi, devices=["meta"] * need)
        assert mesh.shape == shape and mesh.device_type == "meta"
        with pytest.raises(ValueError, match=f"needs {need} devices"):
            make_production_mesh(multi_pod=multi, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 256 devices, 0 given"):
            make_production_mesh()
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}


def test_meta_positions_only_on_a_mesh():
    """``DeviceMesh`` holds meta positions; ``resolve_device``, which every
    entry point calls, still refuses meta."""
    from repro_torch._device import resolve_device
    from repro_torch.models import init_params

    assert DeviceMesh(["meta"] * 4).device_type == "meta"
    with pytest.raises(ValueError, match="one device type"):
        DeviceMesh(["meta", "cpu"])
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        init_params(get_config("smollm-135m"), None, "meta")


def test_h100_constants_are_chip_smokes():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert analysis.HBM_BW == mod.HBM_BYTES_PER_S
    assert (analysis.PEAK_FLOPS, analysis.LINK_BW) == (989e12, 50e9)
    src = (ROOT / "src/repro_torch/launch/analysis.py").read_text()
    for tpu in ("197e12", "819e9", "TPU v5e", "ICI"):
        assert tpu not in src


@pytest.mark.parametrize("arch,cell,multi", [
    ("qwen3-0.6b", "train_4k", False),
    ("deepseek-v2-lite-16b", "decode_32k", True),
])
def test_lower_cell_on_meta(arch, cell, multi):
    rec = dryrun.lower_cell(arch, cell, multi)
    assert rec["status"] == "ok" and rec["n_chips"] == (512 if multi else 256)
    assert rec["flops_counted"] == "products" and rec["cost_bytes"] is None
    assert 0 < rec["memory"]["argument_size_in_bytes"] < dryrun.DEVICE_BYTES
    assert rec["cost_flops"] * rec["n_chips"] >= rec["model_flops"] * 0.5
    if CELLS[cell].kind == "train":
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                               "collective_s")
        assert rec["collectives"]["total_bytes"] > 0
    else:  # no sharded serving step in the port: nothing to count
        assert rec["collectives"] is None and rec["collectives_note"]
        assert rec["roofline"]["collective_s"] is None
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s")
    json.dumps(rec)
    assert dryrun.lower_cell(arch, cell, multi, unroll=True)["cost_flops"] \
        == rec["cost_flops"]


def test_probe_cell_within_one_percent_of_the_full_count():
    full = dryrun.lower_cell("qwen3-0.6b", "train_4k", False)
    probe = dryrun.probe_cell("qwen3-0.6b", "train_4k", False)
    assert probe["method"] == "depth_probe"
    assert probe["cost_flops"] == pytest.approx(full["cost_flops"], rel=0.01)
    assert probe["collectives"]["total_bytes"] == pytest.approx(
        full["collectives"]["total_bytes"], rel=0.01)


def test_skipped_cell_keeps_the_reference_reason():
    rec = dryrun.lower_cell("qwen3-0.6b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_shapes.cell_applicable(
        ref_configs.get_config("qwen3-0.6b"), ref_shapes.CELLS["long_500k"])[1]


def _brute(pts, qs, k):
    return build_index(pts, backend="brute", device="cpu").query(
        qs, KnnSpec(k))


@pytest.mark.parametrize("multi", [False, True])
def test_trueknn_cell_dense_equals_brute(multi):
    rec, pts, qs, (d2, idx, cnt) = dryrun.lower_trueknn_cell(
        multi, "dense", device="cpu", kcfg=KNN_SMALL)
    assert rec["n_chips"] == (512 if multi else 256)
    assert pts.shape == (KNN_SMALL.n_points * 16, 3)
    want = _brute(pts, qs, KNN_SMALL.k)
    assert np.array_equal(np.sqrt(np.maximum(d2.numpy(), 0)), want.dists)
    assert np.array_equal(idx.numpy(), want.idxs)
    assert rec["first_s"] > 0 and rec["warm_s"] > 0


def test_trueknn_cell_grid_equals_brute_within_its_radius():
    """One grid round: each row's ``found`` is its ball's count, and its
    first min(found, k) neighbors are brute's, distances bitwise and
    indices up to the grid's order among equal distances."""
    k = KNN_SMALL.k
    rec, pts, qs, (d2, idx, found) = dryrun.lower_trueknn_cell(
        False, "grid", device="cpu", kcfg=KNN_SMALL)
    want = _brute(pts, qs, k)
    r = rec["radius"]
    dist = np.sqrt(np.maximum(d2.numpy(), 0))
    ball = np.sqrt(((qs[:, None, :] - pts[None]) ** 2).sum(-1)) <= r
    np.testing.assert_array_equal(found.numpy(), ball.sum(1))
    got_idx = idx.numpy()
    for row in range(qs.shape[0]):
        m = min(int(found[row]), k)
        assert np.array_equal(dist[row, :m], want.dists[row, :m]), row
        assert set(got_idx[row, :m]) == set(want.idxs[row, :m]), row
    resolved = (found.numpy() >= k).mean()
    assert 0.2 < resolved < 0.8  # the radius holds k points on average


def test_cli_writes_records(tmp_path, capsys):
    out = tmp_path / "dryrun"
    recs = dryrun.main(["--arch", "smollm-135m", "--cell", "decode_32k",
                        "--mesh", "both", "--out", str(out)])
    assert [r["status"] for r in recs] == ["ok", "ok"]
    for tag in ("single", "multi"):
        rec = json.loads((out / f"smollm-135m__decode_32k__{tag}.json")
                         .read_text())
        assert rec["multi_pod"] == (tag == "multi")
        assert rec["roofline"]["n_chips"] == rec["n_chips"]
    again = dryrun.main(["--arch", "smollm-135m", "--cell", "decode_32k",
                         "--mesh", "single", "--out", str(out)])
    assert again == [] and "[skip existing]" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the trueknn cell needs the card
        knn = dryrun.main(["--arch", "trueknn", "--mesh", "single", "--out",
                           str(out)])
        assert knn[0]["status"] == "skipped"
        assert "torch.cuda.is_available() is False" in knn[0]["reason"]
