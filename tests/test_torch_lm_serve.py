"""The port's serving engine against the JAX package's: ``BatchedServer``
on the reference's weights serves the reference's greedy completions
token for token (left-padded batches, more requests than slots), and
the properties ``tests/test_serve.py`` holds the reference to hold in the
port (batching does not change greedy outputs; every request completes).
Also the synthetic token stream the kNN-LM datastore reads, copied from
the reference, and sampling at temperature > 0, which draws from a
torch generator seeded by position where the reference draws
``jax.random.categorical(PRNGKey(pos))`` (ROADMAP §3 B9): only its
determinism is held."""

import functools

import jax
import numpy as np
import pytest
import torch

import repro.data as ref_data
import repro.models as ref_models
import repro.serve as ref_serve
import repro_torch.data as port_data
import repro_torch.models as port_models
from repro.configs import get_config, smoke_config
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import smoke_config as port_smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as port_launch
from repro_torch.serve import BatchedServer, ServeConfig

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


@functools.lru_cache(maxsize=None)
def _weights(name):
    cfg = smoke_config(get_config(name))
    params = jax.jit(ref_models.init_params, static_argnums=1)(KEY, cfg)
    pcfg = port_smoke_config(port_get_config(name))
    return cfg, params, pcfg, lm_params_from_reference(
        jax.tree.map(np.asarray, params), pcfg, "cpu")


def _greedy_reference(cfg, model, prompt, n_new):
    """Step-by-step greedy decode of one prompt in the port."""
    caches = port_models.make_decode_caches(cfg, 1, len(prompt) + n_new + 1,
                                            device="cpu")
    with torch.no_grad():
        lg, caches = port_models.prefill(model, cfg, np.asarray([prompt]),
                                         caches)
        out = []
        for i in range(n_new):
            tok = int(torch.argmax(lg, -1)[0])
            out.append(tok)
            lg, caches = port_models.decode_step(
                model, cfg, torch.tensor([[tok]]), len(prompt) + i, caches)
    return out


def test_batched_server_equals_reference_server():
    """Five prompts of different lengths through two slots: three batches,
    each left-padded to its longest prompt; every completion token equals
    the reference server's on the same weights."""
    cfg, params, pcfg, model = _weights("smollm-135m")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 9, 7, 7, 3)]
    ref = ref_serve.BatchedServer(cfg, params, ref_serve.ServeConfig(
        batch_slots=2))
    port = BatchedServer(pcfg, model, ServeConfig(batch_slots=2))
    for p in prompts:
        ref.submit(p)
        port.submit(p)
    want = ref.run(max_new_tokens=6)
    got = port.run(max_new_tokens=6)
    assert got == want
    assert [len(o) for o in got] == [6] * 5 and not port.queue


def test_batched_server_matches_single_decode():
    """Same-length prompts: batching must not change greedy outputs."""
    _, _, pcfg, model = _weights("smollm-135m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, pcfg.vocab_size, 9).tolist() for _ in range(3)]
    server = BatchedServer(pcfg, model, ServeConfig(batch_slots=3))
    for p in prompts:
        server.submit(p)
    outs = server.run(max_new_tokens=6)
    for p, o in zip(prompts, outs):
        assert o == _greedy_reference(pcfg, model, p, 6)


def test_server_handles_more_requests_than_slots():
    _, _, pcfg, model = _weights("smollm-135m")
    server = BatchedServer(pcfg, model, ServeConfig(batch_slots=2))
    rng = np.random.default_rng(1)
    for _ in range(5):
        server.submit(rng.integers(0, pcfg.vocab_size, 7).tolist())
    outs = server.run(max_new_tokens=4)
    assert len(outs) == 5
    assert all(len(o) == 4 for o in outs)


def test_server_stops_a_row_on_eos():
    """A row that emits ``eos_token`` takes no more tokens; the batch
    stops once every row has."""
    _, _, pcfg, model = _weights("smollm-135m")
    prompt = np.random.default_rng(2).integers(0, pcfg.vocab_size, 6).tolist()
    first = _greedy_reference(pcfg, model, prompt, 3)  # first[1] is the eos
    server = BatchedServer(pcfg, model, ServeConfig(batch_slots=1,
                                                    eos_token=first[1]))
    server.submit(prompt)
    want = first[:first.index(first[1]) + 1]
    assert server.run(max_new_tokens=8) == [want]


def test_sampling_is_seeded_by_position():
    """temperature > 0 draws from a generator seeded with each step's
    position: two runs give the same tokens, in the vocabulary."""
    _, _, pcfg, model = _weights("smollm-135m")
    runs = []
    for _ in range(2):
        server = BatchedServer(pcfg, model, ServeConfig(batch_slots=2,
                                                        temperature=0.8))
        for n in (4, 6):
            server.submit(list(range(1, n + 1)))
        runs.append(server.run(max_new_tokens=5))
    assert runs[0] == runs[1]
    assert all(0 <= t < pcfg.padded_vocab for o in runs[0] for t in o)


@pytest.mark.parametrize("step,shard", [(0, (0, 1)), (3, (1, 2))])
def test_synthetic_stream_equals_reference(step, shard):
    cfg = dict(vocab_size=500, seq_len=64, global_batch=4, seed=11)
    port = port_data.SyntheticLMStream(port_data.DataConfig(**cfg), *shard)
    ref = ref_data.SyntheticLMStream(ref_data.DataConfig(**cfg), *shard)
    got, want = port.batch_at(step), ref.batch_at(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key


def test_lm_mode_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        port_launch.main(["--mode", "lm", "--requests", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        port_models.make_decode_caches(
            port_smoke_config(port_get_config("qwen3-0.6b")), 1, 4)
