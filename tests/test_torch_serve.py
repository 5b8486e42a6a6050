"""The port's generation engine against the JAX package's."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serve import GenerationConfig as JaxGenerationConfig  # noqa: E402
from repro.serve import GenerationEngine as JaxGenerationEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import GenerationConfig, GenerationEngine  # noqa: E402
from repro_torch.serve.engine import _grow_cache, make_serve_step  # noqa: E402

BATCH, PROMPT, NEW = 2, 16, 8


def _port_engine(tree, impl="kernel", **gen):
    cfg = dataclasses.replace(get_config("rwkv6-1.6b").smoke(), wkv_impl=impl)
    model = get_model(cfg, device="cpu")
    return GenerationEngine(model, params_from_jax(tree, model),
                            GenerationConfig(max_new_tokens=NEW, eos_token=-1, **gen))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("rwkv6-1.6b").smoke(), wkv_impl="xla")
    jm = jax_get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (BATCH, PROMPT)).tolist()
    return jm, params, jax.tree.map(np.asarray, params), prompts


def test_greedy_tokens_equal_jax_xla_engine(setup):
    """Port (kernel-path prefill) vs reference (exact recurrence); eos=-1 so
    no trimming can hide a mismatch."""
    jm, params, tree, prompts = setup
    expect = JaxGenerationEngine(
        jm, params, JaxGenerationConfig(max_new_tokens=NEW, eos_token=-1)
    ).generate(prompts)
    eng = _port_engine(tree)
    got = eng.generate(prompts)
    assert got == expect
    assert all(len(row) == NEW for row in got)
    assert eng.stats["prefill_tokens"] == BATCH * PROMPT
    assert eng.stats["decode_steps"] == NEW


def test_generate_opens_obs_spans_and_records(setup):
    _, _, tree, prompts = setup
    prev_t = obs.set_tracer(obs.Tracer(enabled=True))
    prev_r = obs.set_recorder(obs.WorkloadRecorder(enabled=True))
    try:
        _port_engine(tree).generate(prompts, max_new_tokens=3)
        names = [rec[1] for rec in obs.tracer().records()]
        ops = [r.op for r in obs.recorder().trace().records]
    finally:
        obs.set_tracer(prev_t)
        obs.set_recorder(prev_r)
    assert names == ["serve.prefill", "serve.decode"]
    assert ops == ["all-gather", "reduce-scatter"] * 3


def test_temperature_sampling_is_seeded(setup):
    _, _, tree, prompts = setup
    a = _port_engine(tree, temperature=1.0, seed=7).generate(prompts)
    b = _port_engine(tree, temperature=1.0, seed=7).generate(prompts)
    assert a == b and all(len(row) == NEW for row in a)


def test_eos_trims_and_stops(setup):
    _, _, tree, prompts = setup
    eng = _port_engine(tree)
    first = eng.generate(prompts)
    eng.cfg = GenerationConfig(max_new_tokens=NEW, eos_token=first[0][2])
    got = eng.generate(prompts)
    assert got[0] == first[0][:2]


def test_unequal_prompts_raise(setup):
    _, _, tree, _ = setup
    with pytest.raises(ValueError, match="equal prompt lengths"):
        _port_engine(tree).generate([[1, 2, 3], [1, 2]])


def test_serve_step_is_decode_step(setup):
    _, _, tree, prompts = setup
    eng = _port_engine(tree)
    toks = torch.tensor(prompts)
    logits, cache = eng.model.prefill(eng.params, toks)
    cur = logits.argmax(-1)
    a, _ = make_serve_step(eng.model)(eng.params, cur, cache)
    b, _ = eng.model.decode_step(eng.params, cur, cache)
    assert torch.equal(a, b)


def test_grow_cache_pads_only_sequence_buffers():
    cache = {"k": torch.ones(2, 3, 4, 5), "wkv": torch.ones(2, 4, 4),
             "layer": {"v": torch.ones(3, 4, 5)}, "pos": torch.tensor(4)}
    out = _grow_cache(cache, 4, 7)
    assert tuple(out["k"].shape) == (2, 3, 7, 5)
    assert tuple(out["layer"]["v"].shape) == (3, 7, 5)
    assert out["k"][:, :, 4:].abs().sum() == 0
    assert out["wkv"] is cache["wkv"] and out["pos"] is cache["pos"]
