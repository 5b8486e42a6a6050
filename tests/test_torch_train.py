"""The port's training path against the JAX package's, on the same weights and data."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data import host_batch as jax_host_batch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import apply_opt as jax_apply_opt  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.optim import init_opt as jax_init_opt  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.overlap_grads import partition_tree as jax_partition  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.data import SyntheticLM, host_batch  # noqa: E402
from repro_torch.kernels.schedule_runner import check_postcondition  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_opt, cosine_schedule, init_opt  # noqa: E402
from repro_torch.train import (  # noqa: E402
    OverlapGradReducer,
    TrainState,
    certified_allreduce,
    make_overlap_train_step,
    make_train_step,
    partition_tree,
)
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

N = 8                       # virtual data-parallel ranks
SEQ = 16
PERM = [3, 1, 4, 7, 5, 0, 2, 6]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """The smoke qwen2-0.5b in f32 from JAX's init, both sides' batch and
    JAX's one-device baseline step."""
    jcfg = jax_get_config("qwen2-0.5b").smoke()
    jm = jax_get_model(jcfg)
    jstate = jax_init_state(jm, jax.random.PRNGKey(0))
    jbatch = jax_host_batch(JaxSyntheticLM(jcfg.vocab_size, SEQ, N, seed=0), 0)
    opt = JaxAdamWConfig(lr=1e-3)
    base_state, base_metrics = jax.jit(jax_make_train_step(jm, opt))(jstate, jbatch)
    base_loss, base_grads = jax.jit(jax.value_and_grad(jm.loss))(jstate.params,
                                                                  jbatch)
    model = get_model(get_config("qwen2-0.5b").smoke(), device="cpu")
    params = params_from_jax(_np_tree(jstate.params), model)
    return dict(jm=jm, jstate=jstate, jbatch=jbatch, base_state=base_state,
                base_metrics=base_metrics, base_loss=base_loss,
                base_grads=base_grads, model=model, params=params)


def _close_trees(got, want, rtol, atol):
    got_l = tree_leaves(got)
    want_l = jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 2)])
def test_synthetic_tokens_equal_the_reference(seed, step):
    a = host_batch(SyntheticLM(256, SEQ, N, seed=seed), step)
    b = jax_host_batch(JaxSyntheticLM(256, SEQ, N, seed=seed), step)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("scheduled", [False, True], ids=["constant", "cosine"])
def test_apply_opt_matches_the_reference(scheduled):
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"z": rng.standard_normal(7).astype(np.float32)}}
    grads = [{"w": rng.standard_normal((6, 5)).astype(np.float32) * s,
              "b": {"z": rng.standard_normal(7).astype(np.float32) * s}}
             for s in (0.3, 3.0)]        # the second step clips
    jcfg = JaxAdamWConfig(lr=1e-2, schedule=jax_cosine(1e-2, 1, 10) if scheduled
                          else None)
    cfg = AdamWConfig(lr=1e-2, schedule=cosine_schedule(1e-2, 1, 10) if scheduled
                      else None)
    jp, jo = jax.tree.map(jnp.asarray, tree), jax_init_opt(jax.tree.map(jnp.asarray, tree))
    tp = tree_map(torch.from_numpy, tree)
    to = init_opt(tp)
    for g in grads:
        jp, jo, jmet = jax_apply_opt(jcfg, jp, jax.tree.map(jnp.asarray, g), jo)
        tp, to, tmet = apply_opt(cfg, tp, tree_map(torch.from_numpy, g), to)
        _close_trees(tp, jp, rtol=0, atol=1e-6)
        _close_trees(to.m, jo.m, rtol=0, atol=1e-6)
        _close_trees(to.v, jo.v, rtol=0, atol=1e-6)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-6)
    assert int(to.count) == int(jo.count) == 2


def test_partition_tree_equals_the_reference(setup):
    for bb in (0.0, 4096.0, 30000.0):
        want = jax_partition(setup["jstate"].params, bb)
        got = partition_tree(setup["params"], bb)
        assert [(b.leaf_ids, b.sizes, b.n_elems, b.n_bytes) for b in got] == \
            [(b.leaf_ids, b.sizes, b.n_elems, b.n_bytes) for b in want]
    stacked = tree_map(lambda t: t.expand(N, *t.shape), setup["params"])
    assert partition_tree(stacked, 4096.0, leading_axis=True) == \
        partition_tree(setup["params"], 4096.0)


def test_decoder_logits_loss_and_grads_match_the_reference(setup):
    jm, jstate, jbatch = setup["jm"], setup["jstate"], setup["jbatch"]
    model, params = setup["model"], setup["params"]
    toks = torch.from_numpy(np.asarray(jbatch["tokens"])).long()
    want_logits, _ = jax.jit(jm.forward)(jstate.params, jnp.asarray(jbatch["tokens"]))
    with torch.no_grad():
        logits, aux = model.forward(params, toks)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    batch = {k: torch.from_numpy(np.asarray(v)).long() for k, v in jbatch.items()}
    loss, grads = value_and_grad(model, params, batch)
    np.testing.assert_allclose(float(loss), float(setup["base_loss"]), rtol=1e-5)
    _close_trees(grads, setup["base_grads"], rtol=2e-4, atol=1e-6)


def test_chunked_loss_equals_the_full_loss(setup):
    """The chunked cross entropy (S > chunk) is the plain mean."""
    from repro_torch.models.transformer import lm_loss

    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    head = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 32, (2, 8)))
    full = lm_loss(feats, head, labels, chunk=0)
    chunked = lm_loss(feats, head, labels, chunk=4)
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-6)


@pytest.mark.parametrize("mode", ["bucketed", "fused"])
def test_overlap_step_matches_the_reference_baseline(setup, mode):
    """tests/test_overlap.py:260-325 on the virtual mesh: n=8 ranks, the
    ring in perm [3,1,4,7,5,0,2,6] with chunk factor 2, against JAX's
    one-device baseline step on the full batch."""
    model, params = setup["model"], setup["params"]
    state = TrainState(params, init_opt(params), torch.zeros((), dtype=torch.int32))
    pb = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    bb = pb / 3.5
    sched = certified_allreduce(N, bb, algo="ring", perm=PERM, chunk_factor=2)
    red = OverlapGradReducer(sched, bucket_bytes=bb, mode=mode)
    assert len(red.buckets_for(tree_map(lambda t: t[None], params))) > 1

    # the reducer alone: the mean of per-rank grads == the baseline grads
    batch = {k: torch.from_numpy(np.asarray(v)).long()
             for k, v in setup["jbatch"].items()}
    per = batch["tokens"].shape[0] // N
    ranks = [value_and_grad(model, params,
                            {k: v[r * per:(r + 1) * per] for k, v in batch.items()})[1]
             for r in range(N)]
    gstack = tree_map(lambda *ls: torch.stack(ls), *ranks)
    mean_tree, _ = red(gstack)
    _close_trees(mean_tree, setup["base_grads"], rtol=2e-4, atol=1e-6)

    new_state, metrics = make_overlap_train_step(
        model, AdamWConfig(lr=1e-3), red)(state, setup["jbatch"])
    base = setup["base_metrics"]
    np.testing.assert_allclose(float(metrics["loss"]), float(base["loss"]),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(base["grad_norm"]),
                               rtol=2e-4, atol=1e-5)
    # params: absolute bound only (Adam's first step is sign-like where
    # grads ~ 0, so a relative comparison there is ill-conditioned)
    _close_trees(new_state.params, setup["base_state"].params, rtol=0, atol=1e-4)
    assert int(new_state.step) == 1


def test_bucket_payloads_meet_the_postcondition(setup):
    """Every bucket payload through the certified ring is a true all-reduce."""
    from repro_torch.kernels.overlap import run_overlapped

    params = setup["params"]
    pb = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    sched = certified_allreduce(N, pb / 3.5, algo="ring", perm=PERM, chunk_factor=2)
    rng = np.random.default_rng(4)
    stacked = tree_map(lambda t: torch.from_numpy(
        rng.standard_normal((N, *t.shape)).astype(np.float32)), params)
    red = OverlapGradReducer(sched, bucket_bytes=pb / 3.5)
    leaves = tree_leaves(stacked)
    for bkt in red.buckets_for(stacked):
        payload = red._payload(leaves, bkt)
        assert payload.shape[1] % (sched.n_chunks * sched.chunk_factor) == 0
        out, _ = run_overlapped(payload, sched)
        assert check_postcondition(sched, payload, out, atol=1e-4) == []


def test_baseline_step_matches_the_reference(setup):
    model, params = setup["model"], setup["params"]
    state = TrainState(params, init_opt(params), torch.zeros((), dtype=torch.int32))
    new_state, metrics = make_train_step(model, AdamWConfig(lr=1e-3))(
        state, setup["jbatch"])
    base = setup["base_metrics"]
    np.testing.assert_allclose(float(metrics["loss"]), float(base["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(base["grad_norm"]),
                               rtol=2e-4)
    _close_trees(new_state.params, setup["base_state"].params, rtol=0, atol=1e-4)


def test_record_buckets_reports_payloads(setup):
    params = setup["params"]
    sched = certified_allreduce(N, 4096.0)
    red = OverlapGradReducer(sched, bucket_bytes=4096.0, mode="sequential")
    prev = obs.set_recorder(obs.WorkloadRecorder(enabled=True))
    try:
        stacked = tree_map(lambda t: t.expand(N, *t.shape), params)
        buckets = red.record_buckets(stacked)
        recs = obs.recorder().trace().records
    finally:
        obs.set_recorder(prev)
    assert [r.size_bytes for r in recs] == [float(b.n_bytes) for b in buckets]
    assert all(r.op == "all-reduce" for r in recs)


def test_params_from_jax_takes_the_decoder_tree(setup):
    model = setup["model"]
    spec = model.param_spec()
    tree = _np_tree(setup["jstate"].params)
    params = params_from_jax(tree, model)
    assert set(params) == set(spec)
    leaf = np.asarray(tree["blocks"]["attn"]["wq"])
    assert torch.equal(params["blocks"]["attn"]["wq"], tensor_from_numpy(leaf))
    gen = torch.Generator()
    gen.manual_seed(0)
    drawn = model.init(gen)
    assert [tuple(t.shape) for t in tree_leaves(drawn)] == \
        [tuple(t.shape) for t in tree_leaves(params)]
    del tree["blocks"]["attn"]["bq"]
    with pytest.raises(KeyError, match="bq"):
        params_from_jax(tree, model)
