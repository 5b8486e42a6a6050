"""The port's Trainer, ClusterView, checkpoints and dynamic re-ranking
against the JAX package's, on the same inputs (CPU, the smoke qwen2-0.5b)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.fabric as ref_fabric  # noqa: E402
import repro.session as ref_session  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.cost_models import make_cost_model as ref_make_cost_model  # noqa: E402
from repro.core.dynamic import AdaptiveReranker as RefReranker  # noqa: E402
from repro.core.dynamic import StragglerDetector as RefStraggler  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data import host_batch as jax_host_batch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.trainer import ClusterView as RefClusterView  # noqa: E402
from repro.train.trainer import Trainer as RefTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore, save  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import AdaptiveReranker, StragglerDetector, make_cost_model  # noqa: E402
from repro_torch.data import SyntheticLM, host_batch  # noqa: E402
from repro_torch.fabric import make_datacenter, scramble  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt  # noqa: E402
from repro_torch.session import Session, SessionConfig  # noqa: E402
from repro_torch.train import (  # noqa: E402
    ClusterView,
    OverlapGradReducer,
    Trainer,
    TrainerConfig,
    TrainState,
    certified_allreduce,
    make_overlap_train_step,
    partition_tree,
)
from repro_torch.train.train_step import batch_on  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SEQ, ROWS = 16, 8
BUCKET = 1 << 17             # bytes: the smoke tree (428,288 bytes) in 5 buckets


def _fabrics(n=8):
    a, _ = scramble(make_datacenter(n, seed=0), seed=1)
    b, _ = ref_fabric.scramble(ref_fabric.make_datacenter(n, seed=0), seed=1)
    return a, b


@pytest.mark.parametrize("with_session", [False, True])
def test_cluster_view_plan_and_resolve_equal_the_reference(with_session):
    """The mesh plan, then the re-solve after a node fails (elastic shrink),
    equal the reference's ClusterView on the same fabric."""
    fab, rfab = _fabrics()
    kw = dict(mesh_shape=(8,), axis_names=("data",), payload_bytes=4e6)
    if with_session:
        cfg = {"probe": {"n_probes": 64},
               "solver": {"budget": {"iters": 300, "chains": 2}}}
        kw_a = dict(kw, session=Session(SessionConfig.from_dict(cfg)))
        kw_b = dict(kw, session=ref_session.Session(
            ref_session.SessionConfig.from_dict(cfg)))
    else:
        kw_a = kw_b = kw
    a, b = ClusterView(fab, **kw_a), RefClusterView(rfab, **kw_b)
    np.testing.assert_array_equal(a.solve_plan().flat, b.solve_plan().flat)
    assert a.plan.cost == pytest.approx(b.plan.cost, rel=1e-12)
    for view in (a, b):
        view.fail([3])
        assert view.shrink_mesh() == (4,)
    np.testing.assert_array_equal(a.solve_plan().flat, b.solve_plan().flat)
    assert a.active == b.active and len(a.active) == 4


def test_straggler_and_reranker_equal_the_reference():
    c = np.random.default_rng(0).uniform(1e-6, 1e-4, (6, 6))
    c = c + c.T
    np.fill_diagonal(c, 0.0)
    a, b = StragglerDetector(6), RefStraggler(6)
    times = np.random.default_rng(1).uniform(0.9, 1.1, (20, 6))
    times[:, 4] *= 3.0                       # node 4 straggles
    for row in times:
        for node, t in enumerate(row):
            a.observe(node, t)
            b.observe(node, t)
    np.testing.assert_array_equal(a.stragglers(), b.stragglers())
    np.testing.assert_array_equal(a.inflate(c), b.inflate(c))
    ra = AdaptiveReranker(lambda m: make_cost_model("ring", m, 0.0),
                          perm=np.arange(6), threshold=1.1)
    rb = RefReranker(lambda m: ref_make_cost_model("ring", m, 0.0),
                     perm=np.arange(6), threshold=1.1)
    for m in (c, a.inflate(c), a.inflate(c) * 2.0):
        pa, ca = ra.update(m)
        pb, cb = rb.update(m)
        np.testing.assert_array_equal(pa, pb)
        assert ca == cb
    assert ra.history == rb.history
    with pytest.raises(ValueError, match="NaN"):
        ra.update(np.full((6, 6), np.nan))


@pytest.fixture(scope="module")
def smoke():
    """The smoke qwen2-0.5b (f32) on the CPU from JAX's ``init_state``."""
    jm = jax_get_model(jax_get_config("qwen2-0.5b").smoke())
    jstate = jax_init_state(jm, jax.random.PRNGKey(0))
    model = get_model(get_config("qwen2-0.5b").smoke(), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params), model)
    for got, want in zip(tree_leaves(params), jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return model, params, jm, jstate


def _state(params):
    return TrainState(params, init_opt(params), torch.zeros((), dtype=torch.int32))


def _step_fn(model, n):
    red = OverlapGradReducer(certified_allreduce(n, BUCKET, "ring"),
                             bucket_bytes=BUCKET, mode="bucketed")
    return make_overlap_train_step(model, AdamWConfig(lr=1e-2), red)


def _batches(ds, batch_fn):
    i = 0
    while True:
        yield batch_fn(ds, i)
        i += 1


def _inject_once(step, nodes=(1,)):
    """A failure injector: ``nodes`` fail before step ``step + 1`` runs."""
    fired = []

    def inject(at):
        if at == step and not fired:
            fired.append(at)
            return list(nodes)
        return None

    return inject


STEPS = 10          # the straggler/re-rank check runs at step 10


def test_trainer_learns_and_survives_an_elastic_restart(smoke, tmp_path):
    """4 virtual ranks; node 1 fails after step 5: the cluster shrinks to 2
    ranks, re-solves its order, the step is rebuilt, training resumes
    from the step-4 checkpoint, and step 10 runs the re-rank check.  The
    reference Trainer on the same parameters, batches, fabric and
    injector (JAX's one-device step) gives the same restarts, history,
    re-rank events, cluster and checkpoint, and the same losses within
    f32 tolerance; a held-out batch's loss falls, and every step run
    records one all-reduce a gradient bucket."""
    model, params, jm, jstate = smoke
    ds = SyntheticLM(model.cfg.vocab_size, SEQ, ROWS, seed=0)
    held_out = batch_on(host_batch(ds, 1000), "cpu")
    with torch.no_grad():
        before = float(model.loss(params, held_out))
    fab, rfab = _fabrics(4)
    view = dict(mesh_shape=(4,), axis_names=("data",))
    cluster, ref_cluster = ClusterView(fab, **view), RefClusterView(rfab, **view)

    def rebuild(trainer):
        trainer.step_fn = _step_fn(model, trainer.cluster.mesh_shape[0])

    trainer = Trainer(_step_fn(model, 4), _state(params), _batches(ds, host_batch),
                      TrainerConfig(total_steps=STEPS, ckpt_every=4, log_every=1,
                                    ckpt_dir=str(tmp_path / "port"),
                                    bucket_bytes=BUCKET),
                      cluster=cluster, failure_injector=_inject_once(5),
                      rebuild=rebuild)
    prev = obs.set_recorder(obs.WorkloadRecorder(enabled=True))
    try:
        report = trainer.run()
        records = obs.recorder().trace().records
    finally:
        obs.set_recorder(prev)
    ref = RefTrainer(
        jax.jit(jax_make_train_step(jm, JaxAdamWConfig(lr=1e-2))), jstate,
        _batches(JaxSyntheticLM(model.cfg.vocab_size, SEQ, ROWS, seed=0),
                 jax_host_batch),
        RefTrainerConfig(total_steps=STEPS, ckpt_every=4, log_every=1,
                         ckpt_dir=str(tmp_path / "ref"), bucket_bytes=BUCKET),
        cluster=ref_cluster, failure_injector=_inject_once(5))
    want = ref.run()

    steps = [h["step"] for h in report["history"]]
    assert steps == [h["step"] for h in want["history"]]
    assert steps == [1, 2, 3, 4, 5, 5, 6, 7, 8, 9, 10]
    assert report["final_step"] == want["final_step"] == STEPS
    assert report["restarts"] == want["restarts"] == 1
    assert report["rerank_events"] == want["rerank_events"]
    assert cluster.mesh_shape == ref_cluster.mesh_shape == (2,)
    assert cluster.active == ref_cluster.active
    np.testing.assert_array_equal(cluster.plan.flat, ref_cluster.plan.flat)
    # f32 data-parallel means against JAX's one-device step.  The first
    # steps agree to rounding; after them AdamW's update m / (sqrt(v) + eps)
    # of a few near-zero gradient entries (|m| ~ sqrt(v) ~ 1e-8) turns
    # rounding into steps of up to lr, so by step 10 the losses drift
    # apart by about 1e-4 of their value.
    got = [h["loss"] for h in report["history"]]
    ref_losses = [h["loss"] for h in want["history"]]
    np.testing.assert_allclose(got[:5], ref_losses[:5], rtol=2e-6)
    np.testing.assert_allclose(got, ref_losses, rtol=5e-4)
    assert report["checkpoint"]["step"] == STEPS
    assert latest_step(str(tmp_path / "port")) == latest_step(
        str(tmp_path / "ref")) == STEPS
    assert int(trainer.state.step) == int(ref.state.step) == STEPS
    buckets = [float(b.n_bytes) for b in partition_tree(params, BUCKET)]
    assert len(buckets) > 1
    runs = len(steps)
    assert [r.op for r in records] == ["all-reduce"] * (runs * len(buckets))
    assert [r.size_bytes for r in records] == buckets * runs
    with torch.no_grad():
        after = float(model.loss(trainer.state.params, held_out))
    assert after < before - 0.05, (before, after)


def test_checkpoint_round_trip_is_bitwise(smoke, tmp_path):
    model, params = smoke[:2]
    mixed = dict(params, extra={"bf16": torch.linspace(-3, 3, 77).to(torch.bfloat16)})
    state = _state(mixed)._replace(step=torch.tensor(5, dtype=torch.int32))
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(5, state, extras={"note": "x"})
    ck.wait()
    assert ck.last["step"] == 5 and ck.last["bytes"] > 0
    got, step, extras = restore(str(tmp_path), state)
    assert step == 5 and extras == {"note": "x"}
    assert isinstance(got, TrainState)
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a later synchronous save moves LATEST; a mismatched template raises
    save(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    with pytest.raises(ValueError, match="leaves"):
        restore(str(tmp_path), {"only": torch.zeros(1)})
