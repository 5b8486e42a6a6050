"""``python -m repro_torch`` on the CPU: serve, probe, plan and train (smoke configs)."""

import contextlib
import functools
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serve_module_entry_point_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "serve", "--arch", "rwkv6-1.6b",
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
         "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[serve] arch=rwkv6-1.6b-smoke 8 tokens in" in r.stdout


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_serve_in_process(capsys, impl):
    from repro_torch.cli import main

    assert main(["serve", "--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                 "--wkv-impl", impl, "--batch", "1", "--prompt-len", "32",
                 "--max-new", "2"]) == 0
    assert "[serve] arch=rwkv6-1.6b-smoke 2 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_serve_dense_in_process(capsys, impl):
    from repro_torch.cli import main

    assert main(["serve", "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                 "--attention-impl", impl, "--batch", "2", "--prompt-len", "16",
                 "--max-new", "3"]) == 0
    assert "[serve] arch=qwen2-0.5b-smoke 6 tokens" in capsys.readouterr().out


def test_smoke_is_off_by_default():
    from repro_torch.cli import build_parser

    args = build_parser().parse_args(["serve"])
    assert args.smoke is False and args.device == "cuda"
    # the reference's default arch; the dense prefill through the kernel
    assert args.arch == "qwen2-0.5b" and args.attention_impl == "flash"
    assert build_parser().parse_args(["serve", "--smoke"]).smoke is True


# the session arguments of a small planning run, shared by both CLIs
PLAN_ARGS = ["--nodes", "8", "--scramble-seed", "1", "--mesh", "8",
             "--axes", "data", "--payload-bytes", "988065536", "--iters", "300",
             "--chains", "2"]


def test_probe_in_process(capsys, tmp_path):
    from repro_torch.cli import main

    out = str(tmp_path / "probe.json")
    assert main(["probe", "--nodes", "8", "--sparse", "--probe-budget", "0.5",
                 "--out", out]) == 0
    text = capsys.readouterr().out
    assert "[probe] fabric=datacenter n=8" in text and "[probe] sparse:" in text
    assert len(json.load(open(out))["lat"]) == 8


def test_plan_digest_equals_repro_plan(capsys):
    from repro.cli import main as ref_main
    from repro_torch.cli import main

    def digest():
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[plan]")][0]
        return line.split()[2]

    assert ref_main(["plan", *PLAN_ARGS, "--dry-run"]) == 0
    want = digest()
    assert main(["plan", *PLAN_ARGS, "--dry-run"]) == 0
    assert digest() == want
    assert main(["plan", *PLAN_ARGS, "--dump-config"]) == 0
    cfg = json.loads(capsys.readouterr().out)
    assert cfg["mesh"]["shape"] == [8] and cfg["payload_bytes"] == 988065536.0


@pytest.mark.parametrize("reorder", ["simulate", "none"])
def test_train_smoke_in_process(capsys, tmp_path, reorder):
    """A planned (or identity-order) data-parallel run over 4 virtual ranks
    through the runner transport; the loss falls over 12 steps."""
    from repro_torch.cli import main

    assert main(["train", "--smoke", "--device", "cpu", "--mesh", "4",
                 "--batch", "8", "--seq", "32", "--steps", "12",
                 "--lr", "1e-2", "--reorder", reorder, "--probe-seed", "0",
                 "--ckpt-dir", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    report = json.loads(text.split("[train] report ")[1].splitlines()[0])
    assert report["steps"] == 12 and report["ranks"] == 4
    assert report["transport"] == "runner" and report["algorithm"] == "ring"
    assert (report["plan_digest"] is None) == (reorder == "none")
    losses = report["losses"]
    assert sum(losses[-3:]) / 3 < sum(losses[:3]) / 3 - 0.03, losses
    assert report["checkpoint"]["step"] == 12
    assert "[train] arch=qwen2-0.5b-smoke steps=12" in text


def test_train_rwkv6_smoke_shows_a_falling_loss(capsys, tmp_path):
    """The ssm family trains through the user's entry point (the exact WKV
    recurrence, one rank); the loss falls over 12 steps."""
    from repro_torch.cli import main

    assert main(["train", "--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                 "--mesh", "1", "--batch", "8", "--seq", "32", "--steps", "12",
                 "--lr", "1e-2", "--reorder", "none",
                 "--ckpt-dir", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    report = json.loads(text.split("[train] report ")[1].splitlines()[0])
    assert report["steps"] == 12 and report["ranks"] == 1
    losses = report["losses"]
    assert sum(losses[-3:]) / 3 < sum(losses[:3]) / 3 - 0.03, losses
    assert "[train] arch=rwkv6-1.6b-smoke steps=12" in text


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "llava-next-mistral-7b"])
def test_train_takes_the_hybrid_and_vlm_families(capsys, tmp_path, arch):
    from repro_torch.cli import main

    assert main(["train", "--arch", arch, "--smoke", "--device", "cpu",
                 "--mesh", "1", "--batch", "2", "--seq", "16", "--steps", "2",
                 "--reorder", "none", "--ckpt-dir", str(tmp_path)]) == 0
    assert f"[train] arch={arch}-smoke steps=2" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small",
                                  "llava-next-mistral-7b", "deepseek-v2-236b",
                                  "dbrx-132b"])
def test_serve_new_families_in_process(capsys, arch):
    """The hybrid at a prompt as long as its smoke window (32), Whisper and
    the VLM with the reference's front-end stub, and the two MoE archs
    (deepseek's MLA)."""
    from repro_torch.cli import main

    assert main(["serve", "--arch", arch, "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "32", "--max-new", "3"]) == 0
    assert f"[serve] arch={arch}-smoke 6 tokens" in capsys.readouterr().out


def test_serve_moe_over_a_mesh_arms_the_ep_all_to_all(capsys, monkeypatch):
    """``serve --mesh 4`` on an MoE arch runs the prompt's experts through
    the EP all-to-all in the plan's order (the reference's configure_sp),
    and leaves nothing armed behind it."""
    from repro_torch.cli import main
    from repro_torch.parallel import moe_a2a

    seen = []
    real = moe_a2a.moe_a2a

    def spy(p, x, cfg):
        seen.append(moe_a2a._EP_STATE["a2a_order"])
        return real(p, x, cfg)

    monkeypatch.setattr(moe_a2a, "moe_a2a", spy)
    assert main(["serve", "--arch", "dbrx-132b", "--smoke", "--device", "cpu",
                 "--batch", "4", "--prompt-len", "8", "--max-new", "2",
                 "--mesh", "4"]) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=dbrx-132b-smoke 8 tokens" in out and "all-to-all" in out
    # one prefill of the two MoE layers (4 experts, one a rank), in the
    # plan's order
    assert len(seen) == 2 and seen[0] is not None and sorted(seen[0]) == [0, 1, 2, 3]
    assert moe_a2a._EP_STATE["mesh"] is None


@pytest.mark.parametrize("mesh", ["4", "2x2"])
def test_train_moe_over_the_ep_all_to_all(capsys, tmp_path, mesh):
    """``train --arch dbrx-132b`` on 4 data ranks, and on 2 data ranks x a
    model axis of 2: the plan's all-to-all entry printed beside the armed
    shift order, the all-reduce over the replicated leaves only, the loss
    finite and falling over 16 steps (the smoke experts, at the
    reference's ``1/sqrt(E)`` init, add outputs a thousand times the
    embeddings' scale, so the loss falls slower than the dense model's;
    at lr 1e-2 it wanders), nothing left armed."""
    from repro_torch.cli import main
    from repro_torch.parallel import moe_a2a

    assert main(["train", "--arch", "dbrx-132b", "--smoke", "--device", "cpu",
                 "--mesh", mesh, "--batch", "8", "--seq", "16", "--steps",
                 "16", "--lr", "3e-3", "--reorder", "simulate",
                 "--ckpt-dir", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    report = json.loads(text.split("[train] report ")[1].splitlines()[0])
    d = 4 if mesh == "4" else 2
    assert (report["dp"], report["model"]) == (d, 4 // d)
    assert "EP all-to-all shift order" in text
    ep = report["ep"]
    # 16 steps x 2 MoE layers x 8 x 16 tokens x top-2, routed once a
    # forward (the checkpoint's recompute in the backward counts nothing)
    assert ep["experts_per_rank"] == 4 // d and ep["choices"] == 16 * 2 * 8 * 16 * 2
    if mesh == "4":
        # the plan's entry over the data axis's 4 nodes orders the ring
        assert sorted(ep["order"]) == [0, 1, 2, 3]
        assert sorted(ep["plan_entry_order"]) == [0, 1, 2, 3]
    else:
        assert report["tp_collectives"]["model_reducescatter"] > 0
    assert ep["replicated_bytes"] < report["checkpoint"]["bytes"]
    losses = report["losses"]
    assert all(np.isfinite(losses))
    assert sum(losses[-3:]) / 3 < sum(losses[:3]) / 3 - 0.03, losses
    assert moe_a2a._EP_STATE["mesh"] is None


def test_train_warms_up_as_the_reference(monkeypatch, tmp_path):
    """``train`` builds its optimizer from the reference's schedule,
    ``cosine_schedule(lr, 10, steps)`` (``repro/cli.py:287``): at lr 1e-3
    over 4 steps the rates of steps 0-3 are 0, 1e-4, 2e-4 and 3e-4."""
    import jax.numpy as jnp
    import numpy as np
    from repro.optim import cosine_schedule as ref_cosine_schedule

    from repro_torch import cli

    calls = []

    def spy(lr, steps):
        calls.append((lr, steps))
        return cli_schedule(lr, steps)

    cli_schedule = cli.train_schedule
    monkeypatch.setattr(cli, "train_schedule", spy)
    assert cli.main(["train", "--smoke", "--device", "cpu", "--mesh", "1",
                     "--batch", "1", "--seq", "8", "--steps", "1",
                     "--lr", "1e-3", "--reorder", "none",
                     "--ckpt-dir", str(tmp_path)]) == 0
    assert calls == [(1e-3, 1)]
    port = cli_schedule(1e-3, 4)
    ref = ref_cosine_schedule(1e-3, 10, 4)
    got = [float(port(torch.tensor(i))) for i in range(4)]
    np.testing.assert_allclose(got, [0.0, 1e-4, 2e-4, 3e-4], rtol=1e-6)
    np.testing.assert_allclose(
        got, [float(ref(jnp.asarray(i))) for i in range(4)], rtol=1e-6)


def test_train_refuses_what_is_not_ported(tmp_path):
    import numpy as np

    from repro_torch.cli import build_parser, main

    args = build_parser().parse_args(["train"])
    assert args.smoke is False and args.device == "cuda"
    # the transport follows the device: peer_ring on CUDA, runner on the CPU
    assert args.reorder == "simulate" and not hasattr(args, "transport")
    with pytest.raises(NotImplementedError, match="item 13"):
        main(["train", "--smoke", "--device", "cpu", "--mesh", "2",
              "--reorder", "probe", "--ckpt-dir", str(tmp_path)])
    # a model axis runs the tensor-parallel ZeRO-1 step: the same losses
    # as the data-parallel step over as many ranks
    losses = {}
    for mesh in ("2x2", "4"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(["train", "--smoke", "--device", "cpu", "--mesh", mesh,
                         "--reorder", "none", "--batch", "4", "--seq", "16",
                         "--steps", "2", "--ckpt-dir",
                         str(tmp_path / mesh)]) == 0
        report = json.loads(out.getvalue().split("[train] report ")[1])
        losses[mesh] = report["losses"]
        assert (report["model"], report["dp"]) == \
            ((2, 2) if mesh == "2x2" else (1, 4))
    np.testing.assert_allclose(losses["2x2"], losses["4"], rtol=1e-5)
    # rwkv6 and the hybrid on a model axis name their items
    for arch, item in (("rwkv6-1.6b", "item 20"), ("recurrentgemma-9b", "item 21")):
        with pytest.raises(NotImplementedError, match=item):
            main(["train", "--arch", arch, "--smoke", "--device", "cpu",
                  "--mesh", "1x2", "--reorder", "none",
                  "--ckpt-dir", str(tmp_path)])
    # MoE trains (test_train_moe_over_the_ep_all_to_all, and where the data
    # axis does not divide the experts
    # test_train_moe_where_the_data_axis_does_not_divide_the_experts); MLA
    # on a model axis and an MoE arch on a pod axis name their items
    for arch, mesh, err, match in (
            ("deepseek-v2-236b", "2x2", NotImplementedError, "item 23"),
            ("dbrx-132b", "2x2x2", NotImplementedError, "item 24")):
        with pytest.raises(err, match=match):
            main(["train", "--arch", arch, "--smoke", "--device", "cpu",
                  "--mesh", mesh, "--batch", "8",
                  "--reorder", "none", "--ckpt-dir", str(tmp_path)])
    # Whisper's loss needs audio the synthetic batches do not carry
    with pytest.raises(NotImplementedError, match="frontend_embeds"):
        main(["train", "--arch", "whisper-small", "--smoke", "--device", "cpu",
              "--reorder", "none", "--ckpt-dir", str(tmp_path)])


def test_train_checks_the_smoke_config_it_runs(tmp_path):
    """``--smoke`` applies before any check reads the experts: the
    published dbrx's 16 split over 8 data ranks, the smoke one's 4 do
    not, so ``--mesh 8`` runs the data-parallel fallback (the check once
    read the published config, armed EP and died in ``EPTrainStep``)."""
    from repro_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["train", "--arch", "dbrx-132b", "--smoke", "--device",
                     "cpu", "--mesh", "8", "--batch", "8", "--seq", "4",
                     "--steps", "1", "--reorder", "none",
                     "--ckpt-dir", str(tmp_path)]) == 0
    text = out.getvalue()
    report = json.loads(text.split("[train] report ")[1].splitlines()[0])
    assert "4 experts do not split over the 8" in text
    assert "dense_moe" in report and "ep" not in report


def test_train_refuses_the_fallback_only_over_the_cards_memory(
        monkeypatch, capsys, tmp_path):
    """The data-parallel MoE step reckons its memory first (weights, f32
    moments, the ranks' gradient buffers and their mean, the gradients in
    flight); a card
    smaller than the reckoning refuses the run in words, before any
    weight is drawn; the CPU reckons and refuses nothing."""
    from repro_torch import cli
    from repro_torch.train import sharded_step

    argv = ["train", "--arch", "dbrx-132b", "--smoke", "--device", "cpu",
            "--mesh", "3", "--batch", "3", "--seq", "4", "--steps", "1",
            "--reorder", "none", "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(cli, "device_memory", lambda device: 10 ** 6)
    monkeypatch.setattr(sharded_step, "init_sharded_state", None)
    with pytest.raises(ValueError, match="reckoned at weights .* over the "
                                         "card's 1000000 bytes"):
        cli.main(argv)
    memory = json.loads(capsys.readouterr().out.split(
        "[train] memory ")[1].splitlines()[0])
    n = memory["params"]
    assert memory["card_bytes"] == 10 ** 6
    assert (memory["weights"], memory["moments"], memory["gradients"]) == \
        (4 * n, 8 * n, 3 * 4 * n)        # f32 smoke weights, 3 ranks
    # in flight: at least 3 ranks' gradients of the smoke experts (w1, w3
    # and w2 of [2 blocks, 4 experts, 64, 32] in f32)
    assert memory["in_flight"] >= 3 * 3 * (2 * 4 * 64 * 32) * 4
    assert memory["mean"] == 4 * n
    assert memory["total"] == sum(memory[k] for k in (
        "weights", "moments", "gradients", "mean", "in_flight"))


@functools.lru_cache(maxsize=None)
def _dense_moe_reference(lr: float):
    """The reference's smoke dbrx (4 experts, vocab 2048, as ``train
    --smoke``), its loss and gradient, and its AdamW step at ``train``'s
    schedule over one step, jitted once for every case below."""
    import dataclasses

    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import get_model as jax_get_model
    from repro.optim import AdamWConfig, apply_opt, cosine_schedule

    from repro_torch.cli import WARMUP_STEPS

    model = jax_get_model(dataclasses.replace(
        jax_get_config("dbrx-132b").smoke(), vocab_size=2048))
    opt = AdamWConfig(schedule=cosine_schedule(lr, WARMUP_STEPS, 1))
    return (model, jax.jit(jax.value_and_grad(model.loss)),
            jax.jit(functools.partial(apply_opt, opt)))


# the smoke dbrx (4 experts) where the data axis does not divide them
@pytest.mark.parametrize("mesh,batch", [("8", 8), ("3", 6), ("3x2", 6)])
def test_train_moe_where_the_data_axis_does_not_divide_the_experts(
        monkeypatch, tmp_path, mesh, batch):
    """The reference arms EP on any data axis, but its ``ep_armed`` is
    false where the axis does not divide the experts, and ``moe_layer``
    runs ``moe_dense`` on the global batch: so does the port's fallback.
    On the same weights on both sides (the port's seeded init, carried
    through ``params_from_jax``), the step-0 loss is
    the reference's ``DecoderLM`` loss on the global batch within 1e-5
    (the aux loss the global batch's, not a mean of the ranks'), and one
    step lands within 1e-5 of the reference's AdamW on the full-batch
    gradient; every leaf, the experts' included, goes through the
    reducer."""
    import jax
    import jax.numpy as jnp
    from repro.optim import init_opt as r_init_opt
    from repro.parallel import moe_a2a as R_a2a

    from repro_torch import cli
    from repro_torch.convert import params_from_jax
    from repro_torch.data import SyntheticLM, host_batch
    from repro_torch.parallel import moe_a2a
    from repro_torch.parallel.tensor import shard_params, unshard_params
    from repro_torch.train import sharded_step
    from repro_torch.tree import tree_leaves, tree_map

    lr, seq = 1e-3, 16
    rmodel, r_value_and_grad, r_apply_opt = _dense_moe_reference(lr)
    seen = {}
    real_init = sharded_step.init_sharded_state

    def whole(tree, layout):
        """A tree in model-axis storage, unsharded, as numpy."""
        if layout.m > 1:
            tree = unshard_params(tree, layout.pspecs)
        return tree_map(lambda t: t.detach().numpy().copy(), tree)

    def init_seen(model, gen, layout):
        state = real_init(model, gen, layout)
        seen["numpy"] = whole(state.params, layout)
        conv = shard_params(params_from_jax(seen["numpy"], model),
                            layout.pspecs, layout.m)
        for dst, src in zip(tree_leaves(state.params), tree_leaves(conv)):
            dst.copy_(src)
        seen["state"], seen["layout"] = state, layout
        return state

    monkeypatch.setattr(sharded_step, "init_sharded_state", init_seen)
    real_apply = sharded_step.DenseMoETrainStep.apply

    def apply_seen(self, state, grads):
        seen["grads"] = whole(grads, self.layout)
        return real_apply(self, state, grads)

    monkeypatch.setattr(sharded_step.DenseMoETrainStep, "apply", apply_seen)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["train", "--arch", "dbrx-132b", "--smoke", "--device",
                         "cpu", "--mesh", mesh, "--batch", str(batch), "--seq",
                         str(seq), "--steps", "1", "--lr", str(lr),
                         "--ckpt-dir", str(tmp_path)]) == 0
    text = out.getvalue()
    report = json.loads(text.split("[train] report ")[1].splitlines()[0])
    rparams = jax.tree.map(jnp.asarray, seen["numpy"])
    assert jax.tree.structure(rparams) == jax.tree.structure(
        jax.eval_shape(rmodel.init, jax.random.PRNGKey(0)))
    assert "EP cannot arm" in text and "ep" not in report
    assert (report["dp"], report["model"]) == \
        tuple(int(v) for v in (mesh + "x1").split("x")[:2])
    # every leaf's bytes go through the all-reduce
    assert report["dense_moe"]["all_reduce_bytes"] == sum(
        a.size * a.dtype.itemsize for a in jax.tree.leaves(rparams))
    assert moe_a2a._EP_STATE["mesh"] is None

    R_a2a.clear_ep()
    b = host_batch(SyntheticLM(rmodel.cfg.vocab_size, seq, batch, seed=0), 0)
    rbatch = {k: jnp.asarray(v) for k, v in b.items()}
    loss, grads = r_value_and_grad(rparams, rbatch)
    assert abs(report["losses"][0] - float(loss)) <= 1e-5, \
        (report["losses"][0], float(loss))
    # the mean gradient the reducer hands the update, every leaf
    for g, w in zip(jax.tree.leaves(seen["grads"]), jax.tree.leaves(grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-12)
    want, _, _ = r_apply_opt(rparams, grads, r_init_opt(rparams))
    got = whole(seen["state"].params, seen["layout"])
    moved = 0.0
    for g, w, p0 in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                        jax.tree.leaves(rparams)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
        moved = max(moved, float(np.abs(np.asarray(w) - np.asarray(p0)).max()))
    assert moved > 5e-5      # the step moves the weights past the tolerance
