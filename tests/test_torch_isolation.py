"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU fall-back."""

import ast
import functools
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = []
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in filenames if f.endswith(".py"))
    return sorted(out) + [os.path.join(ROOT, "chip_smoke.py")]


@functools.lru_cache(maxsize=None)
def _import_nodes(path):
    """The import statements of a file, parsed once for every test here."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    return tuple(node for node in ast.walk(tree)
                 if isinstance(node, (ast.Import, ast.ImportFrom)))


def _imported_roots(path):
    for node in _import_nodes(path):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_repro():
    bad = [(os.path.relpath(p, ROOT), m) for p in _port_files()
           for m in _imported_roots(p)
           if m in ("jax", "jaxlib", "repro", "benchmarks")
           or m.startswith("jax")]
    assert bad == []


def _imported_modules(path):
    """Full dotted names of what a file imports (``from a import b`` as
    ``a.b`` too)."""
    for node in _import_nodes(path):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_port_file_imports_dtensor():
    """The port's model axis runs certified schedules, never DTensor's
    c10d collectives: no file imports ``torch.distributed.tensor``."""
    bad = [(os.path.relpath(p, ROOT), m) for p in _port_files()
           for m in _imported_modules(p)
           if m == "torch.distributed.tensor"
           or m.startswith("torch.distributed.tensor.")
           or m.startswith("torch.distributed._tensor")]
    assert bad == []


def test_importing_every_module_loads_no_jax_or_repro():
    prog = (
        "import pkgutil, sys, importlib\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.__main__\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout
    assert int(r.stdout.split("LOADED ")[1].split()[0]) >= 80


# the session/trainer slice and the scan kernel: each a file of the port
# that imports neither JAX nor ``repro``, and loads in this process
NEW_MODULES = [
    "repro_torch.core.dynamic", "repro_torch.faults.health",
    "repro_torch.faults.retry", "repro_torch.faults.ladder",
    "repro_torch.fabric.sparse", "repro_torch.plan.cache",
    "repro_torch.plan.service", "repro_torch.session.config",
    "repro_torch.session.session", "repro_torch.launch.mesh",
    "repro_torch.launch.train", "repro_torch.checkpoint.ckpt",
    "repro_torch.train.trainer", "repro_torch.kernels.rwkv6_scan",
    "repro_torch.faults.inject", "repro_torch.obs.capture",
    "repro_torch.analysis.lint", "repro_torch.bench.overlap_step",
    "repro_torch.launch.hlo_analysis", "repro_torch.launch.serve",
    "repro_torch.launch.dryrun", "repro_torch.kernels.accounting",
]


@pytest.mark.parametrize("name", NEW_MODULES)
def test_session_and_trainer_modules_stand_alone(name):
    import importlib

    path = os.path.join(ROOT, "src", *name.split(".")) + ".py"
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert importlib.import_module(name).__doc__


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.cli import main
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("rwkv6-1.6b").smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["serve", "--smoke", "--batch", "1", "--prompt-len", "16",
              "--max-new", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "--smoke", "--steps", "1", "--mesh", "2"])
    from repro_torch.launch import make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((2,), ("data",))
    assert make_mesh((2,), ("data",), device="cpu").order == (0, 1)
    assert get_model(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ["deepseek-v2-236b"])
def test_non_ssm_families_name_their_roadmap_item(arch):
    """MoE, the last family to be ported, gives the port's decoder; what
    it still cannot do, ``train`` its MLA on a model axis, names its
    ROADMAP item."""
    from repro_torch.cli import main
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.transformer import DecoderLM

    model = get_model(get_config(arch).smoke(), device="cpu")
    assert type(model) is DecoderLM and model.cfg.use_mla and model.n_head == 1
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 23"):
        main(["train", "--arch", arch, "--smoke", "--device", "cpu",
              "--mesh", "2x2", "--reorder", "none"])


@pytest.mark.parametrize("arch,cls", [
    ("recurrentgemma-9b", "rglru.RecurrentGemmaLM"),
    ("whisper-small", "whisper.WhisperLM"),
    ("llava-next-mistral-7b", "transformer.DecoderLM"),
    ("dbrx-132b", "transformer.DecoderLM"),
    ("deepseek-v2-236b", "transformer.DecoderLM")])
def test_ported_families_give_the_port_model(arch, cls):
    """The hybrid, encdec, vlm and moe families give the port's model on
    the CPU."""
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    mod, name = cls.split(".")
    model = get_model(get_config(arch).smoke(), device="cpu")
    assert type(model) is getattr(
        importlib.import_module(f"repro_torch.models.{mod}"), name)
    assert model.device.type == "cpu" and model.cfg.name == arch + "-smoke"


def test_dense_family_gives_a_decoder_that_serves():
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serve import GenerationConfig, GenerationEngine

    model = get_model(get_config("qwen2-0.5b").smoke(), device="cpu")
    assert isinstance(model, DecoderLM) and model.device.type == "cpu"
    gen = torch.Generator()
    gen.manual_seed(0)
    eng = GenerationEngine(model, model.init(gen),
                           GenerationConfig(max_new_tokens=2, eos_token=-1))
    out = eng.generate([[1, 2, 3], [3, 2, 1]])
    assert len(out) == 2 and all(len(row) == 2 for row in out)
    assert all(0 <= t < model.cfg.vocab_size for row in out for t in row)


def test_bench_overlap_refuses_the_cpu_unless_asked(monkeypatch):
    """``bench --scenario overlap`` runs its train steps on CUDA: without
    it, it refuses before planning anything, unless ``--device cpu``."""
    from repro_torch.bench import overlap_step
    from repro_torch.cli import build_parser, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planned = []
    monkeypatch.setattr(overlap_step, "_plan_overlap",
                        lambda seed=0: planned.append(seed))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["bench", "--scenario", "overlap", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        overlap_step.run(smoke=True)
    assert planned == []
    args = build_parser().parse_args(["bench", "--scenario", "overlap"])
    assert args.device == "cuda" and args.out is None
    # the host-only scenarios need no device
    assert main(["analyze", "--program", "ring", "--nodes", "4"]) == 0


def test_lazy_exports():
    import repro_torch

    assert repro_torch.get_config("rwkv6-1.6b").n_layers == 24
    assert repro_torch.Session is __import__("repro_torch.session").session.Session
    assert repro_torch.SessionConfig().payload_bytes == 4e6
    assert repro_torch.Trainer.__name__ == "Trainer"
    assert repro_torch.TrainerConfig().total_steps == 100
    assert repro_torch.FaultSchedule.generate(4, ticks=2).horizon == 2
    assert issubclass(repro_torch.ProbeTimeout, TimeoutError)
    assert repro_torch.FaultyFabric.__module__ == "repro_torch.faults.inject"
    assert repro_torch.FaultEvent("node_join", 1).duration == 1
    assert repro_torch.__version__ == "0.3.0"
    assert repro_torch.default_device().type == "cuda"
    assert repro_torch.on_cuda() == torch.cuda.is_available()
    with pytest.raises(AttributeError):
        repro_torch.no_such_name  # noqa: B018
