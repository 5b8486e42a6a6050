"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU fall-back."""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = []
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in filenames if f.endswith(".py"))
    return sorted(out) + [os.path.join(ROOT, "chip_smoke.py")]


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_repro():
    bad = [(os.path.relpath(p, ROOT), m) for p in _port_files()
           for m in _imported_roots(p)
           if m in ("jax", "jaxlib", "repro") or m.startswith("jax")]
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
    assert int(r.stdout.split("LOADED ")[1].split()[0]) >= 15


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
    assert get_model(cfg, device="cpu").device.type == "cpu"


def test_non_ssm_families_name_their_roadmap_item():
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model(get_config("qwen2-0.5b").smoke(), device="cpu")


def test_lazy_exports():
    import repro_torch

    assert repro_torch.get_config("rwkv6-1.6b").n_layers == 24
    assert repro_torch.default_device().type == "cuda"
    assert repro_torch.on_cuda() == torch.cuda.is_available()
    with pytest.raises(AttributeError):
        repro_torch.no_such_name  # noqa: B018
