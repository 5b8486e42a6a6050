"""``python -m repro_torch serve`` on the CPU (smoke config)."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serve_module_entry_point_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "serve", "--smoke", "--device", "cpu",
         "--batch", "2", "--prompt-len", "16", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[serve] arch=rwkv6-1.6b-smoke 8 tokens in" in r.stdout


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_serve_in_process(capsys, impl):
    from repro_torch.cli import main

    assert main(["serve", "--smoke", "--device", "cpu", "--wkv-impl", impl,
                 "--batch", "1", "--prompt-len", "32", "--max-new", "2"]) == 0
    assert "[serve] arch=rwkv6-1.6b-smoke 2 tokens" in capsys.readouterr().out


def test_smoke_is_off_by_default():
    from repro_torch.cli import build_parser

    args = build_parser().parse_args(["serve"])
    assert args.smoke is False and args.device == "cuda"
    assert build_parser().parse_args(["serve", "--smoke"]).smoke is True
