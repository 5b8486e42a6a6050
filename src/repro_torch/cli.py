"""``python -m repro_torch serve``: batched generation with the port.

Counterpart of ``repro serve`` (``repro/cli.py`` ``cmd_serve``) on one
device without a collective plan::

    python -m repro_torch serve --arch rwkv6-1.6b --wkv-impl kernel \\
        --batch 8 --prompt-len 512 --max-new 32

Runs on CUDA unless ``--device cpu`` is given; ``--smoke`` picks the
reduced same-family config.  Weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

__all__ = ["main"]


def cmd_serve(args: argparse.Namespace) -> int:
    import torch

    from repro_torch import obs, resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, GenerationEngine

    device = resolve_device(args.device)
    arch = get_config(args.arch)
    if args.smoke:
        arch = arch.smoke()
    arch = dataclasses.replace(arch, wkv_impl=args.wkv_impl)
    model = get_model(arch, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)

    prompts = [
        [(11 * i + j) % arch.vocab_size for j in range(args.prompt_len)]
        for i in range(args.batch)
    ]
    eng = GenerationEngine(
        model, params,
        GenerationConfig(max_new_tokens=args.max_new, eos_token=-1))
    timer = obs.tracer().timer("cli.serve.generate", batch=args.batch)
    with timer:
        outs = eng.generate(prompts)    # ends on a host copy: synchronised
    dt = max(timer.elapsed, 1e-9)
    total = sum(len(o) for o in outs)
    print(f"[serve] arch={arch.name} {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch",
                                 description="PyTorch/CUDA port of repro")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("serve", help="batched generation on one device")
    p.add_argument("--arch", default="rwkv6-1.6b")
    p.add_argument("--wkv-impl", choices=["xla", "kernel"], default="kernel",
                   help="kernel: chunked CUDA WKV kernel for the prefill; "
                        "xla: the exact recurrence (the reference's name)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--smoke", action="store_true",
                   help="the reduced same-family config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--seed", type=int, default=0, help="weight seed")
    p.set_defaults(fn=cmd_serve)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
