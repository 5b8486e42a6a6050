"""The serving launcher's deprecated shim (counterpart of
``repro.launch.serve``).

The serving entry point is the CLI::

    python -m repro_torch serve --arch dbrx-132b --mesh 4
    python -m repro_torch serve --arch rwkv6-1.6b --batch 8 --max-new 64

``python -m repro_torch.launch.serve`` still works (delegating there),
and :func:`serve_job_mix` remains as a deprecated alias of
:func:`repro_torch.session.serve_mix`.
"""

from __future__ import annotations

import warnings


def serve_job_mix(payload_bytes: float, moe: bool = False):
    """Deprecated: use :func:`repro_torch.session.serve_mix`."""
    warnings.warn(
        "repro_torch.launch.serve.serve_job_mix is deprecated; use "
        "repro_torch.session.serve_mix", DeprecationWarning, stacklevel=2)
    from repro_torch.session import serve_mix

    return serve_mix(payload_bytes, moe=moe)


def main() -> None:
    """Deprecated entry point: delegates to ``python -m repro_torch serve``."""
    import sys

    warnings.warn(
        "python -m repro_torch.launch.serve is deprecated; use "
        "`python -m repro_torch serve`", DeprecationWarning, stacklevel=2)
    from repro_torch.cli import main as cli_main

    raise SystemExit(cli_main(["serve", *sys.argv[1:]]))


if __name__ == "__main__":
    main()
