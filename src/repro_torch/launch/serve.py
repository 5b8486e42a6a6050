"""The serving launcher's deprecated shim (counterpart of
``repro.launch.serve``).

The serving entry point is the CLI::

    python -m repro_torch serve --arch dbrx-132b --mesh 4
    python -m repro_torch serve --arch rwkv6-1.6b --batch 8 --max-new 64

``python -m repro_torch.launch.serve`` still works (delegating there),
and :func:`serve_job_mix` remains as a deprecated alias of
:func:`repro_torch.session.serve_mix`.

:func:`serve_arch`, :func:`serve_layout` and :func:`serving_layout` are
what ``serve`` runs an arch as on a mesh; ``serve`` and the dry run
(:mod:`repro_torch.launch.dryrun`) both use them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Dict, Iterator, Sequence

#: ``serve``'s attention and WKV paths unless a flag picks others
SERVE_ATTENTION_IMPL = "flash"
SERVE_WKV_IMPL = "kernel"


def serve_arch(arch, attention_impl: str = SERVE_ATTENTION_IMPL,
               wkv_impl: str = SERVE_WKV_IMPL):
    """``arch`` with the attention and WKV paths ``serve`` runs."""
    return dataclasses.replace(arch, wkv_impl=wkv_impl,
                               attention_impl=attention_impl)


def serve_layout(arch, shape: Sequence[int], axes: Sequence[str]
                 ) -> Dict[str, Any]:
    """The layout ``serve`` runs ``arch`` in on a mesh of ``shape`` over
    ``axes``: ``{"ep_armed": bool, "model_axis": int}``.  The weights and
    caches are whole on every rank (a model axis shards nothing yet,
    ROADMAP.md §1 item 22); an MoE arch on a data axis of 2 or more ranks
    runs its prompts' experts through the EP all-to-all.  Raises what
    ``serve`` refuses: an MoE arch with both a data axis and a model axis
    (item 22), whose EP layer would split rows over a model axis the
    replicated forward does not shard."""
    sizes = dict(zip(axes, shape))
    armed = bool(arch.n_experts) and sizes.get("data", 1) > 1
    if armed and sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"serve {arch.name} ({arch.family!r}) on a model axis: the EP "
            f"all-to-all under a model axis needs the tensor-parallel "
            f"serving forward, ROADMAP.md §1 item 22")
    return {"ep_armed": armed, "model_axis": sizes.get("model", 1)}


@contextlib.contextmanager
def serving_layout(arch, mesh, plan=None) -> Iterator[Dict[str, Any]]:
    """:func:`serve_layout` on ``mesh`` for the ``with`` block: the EP half
    of the reference's ``configure_sp`` armed where it runs, in ``plan``'s
    all-to-all order, and cleared on exit."""
    from repro_torch.parallel.moe_a2a import arm_ep, clear_ep

    lay = serve_layout(arch, mesh.shape, mesh.axis_names)
    if lay["ep_armed"]:
        arm_ep(mesh, "data", None, plan=plan)
    try:
        yield lay
    finally:
        if lay["ep_armed"]:
            clear_ep()


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
