"""Launchers and mesh builders (counterpart of ``repro.launch``).

New code goes through :class:`repro_torch.session.Session` (or ``python
-m repro_torch train/serve``); the modules here are the mechanical layer
the session drives:

* :mod:`.mesh` — the production, reordered and planned meshes, virtual
  or group-backed, and ``mesh_context``;
* :mod:`.train` — ``build_mesh`` and the planning session; :mod:`.train`
  and :mod:`.serve` keep the reference's deprecated shims
  (``default_job_mix``, ``serve_job_mix`` and their ``main``);
* :mod:`.hlo_analysis` — collective accounting from HLO text and the
  roofline terms at an H100's datasheet rates;
* :mod:`.specs` — the cells' sharded stand-ins, ``configure_sp`` and
  ``input_specs``;
* :mod:`.dryrun` — the dry run of every (arch x shape) cell on the
  production meshes, counted on ``meta`` tensors (``python -m
  repro_torch.launch.dryrun``, ROADMAP.md §1 item 15b).

Submodules import lazily, as the reference's
do; a name re-exported here is looked up in its module at each access,
so :meth:`Session.wrap <repro_torch.session.Session.wrap>`'s patches
reach it.
"""

from importlib import import_module

_SUBMODULES = ("dryrun", "hlo_analysis", "mesh", "serve", "specs", "train")

#: names re-exported from a submodule, resolved at each access
_NAMES = {
    "PlannedMesh": "mesh", "make_mesh": "mesh", "make_planned_mesh": "mesh",
    "make_production_mesh": "mesh", "make_reordered_mesh": "mesh",
    "mesh_context": "mesh", "production_shape": "mesh",
    "apply_planned": "train", "build_mesh": "train", "parse_mesh": "train",
    "planning_session": "train",
}

__all__ = list(_SUBMODULES) + sorted(_NAMES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return import_module(f"{__name__}.{name}")
    if name in _NAMES:
        return getattr(import_module(f"{__name__}.{_NAMES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
