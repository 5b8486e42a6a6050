"""Planned meshes (counterpart of ``repro.launch.mesh``).

The reference permutes a JAX device array with a solved
:class:`~repro_torch.core.reorder.MeshPlan` before building its ``Mesh``:
the JAX form of feeding the paper's reordered IP list to an unmodified
backend.  :class:`PlannedMesh` holds the flat order, the mesh shape and
axis names, and the device the ranks live on.  Mesh slot ``i`` (data
shard ``i``) is placed on rank ``order[i]``, as the reference's mesh
places it on device ``order[i]``: :meth:`PlannedMesh.batch_rows` is that
placement of a global batch's rows.

The ranks are virtual by default: the leading dimension of one tensor on
one device, virtual rank ``r`` standing for node ``r`` of the planned
fabric, as in the certified all-reduce's ring order.  Given a
:mod:`torch.distributed` process group, :func:`make_planned_mesh` returns
a group-backed mesh instead: rank ``r`` is the process at group rank
``r``, so mesh slot ``i`` lives in the process at group rank
``order[i]`` (:attr:`PlannedMesh.slot` is the calling process's slot).
This placement is the only one: :mod:`repro_torch.kernels.group_runner`
runs schedule position ``i`` in the process that holds slot ``i``, as the
reference's ``shard_map`` runs it on the device at axis index ``i``.

The reference's production meshes have counterparts of the same names:
:func:`production_shape` (single-pod ``(data=16, model=16)``, multi-pod
``(pod=2, data=16, model=16)``), :func:`make_production_mesh` (the
identity order at that shape) and :func:`make_reordered_mesh` (a solved
``MeshPlan``'s order, the reference's ``devices[plan.flat]``).  Each is
metadata: a :class:`PlannedMesh` allocates nothing on its device.

A plan without a mesh assignment raises; nothing falls back to an
unreordered mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Sequence, Tuple

import numpy as np

__all__ = ["PlannedMesh", "make_mesh", "make_planned_mesh",
           "make_production_mesh", "make_reordered_mesh", "mesh_context",
           "production_shape"]


@dataclasses.dataclass(frozen=True)
class PlannedMesh:
    """A rank order over a mesh shape: virtual ranks on one device, or
    the processes of a group (``group``)."""

    #: flat rank order: mesh slot i is placed on rank ``order[i]``
    order: Tuple[int, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: Any                      # torch.device
    #: the torch.distributed group whose rank r is rank r (None: virtual)
    group: Any = None

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} needs one axis name "
                             f"per dim, got {self.axis_names}")
        if sorted(self.order) != list(range(int(np.prod(self.shape)))):
            raise ValueError(f"order {self.order} is not a permutation of "
                             f"the {int(np.prod(self.shape))} mesh slots")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def axis_size(self, axis: str) -> int:
        """The number of slots along ``axis``."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}; axes "
                             f"{self.axis_names}")
        return self.shape[self.axis_names.index(axis)]

    @property
    def slot(self) -> int:
        """The mesh slot placed on the calling process (group-backed
        meshes only): the ``i`` with ``order[i]`` its group rank."""
        if self.group is None:
            raise ValueError("a virtual mesh has no slot per process; pass "
                             "a group to make_planned_mesh")
        import torch.distributed as dist

        return self.order.index(dist.get_rank(self.group))

    def batch_rows(self, batch: int) -> np.ndarray:
        """A global batch's row indices in virtual-rank order.

        Data shard ``i`` (rows ``i * per`` to ``(i + 1) * per``, ``per =
        batch // size``) lies in mesh slot ``i``, which is placed on rank
        ``order[i]``; the train step gives rank ``r`` the ``r``-th block of
        ``per`` rows of what this returns.
        """
        if batch % self.size:
            raise ValueError(f"a batch of {batch} rows does not split over "
                             f"the {self.size} mesh slots")
        per = batch // self.size
        slot_of_rank = np.argsort(np.asarray(self.order))
        return (slot_of_rank[:, None] * per + np.arange(per)).reshape(-1)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: Any = "cuda") -> PlannedMesh:
    """The identity-order mesh (counterpart of ``make_mesh_for_tests``)."""
    from repro_torch import resolve_device

    n = int(np.prod(tuple(shape)))
    return PlannedMesh(order=tuple(range(n)), shape=tuple(int(s) for s in shape),
                       axis_names=tuple(axis_names),
                       device=resolve_device(device))


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production mesh's shape and axis names: ``(16, 16)`` over
    ``(data, model)``, or ``(2, 16, 16)`` over ``(pod, data, model)``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False,
                         device: Any = "cuda") -> PlannedMesh:
    """The production mesh in identity order, virtual ranks on ``device``
    (:meth:`repro_torch.session.Session.wrap` swaps in a planned order)."""
    return make_mesh(*production_shape(multi_pod), device)


def make_reordered_mesh(plan, device: Any = "cuda", group=None) -> PlannedMesh:
    """The mesh whose rank order is a solved
    :class:`~repro_torch.core.reorder.MeshPlan`'s: mesh slot ``i`` on rank
    ``plan.flat[i]``, at ``plan.assignment.shape`` (the paper's reordered
    IP list).  Virtual ranks on ``device``; with a process ``group``, slot
    ``i`` on the process at group rank ``plan.flat[i]``, and a group of
    another size than the plan raises, as the reference's device count
    must equal the plan's."""
    from repro_torch import resolve_device

    order = tuple(int(i) for i in np.asarray(plan.flat).reshape(-1))
    if group is not None:
        import torch.distributed as dist

        size = dist.get_world_size(group)
        if size != len(order):
            raise ValueError(f"the group has {size} processes, the planned "
                             f"mesh {len(order)} slots")
    return PlannedMesh(order=order,
                       shape=tuple(int(s) for s in plan.assignment.shape),
                       axis_names=tuple(plan.axis_names),
                       device=resolve_device(device), group=group)


def make_planned_mesh(plan, device: Any = "cuda", group=None) -> PlannedMesh:
    """The mesh of a compiled :class:`~repro_torch.plan.Plan`: its solved
    ``MeshPlan`` applied by :func:`make_reordered_mesh`.  A plan compiled
    without a mesh shape raises."""
    if plan.mesh_plan is None:
        raise ValueError("the plan was compiled without a mesh shape; "
                         "request one (SessionConfig.mesh.shape)")
    return make_reordered_mesh(plan.mesh_plan, device, group)


@contextlib.contextmanager
def mesh_context(mesh) -> Iterator[Any]:
    """The reference's ``mesh_context`` sets JAX's global mesh.  The port
    has none: every collective takes its mesh as an argument.  So this
    yields ``mesh`` and does nothing else."""
    yield mesh
