"""Planned meshes on the virtual mesh (counterpart of ``repro.launch.mesh``).

The reference permutes a JAX device array with a solved
:class:`~repro_torch.core.reorder.MeshPlan` before building its ``Mesh``:
the JAX form of feeding the paper's reordered IP list to an unmodified
backend.  The port's data-parallel ranks are virtual (the leading
dimension of one tensor on one device); virtual rank ``r`` stands for
node ``r`` of the planned fabric, as in the certified all-reduce's ring
order.  :class:`PlannedMesh` holds the flat order, the mesh shape and
axis names, and the device the ranks live on.  Mesh slot ``i`` (data
shard ``i``) is placed on rank ``order[i]``, as the reference's mesh
places it on device ``order[i]``: :meth:`PlannedMesh.batch_rows` is that
placement of a global batch's rows.

A plan without a mesh assignment raises; nothing falls back to an
unreordered mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np

__all__ = ["PlannedMesh", "make_mesh", "make_planned_mesh"]


@dataclasses.dataclass(frozen=True)
class PlannedMesh:
    """A rank order over a mesh shape, on one device."""

    #: flat rank order: mesh slot i is placed on virtual rank ``order[i]``
    order: Tuple[int, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: Any                      # torch.device

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


def make_planned_mesh(plan, device: Any = "cuda") -> PlannedMesh:
    """The mesh of a compiled :class:`~repro_torch.plan.Plan`: its solved
    ``MeshPlan``'s rank order (the paper's reordered IP list)."""
    from repro_torch import resolve_device

    mp = plan.mesh_plan
    if mp is None:
        raise ValueError("the plan was compiled without a mesh shape; "
                         "request one (SessionConfig.mesh.shape)")
    return PlannedMesh(order=tuple(int(i) for i in mp.flat),
                       shape=tuple(int(s) for s in mp.assignment.shape),
                       axis_names=tuple(mp.axis_names),
                       device=resolve_device(device))
