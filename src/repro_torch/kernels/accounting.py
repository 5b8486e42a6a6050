"""The hand-written kernels' work and the runners' collectives, tallied
per call while a counter is open.

A kernel launched through ``ctypes`` is invisible to
:class:`torch.utils.flop_counter.FlopCounterMode` and to any
``TorchDispatchMode``: so each wrapper reports the ``(flops, bytes)`` of
its module's ``work()`` formula to every open :class:`KernelWork` where
it launches its kernel on the card, and where it stands in for it on
``meta`` tensors (the dry run, :mod:`repro_torch.launch.dryrun`): there
it returns empty outputs of the kernel's shapes and launches nothing.
A wrapper's plain version on CPU tensors reports nothing: its PyTorch
operations are what a counter sees there.

The virtual mesh's collective runners (the data axis's reducer and
ZeRO-1 all-gather, the model axis's
:class:`~repro_torch.parallel.tensor.TensorParallel`, the EP all-to-all)
report each call through :func:`collective`, as one rank's share: the
bytes of the result one rank of a real mesh would hold, under the name
the HLO gives the collective.

With no :class:`KernelWork` open, :func:`record` and :func:`collective`
cost one list test: the cost is a callable, evaluated only for a counter.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

__all__ = ["KernelWork", "collective", "counting", "record"]

_OPEN: List["KernelWork"] = []


class KernelWork:
    """A context that tallies, while it is open, the kernels' calls:
    ``flops`` and ``bytes`` (their ``work()``), ``calls`` by kernel; and
    the collectives one rank takes part in (:meth:`collectives`)."""

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.calls: Dict[str, int] = {}
        # (name, groups) -> [calls, bytes]: see :func:`collective`
        self._coll: Dict[Tuple[str, int], List[float]] = {}

    def __enter__(self) -> "KernelWork":
        _OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _OPEN.remove(self)

    def collectives(self) -> Dict[str, Tuple[int, float]]:
        """``{hlo name: (calls, bytes)}`` of one rank: the calls made for
        ``groups`` groups one after another divided by ``groups``.  Exact
        where each group makes the same calls; in one autograd graph over
        the groups (the MoE steps), a checkpoint's recompute stops once it
        has what the backward needs, which can leave out the last group's
        last call, so the calls are rounded down there and the bytes
        averaged."""
        out: Dict[str, List[float]] = {}
        for (name, groups), (calls, nbytes) in self._coll.items():
            row = out.setdefault(name, [0, 0.0])
            row[0] += calls // groups
            row[1] += nbytes / groups
        return {k: (int(c), float(b)) for k, (c, b) in out.items()}


def counting() -> bool:
    """A :class:`KernelWork` is open."""
    return bool(_OPEN)


def record(name: str, cost: Callable[[], Tuple[int, int]]) -> None:
    """One call of kernel ``name``; ``cost()`` gives its ``(flops,
    bytes)``, added to every open :class:`KernelWork`."""
    if not _OPEN:
        return
    flops, nbytes = cost()
    for w in _OPEN:
        w.flops += int(flops)
        w.bytes += int(nbytes)
        w.calls[name] = w.calls.get(name, 0) + 1


def collective(name: str, cost: Callable[[], float], groups: int = 1) -> None:
    """One call of collective ``name`` (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``) on the virtual mesh; ``cost()``
    gives the bytes of one rank's result.  ``groups``: the groups of
    ranks that make their calls one after another on the virtual mesh
    (the data-parallel groups of a model axis), of which a rank sees
    one; a call that covers every rank at once has ``groups=1``."""
    if not _OPEN:
        return
    nbytes = float(cost())
    for w in _OPEN:
        row = w._coll.setdefault((name, int(groups)), [0, 0.0])
        row[0] += 1
        row[1] += nbytes
