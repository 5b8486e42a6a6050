"""Flow and the group-size checks the collective builders use.

A copy of the part of ``repro.core.schedule`` that the port's collective
IR needs: the node-space :class:`Flow` that ``Program.to_flows`` emits,
and the power-of-two / power-of-base checks of the builders.  The legacy
free builders and the ``SCHEDULES`` shim stay in the reference.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Flow"]


@dataclasses.dataclass(frozen=True)
class Flow:
    src: int
    dst: int
    size: float  # bytes


def _require_power_of_two(n: int, algo: str) -> None:
    if n < 1 or n & (n - 1) != 0:
        raise ValueError(
            f"{algo} requires a power-of-two world size, got n={n}; "
            "fall back to 'ring' (valid for any n) or pad/split the group"
        )


def _require_power_of_base(n: int, base: int, algo: str) -> int:
    """Validate n == base**k (k >= 0) and return the number of rounds k."""
    if base < 2:
        raise ValueError(f"{algo} requires base >= 2, got base={base}")
    n_rounds, m = 0, 1
    while m < n:
        m *= base
        n_rounds += 1
    if m != n:
        raise ValueError(
            f"{algo} requires world size a power of its base "
            f"({n} is not a power of {base}); fall back to 'ring' "
            "(valid for any n) or choose a base b with n == b**k"
        )
    return n_rounds
