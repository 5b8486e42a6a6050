"""repro_torch.bench — the benchmark scenarios the CLI's ``bench`` runs.

* :mod:`~repro_torch.bench.overlap_step` — ``bench --scenario overlap``:
  the planned, bucketed, overlapped data-parallel train step against the
  sequential one, modeled on a fabric and run on the virtual mesh (the
  counterpart of the reference's ``benchmarks/overlap_step.py``).

The ``plan``, ``faults`` and ``obs`` scenarios are host-only and live in
:mod:`repro_torch.cli`, as in the reference.
"""
