"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``).

For every (architecture x input shape) cell this module:

1. builds the production mesh, ``(16, 16)`` single-pod or ``(2, 16, 16)``
   multi-pod (:func:`repro_torch.launch.mesh.make_production_mesh`, virtual
   ranks, nothing allocated);
2. builds the step the port's command runs for the cell on that mesh:
   ``train``'s (:func:`repro_torch.launch.train.build_train_step`: the
   tensor-parallel ZeRO-1 step, the EP step, ...) or ``serve``'s prefill or
   decode step (:func:`repro_torch.launch.serve.serving_layout`), and
   raises the refusals those commands raise, which make the cell a
   ``skip`` naming its ROADMAP item;
3. runs that step once on ``meta`` tensors at full depth and width: every
   layer executes in Python, so nothing is undercounted, and no byte is
   allocated on any device.  It counts what runs:

   * FLOPs: :class:`torch.utils.flop_counter.FlopCounterMode` (matmuls,
     convolutions and attention products; elementwise operations count
     nothing) plus each hand-written kernel's ``work()``, which its wrapper
     reports on ``meta`` (:mod:`repro_torch.kernels.accounting`);
   * bytes accessed: a ``TorchDispatchMode`` (:class:`MetaCounter`) adds,
     for every aten operation, the bytes of its tensor inputs and outputs;
     views, metadata and allocations count zero, and so do the schedule
     runner's link gathers (:func:`~repro_torch.kernels.schedule_runner.
     in_links`), whose traffic is the collectives' (the runner's local
     copies, seeding its state and landing each round, count as any
     operation does).  The count is per operation, with no fusion, so it
     exceeds what XLA counts after fusing;
   * collectives, under the HLO names, as the port's own runners report
     them (:func:`repro_torch.kernels.accounting.collective`): the data
     axis's reducer (a bucket each) and ZeRO-1 all-gather, the
     :class:`~repro_torch.parallel.tensor.TensorParallel` model axis, and
     the EP all-to-all; each call as one rank's result bytes, as
     ``parse_collectives`` counts them, and the calls one rank takes part
     in (a model axis's calls for each data-parallel group, which run
     one after another, once);
   * memory: :class:`MetaCounter` tracks every storage the step makes
     (``weakref`` finalizers on its storages) and keeps the peak.

4. derives the three roofline terms at the H100's rates
   (:class:`~repro_torch.launch.hlo_analysis.HW`) and writes one JSON per
   cell under ``--out``.

Per-device numbers are what one rank of the port holds, computes and
sends under the layout the port's command runs:

* ``cost_analysis_raw``: a train cell's virtual mesh runs every rank's
  work, so its counts are divided by the ``n`` ranks; a computation the
  specs leave replicated is held once on the virtual mesh and is spread
  over the ranks too (a rank of a real mesh would compute it whole).  A
  serving cell runs as ``serve`` does, weights and caches whole on every
  rank (ROADMAP.md §1 item 22), so one rank's count is the whole count.
* ``collectives``: the runners report one rank's calls and bytes
  (above), so nothing is divided.
* ``memory.argument_bytes``: one rank's share of the state and batch the
  step takes, read from the step's per-rank views (rank 0's shards,
  ZeRO-1 slices and experts); exact.  ``output_bytes`` and
  ``alias_bytes`` likewise (an output on an argument's storage, as the EP
  step's in-place update, is aliased).
* ``memory.temp_bytes``: the peak of the storage the step makes beyond its
  outputs, from the virtual mesh's run, divided by the ranks that run at
  once: the model axis for the tensor-parallel step (its data-parallel
  ranks run one after another), every rank for the one-graph MoE steps,
  one for the data-parallel step and for serving.  Exact on one rank
  (``temp_bytes_total`` is the undivided peak); on a mesh an estimate:
  the tensor-parallel step's stacked ``[dp, ...]`` gradients are divided
  by ``m``, not ``n``, so it is an upper bound there.  ``live =
  argument + output - alias + temp`` is then the peak a rank holds while
  the caller keeps its arguments.

The departures from the reference, each in ROADMAP.md §3: ``fits_16GB``
(a TPU's memory) is :data:`fits_hbm` against ``HW().hbm_per_chip``;
``lower_s``/``compile_s`` are ``trace_s``, the meta run's wall time; bytes
are counted without fusion; serving cells on a model axis run replicated
(``model_axis``); and the cells the port refuses are ``skip``.  The depth
difference keeps the reference's semantics and keys (depths 1 and 2 at
full width, extrapolated); here it is a cheap estimate that the full-depth
count checks, and the roofline's ``source`` says which fed it.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all                # 16x16 + 2x16x16
    python -m repro_torch.launch.dryrun --all --multi-pod-only
    python -m repro_torch.launch.dryrun --all --jobs 8 --table  # in 8 processes
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import re
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import obs
from repro_torch.kernels.schedule_runner import in_links

__all__ = ["MetaCounter", "account", "cell_record", "cell_status",
           "cell_step", "count_step", "main", "measure_cell", "run_cell"]

#: operations that move no bytes: allocations and metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "detach", "alias",
         "lift_fresh", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset"}


def _cfg_overrides(cfg, overrides: Dict[str, Any]):
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _key(x):
    """A hashable stand-in for an argument: a tensor by its metadata."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    hash(x)
    return x


class MetaCounter(TorchDispatchMode):
    """Bytes accessed and live storage of every aten operation run under
    it.

    ``bytes``: each operation's tensor inputs and outputs, once each;
    views (``OpOverload.is_view``), allocations, metadata and the
    schedule runner's link gathers count zero.
    ``live``/``peak``: the bytes of the storages made under the mode that
    are still alive (a ``weakref`` finalizer on each storage), and their
    most; a tensor made before the mode (an argument) is not counted.

    On ``meta`` tensors an operation that returns new tensors is looked up
    by its arguments' metadata: its first run's output shapes, strides and
    dtypes serve every later call with the same metadata (a meta kernel's
    output depends on nothing else), which spares the Python meta kernels
    of elementwise operations the repeated layers and ranks would run.
    """

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        self._cache: Dict[Any, Any] = {}
        self._kinds: Dict[Any, str] = {}

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _kind(self, func) -> str:
        """``view`` (no bytes, no storage), ``free`` (no bytes), ``fresh``
        (a functional operation: its outputs are new tensors) or ``op``."""
        kind = self._kinds.get(func)
        if kind is None:
            schema = func._schema
            if func.is_view:
                kind = "view"
            elif func.overloadpacket.__name__ in _FREE:
                kind = "free"
            elif schema.is_mutable or any(r.alias_info is not None
                                          for r in schema.returns):
                kind = "op"
            else:
                kind = "fresh"
            self._kinds[func] = kind
        return kind

    def _fresh(self, func, args, kwargs, ins):
        """A functional operation's output on meta tensors, from the cache
        of output metadata where its arguments' metadata was seen."""
        if not ins or any(t.device.type != "meta" for t in ins):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        meta = self._cache.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if all(isinstance(o, torch.Tensor) for o in outs):
                self._cache[key] = (isinstance(out, (tuple, list)), [
                    (tuple(o.shape), o.stride(), o.dtype) for o in outs])
            return out
        many, specs = meta
        outs = [torch.empty_strided(s, st, dtype=d, device="meta")
                for s, st, d in specs]
        return tuple(outs) if many else outs[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kind(func)
        if kind == "view":
            return func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs) if kwargs else _tensors(args)
        if kind == "fresh":
            out = self._fresh(func, args, kwargs, ins)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if kind != "free" and not in_links():
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        if kind != "fresh":
            # an in-place or aliasing output lies on an input's storage
            held = {t.untyped_storage()._cdata for t in ins}
            outs = [t for t in outs if t.untyped_storage()._cdata not in held]
        self._track(outs)
        return out


@dataclasses.dataclass
class Count:
    """One run of a step under the counters."""

    flops: int            # FlopCounterMode's and the kernels' work()
    kernel_flops: int     # the kernels' work() alone
    bytes: int            # MetaCounter's and the kernels' work()
    peak_new: int         # the most bytes of storage made by the step
    kernel_calls: Dict[str, int]
    coll: Dict[str, Any]  # one rank's collectives, by HLO name
    trace_s: float
    out: Any


def count_step(fn, *args) -> Count:
    """Run ``fn(*args)`` once under :class:`FlopCounterMode`,
    :class:`MetaCounter` and a :class:`~repro_torch.kernels.accounting.
    KernelWork`, on whatever device its tensors are on (``meta`` for the
    dry run; the card, for the anchor that holds a real run to it)."""
    from repro_torch.kernels.accounting import KernelWork

    t0 = time.perf_counter()
    with KernelWork() as kw, MetaCounter() as mc, \
            FlopCounterMode(display=False) as fc:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    coll = kw.collectives()
    return Count(flops=int(fc.get_total_flops()) + kw.flops,
                 kernel_flops=kw.flops, bytes=mc.bytes + kw.bytes,
                 peak_new=mc.peak, kernel_calls=dict(kw.calls),
                 coll={"bytes_by_type": {k: b for k, (_, b) in coll.items()},
                       "count_by_type": {k: c for k, (c, _) in coll.items()},
                       "total_bytes": float(sum(b for _, b in coll.values()))},
                 trace_s=trace_s, out=out)


# ---------------------------------------------------------------------------
# one rank's share of a step's tensors
# ---------------------------------------------------------------------------

def _rank_state_bytes(build, state, keep=None) -> int:
    """Rank 0's view of a train state: its model-axis shard of a sharded
    leaf, its ZeRO-1 slice of the moments, its ``E/d`` experts under EP;
    a replicated leaf whole.  ``keep(leaf)`` picks the leaves counted."""
    from repro_torch.parallel.tensor import model_dim
    from repro_torch.tree import tree_leaves

    sh = build.sharded
    keep = keep or (lambda t: True)
    leaves = tree_leaves(state.params)
    moms = (tree_leaves(state.opt.m), tree_leaves(state.opt.v))
    total = sum(_nbytes(t) for t in (state.opt.count, state.step) if keep(t))
    if sh is not None:
        specs = tree_leaves(sh.layout.pspecs)
        expert = getattr(sh, "expert", [False] * len(leaves))
        m, d = sh.layout.m, sh.layout.dp

    def view(t, i, moment):
        if sh is None:
            return t
        if moment and sh.layout.zdims[i] is not None:
            t = t[0]                          # rank 0's ZeRO-1 slice
        elif expert[i]:
            t = sh._experts_of(t, 0, d)       # its E/d experts
        split = model_dim(specs[i]) is not None and m > 1
        return t[0] if split else t           # its model-axis shard

    for i, p in enumerate(leaves):
        for t, moment in ((p, False), (moms[0][i], True), (moms[1][i], True)):
            if keep(t):
                total += _nbytes(view(t, i, moment))
    return total


def _rank_batch_bytes(build, batch) -> int:
    """A rank's rows: ``[n, rows, S]`` of a sharded step's global batch,
    the host batch's ``1/n`` otherwise."""
    n = build.layout["n"]
    return sum(_nbytes(v[0]) if build.global_batch else _nbytes(v) // n
               for v in batch.values())


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

def cell_step(cfg, shape, mesh, device: Any = "cuda",
              generator: Optional[torch.Generator] = None):
    """The step a cell runs and its inputs: ``(fn, args, build)``.

    A train cell runs :func:`~repro_torch.launch.train.build_train_step`'s
    step (``build`` its :class:`~repro_torch.launch.train.TrainBuild`); a
    prefill or decode cell runs ``serve``'s arch (:func:`~repro_torch.
    launch.serve.serve_arch`) on the reference's inputs (``build`` None,
    the caller arming :func:`~repro_torch.launch.serve.serving_layout`).
    With no ``generator`` every tensor is on ``meta`` and nothing is drawn;
    with one, the model is on ``device``, its weights drawn from the
    generator, the tokens too (the anchor that holds a real step to the
    count).  A train cell's SP/EP contexts are armed: the caller clears
    them."""
    from repro_torch.launch.specs import _meta_model, input_specs
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import get_model

    real = generator is not None
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        model = get_model(cfg, device=device) if real else _meta_model(cfg)
        build = build_train_step(cfg, mesh, device, model=model)
        rows = ((mesh.size, B // build.layout["dp"], S) if build.global_batch
                else (B, S))
        batch = {k: _tokens(rows, cfg.vocab_size, model.device, generator)
                 for k in ("tokens", "labels")}
        return build.step, (build.state(generator), batch), build

    from repro_torch.launch.serve import serve_arch

    cfg = serve_arch(cfg)
    args = tuple(_unspec(a) for a in input_specs(cfg, shape, mesh))
    if real:
        model = get_model(cfg, device=device)
        params = model.init(generator)
        tokens = _tokens(args[1].shape, cfg.vocab_size, model.device,
                         generator)
        if shape.kind == "prefill":
            args = (params, tokens) + tuple(
                torch.ones(a.shape, dtype=a.dtype, device=model.device)
                for a in args[2:])
        else:
            args = (params, tokens, model.init_cache(B, S))
    else:
        model = _meta_model(cfg)
    if shape.kind == "prefill":
        return model.prefill, args, None
    return model.decode_step, args, None


def _tokens(shape, vocab: int, device, generator):
    """Token ids: random from ``generator`` on ``device``, else on meta."""
    if generator is None:
        return torch.empty(tuple(shape), dtype=torch.int32, device="meta")
    return torch.randint(0, vocab, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.int32
                         ).to(device)


def account(fn, args, build, shape) -> Dict[str, Any]:
    """Run a cell's step once under :func:`count_step` and read one rank's
    share of its inputs and outputs, its collectives and its peak (the
    module docstring): the same accounting on ``meta`` and on a device."""
    c = count_step(fn, *args)
    argset = {t.untyped_storage()._cdata for t in _tensors(args)}

    def aliased(t):
        return t.untyped_storage()._cdata in argset

    if build is not None:
        state, batch = args
        new_state, _metrics = c.out
        lay = build.layout
        arg = _rank_state_bytes(build, state) + _rank_batch_bytes(build, batch)
        out = _rank_state_bytes(build, new_state)
        alias = _rank_state_bytes(build, new_state, aliased)
        outs = _tensors(new_state)
        div = lay["n"]
        width = {"tensor_parallel": lay["m"], "ep": lay["n"],
                 "dense_moe": lay["n"]}.get(build.kind, 1)
        kind = build.kind
    else:
        outs = _tensors(c.out)
        arg = sum(_nbytes(t) for t in _tensors(args))
        out = sum(_nbytes(t) for t in outs)
        alias = sum(_nbytes(t) for t in outs if aliased(t))
        div, width, kind = 1, 1, shape.kind
    new_total = sum(_nbytes(t) for t in outs if not aliased(t))
    arg_total = sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                     for t in _tensors(args)}.values())
    return {"kind_of_step": kind, "count": c, "div": div, "temp_div": width,
            "arg": arg, "out": out, "alias": alias, "arg_total": arg_total,
            "out_new_total": new_total, "coll": c.coll}


def measure_cell(cfg, shape, mesh, device: Any = "cuda",
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, Any]:
    """:func:`cell_step` then :func:`account`, in the layout the port's
    command runs the cell in (the SP/EP contexts armed for the run and
    cleared after).  The EP layer's routing tallies (``ep_stats``) are the
    caller's again afterwards: the run's own, on ``meta`` or on another
    device than the caller's, are dropped."""
    from repro_torch.launch.serve import serving_layout
    from repro_torch.models.layers import clear_sequence_parallel
    from repro_torch.parallel import moe_a2a

    stats = dict(moe_a2a._STATS)
    moe_a2a.reset_ep_stats()
    try:
        fn, args, build = cell_step(cfg, shape, mesh, device, generator)
        if build is not None:
            return account(fn, args, build, shape)
        with serving_layout(cfg, mesh):
            return account(fn, args, build, shape)
    finally:
        moe_a2a.clear_ep()
        clear_sequence_parallel()
        moe_a2a.reset_ep_stats()
        moe_a2a._STATS.update(stats)


def _unspec(tree):
    """:func:`~repro_torch.launch.specs.input_specs`' stand-ins as their
    meta tensors."""
    from repro_torch.launch.specs import MetaSpec

    if isinstance(tree, MetaSpec):
        return tree.tensor
    if isinstance(tree, dict):
        return {k: _unspec(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_unspec(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unspec(v) for v in tree)
    return tree


def _refusal(cfg, shape, mesh) -> Optional[str]:
    """The words ``train`` or ``serve`` refuses the cell in, or None."""
    from repro_torch.launch.serve import serve_layout
    from repro_torch.launch.train import train_layout

    layout = train_layout if shape.kind == "train" else serve_layout
    try:
        layout(cfg, mesh.shape, mesh.axis_names)
    except NotImplementedError as e:
        return str(e)
    return None


def cell_status(arch: str, shape_name: str, multi_pod: bool = False,
                overrides: Optional[Dict[str, Any]] = None
                ) -> Tuple[str, str]:
    """``("ok" | "skip", reason)`` of a cell, without running it: the
    reference's ``shape_applicable``, then ``train``'s or ``serve``'s
    refusals."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch.mesh import make_production_mesh

    cfg = _cfg_overrides(get_config(arch), overrides or {})
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return "skip", why
    why = _refusal(cfg, shape, make_production_mesh(multi_pod=multi_pod,
                                                    device="cpu"))
    return ("skip", why) if why else ("ok", "")


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    do_diff: bool = True,
    overrides: Optional[Dict[str, Any]] = None,
    verbose: bool = True,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """One cell's record on the production mesh (the module docstring);
    ``device`` names the card the kernels would run on (the data axis's
    transport), which allocates nothing."""
    from repro_torch import resolve_device
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch.mesh import make_production_mesh

    cfg = _cfg_overrides(get_config(arch), overrides or {})
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind,
    }
    if not ok:
        rec.update(status="skip", reason=why)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name}: SKIP ({why})")
        return rec
    device = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    return cell_record(cfg, shape, mesh, device, do_diff, verbose, rec)


def cell_record(cfg, shape, mesh, device: Any = "cuda", do_diff: bool = True,
                verbose: bool = True,
                rec: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The record of ``cfg`` at ``shape`` on ``mesh`` (:func:`run_cell`
    past its skip by shape): ``skip`` where the port's command refuses
    the cell, else the counts of one meta run of its step."""
    from repro_torch.launch import hlo_analysis as ha

    rec = rec if rec is not None else {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(str(d) for d in mesh.shape), "kind": shape.kind}
    arch, shape_name = rec["arch"], rec["shape"]
    why = _refusal(cfg, shape, mesh)
    if why:
        rec.update(status="skip", reason=why)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} mesh={rec['mesh']}: "
                  f"SKIP ({why})")
        return rec
    n_chips = mesh.size
    timer = obs.tracer().timer("dryrun.trace", arch=arch, shape=shape_name)
    with timer:
        got = measure_cell(cfg, shape, mesh, device)
    c = got["count"]
    div = got["div"]
    temp_total = max(c.peak_new - got["out_new_total"], 0)
    mem = {
        "argument_bytes": int(got["arg"]),
        "output_bytes": int(got["out"]),
        "temp_bytes": int(temp_total // got["temp_div"]),
        "alias_bytes": int(got["alias"]),
        "code_bytes": 0,
        "temp_bytes_total": int(temp_total),
        "temp_divisor": int(got["temp_div"]),
        "argument_bytes_total": int(got["arg_total"]),
        "step_peak_bytes_total": int(c.peak_new),
    }
    live = (mem["argument_bytes"] + mem["output_bytes"]
            - mem["alias_bytes"] + mem["temp_bytes"])
    mem["live_bytes_per_device"] = int(live)
    mem["fits_hbm"] = bool(live < ha.HW().hbm_per_chip)
    per_dev_coll = got["coll"]
    rec.update(
        status="ok",
        n_chips=n_chips,
        step=got["kind_of_step"],
        trace_s=round(c.trace_s, 2),
        memory=mem,
        cost_analysis_raw={"flops": c.flops / div,
                           "bytes_accessed": c.bytes / div},
        kernels={"flops": c.kernel_flops / div, "calls": c.kernel_calls},
        collectives=per_dev_coll,
    )
    if shape.kind != "train" and dict(zip(
            mesh.axis_names, mesh.shape)).get("model", 1) > 1:
        rec["model_axis"] = "replicated (ROADMAP §1 item 22)"
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={rec['mesh']} "
              f"step={rec['step']}")
        print(f"  memory: {mem}")
        print(f"  counted(per device): flops={c.flops / div:.3e} "
              f"bytes={c.bytes / div:.3e}")
        print(f"  collectives: "
              f"{ {k: f'{v:.3e}' for k, v in per_dev_coll['bytes_by_type'].items()} } "
              f"total={per_dev_coll['total_bytes']:.3e} B")
        print(f"  trace={c.trace_s:.1f}s live/device={live / 1e9:.2f} GB "
              f"fits_hbm={mem['fits_hbm']}")
    if do_diff:
        try:
            rec["per_device"] = _depth_diff(cfg, shape, mesh, verbose, device)
        except Exception as e:  # depth-diff is best-effort
            rec["per_device"] = {"error": f"{type(e).__name__}: {e}"}
    _finish_roofline(rec, cfg, shape, n_chips)
    return rec


def _depth_variant(cfg, n: int):
    """Reduced-depth, unrolled, full-width copy of the config.

    Unrolls every scan that hides FLOPs from ``cost_analysis`` (which
    counts loop bodies once): the layer scan, the blockwise-attention
    q-chunk map, and the chunked-CE scan.  These chunked paths are
    memory layouts, not extra math, so disabling them leaves FLOPs/bytes
    semantics intact while making them countable.
    """
    kw: Dict[str, Any] = {"use_scan": False, "attn_q_chunk": 0,
                          "loss_chunk_size": 0}
    if cfg.block_pattern:
        kw["n_layers"] = n * len(cfg.block_pattern)
    else:
        kw["n_layers"] = n + cfg.n_dense_layers
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = n
    return dataclasses.replace(cfg, **kw)


def _diff_layers(cfg, n: int) -> int:
    """How many 'marginal units' a depth-n variant contains."""
    return n


def _full_units(cfg) -> int:
    if cfg.block_pattern:
        return cfg.n_layers // len(cfg.block_pattern)  # (R,R,A) groups
    return cfg.n_layers - cfg.n_dense_layers


def _depth_diff(cfg, shape, mesh, verbose: bool,
                device: Any = "cuda") -> Dict[str, float]:
    """Per-device totals from the per-layer marginal cost: the cell at
    depths 1 and 2 of :func:`_depth_variant`, extrapolated to
    :func:`_full_units` (the reference's semantics and keys).  The port
    counts every layer at full depth as well, so this is the cheap
    estimate that count checks."""
    results = []
    for n in (1, 2):
        got = measure_cell(_depth_variant(cfg, n), shape, mesh, device)
        c, div = got["count"], got["div"]
        results.append({"flops": c.flops / div, "bytes": c.bytes / div,
                        "coll": got["coll"]["total_bytes"]})
    u_full = _full_units(cfg)
    out = {}
    for key in ("flops", "bytes", "coll"):
        c1, c2 = results[0][key], results[1][key]
        marginal = max(c2 - c1, 0.0)
        out[key + "_total"] = c1 + marginal * (u_full - 1)
        out[key + "_marginal"] = marginal
    if verbose:
        print(f"  depth-diff: flops={out['flops_total']:.3e}/dev "
              f"bytes={out['bytes_total']:.3e}/dev "
              f"coll={out['coll_total']:.3e}/dev "
              f"(marginal flops {out['flops_marginal']:.3e} x {u_full} units)")
    return out


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D train / 2*N*D inference (N = active params)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def _finish_roofline(rec, cfg, shape, n_chips: int, hw=None) -> None:
    """The reference's roofline from the record (``hw`` defaults to the
    H100's :class:`~repro_torch.launch.hlo_analysis.HW`).  ``source`` is
    ``depth_diff`` where the depth difference fed it, else ``scan_raw``:
    in the port, the full-depth count."""
    from repro_torch.launch import hlo_analysis as ha

    hw = hw if hw is not None else ha.HW()
    pd = rec.get("per_device") or {}
    if "flops_total" in pd:
        total_flops = pd["flops_total"] * n_chips
        total_bytes = pd["bytes_total"] * n_chips
        total_coll = max(pd["coll_total"],
                         rec["collectives"]["total_bytes"]) * n_chips
        src = "depth_diff"
    else:
        total_flops = rec["cost_analysis_raw"]["flops"] * n_chips
        total_bytes = rec["cost_analysis_raw"]["bytes_accessed"] * n_chips
        total_coll = rec["collectives"]["total_bytes"] * n_chips
        src = "scan_raw"
    mf = _model_flops(cfg, shape)
    terms = ha.roofline_terms(total_flops, total_bytes, total_coll, n_chips,
                              hw)
    rec["roofline"] = dict(
        terms,
        source=src,
        hlo_flops=total_flops,
        hlo_bytes=total_bytes,
        collective_bytes=total_coll,
        model_flops=mf,
        useful_flops_frac=(mf / total_flops) if total_flops else 0.0,
    )


def _cell_job(job) -> Dict[str, Any]:
    """One cell of :func:`main`: its record (an ``error`` record where it
    raised), written under ``out``."""
    a, s, mp, do_diff, overrides, verbose, device, out, suffix = job
    mesh = "2x16x16" if mp else "16x16"
    try:
        rec = run_cell(a, s, multi_pod=mp, do_diff=do_diff,
                       overrides=overrides, verbose=verbose, device=device)
    except Exception as e:
        rec = {"arch": a, "shape": s, "mesh": mesh, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        print(f"[dryrun] {a} x {s} mesh={mesh} FAILED: {e}")
    path = os.path.join(out, f"{a}_{s}_{'mp' if mp else 'sp'}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def _weight(job) -> float:
    """A cell's expected trace time, for ``--jobs``: train cells by depth,
    data ranks and experts; serving cells last."""
    from repro_torch.configs import SHAPES, get_config

    arch, shape, multi_pod = job[:3]
    if SHAPES[shape].kind != "train":
        return 0.0
    cfg = get_config(arch)
    return cfg.n_layers * (2 if multi_pod else 1) * (4 if cfg.n_experts else 1)


def _table_row(rec: Dict[str, Any]) -> str:
    """One markdown row of ``--table``."""
    head = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
    if rec["status"] == "skip":
        m = re.search(r"item \d+|encdec|long_500k runs only", rec["reason"])
        return head + f"skip ({m.group(0) if m else rec['reason'][:40]}) " \
            "| | | | | |"
    if rec["status"] != "ok":
        return head + f"{rec['status']}: {rec.get('error', '')[:60]} " \
            "| | | | | |"
    mem, roof = rec["memory"], rec["roofline"]
    return head + (f"ok ({rec['step']}) | {roof['dominant']} "
                   f"({roof['bound_s']:.4g} s) | "
                   f"{mem['live_bytes_per_device']} | {mem['fits_hbm']} | "
                   f"{roof['useful_flops_frac']:.4f} | {rec['trace_s']} |")


def main() -> None:
    from repro_torch.configs import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--no-diff", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides (perf tuning)")
    ap.add_argument("--suffix", default=None,
                    help="artifact filename suffix (default: '_opt' iff "
                         "--override is set)")
    ap.add_argument("--device", default="cuda",
                    help="the card the kernels would run on (the data "
                         "axis's transport); nothing is allocated there")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes; more than 1 runs the cells "
                         "in them, the largest first, quietly")
    ap.add_argument("--table", action="store_true",
                    help="print one markdown row a cell at the end")
    args = ap.parse_args()

    overrides = json.loads(args.override) if args.override else None
    os.makedirs(args.out, exist_ok=True)
    suffix = args.suffix if args.suffix is not None else (
        "_opt" if overrides else "")

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [True] if args.multi_pod_only else (
        [False, True] if args.all else [args.multi_pod])
    jobs = [(a, s, mp, not args.no_diff, overrides, args.jobs == 1,
             args.device, args.out, suffix)
            for mp in meshes for a in archs for s in shapes]

    t0 = time.perf_counter()
    if args.jobs > 1:
        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            recs = pool.map(_cell_job, sorted(jobs, key=_weight, reverse=True),
                            chunksize=1)
    else:
        recs = [_cell_job(job) for job in jobs]
    wall = time.perf_counter() - t0
    failures = sum(rec["status"] == "error" for rec in recs)
    if args.table:
        print("| arch | shape | mesh | status | dominant (bound_s) | "
              "live_bytes_per_device | fits_hbm | useful_flops_frac | "
              "trace_s |")
        print("|---|---|---|---|---|---|---|---|---|")
        for rec in sorted(recs, key=lambda r: (r["mesh"], r["arch"],
                                               r["shape"])):
            print(_table_row(rec))
    print(f"[dryrun] done; {failures} failures; {len(recs)} cells in "
          f"{wall:.1f} s over {args.jobs} process(es); artifacts in "
          f"{args.out}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
