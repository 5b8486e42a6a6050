"""Sharding rules: DP / TP / EP / SP over a (pod, data, model) mesh
(counterpart of ``repro.parallel.sharding``).

Axis roles (DESIGN.md §5):

* ``pod``   — outer data parallelism across pods (DCN).
* ``data``  — data parallelism within a pod; also hosts MoE expert
  parallelism (experts live on the data axis) and ZeRO-1 optimizer-state
  sharding.
* ``model`` — Megatron tensor parallelism: attention heads, FFN hidden,
  vocab.

Rules are name-based over the parameter tree; anything unmatched is
replicated.  Dims only get an axis when divisible by the axis size —
e.g. whisper's 12 heads stay replicated on a 16-way model axis while its
MLP still shards.  Nothing is padded.

The rules are the reference's, rule for rule.  A spec is a :class:`P`:
a tuple whose entries are ``None``, an axis name or a tuple of axis
names, as ``jax.sharding.PartitionSpec`` (a one-name tuple is stored as
the name, as JAX stores it), so two specs compare by ``tuple(spec)``.
The parameter paths are the port's nested dict keys (list entries as
``"[i]"``), which :func:`repro_torch.convert.params_from_jax` matches to
the reference's tree.  A mesh is anything with ``axis_names`` and
``shape`` (:class:`repro_torch.launch.mesh.PlannedMesh`), or with
``devices.shape`` as a JAX mesh has.  What the port does with the specs
is :mod:`repro_torch.parallel.tensor`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig

__all__ = [
    "P", "NamedSharding", "mesh_axis_sizes", "dp_axes", "batch_spec", "param_pspecs",
    "named_shardings", "cache_pspecs", "zero1_spec", "map_with_path",
    "spec_axes",
]


def _entry(part):
    """One spec entry as JAX stores it: no names -> None, one -> the name."""
    if not isinstance(part, (tuple, list)):
        return part
    part = tuple(part)
    return None if not part else (part[0] if len(part) == 1 else part)


class P(tuple):
    """A partition spec: one entry a dimension, each ``None``, an axis
    name or a tuple of axis names (a one-name tuple becomes the name, an
    empty one None)."""

    #: a leaf of the port's trees (:mod:`repro_torch.tree`), not a node
    tree_leaf = True

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_entry(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spec_axes(part) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


def _shape(mesh) -> Tuple[int, ...]:
    shape = getattr(mesh, "shape", None)
    if shape is None or isinstance(shape, dict):
        shape = mesh.devices.shape
    return tuple(int(s) for s in shape)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, _shape(mesh)))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry the batch (pod + data when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh) -> P:
    return P(dp_axes(mesh))


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _model_ok(mesh) -> int:
    return mesh_axis_sizes(mesh).get("model", 1)


def _param_rule(path: Tuple[str, ...], shape: Tuple[int, ...],
                cfg: ModelConfig, mesh) -> P:
    """PartitionSpec for the *logical* (unstacked) parameter shape."""
    m = _model_ok(mesh)
    name = path[-1]
    in_moe = "moe" in path
    in_attn = any(k in path for k in ("attn", "self_attn", "cross_attn", "time_mix"))

    def mdl(dim: int) -> Optional[str]:
        return "model" if _div(dim, m) else None

    # ---- embeddings / unembeddings -----------------------------------
    if name == "embed":
        return P(mdl(shape[0]), None)
    if name == "lm_head":
        return P(None, mdl(shape[1]))
    if name == "dec_pos":
        return P(None, None)

    # ---- MoE ----------------------------------------------------------
    if in_moe:
        E = cfg.n_experts
        edp = "data" if ("data" in mesh.axis_names
                         and _div(E, mesh_axis_sizes(mesh)["data"])) else None
        if name == "router":
            return P(None, None)
        if name in ("w1", "w3") and len(shape) == 3:
            return P(edp, None, mdl(shape[2]))
        if name == "w2" and len(shape) == 3:
            return P(edp, mdl(shape[1]), None)
        # shared expert mlp (w1/w3/w2, rank 2) falls through to MLP rules

    # ---- attention projections ----------------------------------------
    if in_attn or name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wk_rope"):
        heads_ok = _div(cfg.n_heads, m)
        kv_ok = _div(cfg.n_kv_heads, m)
        if name == "wq":
            return P(None, "model" if heads_ok else None)
        if name in ("wk", "wv"):
            # rwkv time_mix wk/wv are [D, D] head-sharded like wq
            if "time_mix" in path:
                return P(None, "model" if heads_ok else None)
            return P(None, "model" if kv_ok else None)
        if name == "wo":
            return P("model" if heads_ok else None, None)
        if name == "bq":
            return P("model" if heads_ok else None)
        if name in ("bk", "bv"):
            return P("model" if kv_ok else None)
        # MLA: low-rank downs replicated, ups column-parallel, wo row-par.
        if name in ("wq_a", "wkv_a", "wk_rope"):
            return P(None, None)
        if name in ("wq_b", "wkv_b"):
            return P(None, "model" if heads_ok else None)
        # rwkv extras
        if name in ("wr", "wg"):
            return P(None, "model" if heads_ok else None)
        if name == "u" or name == "ln_x_w" or name == "ln_x_b":
            return P("model" if heads_ok else None, None)

    # ---- dense MLP ------------------------------------------------------
    if name in ("w1", "w3", "wk"):
        return P(None, mdl(shape[-1]))
    if name in ("w2", "wv"):
        return P(mdl(shape[0]), None)
    if name == "b1":
        return P(mdl(shape[0]))

    # ---- RG-LRU recurrent block -----------------------------------------
    if name in ("w_gate", "w_in", "w_a", "w_x"):
        return P(None, mdl(shape[-1]))
    if name == "w_out":
        return P(mdl(shape[0]), None)
    if name in ("b_a", "b_x", "lam"):
        return P(mdl(shape[0]))
    if name == "conv_w":
        return P(None, mdl(shape[-1]))
    if name == "conv_b":
        return P(mdl(shape[0]))

    return P(*([None] * len(shape)))


_STACK_KEYS = ("blocks", "groups", "enc_blocks", "dec_blocks")


def map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                  path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists (a :class:`P` is
    a leaf); ``path`` holds the dict keys and ``"[i]"`` for list entries,
    as ``jax.tree_util.tree_map_with_path``'s keys print."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        vals = [map_with_path(fn, v, path + (f"[{i}]",))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return fn(path, tree)


def param_pspecs(params_shape: Any, cfg: ModelConfig, mesh) -> Any:
    """PartitionSpec tree matching ``params_shape`` (a tree of tensors,
    meta tensors included, or of anything with ``.shape``)."""

    def visit(keys, leaf):
        shape = tuple(leaf.shape)
        stacked = any(k in _STACK_KEYS for k in keys)
        logical = shape[1:] if stacked else shape
        spec = _param_rule(keys, logical, cfg, mesh)
        if stacked:
            spec = P(None, *spec)
        if len(spec) < len(shape):
            spec = P(*spec, *([None] * (len(shape) - len(spec))))
        return spec

    return map_with_path(visit, params_shape)


def zero1_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """ZeRO-1: additionally shard optimizer state over the DP axes.

    Adds the *unused* dp axes to the first dim that is unsharded and
    divisible; leaves the spec unchanged when nothing divides.  Axes
    already occupied by the parameter spec (e.g. MoE experts on 'data')
    are never repeated — a PartitionSpec may use each axis once.
    """
    dp = dp_axes(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for part in parts for a in spec_axes(part)}
    dp = tuple(a for a in dp if a not in used)
    if not dp:
        return spec
    sizes = mesh_axis_sizes(mesh)
    dp_total = int(np.prod([sizes[a] for a in dp]))
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and _div(dim, dp_total):
            parts[i] = dp if len(dp) > 1 else dp[0]
            return P(*parts)
    return spec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s two fields)."""

    mesh: Any
    spec: P


def named_shardings(pspecs: Any, mesh) -> Any:
    """Each spec of a tree paired with the mesh."""
    return map_with_path(lambda _, s: NamedSharding(mesh, s), pspecs)


def cache_pspecs(cache: Any, cfg: ModelConfig, mesh) -> Any:
    """KV/state cache shardings: batch over dp axes, heads over model.

    Batch-dim position is determined by the cache key (see the model
    ``init_cache`` layouts):

    * ``k/v/xk/xv``      [L, B, KV, S, hd]     (rglru: [G, n_att, B, KV, W, hd])
    * ``ckv/k_rope``     [L, B, S, r]
    * ``wkv``            [L, B, H, K, K]
    * ``att_sx/ffn_sx``  [L, B, D]
    * ``h/conv``         rglru groups: [G, n_rec, B, ...]; tail: [n, B, ...]
    """
    dp = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    m = sizes.get("model", 1)
    dp_total = int(np.prod([sizes[a] for a in dp])) if dp else 1
    dp_spec = (dp if len(dp) > 1 else dp[0]) if dp else None

    def visit(keys, leaf):
        shape = tuple(leaf.shape)
        name = keys[-1]
        if name == "pos" or len(shape) == 0:
            return P()
        in_groups = "groups" in keys
        if name in ("k", "v", "xk", "xv"):
            b_dim = 2 if in_groups else 1
            kv_dim = b_dim + 1
        elif name in ("ckv", "k_rope", "wkv", "att_sx", "ffn_sx"):
            b_dim = 1
            kv_dim = 2 if name == "wkv" else None  # wkv heads dim
        elif name in ("h", "conv"):
            b_dim = 2 if in_groups else 1
            kv_dim = None
        elif name in ("tail_h", "tail_conv"):
            b_dim = 1
            kv_dim = None
        else:
            b_dim = 1 if len(shape) > 1 else None
            kv_dim = None
        parts: list = [None] * len(shape)
        if dp and b_dim is not None and _div(shape[b_dim], dp_total):
            parts[b_dim] = dp_spec
        if kv_dim is not None and kv_dim < len(shape) and _div(shape[kv_dim], m):
            parts[kv_dim] = "model"
        elif name in ("k", "v", "ckv", "k_rope") and len(shape) >= 2:
            # GQA/MLA: too few KV heads for the model axis -> shard the
            # cache *sequence* dim instead (sequence-sharded decode)
            s_dim = len(shape) - 2
            if (s_dim != b_dim and parts[s_dim] is None
                    and _div(shape[s_dim], m) and shape[s_dim] >= m):
                parts[s_dim] = "model"
        # RG-LRU states pair with column-parallel w_in: channel dim is
        # model-sharded (rwkv sx states feed full-width matmuls ->
        # replicated channels)
        if name in ("h", "conv", "tail_h", "tail_conv") and _div(shape[-1], m):
            parts[-1] = "model"
        return P(*parts)

    return map_with_path(visit, cache)
