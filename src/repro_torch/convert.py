"""JAX parameter trees to the port's tensors.

The port keeps the JAX layout (``[in, out]`` weights, block parameters
stacked along a leading layer dimension), so converting is a leaf-by-leaf
copy: the dtype is kept, and the tree's names and shapes are checked
against the model's :meth:`param_spec` (nested dicts, and lists such as
``RecurrentGemmaLM``'s ``"tail"`` blocks).
The input is the JAX tree with its leaves turned into numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray, device: Any = "cpu") -> torch.Tensor:
    """One numpy array as a tensor of the same dtype (bfloat16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits as torch's
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree: Any, spec: Any, device, path: str):
    if isinstance(spec, list):
        if not isinstance(tree, (list, tuple)):
            raise KeyError(f"parameter tree at {path or '<root>'}: expected a "
                           f"list of {len(spec)} sub-trees")
        if len(tree) != len(spec):
            raise KeyError(f"parameter tree at {path or '<root>'}: "
                           f"{len(tree)} entries, model wants {len(spec)}")
        return [_convert(t, e, device, f"{path}[{i}]")
                for i, (t, e) in enumerate(zip(tree, spec))]
    if not isinstance(tree, dict):
        raise KeyError(f"parameter tree at {path or '<root>'}: expected a "
                       f"dict, got {type(tree).__name__}")
    missing = sorted(set(spec) - set(tree))
    extra = sorted(set(tree) - set(spec))
    if missing or extra:
        raise KeyError(f"parameter tree at {path or '<root>'}: "
                       f"missing {missing}, unexpected {extra}")
    out = {}
    for name, entry in spec.items():
        where = f"{path}/{name}" if path else name
        leaf = tree[name]
        if isinstance(entry, (dict, list)):
            if not isinstance(leaf, (dict, list, tuple)):
                raise KeyError(f"{where}: expected a sub-tree, got an array")
            out[name] = _convert(leaf, entry, device, where)
            continue
        shape = tuple(np.shape(leaf))
        if shape != tuple(entry[0]):
            raise ValueError(f"{where}: shape {shape}, model wants {tuple(entry[0])}")
        out[name] = tensor_from_numpy(leaf, device)
    return out


def params_from_jax(tree: Dict[str, Any], model, device: Optional[Any] = None
                    ) -> Dict[str, Any]:
    """Copy a numpy-leaved JAX parameter tree onto ``device`` (default: the model's).

    Raises ``KeyError`` for a missing or unexpected name and ``ValueError``
    for a shape that is not the model's.
    """
    return _convert(tree, model.param_spec(),
                    model.device if device is None else device, "")
