"""Weights across the package boundary as flat ``{path: np.ndarray}``.

The JAX reference and this port initialise from different random
generators, so a parity check needs one set of weights in both.  The
port's parameter dicts use the reference pytree's keys, and a parameter's
path is its keys joined by ``/`` — the strings
``repro.optim.optimizers.tree_paths`` gives the reference leaves (e.g.
``layers/attn/wo/sell/a`` for the stacked (L, K, N) diagonals).

* :func:`to_torch` builds the port's nested parameter dict from a flat
  dict of arrays (e.g. ``dict(zip(leaves(tree_paths(p)), leaves(p)))`` on
  the reference side);
* :func:`to_numpy` flattens the port's parameters back;
* :func:`state_to_torch` / :func:`state_to_numpy` do the same for a
  whole train state (``params/...``, ``opt/m/...``, ``opt/v/...``,
  ``step`` and, with compression, ``grad_error/...``), so both trainers
  can start from one state, mid-run too.  ``grad_error`` leaves keep the
  reference's layout ``(dp, *param.shape)``, row r data rank r's
  residual.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE


def to_torch(flat: Dict[str, np.ndarray], device=DEFAULT_DEVICE) -> dict:
    """Nested dict of tensors from ``{"a/b/c": array}``; arrays keep their
    dtype (float64 input is not expected: masters are float32)."""
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return tree


def to_numpy(params: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a/b/c": array}`` for every tensor leaf of ``params``; bfloat16
    leaves come out as float32 (numpy has no bfloat16)."""
    out: Dict[str, np.ndarray] = {}
    for key, val in params.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(to_numpy(val, path))
        else:
            t = val.detach()
            out[path] = (t.float() if t.dtype == torch.bfloat16
                         else t).cpu().numpy()
    return out


def state_to_torch(flat: Dict[str, np.ndarray],
                   device=DEFAULT_DEVICE) -> dict:
    """A train state ``{"params", "opt", "step"[, "grad_error"]}`` from
    the flat paths of the reference's state tree; ``step`` becomes a
    Python int."""
    step = int(np.asarray(flat["step"]))
    state = to_torch({k: v for k, v in flat.items() if k != "step"},
                     device)
    state["step"] = step
    return state


def state_to_numpy(state: dict) -> Dict[str, np.ndarray]:
    """Flat ``{path: array}`` of a train state, ``step`` as int32."""
    out = to_numpy({k: v for k, v in state.items() if k != "step"})
    out["step"] = np.asarray(state["step"], np.int32)
    return out
