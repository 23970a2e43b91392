"""JAX package variables -> the port's state_dict.

Takes ``{"params": ..., "batch_stats": ...}`` of the JAX PointNet2SSG as
nested dicts of numpy arrays (``jax.device_get`` of the flax variables) and
returns the state_dict of the port's PointNet2SSG. It is the inverse of the
JAX package's ``_rules_pointnet2_ssg`` (utils/torch_import.py:125-140),
written out here so that the port needs neither JAX nor that module:

  - Dense kernel [I, O] -> conv weight [O, I, 1, 1] (SA, the reference's
    Conv2d) or [O, I, 1] (FP and head, Conv1d); bias as is;
  - BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var, num_batches_tracked 0.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# (torch prefix, flax path, kind); kind is "conv2d", "conv1d" or "bn"
Rule = Tuple[str, Tuple[str, ...], str]


def pointnet2_ssg_rules() -> List[Rule]:
    r: List[Rule] = []
    for i in (1, 2, 3):
        for j in range(3):
            r.append((f"sa{i}.mlp_convs.{j}", (f"sa{i}", "mlp", f"dense_{j}"), "conv2d"))
            r.append((f"sa{i}.mlp_bns.{j}", (f"sa{i}", "mlp", f"bn_{j}"), "bn"))
    for fp, layers in (("fp3", 2), ("fp2", 2), ("fp1", 3)):
        for j in range(layers):
            r.append((f"{fp}.mlp_convs.{j}", (fp, "mlp", f"dense_{j}"), "conv1d"))
            r.append((f"{fp}.mlp_bns.{j}", (fp, "mlp", f"bn_{j}"), "bn"))
    r += [
        ("conv1", ("head", "dense0"), "conv1d"),
        ("bn1", ("head", "bn0"), "bn"),
        ("conv2", ("head", "dense1"), "conv1d"),
    ]
    return r


def _leaf(tree: Dict[str, Any], path: Tuple[str, ...]) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree, dtype=np.float32)


def flax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX PointNet2SSG variables -> state_dict for ``load_state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for tp, fp, kind in pointnet2_ssg_rules():
        if kind == "bn":
            sd[f"{tp}.weight"] = _leaf(params, fp + ("scale",))
            sd[f"{tp}.bias"] = _leaf(params, fp + ("bias",))
            sd[f"{tp}.running_mean"] = _leaf(stats, fp + ("mean",))
            sd[f"{tp}.running_var"] = _leaf(stats, fp + ("var",))
            sd[f"{tp}.num_batches_tracked"] = np.zeros((), np.int64)
        else:
            kernel = _leaf(params, fp + ("kernel",))  # [I, O]
            trailing = (1, 1) if kind == "conv2d" else (1,)
            sd[f"{tp}.weight"] = kernel.T.reshape(kernel.shape[::-1] + trailing)
            sd[f"{tp}.bias"] = _leaf(params, fp + ("bias",))
    return {k: torch.tensor(v) for k, v in sd.items()}  # copies
