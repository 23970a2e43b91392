"""JAX package variables -> the port's state_dict (``flax_to_state_dict``),
and back (``state_dict_to_flax``, which maps gradients and trained weights
onto the JAX trees leaf by leaf), for every model the port has.

The variables are ``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays (``jax.device_get`` of the flax variables). A rule table a
model says which flax module becomes which prefix of the state_dict:

  - PointNet2SSG (``pointnet2_ssg_rules``) carries the reference torch
    model's names. The table is the inverse of the JAX package's
    ``_rules_pointnet2_ssg`` (utils/torch_import.py:125-140), written out
    here so that the port needs neither JAX nor that module. Dense kernel
    [I, O] -> conv weight [O, I, 1, 1] (SA, the reference's Conv2d) or
    [O, I, 1] (FP and head, Conv1d); bias as is.
  - BriStruNet (``bristrunet_rules``) has no mappable reference torch model,
    so the port names its layers after the flax modules and a prefix is the
    flax path joined with dots. Dense kernel [I, O] -> weight [O, I]; a
    Dense without a bias has none on either side.
  - The PTv3 family (``ptv3_rules``, ``ptv3_pooled_rules``) is named after
    the flax modules too; one block table (``_ptv3_block``) serves both
    models. The tables depend on the depths: the registry names stand for
    the registry's default models, another depth passes its own table.
  - BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var, num_batches_tracked 0.
  - LayerNorm (kind "ln") scale/bias -> weight/bias; it has no statistics.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

# (torch prefix, flax path, kind); kind is "conv2d", "conv1d", "dense", "bn"
# or "ln"
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


_Layers = List[Tuple[Tuple[str, ...], str]]  # (flax path, kind)


def _by_flax_path(layers: _Layers) -> List[Rule]:
    """Rules of layers that the port names after their flax path."""
    return [(".".join(path), path, kind) for path, kind in layers]


def bristrunet_rules() -> List[Rule]:
    bse = [("mlp0_shared", "dense"), ("mlp0_rel", "dense"), ("bn0", "bn"), ("mlp1", "dense")]
    layers: _Layers = [(("bri_enc", n), kind) for n, kind in bse]
    layers += [(("color_encoder", n), "bn" if "bn" in n else "dense")
               for n in ("mlp0", "bn0", "mlp1", "bn1", "attn0", "attn_bn", "attn1", "ctx0", "ctx1")]
    layers += [(("feature_fusion", "fusion"), "dense"), (("feature_fusion", "bn"), "bn")]
    for sa in ("sa1", "sa2", "sa3"):
        for scale in (0, 1):
            for j in range(3):
                layers.append(((sa, f"mlp_{scale}", f"dense_{j}"), "dense"))
                layers.append(((sa, f"mlp_{scale}", f"bn_{j}"), "bn"))
    for geo in ("geometric2", "geometric3"):
        layers += [((geo, "br_pos", n), kind) for n, kind in bse]
        layers += [((geo, "mlp0"), "dense"), ((geo, "bn0"), "bn"), ((geo, "mlp1"), "dense")]
    for fp in ("fp3", "fp2", "fp1"):
        layers += [((fp, "attn_dense0"), "dense"), ((fp, "attn_bn"), "bn"),
                   ((fp, "attn_dense1"), "dense")]
        for j in range(2):
            layers += [((fp, "mlp", f"dense_{j}"), "dense"), ((fp, "mlp", f"bn_{j}"), "bn")]
        layers += [((fp, "boundary_mlp0", "dense_0"), "dense"),
                   ((fp, "boundary_mlp0", "bn_0"), "bn"),
                   ((fp, "boundary_dense1"), "dense")]
    for i in range(3):
        layers += [(("fusion", f"conv{i}"), "dense"), (("fusion", f"bn{i}"), "bn")]
    layers += [(("final0",), "dense"), (("final_bn",), "bn"), (("final1",), "dense")]
    return _by_flax_path(layers)


def _ptv3_block(name: str) -> _Layers:
    """The layers of one PointTransformerBlock called ``name``."""
    return [((name, "norm1"), "ln"), ((name, "attn", "qkv"), "dense"),
            ((name, "attn", "proj"), "dense"), ((name, "norm2"), "ln"),
            ((name, "mlp", "geglu", "proj"), "dense"), ((name, "mlp", "out"), "dense")]


_PTV3_HEAD: _Layers = [(("norm",), "ln"), (("head_fc1",), "dense"), (("head_bn",), "bn"),
                       (("head_fc2",), "dense")]


def ptv3_rules(depth: int = 8) -> List[Rule]:
    layers: _Layers = [(("patch_embed",), "dense"), (("patch_norm",), "ln"),
                       (("pos_embed",), "dense")]
    for i in range(depth):
        layers += _ptv3_block(f"block{i}")
    return _by_flax_path(layers + _PTV3_HEAD)


def ptv3_pooled_rules(enc_depths: Sequence[int] = (2, 2, 2),
                      dec_depths: Sequence[int] = (1, 1)) -> List[Rule]:
    layers: _Layers = [(("patch_embed",), "dense"), (("patch_norm",), "ln")]
    for tag, depths in (("enc", enc_depths), ("dec", dec_depths)):
        for lv, count in enumerate(depths):
            layers.append(((f"{tag}{lv}_pos",), "dense"))
            for i in range(count):
                layers += _ptv3_block(f"{tag}{lv}_block{i}")
    for lv in range(len(dec_depths)):
        layers += [((f"pool{lv}", "proj"), "dense"), ((f"pool{lv}", "norm"), "ln"),
                   ((f"unpool{lv}", "proj_up"), "dense"),
                   ((f"unpool{lv}", "proj_skip"), "dense"), ((f"unpool{lv}", "norm"), "ln")]
    return _by_flax_path(layers + _PTV3_HEAD)


MODEL_RULES = {
    "pointnet2": pointnet2_ssg_rules,
    "pointnet2_ssg": pointnet2_ssg_rules,
    "bristrunet": bristrunet_rules,
    "enhanced_pointnet2": bristrunet_rules,
    "bridgeseg": bristrunet_rules,
    "ptv3": ptv3_rules,
    "ptv3_pooled": ptv3_pooled_rules,
}


def rules_for(model: Union[str, Sequence[Rule]]) -> Sequence[Rule]:
    """A model's rule table by its registry name; a table passes through."""
    if not isinstance(model, str):
        return model
    if model not in MODEL_RULES:
        raise KeyError(f"no weight rules for model '{model}'; known: {sorted(MODEL_RULES)}")
    return MODEL_RULES[model]()


def _leaf(tree: Dict[str, Any], path: Tuple[str, ...]) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree, dtype=np.float32)


_TRAILING = {"conv2d": (1, 1), "conv1d": (1,), "dense": ()}


def flax_to_state_dict(
    variables: Dict[str, Any], model: Union[str, Sequence[Rule]] = "pointnet2_ssg"
) -> Dict[str, torch.Tensor]:
    """JAX variables of ``model`` (a registry name or a rule table) ->
    state_dict for ``load_state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for tp, fp, kind in rules_for(model):
        if kind in ("bn", "ln"):
            sd[f"{tp}.weight"] = _leaf(params, fp + ("scale",))
            sd[f"{tp}.bias"] = _leaf(params, fp + ("bias",))
            if kind == "bn":
                sd[f"{tp}.running_mean"] = _leaf(stats, fp + ("mean",))
                sd[f"{tp}.running_var"] = _leaf(stats, fp + ("var",))
                sd[f"{tp}.num_batches_tracked"] = np.zeros((), np.int64)
        else:
            kernel = _leaf(params, fp + ("kernel",))  # [I, O]
            sd[f"{tp}.weight"] = kernel.T.reshape(kernel.shape[::-1] + _TRAILING[kind])
            try:
                sd[f"{tp}.bias"] = _leaf(params, fp + ("bias",))
            except KeyError:  # a Dense without a bias
                pass
    return {k: torch.tensor(v) for k, v in sd.items()}  # copies


def state_dict_to_flax(
    sd: Dict[str, torch.Tensor], model: Union[str, Sequence[Rule]] = "pointnet2_ssg"
) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: a state_dict of ``model``, or
    any part of one (a dict of gradients holds only weights and biases) ->
    ``{"params": ..., "batch_stats": ...}`` nested dicts of float32 numpy
    arrays, with the leaves that ``sd`` has."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}

    def put(tree: Dict[str, Any], path: Tuple[str, ...], v: torch.Tensor) -> None:
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = v.detach().cpu().numpy().astype(np.float32)

    names = {"weight": "scale", "bias": "bias"}
    for tp, fp, kind in rules_for(model):
        if kind in ("bn", "ln"):
            for key, leaf in names.items():
                if f"{tp}.{key}" in sd:
                    put(out["params"], fp + (leaf,), sd[f"{tp}.{key}"])
            for key, leaf in (("running_mean", "mean"), ("running_var", "var")):
                if f"{tp}.{key}" in sd:  # a LayerNorm has none
                    put(out["batch_stats"], fp + (leaf,), sd[f"{tp}.{key}"])
        else:
            if f"{tp}.weight" in sd:
                w = sd[f"{tp}.weight"]
                put(out["params"], fp + ("kernel",), w.reshape(w.shape[0], w.shape[1]).T)
            if f"{tp}.bias" in sd:
                put(out["params"], fp + ("bias",), sd[f"{tp}.bias"])
    return out
