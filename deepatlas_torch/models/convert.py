"""Convert the JAX package's U-Net and VoxelMorph variables and optimizer
state into this package's state_dicts.

The JAX ``UNetTemplate`` stores one of two parameter trees:

  * standard (``packed=False``): ``ConvBlock_i/{Conv_0, BatchNorm_0}``,
    ``DeconvBlock_j/{ConvTranspose_0, BatchNorm_0}`` whose kernel is
    ``(2, 2, 2, O, I)`` (flax ``transpose_kernel``), and the head ``Conv_0``;
  * packed (``packed=True``, what ``infer_seg.py`` trains and restores by
    default): ``PackedConvBlock_k/{kernel, bias, PackedBatchNorm_0}`` and
    ``PackedDeconvBlock_k`` with a ``(2, 2, 2, I, O)`` kernel on the top
    ``packed_levels`` levels, standard ``ConvBlock_j`` / ``DeconvBlock_j``
    on the deeper ones, and the head as the last ``PackedConvBlock``.

Flax numbers modules per class in creation order: encoder chains top-down,
then per decoder level its upsampler and its conv chain, then the head
(``deepatlas_tpu/models/packed.py::transfer_unet_params`` walks the same
order).  The JAX fixed ``UNet`` creates its modules in that order too
(``ConvBlock_0..7``, then ``DeconvBlock_j`` and two ``ConvBlock``s per
level, the head ``Conv_0``), so its standard tree, BatchNorm statistics
included, maps onto the port's ``UNet`` (a ``UNetTemplate``) by the same
walk.  A model built with ``remat=True`` names its blocks
``CheckpointConvBlock_i`` / ``CheckpointDeconvBlock_j``; the prefix is
dropped.  Variables arrive as nested dicts of arrays; only numpy is used.

The JAX ``VoxelMorphCVPR2018`` likewise stores ``ConvBlock_0..9`` plus the
flow head ``Conv_0`` (standard), or ``PackedConvBlock_0..4`` for the two
shallow encoder convs, the two shallow decoder convs and the head, mixed
with ``ConvBlock_0..5`` for the deep levels (packed); built with
``remat=True`` its ``ConvBlock``s are ``CheckpointConvBlock``s in either
tree, and the prefix is dropped as for the U-Net.  Packed blocks keep
their kernels at the logical ``(3, 3, 3, Cin, Cout)`` shape (for a split
skip input, the concatenation's), so nothing is unpacked.

The mapping is a pure relabelling (plus the standard deconv's transpose), so
it carries any tree shaped like the parameters: gradients, and the ``mu`` /
``nu`` moments of the JAX package's Adam (``adam_from_optax``).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _creation_order(model, nl: Optional[int]) -> Tuple[List, List, str]:
    """Flax module names of the convs (encoder then decoder order), the
    deconvs and the head, for the standard tree (``nl`` None) or a packed
    tree with ``nl`` packed levels."""
    levels = len(model.encoders)
    n = {"PackedConvBlock": 0, "ConvBlock": 0, "PackedDeconvBlock": 0,
         "DeconvBlock": 0}

    def take(kind, packed):
        key = ("Packed" + kind) if packed else kind
        name = f"{key}_{n[key]}"
        n[key] += 1
        return name

    def packed_level(level):
        return nl is not None and level < nl

    convs, deconvs = [], []
    for i, plan in enumerate(model.encoders):
        for _ in (plan if i == 0 else plan[1:]):
            convs.append(take("ConvBlock", packed_level(i)))
    for j, plan in enumerate(model.decoders):
        out_level = levels - 2 - j
        deconvs.append(take("DeconvBlock", packed_level(out_level)))
        for _ in plan[1:]:
            convs.append(take("ConvBlock", packed_level(out_level)))
    head_level = levels - 2 - (len(model.decoders) - 1)
    head = take("ConvBlock", True) if packed_level(head_level) else "Conv_0"
    return convs, deconvs, head


def _np(a) -> np.ndarray:
    return np.array(a, dtype=np.float32)      # a writable copy


def _block_entry(params: dict, stats: dict, name: str) -> Dict[str, np.ndarray]:
    """kernel / bias / BatchNorm arrays of one flax block, either tree."""
    p = params[name]
    s = stats.get(name, {})
    if name.startswith("Packed") or name == "Conv_0":
        op, bn, bn_stats = p, p.get("PackedBatchNorm_0"), \
            s.get("PackedBatchNorm_0")
    else:
        inner = "ConvTranspose_0" if name.startswith("Deconv") else "Conv_0"
        op, bn, bn_stats = p[inner], p.get("BatchNorm_0"), s.get("BatchNorm_0")
    out = {"weight": _np(op["kernel"])}
    if "bias" in op:
        out["bias"] = _np(op["bias"])
    if bn is not None:
        out["bn.weight"] = _np(bn["scale"])
        out["bn.bias"] = _np(bn["bias"])
        if bn_stats is not None:
            out["bn.running_mean"] = _np(bn_stats["mean"])
            out["bn.running_var"] = _np(bn_stats["var"])
    return out


def _unremat(tree: dict) -> dict:
    return {k.removeprefix("Checkpoint"): v for k, v in tree.items()}


def unet_from_flax(variables: dict, model,
                   params_only: bool = False) -> Dict[str, torch.Tensor]:
    """State dict of ``model`` (a ``UNetTemplate``: ``UNet_light`` or the
    fixed ``UNet``) from the JAX U-Net's ``{'params': ...,
    ['batch_stats': ...]}``, standard or packed tree, with or without
    remat.  With ``params_only`` the result holds the parameters' names
    only (no BatchNorm statistics): the form for a gradient or
    optimizer-moment tree.

    Raises ``ValueError`` when the tree does not fit the model's plan.
    """
    params = _unremat(variables["params"])
    stats = {} if params_only else \
        _unremat(variables.get("batch_stats", {}) or {})
    keys = set(params)
    candidates = [None] + list(range(1, len(model.encoders)))
    for nl in candidates:
        convs, deconvs, head = _creation_order(model, nl)
        if set(convs) | set(deconvs) | {head} == keys:
            break
    else:
        raise ValueError(f"parameter tree {sorted(keys)} does not match the "
                         f"U-Net plan {model.encoders} / {model.decoders}")

    targets = [f"enc.{i}.{k}" for i, lvl in enumerate(model.enc)
               for k in range(len(lvl))]
    targets += [f"dec.{j}.{k}" for j, lvl in enumerate(model.dec)
                for k in range(len(lvl))]
    sd: Dict[str, np.ndarray] = {}
    for prefix, name in zip(targets, convs):
        for k, v in _block_entry(params, stats, name).items():
            sd[f"{prefix}.{k}"] = v
    for j, name in enumerate(deconvs):
        entry = _block_entry(params, stats, name)
        if not name.startswith("Packed"):
            # standard (2, 2, 2, O, I) -> (2, 2, 2, I, O)
            entry["weight"] = entry["weight"].transpose(0, 1, 2, 4, 3)
        for k, v in entry.items():
            sd[f"ups.{j}.{k}"] = v
    head_entry = _block_entry(params, stats, head)
    sd["head.weight"] = head_entry["weight"].reshape(
        head_entry["weight"].shape[-2:])
    if "bias" in head_entry:
        sd["head.bias"] = head_entry["bias"]

    ref = dict(model.named_parameters()) if params_only \
        else model.state_dict()
    if set(sd) != set(ref):
        raise ValueError(f"converted keys differ from the model's: missing "
                         f"{sorted(set(ref) - set(sd))}, extra "
                         f"{sorted(set(sd) - set(ref))}")
    out = {}
    for k, v in sd.items():
        if tuple(v.shape) != tuple(ref[k].shape):
            raise ValueError(f"{k}: shape {v.shape} from the tree, model "
                             f"has {tuple(ref[k].shape)}")
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


# port module -> flax module, for the two JAX VoxelMorph trees
_VM_PORT = [f"enc.{i}" for i in range(5)] + [f"dec.{i}" for i in range(5)] \
    + ["head"]
_VM_STANDARD = [f"ConvBlock_{i}" for i in range(10)] + ["Conv_0"]
_VM_PACKED = (["PackedConvBlock_0", "PackedConvBlock_1"]
              + [f"ConvBlock_{i}" for i in range(6)]
              + ["PackedConvBlock_2", "PackedConvBlock_3",
                 "PackedConvBlock_4"])


def voxelmorph_from_flax(variables: dict, model) -> Dict[str, torch.Tensor]:
    """State dict of ``model`` (a ``VoxelMorphCVPR2018``) from the JAX
    VoxelMorph's ``{'params': ...}``, standard or packed tree, with or
    without remat.  The network
    has no BatchNorm, so the same call maps a gradient or an optimizer-moment
    tree.

    Raises ``ValueError`` when the tree does not fit the model.
    """
    params = _unremat(variables["params"])
    keys = set(params)
    for names in (_VM_STANDARD, _VM_PACKED):
        if set(names) == keys:
            break
    else:
        raise ValueError(f"parameter tree {sorted(keys)} is neither the "
                         f"standard nor the packed VoxelMorph tree")
    ref = dict(model.named_parameters())
    out = {}
    for prefix, name in zip(_VM_PORT, names):
        for k, v in _block_entry(params, {}, name).items():
            key = f"{prefix}.{k}"
            if key not in ref:
                raise ValueError(f"{name} carries {k!r}, the model has no "
                                 f"{key}")
            if tuple(v.shape) != tuple(ref[key].shape):
                raise ValueError(f"{key}: shape {v.shape} from the tree, "
                                 f"model has {tuple(ref[key].shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(v))
    if set(out) != set(ref):
        raise ValueError(f"the tree lacks {sorted(set(ref) - set(out))}")
    return out


def _field(node, name):
    """``name`` of an optax state node: a namedtuple as optax builds it, or
    the dict a checkpoint restores it as."""
    return node[name] if isinstance(node, dict) else getattr(node, name)


def adam_from_optax(opt_state, model, convert=None) -> dict:
    """A ``torch.optim.Adam`` state dict for ``model`` from the state of the
    JAX package's optimizer, ``optax.inject_hyperparams(optax.adam)``
    (``deepatlas_tpu/train/steps.py::make_optimizer``): its first moments
    ``mu`` become ``exp_avg``, its second moments ``nu`` ``exp_avg_sq``, its
    ``count`` every parameter's ``step``, and its injected learning rate the
    group's ``lr``.  ``opt_state`` holds numpy arrays, as optax's
    namedtuples or as the nested dicts and lists a checkpoint restores.
    ``convert(variables, model)`` maps a parameter-shaped tree onto
    ``model``'s parameter names: ``unet_from_flax`` with ``params_only`` when
    not given, ``voxelmorph_from_flax`` for a VoxelMorph.
    """
    if convert is None:
        convert = functools.partial(unet_from_flax, params_only=True)
    adam = _field(opt_state, "inner_state")[0]
    count = float(np.asarray(_field(adam, "count")))
    lr = float(np.asarray(_field(opt_state, "hyperparams")["learning_rate"]))
    mu = convert({"params": _field(adam, "mu")}, model)
    nu = convert({"params": _field(adam, "nu")}, model)
    sd = torch.optim.Adam(model.parameters(), lr=lr).state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(count), "exp_avg": mu[name],
            "exp_avg_sq": nu[name]}
        for i, (name, _) in enumerate(model.named_parameters())}
    return sd
