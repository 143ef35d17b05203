#!/usr/bin/env python
"""Convert a JAX-package checkpoint into a deepatlas_torch checkpoint.

Restores an orbax checkpoint directory written by
``deepatlas_tpu.train.save_checkpoint`` (standard or packed parameter tree),
maps its variables onto the PyTorch port's ``UNetTemplate``
(``deepatlas_torch.models.unet_from_flax``) or, with ``--model
voxel_morph_cvpr``, onto its ``VoxelMorphCVPR2018``
(``voxelmorph_from_flax``), and writes the port's checkpoint
(``<out>/checkpoint`` and ``<out>/model_best``) for ``infer_seg_torch.py``.
Optimizer state (Adam moments, step count, learning rate), epoch, best score
(a registration checkpoint keeps it under ``reg_best_score``) and scheduler
state are carried along when the JAX checkpoint has them, so a JAX training
run resumes in ``train_seg_torch.py`` / ``train_reg_torch.py``
(``resume_dir``).  This is the one bridge that imports both packages.

Example:
  python tools/flax_ckpt_to_torch.py --ckpt runs/seg/model_best \\
      --out runs/seg_torch --n-classes 5
  python tools/flax_ckpt_to_torch.py --ckpt runs/reg/model_best \\
      --out runs/reg_torch --model voxel_morph_cvpr
  python tools/flax_ckpt_to_torch.py --ckpt runs/joint/checkpoint \\
      --out runs/joint_torch --model deepatlas --n-classes 32
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="orbax checkpoint directory of deepatlas_tpu")
    ap.add_argument("--out", required=True,
                    help="directory for the deepatlas_torch checkpoint")
    ap.add_argument("--model", default="UNet_light",
                    help="UNet_light, voxel_morph_cvpr, or deepatlas (a joint "
                         "checkpoint of both)")
    ap.add_argument("--n-classes", type=int,
                    help="classes of the U-Net's head (U-Net and joint "
                         "checkpoints)")
    ap.add_argument("--bias", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--BN", action=argparse.BooleanOptionalAction,
                    default=True)
    args = ap.parse_args(argv)

    from deepatlas_tpu.utils.platform import honor_platform_env
    honor_platform_env()
    from deepatlas_tpu.train import load_checkpoint as load_flax

    from deepatlas_torch.models import (adam_from_optax, get_network,
                                        unet_from_flax, voxelmorph_from_flax)
    from deepatlas_torch.train import save_checkpoint

    restored = load_flax(args.ckpt)

    def unet(name="UNet_light"):
        if args.n_classes is None:
            ap.error("--n-classes is required for a U-Net")
        return get_network(name)(in_channel=1, n_classes=args.n_classes,
                                 bias=args.bias, BN=args.BN)

    def scalar(key):
        return float(restored.get(key, 0.0))

    if args.model == "deepatlas":
        seg, reg = unet(), get_network("voxel_morph_cvpr")()
        state = {"epoch": int(restored.get("epoch", 0)),
                 "seg_best_score": scalar("seg_best_score"),
                 "reg_best_score": scalar("reg_best_score"),
                 "seg_model": unet_from_flax(
                     {"params": restored["seg_params"],
                      "batch_stats": restored.get("seg_batch_stats") or {}},
                     seg),
                 "reg_model": voxelmorph_from_flax(
                     {"params": restored["reg_params"]}, reg)}
        if restored.get("seg_opt_state") is not None:
            state["seg_optimizer"] = adam_from_optax(
                restored["seg_opt_state"], seg)
        if restored.get("reg_opt_state") is not None:
            state["reg_optimizer"] = adam_from_optax(
                restored["reg_opt_state"], reg, convert=voxelmorph_from_flax)
    else:
        if args.model == "voxel_morph_cvpr":
            model, convert, best_key = get_network(args.model)(), \
                voxelmorph_from_flax, "reg_best_score"
        else:
            model, convert, best_key = unet(args.model), unet_from_flax, \
                "best_score"
        variables = {"params": restored["params"],
                     "batch_stats": restored.get("batch_stats") or {}}
        state = {"epoch": int(restored.get("epoch", 0)),
                 best_key: scalar(best_key),
                 "model": convert(variables, model)}
        if restored.get("opt_state") is not None:
            state["optimizer"] = adam_from_optax(restored["opt_state"], model,
                                                 convert=convert)
    if restored.get("scheduler"):
        state["scheduler"] = {k: float(v)
                              for k, v in restored["scheduler"].items()}
    path = save_checkpoint(state, True, args.out)
    print(f"wrote {path} and {os.path.join(args.out, 'model_best')}")


if __name__ == "__main__":
    main()
