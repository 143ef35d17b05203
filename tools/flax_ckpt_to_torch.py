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
    ap.add_argument("--model", default="UNet_light")
    ap.add_argument("--n-classes", type=int,
                    help="classes of the U-Net's head (U-Net only)")
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
    if args.model == "voxel_morph_cvpr":
        model, convert, best_key = get_network(args.model)(), \
            voxelmorph_from_flax, "reg_best_score"
    else:
        if args.n_classes is None:
            ap.error("--n-classes is required for a U-Net")
        model = get_network(args.model)(in_channel=1,
                                        n_classes=args.n_classes,
                                        bias=args.bias, BN=args.BN)
        convert, best_key = unet_from_flax, "best_score"
    variables = {"params": restored["params"],
                 "batch_stats": restored.get("batch_stats") or {}}
    state = {"epoch": int(restored.get("epoch", 0)),
             best_key: float(restored.get(best_key, 0.0)),
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
