#!/usr/bin/env python
"""Whole-volume segmentation inference via sliding-window tiles, on PyTorch.

The ``deepatlas_torch`` twin of ``infer_seg.py``, with the same flags and
the same JSON lines: load a checkpoint, partition each test volume into
overlap tiles, predict on the device in fixed-size tile batches, reassemble
(center stitch or per-voxel voting), report per-class Dice when ground truth
exists, and optionally write predictions as .nii.gz.

``--ckpt`` takes a checkpoint file of this package (``save_checkpoint``;
JAX checkpoints convert with ``tools/flax_ckpt_to_torch.py``).  The network
runs on ``--device`` (default ``cuda``); ``--packed`` is accepted for flag
compatibility and changes nothing, since this package has one execution
path for both parameter trees.

``--spatial-shards N`` serves whole volumes exactly instead of tiles: one
process per rank, as torchrun starts them, each runs the network on its
depth slab (``parallel.spatial.make_spatial_seg_forward``: halo-exchanged
convs on kernel A at depth padding 0), the slabs' labels are gathered, and
rank 0 prints and writes.  The depth must divide by N x 8 (UNet_light's
levels on each slab).  Several ranks on one card take ``--dist-backend
gloo``:
  torchrun --nproc-per-node 2 infer_seg_torch.py ... --spatial-shards 2

Example:
  python infer_seg_torch.py --ckpt <dir>/model_best --data-root <dir> \\
      --list-file test.txt --data OAI --n-classes 5 \\
      --tile-size 128 128 128 --overlap 16 16 16 --out-dir preds/
"""
import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint file (deepatlas_torch save_checkpoint)")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--list-file", required=True)
    ap.add_argument("--data", default="OAI",
                    help="dataset key (OAI/OASIS/MindBoggle/...)")
    ap.add_argument("--model", default="UNet_light")
    ap.add_argument("--n-classes", type=int, required=True)
    ap.add_argument("--bias", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--BN", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--packed", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="accepted for compatibility with infer_seg.py; "
                         "this package has one execution path")
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--tile-size", type=int, nargs=3, default=[128, 128, 128])
    ap.add_argument("--overlap", type=int, nargs=3, default=[16, 16, 16])
    ap.add_argument("--tile-batch", type=int, default=4)
    ap.add_argument("--vote", action="store_true",
                    help="per-voxel label voting instead of center stitch")
    ap.add_argument("--out-dir", default=None,
                    help="write predicted masks as .nii.gz here")
    ap.add_argument("--flip-left", action="store_true",
                    help="OAI LEFT-knee flip preprocessing")
    ap.add_argument("--spatial-shards", type=int, default=0,
                    help="exact whole-volume inference with the depth split "
                         "over this many ranks (parallel/spatial.py) instead "
                         "of overlap tiles; depth divisible by shards x 8")
    ap.add_argument("--dist-backend", default=None,
                    help="process-group backend for --spatial-shards: nccl "
                         "(default on CUDA) or gloo (several ranks on one "
                         "card; the default on the CPU)")
    ap.add_argument("--dist-init", default=None,
                    help="process-group address (default env://, "
                         "torchrun's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run the network on")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from deepatlas_torch import resolve_device
    from deepatlas_torch.data import (Compose, DataLoader, LeftToRight,
                                      VolumeToArray, get_seg_dataset,
                                      write_nifti)
    from deepatlas_torch.models import get_network
    from deepatlas_torch.train import (load_checkpoint, make_tile_predictor,
                                       sliding_window_predict, volume_dice)

    device = resolve_device(args.device)
    mesh = None
    if args.spatial_shards > 1:
        from deepatlas_torch.parallel import (make_mesh,
                                              make_spatial_seg_forward,
                                              shard_volume_batch)
        from deepatlas_torch.parallel.collectives import all_gather
        from deepatlas_torch.train import TrainState
        mesh = make_mesh(space=args.spatial_shards, device=device,
                         backend=args.dist_backend,
                         init_method=args.dist_init)
        device = mesh.device
    writer = mesh is None or mesh.rank == 0
    transforms = [VolumeToArray()]
    if args.flip_left:
        transforms.append(LeftToRight())
    dataset = get_seg_dataset(args.data)(
        args.list_file, args.data_root, with_seg=True,
        pre_transform=Compose(transforms))
    loader = DataLoader(dataset, batch_size=1, shuffle=False, prefetch=2)

    model = get_network(args.model)(
        in_channel=1, n_classes=args.n_classes, bias=args.bias, BN=args.BN,
        dtype=torch.bfloat16 if args.bf16 else None)
    model.load_state_dict(load_checkpoint(args.ckpt)["model"])
    model.to(device).eval()
    if mesh is not None:
        forward = make_spatial_seg_forward(model, mesh)
        state = TrainState(model, None)

        def whole_volume(image):
            """``(D, H, W)`` labels of one ``(D, H, W, 1)`` volume: this
            rank's slab through the sharded forward, the slabs gathered
            in depth order."""
            slab = shard_volume_batch(image[None], mesh)
            logits = forward(state, torch.from_numpy(slab).to(device))
            labels = logits[0].argmax(dim=-1).to(torch.uint8)
            return all_gather(labels, mesh.axis("space")).cpu().numpy()
    else:
        predict = make_tile_predictor(model, args.tile_batch)

    if args.out_dir and writer:
        os.makedirs(args.out_dir, exist_ok=True)

    all_dice = []
    for batch in loader:
        name = batch["name"][0]
        sample = {"image": batch["image"][0],
                  "like": batch["like"][0] if "like" in batch else None}
        if mesh is not None:
            pred = whole_volume(sample["image"])
        else:
            pred = sliding_window_predict(predict, sample, args.tile_size,
                                          args.overlap, is_vote=args.vote)
        if not writer:
            continue
        line = {"name": name}
        if "segmentation" in batch:
            dice = volume_dice(pred, batch["segmentation"][0],
                               args.n_classes, device)
            all_dice.append(dice)
            line["dice_avg"] = round(float(dice.mean()), 4)
            line["dice"] = [round(float(d), 4) for d in dice]
        if args.out_dir:
            out_path = os.path.join(args.out_dir, f"{name}_pred.nii.gz")
            # keep the source volume's spacing/affine on the prediction
            write_nifti(out_path, pred.astype(np.uint8),
                        like=sample.get("like"))
            line["saved"] = out_path
        print(json.dumps(line), flush=True)

    if all_dice and writer:
        mean = np.stack(all_dice).mean(axis=0)
        print(json.dumps({"mean_dice_avg": round(float(mean.mean()), 4),
                          "mean_dice_per_class":
                          [round(float(d), 4) for d in mean]}), flush=True)


if __name__ == "__main__":
    main()
