#!/usr/bin/env python
"""Joint DeepAtlas training (alternating semi-supervised seg + reg), on
PyTorch.

The ``deepatlas_torch`` twin of ``train_deepatlas.py``, with the same flags
and config keys: UNet_light (32 classes, BN, bias, bf16) and
VoxelMorph-CVPR2018 (bf16, float32 flow and warp clamped to ``--max-disp``
voxels), trained alternately on ordered pairs of 182x218x182 MindBoggle
volumes cropped to 168x200x168 of which only the first ``--n-labeled`` keep
their labels: LNCC (filter 9) + bending energy + anatomy dice in the reg
phase, supervised dice + anatomy dice in the seg phase, two Adams under the
multiStep schedule.  The networks run on ``--device`` (default ``cuda``;
without a CUDA device the script raises unless ``--device cpu`` is given).
The JAX CLI's ``--no-packed`` chooses between TPU execution paths and has no
counterpart; ``--data-parallel`` and ``--spatial-shards`` have none yet (see
ROADMAP.md).

Example:
  python train_deepatlas_torch.py --data-root <dir> --log-root logs \\
      --num-samples 21 --num-epochs 100 --n-labeled 1
"""
import argparse
import os


def build_config(args) -> dict:
    n_classes = 32
    config = dict(
        debug_mode=args.debug,
        resume_dir="",
        random_seed=230,
        data="MindBoggle",
        n_epochs=args.num_epochs,
        samples_per_epoch=args.num_samples * 2,
        batch_size=args.batch_size,
        print_batch_period=50,
        valid_epoch_period=1,
        save_ckpts_epoch_period=1,

        seg_model="UNet_light",
        seg_model_settings={"in_channel": 1, "n_classes": n_classes,
                            "bias": True, "BN": True, "dtype": "bfloat16"},
        reg_model="voxel_morph_cvpr",
        reg_model_settings={"max_disp": args.max_disp, "dtype": "bfloat16"},
        max_disp=args.max_disp,
        fused_anatomy=True,
        n_classes=n_classes,
        n_labeled=args.n_labeled,

        crop_size=[0, 10, 7, 14, 8, 7],

        sim_loss="lncc",
        sim_loss_settings={"filter_size": 9},
        reg_loss="bendingEnergy",
        reg_loss_settings={},
        seg_loss="dice",
        seg_loss_settings={"n_class": n_classes, "weight_type": "Uniform",
                           "no_bg": False, "softmax": True, "eps": 1e-6},
        reg_weight=args.reg_weight,
        anatomy_weight=args.anatomy_weight,
        supervised_weight=args.supervised_weight,
        max_validation_pairs=args.max_validation_pairs,

        learning_rate=args.lr,
        lr_mode="multiStep",
        milestones=[0.5, 1],
        gamma=0.2,
    )
    config.update(vars(args))

    train_set = ("MMRR-21", "HLN-12", "NKI-TRT-12", "OASIS-TRT-20")
    test_set = "NKI-RS-21"
    if config["num_samples"] == 21:
        train_lists = [f + "-flip" for f in train_set[0:1]]
    elif config["num_samples"] == 65:
        train_lists = [f + "-flip" for f in train_set]
    else:
        raise ValueError("num-samples has to be 21 or 65 for mindboggle "
                         "data but got {}".format(config["num_samples"]))

    config["data_dir"] = os.path.join(args.data_root, "mindboggle")
    config["valid_data_dir"] = os.path.join(args.data_root, "mindboggle")
    config["training_list_file"] = tuple(
        os.path.join(args.data_root, "mindboggle/{}.txt".format(f))
        for f in train_lists)
    config["validation_list_file"] = os.path.join(
        args.data_root, "mindboggle/{}-valid.txt".format(test_set))
    config["testing_list_file"] = os.path.join(
        args.data_root, "mindboggle/NKI-RS-21-train.txt")
    config["log_dir"] = "./{}/{}".format(args.log_root, config["data"])
    return config


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", "-g", default="cuda", type=str,
                        help="torch device to train on (cuda, cuda:1, cpu)")
    parser.add_argument("--debug", "-d", action="store_true")
    parser.add_argument("--preload", "-load", action="store_true")
    parser.add_argument("--num-samples", "-ns", default=21, type=int)
    parser.add_argument("--num-epochs", "-ne", default=100, type=int)
    parser.add_argument("--n-labeled", "-nl", default=1, type=int,
                        help="number of training volumes that keep their "
                             "ground-truth labels (semi-supervision)")
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--reg-weight", default=1.0, type=float)
    parser.add_argument("--anatomy-weight", default=3.0, type=float)
    parser.add_argument("--supervised-weight", default=1.0, type=float)
    parser.add_argument("--max-validation-pairs", default=20, type=int)
    parser.add_argument("--max-disp", type=int, default=8,
                        help="bound (voxels) the warp clamps each axis of "
                             "the displacement to; the reg step reports "
                             "the clipped fraction as disp_overflow and the "
                             "overflow guard widens the bound (8 -> 10 -> "
                             "unclamped) when it persists")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--test-only", "-test", action="store_true",
                        help="skip training: restore the best (or latest) "
                             "joint checkpoint and evaluate both nets on "
                             "the held-out testing_list_file")
    parser.add_argument("--data-root", "-root", default="./data", type=str)
    parser.add_argument("--log-root", "-log", default="./logs", type=str)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from deepatlas_torch.train import DeepAtlasExperiment

    config = build_config(args)
    exp = DeepAtlasExperiment(config)
    if not args.test_only:
        exp.train()
    return exp.test()


if __name__ == "__main__":
    main()
