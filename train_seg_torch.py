#!/usr/bin/env python
"""Train a 3D U-Net for segmentation (MindBoggle101 recipe), on PyTorch.

The ``deepatlas_torch`` twin of ``train_seg.py``, with the same flags and
config keys: UNet_light, 32 classes, bias + BatchNorm, bf16 compute, batch 1,
182x218x182 volumes cropped to 168x200x168, dice loss, Adam, multiStep
schedule.  The network runs on ``--device`` (default ``cuda``; without a
CUDA device the script raises unless ``--device cpu`` is given).  The JAX
CLI's ``--no-packed``, ``--data-parallel`` and ``--spatial-shards`` have no
counterpart here yet (see ROADMAP.md).

Example:
  python train_seg_torch.py --data-root <dir> --log-root logs \\
      --num-samples 21 --num-epochs 100
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
        samples_per_epoch=args.num_samples * 2,  # flipped-data augmentation
        batch_size=1,
        valid_batch_size=1,
        print_batch_period=50,
        valid_epoch_period=1,
        save_ckpts_epoch_period=1,

        model="UNet_light",
        model_settings={"in_channel": 1, "n_classes": n_classes,
                        "bias": True, "BN": True, "dtype": "bfloat16"},
        n_classes=n_classes,
        class_name={k: str(k) for k in range(1, n_classes)},

        crop_size=[0, 10, 7, 14, 8, 7],

        loss="dice",
        loss_settings={"n_class": n_classes, "weight_type": "Uniform",
                       "no_bg": False, "softmax": True, "eps": 1e-6},

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
        raise ValueError("n_seg has to be 21 or 65 for mindboggle data but "
                         "got {}".format(config["num_samples"]))

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
    parser.add_argument("--debug", "-d", action="store_true",
                        help="if debug mode")
    parser.add_argument("--preload", "-load", action="store_true",
                        help="if preload data into memory to speed up IO")
    parser.add_argument("--num-samples", "-ns", default=21, type=int,
                        help="number of samples for training")
    parser.add_argument("--num-epochs", "-ne", default=100, type=int,
                        help="number of training epochs")
    parser.add_argument("--lr", default=1e-3, type=float,
                        help="learning rate")
    parser.add_argument("--test_only", "-t", action="store_true",
                        help="only test model")
    parser.add_argument("--data-root", "-root", default="./data", type=str,
                        help="root of the data folder")
    parser.add_argument("--log-root", "-log", default="./logs", type=str,
                        help="root of the log folders that saves "
                             "logs/checkpoints")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from deepatlas_torch.train import SegmentationExperiment

    config = build_config(args)
    exp = SegmentationExperiment(config)
    if not args.test_only:
        exp.train()
    return exp.test()


if __name__ == "__main__":
    main()
