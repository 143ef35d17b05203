"""Segmentation experiment: the full seg train / validate / test workload.

Counterpart of ``deepatlas_tpu/train/segmentation.py``: the same experiment
name and checkpoint-dir layout, MultiStep / plateau LR scheduling, periodic
validation with per-class dice computed on the device, best-checkpoint
tracking, scalars under the same tag names (into ``scalars.jsonl``, see
``train/base.py``), config snapshot, resume, a logging ``test()``, and the
``profile_dir`` key (``train/base.py``).  Each training step is an ``experiment.step`` span (``step.forward``,
``step.loss`` and ``step.backward`` inside it, Adam's own marker after
them), its copy to the device ``experiment.copy_in`` and the print
period's scalars and summaries ``experiment.log`` (``utils/profiling.py``
logs every span; the trace carries them).  The print period's rate is its
samples over its seconds.

OAI patch training: ``patch_size`` (D, H, W) draws one crop per training
volume through ``RandomCrop`` (``sampler`` "random", ``patch_threshold``
default 0.0) or ``BalancedRandomCrop`` (``sampler`` "balanced",
``patch_threshold`` default 0.01), seeded from ``random_seed``; validation
and ``test()`` see whole volumes.  ``augmentation`` (``data/augment.py``)
augments each training batch on the device before its step.  Image
summaries: the last training batch every ``save_ckpts_epoch_period``
epochs (tag ``training``: the batch as loaded, the logits of the
augmented one) and the last validation batch (``validation``).

The device comes from the config key ``device`` (``cuda`` when absent; the
experiment raises without a card unless ``device="cpu"`` is asked for).

The parallel tiers (``train/base.py``): ``data_parallel`` splits each
batch's rows over the world's ranks (``parallel.dp``; validation is
data-parallel where ``valid_batch_size`` divides by the replicas, else
every rank evaluates the whole batch), ``spatial_shards`` splits each
volume's depth (``parallel.spatial``, the dice criterion only; validation
is sharded too).  A training batch is augmented whole, then cut to the
rank's block.
"""
from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch

from ..data import (BalancedRandomCrop, Compose, CropVolume, DataLoader,
                    LeftToRight, RandomCrop, VolumeToArray, get_seg_dataset)
from ..data.augment import make_augmenter
from ..losses import get_loss_function
from ..models import get_network, resolve_model_settings
from ..utils import visualize
from ..utils.profiling import annotate
from .base import BaseExperiment, test_logger
from .steps import (TrainState, make_optimizer, make_seg_eval_step,
                    make_seg_train_step, set_learning_rate)

# the batch elements a segmentation summary shows
SUMMARY_BATCH = 4


def summary_slices(images: np.ndarray, truths: np.ndarray,
                   logits: torch.Tensor):
    """The mid-depth slices that ``make_segmentation_image_summary`` reads,
    of the first ``SUMMARY_BATCH`` elements, on the host: ``(B', 1, H, W,
    C)`` images, ``(B', 1, H, W)`` truths and ``(B', 1, H, W, n_classes)``
    float32 logits (cut on the logits' device, then copied).  The summary
    of these slices equals the summary of the whole arrays."""
    mid = images.shape[1] // 2
    cut = (slice(0, SUMMARY_BATCH), slice(mid, mid + 1))
    return (np.array(images[cut]), np.array(truths[cut]),
            logits[cut].float().cpu().numpy())


class SegmentationExperiment(BaseExperiment):
    debug_dir = "debug_seg"

    def __init__(self, config):
        super().__init__(config)
        self.best_score = 0.0

    def experiment_name(self) -> str:
        ms = self.config["model_settings"]
        return "Seg_{}{}{}_{}_{}samples_batch_{}_{}epochs_{}_{}_lr_{}{}".format(
            self.config["model"],
            "_bias" if ms.get("bias") else "",
            "_BN" if ms.get("BN") else "",
            os.path.basename(self.config["data_dir"]),
            self.config["num_samples"],
            self.config["batch_size"],
            self.config["n_epochs"],
            self.config["loss"],
            self.config["loss_settings"]["weight_type"],
            self.config["learning_rate"],
            "_scheduler_{}".format(self.config["lr_mode"])
            if self.config["lr_mode"] != "const" else "")

    # ------------------------------------------------------------- setup
    def _transforms(self):
        transforms = [VolumeToArray()]
        if self.config.get("flip_left"):
            transforms.append(LeftToRight())
        if self.config.get("crop_size"):
            transforms.append(CropVolume(self.config["crop_size"]))
        return Compose(transforms)

    def _patch_sampler(self):
        """OAI patch training: a running transform drawing random or
        class-balanced ROI crops of ``patch_size``; None without one."""
        patch = self.config.get("patch_size")
        if not patch:
            return None
        rng = np.random.RandomState(self.config["random_seed"])
        if self.config.get("sampler", "random") == "balanced":
            return BalancedRandomCrop(
                patch, threshold=self.config.get("patch_threshold", 0.01),
                n_classes=self.config["n_classes"], random_state=rng)
        return RandomCrop(patch,
                          threshold=self.config.get("patch_threshold", 0.0),
                          random_state=rng)

    def setup_train_data(self):
        dataset_cls = get_seg_dataset(self.config["data"])
        tf = self._transforms()
        training_data = dataset_cls(
            self.config["training_list_file"], self.config["data_dir"],
            with_seg=True, preload=self.config.get("preload", False),
            pre_transform=tf, running_transform=self._patch_sampler(),
            n_samples=self.config["num_samples"] * 2)
        self.training_data_loader = DataLoader(
            training_data, batch_size=self.config["batch_size"], shuffle=True,
            seed=self.config["random_seed"],
            prefetch=self.config.get("prefetch", 2),
            num_workers=self.config.get("num_workers"))
        print("Initializing dataloader: {} decode threads".format(
            self.training_data_loader.num_workers))
        validation_data = dataset_cls(
            self.config["validation_list_file"],
            self.config.get("valid_data_dir", self.config["data_dir"]),
            with_seg=True, preload=self.config.get("preload", False),
            pre_transform=tf)
        self.validation_data_loader = DataLoader(
            validation_data, batch_size=self.config.get("valid_batch_size", 1),
            shuffle=False, prefetch=2)

    def setup_model(self):
        model_type = get_network(self.config["model"])
        self.model = model_type(
            **resolve_model_settings(self.config["model_settings"]))

    def setup_loss(self):
        self.criterion = get_loss_function(self.config["loss"])(
            **self.config["loss_settings"])

    def _init_state(self):
        self.model.to(self.device)
        self.state = TrainState(
            self.model, make_optimizer(self.model,
                                       self.config["learning_rate"]))
        n_class = self.config["n_classes"]
        self.local_eval = False
        if self.spatial:
            from ..parallel import (make_spatial_seg_eval_step,
                                    make_spatial_seg_step, replicate)
            if self.config["loss"] != "dice":
                raise ValueError(
                    "spatial_shards currently supports the dice criterion "
                    "(the only seg loss with axis_name shard reductions, "
                    "losses/dice.py); got " + repr(self.config["loss"]))
            replicate(self.model, self.mesh)
            ls = dict(self.config["loss_settings"])
            ls.pop("n_class", None)
            self.train_step = make_spatial_seg_step(
                self.model, get_loss_function(self.config["loss"]),
                n_class=n_class, mesh=self.mesh, criterion_kwargs=ls)
            self.eval_step = make_spatial_seg_eval_step(self.model, n_class,
                                                        self.mesh)
            self.local_eval = True
        elif self.mesh is not None:
            from ..parallel import (make_dp_seg_eval_step,
                                    make_dp_seg_train_step, replicate)
            replicate(self.model, self.mesh)
            self.train_step = make_dp_seg_train_step(self.criterion,
                                                     self.mesh)
            if self.config.get("valid_batch_size", 1) % self.mesh.size:
                # ragged eval batches: every rank evaluates the whole batch
                self.eval_step = make_seg_eval_step(n_class)
            else:
                self.eval_step = make_dp_seg_eval_step(n_class, self.mesh)
                self.local_eval = True
        else:
            self.train_step = make_seg_train_step(self.criterion)
            self.eval_step = make_seg_eval_step(n_class)
        self.augmenter = make_augmenter(self.config.get("augmentation"))

    def _checkpoint_state(self) -> dict:
        return {"epoch": self.current_epoch,
                "model": self.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(),
                "best_score": self.best_score,
                "scheduler": self.scheduler.state_dict()}

    def _restore(self, restored: dict, best: float) -> None:
        self.model.load_state_dict(restored["model"])
        self.state.optimizer.load_state_dict(restored["optimizer"])
        self.best_score = best

    # ------------------------------------------------------------- train
    def train_one_epoch(self):
        running_loss = 0.0
        period = self.config["print_batch_period"]
        iters_per_epoch = (self.config["samples_per_epoch"]
                           // self.config["batch_size"])
        period_start = time.perf_counter()
        batch = logits = None
        for i in range(iters_per_epoch):
            batch = next(self._train_iter)
            if self.augmenter is not None:
                # the whole batch, as one process augments it, then the
                # rank's block of it
                images, labels = self._to_device(batch["image"],
                                                 batch["segmentation"])
                akey = (self.config["random_seed"], 2 ** 20 + self.global_step)
                images, labels = self.augmenter(akey, images, labels)
                if self.mesh is not None:
                    images = self.local_batch(images)
                    labels = self.local_batch(labels)
            else:
                images, labels = self._to_device(
                    batch["image"], batch["segmentation"], local=True)
            with annotate("experiment.step"):
                self.state, loss, logits = self.train_step(self.state,
                                                           images, labels)
            self.global_step = ((self.current_epoch - 1) * iters_per_epoch
                                + (i + 1) * self.config["batch_size"])
            running_loss += float(loss)     # waits for the step
            if i % period == period - 1:
                now = time.perf_counter()
                seconds, period_start = now - period_start, now
                rate = period * self.config["batch_size"] / seconds
                with annotate("experiment.log"):
                    avg = running_loss / period if i > 0 \
                        else running_loss
                    print("Epoch[{}/{}] iter {} loss: {:.3f} lr:{} "
                          "{:.3f} vol/s/chip {}".format(
                              self.current_epoch, self.config["n_epochs"],
                              i + 1, avg, self.scheduler.lr, rate,
                              datetime.datetime.now().strftime(
                                  "%D %H:%M:%S")))
                    self.writer.add_scalar("loss/training", avg,
                                           global_step=self.global_step)
                    self.writer.add_scalar("learning_rate",
                                           self.scheduler.lr,
                                           global_step=self.global_step)
                    self.writer.add_scalar(
                        "throughput/ingest_wait_fraction",
                        self.training_data_loader.wait_fraction,
                        global_step=self.global_step)
                    self.writer.add_scalar(
                        "throughput/volumes_per_sec_per_chip", rate,
                        global_step=self.global_step)
                running_loss = 0.0

        if (batch is not None and self.current_epoch
                % self.config["save_ckpts_epoch_period"] == 0):
            with annotate("experiment.log"):
                summary = visualize.make_segmentation_image_summary(
                    *summary_slices(self.local_batch(batch["image"]),
                                    self.local_batch(batch["segmentation"]),
                                    logits))
                self.writer.add_image("training", summary,
                                      global_step=self.global_step)

    # -------------------------------------------------------------- eval
    def eval(self, dataloader):
        """``(dice_per_class, dice_avg, sample)``: the foreground dice over
        the loader's volumes and, for the summary, ``summary_slices`` of
        the last batch (None for an empty loader)."""
        n_fg = self.config["n_classes"] - 1
        dice_sum = np.zeros((n_fg,), np.float64)
        count = 0
        last = None
        cut = self.local_batch if self.local_eval else (lambda x: x)
        for batch in dataloader:
            images, labels = self._to_device(
                batch["image"], batch["segmentation"], local=self.local_eval)
            dice, logits = self.eval_step(self.state, images, labels)
            dice_sum += dice.double().sum(dim=0).cpu().numpy()
            count += dice.shape[0]
            last = (cut(batch["image"]), cut(batch["segmentation"]), logits)
        dice_per_class = dice_sum / max(count, 1)
        sample = None if last is None else summary_slices(*last)
        return dice_per_class, float(dice_per_class.mean()), sample

    def validate(self):
        if self.current_epoch % self.config["valid_epoch_period"]:
            return False
        start = time.time()
        dice_per_class, dice_avg, sample = self.eval(
            self.validation_data_loader)
        new_lr = self.scheduler.step(
            dice_avg if self.config["lr_mode"] == "plateau" else None)
        self.state = set_learning_rate(self.state, new_lr)

        is_best = dice_avg > self.best_score
        if is_best:
            self.best_score = dice_avg

        data_name = self.config["data"]
        self.writer.add_scalar(f"validation_{data_name}/dice_avg", dice_avg,
                               global_step=self.global_step)
        class_name = self.config.get("class_name", {})
        for c in range(self.config["n_classes"] - 1):
            self.writer.add_scalar(
                "validation_{}/dice_{}".format(
                    data_name, class_name.get(c + 1, str(c + 1))),
                dice_per_class[c], global_step=self.global_step)
        if sample is not None:
            self.writer.add_image(
                "validation", visualize.make_segmentation_image_summary(
                    *sample), global_step=self.global_step)

        print("Validation: Dice Avg: {:.4f} ({:.3f} sec) {}".format(
            dice_avg, time.time() - start,
            datetime.datetime.now().strftime("%D %H:%M:%S")))
        return is_best

    # -------------------------------------------------------------- test
    def setup_test_data(self):
        dataset_cls = get_seg_dataset(self.config["data"])
        testing_data = dataset_cls(
            self.config["testing_list_file"], self.config["data_dir"],
            with_seg=True, preload=False, pre_transform=self._transforms())
        self.testing_data_loader = DataLoader(testing_data, batch_size=1,
                                              shuffle=False, prefetch=2)

    def test(self, best: bool = True, if_log: bool = True):
        self.setup_random_seed()
        self.setup_model()
        self.setup_loss()
        self.setup_optimizer()
        self.setup_test_data()
        self.validation_data_loader = self.testing_data_loader
        self._init_state()

        ckpoint_file, restored, last_epoch = self._test_checkpoint(best)
        self.model.load_state_dict(restored["model"])

        dice_per_class, dice_avg, _ = self.eval(self.testing_data_loader)
        if if_log and self.is_writer:
            with test_logger(os.path.join(self.ckpoint_dir,
                                          "test_log.txt")) as log:
                log.info("\n" + "=" * 50 + "\n")
                log.info("Testing Model: %s (%s epochs)\n", ckpoint_file,
                         last_epoch)
                log.info("Test data: %s\n", self.config["data_dir"])
                log.info("Test list: %s\n",
                         self.config["testing_list_file"])
                log.info("\n" + "-" * 50 + "\n")
                log.info("Dice_avg: %s", dice_avg)
                class_name = self.config.get("class_name", {})
                for c in range(self.config["n_classes"] - 1):
                    log.info("Dice_%s:%.3f",
                             class_name.get(c + 1, str(c + 1)),
                             dice_per_class[c])
                log.info("\n" + "-" * 50 + "\n")
        return dice_per_class, dice_avg
