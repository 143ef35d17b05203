"""Segmentation experiment: the full seg train / validate / test workload.

Counterpart of ``deepatlas_tpu/train/segmentation.py``: the same experiment
name and checkpoint-dir layout, MultiStep / plateau LR scheduling, periodic
validation with per-class dice computed on the device, best-checkpoint
tracking, scalars under the same tag names (into ``scalars.jsonl``, see
``train/base.py``), config snapshot, resume, and a logging ``test()``.

The device comes from the config key ``device`` (``cuda`` when absent; the
experiment raises without a card unless ``device="cpu"`` is asked for).

Not ported yet, and rejected rather than ignored when a config asks for
them: ``data_parallel``, ``spatial_shards`` (the parallel tiers),
``augmentation`` (the device-side augmenter) and ``patch_size`` (the patch
samplers); image summaries are not written.  ROADMAP.md lists them.
"""
from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import (Compose, CropVolume, DataLoader, LeftToRight,
                    VolumeToArray, endless, get_seg_dataset)
from ..losses import get_loss_function
from ..models import get_network, resolve_model_settings
from ..utils.profiling import ThroughputMeter
from .base import BaseExperiment, ScalarWriter, test_logger
from .checkpoint import BEST_NAME, CKPT_NAME, initialize_from, save_checkpoint
from .schedules import make_scheduler, scheduler_from_restored
from .steps import (TrainState, make_optimizer, make_seg_eval_step,
                    make_seg_train_step, set_learning_rate)

_NOT_PORTED = ("data_parallel", "spatial_shards", "augmentation",
               "patch_size")


class SegmentationExperiment(BaseExperiment):
    def __init__(self, config):
        super().__init__(config)
        for key in _NOT_PORTED:
            if self.config.get(key):
                raise NotImplementedError(
                    f"config key {key!r} is not ported to PyTorch yet; see "
                    f"Queue 1 of ROADMAP.md for the slice that brings it")
        self.device = resolve_device(self.config.get("device"))
        if self.config.get("debug_mode"):
            print("Debug mode")
            self.config["print_batch_period"] = 2
            self.config["valid_epoch_period"] = 2

        ms = self.config["model_settings"]
        self.exp_name = "Seg_{}{}{}_{}_{}samples_batch_{}_{}epochs_{}_{}_lr_{}{}".format(
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

        self.ckpoint_dir = os.path.join(
            self.config["log_dir"],
            self.exp_name if not self.config.get("debug_mode") else "debug_seg",
            str(self.config["random_seed"]))
        print("Init experiment {} seed {}".format(
            self.exp_name, self.config["random_seed"]))
        self.best_score = 0.0
        self.current_epoch = 1
        self.global_step = 0
        self._pending_best = False

    # ------------------------------------------------------------- setup
    def setup_log(self):
        os.makedirs(self.ckpoint_dir, exist_ok=True)
        self.save_config_snapshot(self.ckpoint_dir)
        self.writer = ScalarWriter(self.ckpoint_dir)

    def _transforms(self):
        transforms = [VolumeToArray()]
        if self.config.get("flip_left"):
            transforms.append(LeftToRight())
        if self.config.get("crop_size"):
            transforms.append(CropVolume(self.config["crop_size"]))
        return Compose(transforms)

    def setup_train_data(self):
        print("Initializing dataloader")
        dataset_cls = get_seg_dataset(self.config["data"])
        tf = self._transforms()
        training_data = dataset_cls(
            self.config["training_list_file"], self.config["data_dir"],
            with_seg=True, preload=self.config.get("preload", False),
            pre_transform=tf, n_samples=self.config["num_samples"] * 2)
        self.training_data_loader = DataLoader(
            training_data, batch_size=self.config["batch_size"], shuffle=True,
            seed=self.config["random_seed"],
            prefetch=self.config.get("prefetch", 2),
            num_workers=self.config.get("num_workers"))
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

    def setup_optimizer(self):
        self.scheduler = make_scheduler(
            self.config.get("lr_mode", "const"),
            self.config["learning_rate"], self.config["n_epochs"],
            self.config.get("milestones"), self.config.get("gamma", 0.2),
            self.config.get("valid_epoch_period", 1))

    def _init_state(self):
        self.model.to(self.device)
        self.state = TrainState(
            self.model, make_optimizer(self.model,
                                       self.config["learning_rate"]))
        self.train_step = make_seg_train_step(self.criterion)
        self.eval_step = make_seg_eval_step(self.config["n_classes"])

    def _maybe_resume(self):
        resume_dir = self.config.get("resume_dir")
        if resume_dir:
            restored, finished_epoch, best = initialize_from(
                resume_dir, map_location=self.device)
            self.model.load_state_dict(restored["model"])
            self.state.optimizer.load_state_dict(restored["optimizer"])
            # older checkpoints carry no scheduler state
            scheduler_from_restored(self.scheduler, restored.get("scheduler"))
            set_learning_rate(self.state, self.scheduler.lr)
            self.best_score = best
            self.current_epoch = finished_epoch + 1
            print("=> resumed from '{}' (epoch {})".format(resume_dir,
                                                           finished_epoch))

    def _to_device(self, batch):
        images = torch.from_numpy(batch["image"]).to(self.device)
        labels = torch.from_numpy(batch["segmentation"]).to(self.device)
        return images, labels

    # ------------------------------------------------------------- train
    def train(self):
        self.setup_train()
        print("Training {}".format(self.exp_name))
        self._init_state()
        self._maybe_resume()
        self._train_iter = endless(self.training_data_loader)

        print(self.config["samples_per_epoch"], self.config["batch_size"])
        print("Start Training:")
        for _ in range(self.current_epoch, self.config["n_epochs"] + 1):
            self.train_one_epoch()
            if self.validate():
                # pending until persisted: the save cadence is decoupled
                # from the validation cadence, so a best found at a
                # validation epoch must survive to the next periodic save
                # even when the two periods are coprime
                self._pending_best = True
            # the periodic save is NOT gated on the validation cadence: a
            # run whose epochs never hit valid_epoch_period must still
            # leave a checkpoint for test()/resume
            if self.current_epoch % self.config["save_ckpts_epoch_period"] \
                    == 0:
                save_checkpoint({"epoch": self.current_epoch,
                                 "model": self.model.state_dict(),
                                 "optimizer":
                                     self.state.optimizer.state_dict(),
                                 "best_score": self.best_score,
                                 "scheduler": self.scheduler.state_dict()},
                                self._pending_best, self.ckpoint_dir)
                self._pending_best = False
            self.current_epoch += 1
        self.close()
        print("Finished Training: {}".format(self.exp_name))

    def train_one_epoch(self):
        running_loss = 0.0
        period = self.config["print_batch_period"]
        iters_per_epoch = (self.config["samples_per_epoch"]
                           // self.config["batch_size"])
        meter = ThroughputMeter(n_chips=1)
        meter.start()
        for i in range(iters_per_epoch):
            batch = next(self._train_iter)
            images, labels = self._to_device(batch)
            self.state, loss, _ = self.train_step(self.state, images, labels)
            self.global_step = ((self.current_epoch - 1) * iters_per_epoch
                                + (i + 1) * self.config["batch_size"])
            running_loss += float(loss)     # waits for the step
            meter.step(volumes=self.config["batch_size"])
            if i % period == period - 1:
                avg = running_loss / period if i > 0 else running_loss
                print("Epoch[{}/{}] iter {} loss: {:.3f} lr:{} "
                      "{:.3f} vol/s/chip {}".format(
                          self.current_epoch, self.config["n_epochs"], i + 1,
                          avg, self.scheduler.lr,
                          meter.volumes_per_sec_per_chip,
                          datetime.datetime.now().strftime("%D %H:%M:%S")))
                self.writer.add_scalar("loss/training", avg,
                                       global_step=self.global_step)
                self.writer.add_scalar("learning_rate", self.scheduler.lr,
                                       global_step=self.global_step)
                self.writer.add_scalar(
                    "throughput/ingest_wait_fraction",
                    self.training_data_loader.wait_fraction,
                    global_step=self.global_step)
                self.writer.add_scalar("throughput/volumes_per_sec_per_chip",
                                       meter.volumes_per_sec_per_chip,
                                       global_step=self.global_step)
                running_loss = 0.0

    # -------------------------------------------------------------- eval
    def eval(self, dataloader):
        n_fg = self.config["n_classes"] - 1
        dice_sum = np.zeros((n_fg,), np.float64)
        count = 0
        for batch in dataloader:
            images, labels = self._to_device(batch)
            dice, _ = self.eval_step(self.state, images, labels)
            dice_sum += dice.double().sum(dim=0).cpu().numpy()
            count += dice.shape[0]
        dice_per_class = dice_sum / max(count, 1)
        return dice_per_class, float(dice_per_class.mean())

    def validate(self):
        if self.current_epoch % self.config["valid_epoch_period"]:
            return False
        start = time.time()
        dice_per_class, dice_avg = self.eval(self.validation_data_loader)
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

        ckpoint_file = os.path.join(self.ckpoint_dir,
                                    BEST_NAME if best else CKPT_NAME)
        if best and not os.path.isfile(ckpoint_file):
            # no validation ever beat the initial best score (e.g. very
            # short runs): test the periodic checkpoint instead
            print("=> no best checkpoint yet; testing the latest periodic "
                  "checkpoint instead")
            ckpoint_file = os.path.join(self.ckpoint_dir, CKPT_NAME)
        restored, last_epoch, _ = initialize_from(ckpoint_file,
                                                  map_location=self.device)
        self.model.load_state_dict(restored["model"])

        dice_per_class, dice_avg = self.eval(self.testing_data_loader)
        if if_log:
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
