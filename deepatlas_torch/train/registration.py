"""Registration experiment: pairwise deformable registration training.

Counterpart of ``deepatlas_tpu/train/registration.py``: pairwise reg
datasets, VoxelMorph + spatial transformer, LNCC similarity + bending-energy
or gradient regularization, the same experiment name, checkpoint-dir layout
and ``reg_best_score`` checkpoint key, scalars under the same tag names
(into ``scalars.jsonl``, see ``train/base.py``), resume and a logging
``test()``.  Validation warps the moving labels with the predicted field and
reports the mean foreground dice and the Jacobian folding fraction, both
computed on the device.

The device comes from the config key ``device`` (``cuda`` when absent; the
experiment raises without a card unless ``device="cpu"`` is asked for).

Not ported yet, and rejected rather than ignored when a config asks for
them: ``data_parallel``, ``spatial_shards`` (the parallel tiers) and
``image_summary`` (the TensorBoard image panels; none are written).  The
model settings that choose between the JAX package's TPU execution paths
(``packed``, ``use_pallas_warp``, ...) have no counterpart: the model's
constructor refuses them.
"""
from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import (Compose, CropVolume, DataLoader, VolumeToArray, endless,
                    get_reg_dataset)
from ..losses import get_loss_function
from ..models import get_network, resolve_model_settings
from .base import BaseExperiment, ScalarWriter, test_logger
from .checkpoint import BEST_NAME, CKPT_NAME, initialize_from, save_checkpoint
from .reg_steps import make_reg_eval_step, make_reg_train_step
from .schedules import make_scheduler, scheduler_from_restored
from .steps import TrainState, make_optimizer, set_learning_rate

_NOT_PORTED = ("data_parallel", "spatial_shards", "image_summary")


class RegistrationExperiment(BaseExperiment):
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

        self.exp_name = "Reg_{}_{}_{}epochs_{}_{}_w{}_lr_{}{}".format(
            self.config["model"],
            os.path.basename(self.config["data_dir"]),
            self.config["n_epochs"],
            self.config["loss"],
            self.config.get("reg_loss", "bendingEnergy"),
            self.config.get("reg_weight", 1.0),
            self.config["learning_rate"],
            "_scheduler_{}".format(self.config["lr_mode"])
            if self.config.get("lr_mode", "const") != "const" else "")

        self.ckpoint_dir = os.path.join(
            self.config["log_dir"],
            self.exp_name if not self.config.get("debug_mode") else "debug_reg",
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
        if self.config.get("crop_size"):
            transforms.append(CropVolume(self.config["crop_size"]))
        return Compose(transforms)

    def setup_train_data(self):
        print("Initializing dataloader")
        dataset_cls = get_reg_dataset(self.config["data"])
        tf = self._transforms()
        training_data = dataset_cls(
            self.config["training_list_file"], self.config["data_dir"],
            with_seg=True, preload=self.config.get("preload", False),
            pre_transform=tf, n_samples=self.config.get("num_samples"))
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
            validation_data, batch_size=1, shuffle=False, prefetch=2)

    def setup_model(self):
        model_type = get_network(self.config["model"])
        self.model = model_type(
            **resolve_model_settings(self.config.get("model_settings", {})))

    def setup_loss(self):
        self.sim_loss = get_loss_function(self.config["loss"])(
            **self.config.get("loss_settings", {}))
        self.reg_loss = get_loss_function(
            self.config.get("reg_loss", "bendingEnergy"))(
            **self.config.get("reg_loss_settings", {}))

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
        self.train_step = make_reg_train_step(
            self.sim_loss, self.reg_loss, self.config.get("reg_weight", 1.0),
            # surface the clamped warp's saturation as a step metric
            max_disp=self.model.max_disp)
        self.eval_step = make_reg_eval_step(self.config["n_classes"])

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

    def _to_device(self, batch, key):
        return torch.from_numpy(batch[key]).to(self.device)

    # ------------------------------------------------------------- train
    def train(self):
        self.setup_train()
        print("Training {}".format(self.exp_name))
        self._init_state()
        self._maybe_resume()
        self._train_iter = endless(self.training_data_loader)
        print("Start Training:")
        for _ in range(self.current_epoch, self.config["n_epochs"] + 1):
            self.train_one_epoch()
            if self.validate():
                # pending until persisted: a best found at a validation
                # epoch must survive to the next periodic save when the
                # save and validation cadences are coprime
                self._pending_best = True
            # periodic save independent of the validation cadence (a run
            # that never validates must still leave a checkpoint)
            if self.current_epoch % self.config["save_ckpts_epoch_period"] \
                    == 0:
                save_checkpoint({"epoch": self.current_epoch,
                                 "model": self.model.state_dict(),
                                 "optimizer":
                                     self.state.optimizer.state_dict(),
                                 "reg_best_score": self.best_score,
                                 "scheduler": self.scheduler.state_dict()},
                                self._pending_best, self.ckpoint_dir)
                self._pending_best = False
            self.current_epoch += 1
        self.close()
        print("Finished Training: {}".format(self.exp_name))

    def train_one_epoch(self):
        running = {"loss": 0.0, "sim": 0.0, "reg": 0.0}
        period = self.config["print_batch_period"]
        iters = (self.config["samples_per_epoch"]
                 // self.config["batch_size"])
        for i in range(iters):
            batch_m, batch_f = next(self._train_iter)
            moving = self._to_device(batch_m, "image")
            fixed = self._to_device(batch_f, "image")
            self.state, metrics = self.train_step(self.state, moving, fixed)
            self.global_step = ((self.current_epoch - 1) * iters + i + 1) \
                * self.config["batch_size"]
            for k in running:
                running[k] += float(metrics[k])     # waits for the step
            if i % period == period - 1:
                n = period if i > 0 else 1
                overflow = metrics.get("disp_overflow")
                print("Epoch[{}/{}] iter {} loss {:.4f} sim {:.4f} reg "
                      "{:.4f}{} lr {} {}".format(
                          self.current_epoch, self.config["n_epochs"], i + 1,
                          running["loss"] / n, running["sim"] / n,
                          running["reg"] / n,
                          "" if overflow is None else
                          " disp_overflow {:.4f}".format(float(overflow)),
                          self.scheduler.lr,
                          datetime.datetime.now().strftime("%D %H:%M:%S")))
                self.writer.add_scalar("loss/training",
                                       running["loss"] / n, self.global_step)
                self.writer.add_scalar("loss/similarity",
                                       running["sim"] / n, self.global_step)
                self.writer.add_scalar("loss/regularization",
                                       running["reg"] / n, self.global_step)
                self.writer.add_scalar("learning_rate", self.scheduler.lr,
                                       self.global_step)
                running = {k: 0.0 for k in running}

    # -------------------------------------------------------------- eval
    def eval(self, dataloader, max_pairs: int = None):
        """``(dice_per_class, dice_avg, folding_fraction)`` over the
        loader's pairs (the first ``max_pairs`` of them)."""
        n_fg = self.config["n_classes"] - 1
        dice_sum = np.zeros((n_fg,), np.float64)
        folding_sum = 0.0
        count = 0
        for batch_m, batch_f in dataloader:
            dice, folding, _ = self.eval_step(
                self.state, self._to_device(batch_m, "image"),
                self._to_device(batch_f, "image"),
                self._to_device(batch_m, "segmentation"),
                self._to_device(batch_f, "segmentation"))
            dice_sum += dice.double().sum(dim=0).cpu().numpy()
            folding_sum += float(folding)
            count += dice.shape[0]
            if max_pairs and count >= max_pairs:
                break
        dice_per_class = dice_sum / max(count, 1)
        return (dice_per_class, float(dice_per_class.mean()),
                folding_sum / max(count, 1))

    def validate(self):
        if self.current_epoch % self.config["valid_epoch_period"]:
            return False
        start = time.time()
        _, dice_avg, folding = self.eval(
            self.validation_data_loader,
            max_pairs=self.config.get("max_validation_pairs"))
        new_lr = self.scheduler.step(
            dice_avg if self.config.get("lr_mode") == "plateau" else None)
        self.state = set_learning_rate(self.state, new_lr)

        is_best = dice_avg > self.best_score
        if is_best:
            self.best_score = dice_avg
        data_name = self.config["data"]
        self.writer.add_scalar(f"validation_{data_name}/dice_avg", dice_avg,
                               self.global_step)
        self.writer.add_scalar(f"validation_{data_name}/folding_fraction",
                               folding, self.global_step)
        print("Validation: Dice Avg: {:.4f} folding {:.5f} ({:.3f} sec) {}"
              .format(dice_avg, folding, time.time() - start,
                      datetime.datetime.now().strftime("%D %H:%M:%S")))
        return is_best

    # -------------------------------------------------------------- test
    def test(self, best: bool = True, if_log: bool = True):
        self.setup_random_seed()
        self.setup_model()
        self.setup_loss()
        self.setup_optimizer()
        dataset_cls = get_reg_dataset(self.config["data"])
        testing_data = dataset_cls(
            self.config["testing_list_file"], self.config["data_dir"],
            with_seg=True, preload=False, pre_transform=self._transforms())
        self.validation_data_loader = DataLoader(testing_data, batch_size=1,
                                                 shuffle=False, prefetch=2)
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
        dice_per_class, dice_avg, folding = self.eval(
            self.validation_data_loader,
            max_pairs=self.config.get("max_validation_pairs"))
        if if_log:
            with test_logger(os.path.join(self.ckpoint_dir,
                                          "test_log.txt")) as log:
                log.info("Testing Model: %s (%s epochs)", ckpoint_file,
                         last_epoch)
                log.info("Dice_avg: %s folding: %s", dice_avg, folding)
        return dice_per_class, dice_avg, folding
