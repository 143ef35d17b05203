"""Registration experiment: pairwise deformable registration training.

Counterpart of ``deepatlas_tpu/train/registration.py``: pairwise reg
datasets, VoxelMorph + spatial transformer, LNCC similarity + bending-energy
or gradient regularization, the same experiment name, checkpoint-dir layout
and ``reg_best_score`` checkpoint key, scalars under the same tag names
(into ``scalars.jsonl``, see ``train/base.py``), resume and a logging
``test()``.  Validation warps the moving labels with the predicted field and
reports the mean foreground dice and the Jacobian folding fraction, both
computed on the device.  With ``image_summary`` (default True) each
validation writes the image panels of the first validation pair
(``validation/{images,disp_field,masks,deform_grid}``,
``write_registration_summaries``).  A pair's copy to the device is an
``experiment.copy_in`` span (``utils/profiling.py``).

The device comes from the config key ``device`` (``cuda`` when absent; the
experiment raises without a card unless ``device="cpu"`` is asked for).

The parallel tiers (``train/base.py``): ``data_parallel`` splits each
batch's pairs over the world's ranks (``parallel.dp``), ``spatial_shards``
splits each volume's depth (``parallel.spatial``; the lncc + bendingEnergy
pair, the losses with depth-sharded reductions).  Validation runs whole
volumes on every rank, as the JAX experiment keeps it on one device.  The
model settings that choose between the JAX package's TPU execution paths
(``packed``, ``use_pallas_warp``, ...) have no counterpart: the model's
constructor refuses them.
"""
from __future__ import annotations

import datetime
import importlib.util
import os
import time

import numpy as np
import torch

from ..data import (Compose, CropVolume, DataLoader, VolumeToArray,
                    get_reg_dataset)
from ..losses import get_loss_function
from ..models import get_network, resolve_model_settings
from ..ops import warp_labels
from ..utils import visualize
from .base import BaseExperiment, test_logger
from .reg_steps import make_reg_eval_step, make_reg_train_step
from .steps import TrainState, make_optimizer, set_learning_rate


def write_registration_summaries(writer, model, loader, device,
                                 prefix: str, global_step: int):
    """The image panels of ``loader``'s first pair under ``prefix``: the
    model's eval-mode forward, the moving labels warped by nearest
    neighbour, ``make_registration_image_summary``'s grids (``images``,
    ``disp_field``, ``masks``) and the contour grid of the deformation's
    mid-depth slice (``deform_grid``, which needs matplotlib: where it does
    not import, one line names the skipped tag).  Returns the pair's
    moving image and labels on ``device``."""
    batch_m, batch_f = next(iter(loader))
    moving = torch.from_numpy(batch_m["image"][:1]).to(device)
    fixed = torch.from_numpy(batch_f["image"][:1]).to(device)
    mseg = torch.from_numpy(batch_m["segmentation"][:1]).to(device).long()
    with torch.no_grad():
        disp, warped, deform = model(moving, fixed, train=False)
        warped_seg = warp_labels(mseg, deform)
    warped = warped.float().cpu().numpy()
    deform = deform.float().cpu().numpy()
    grids = visualize.make_registration_image_summary(
        batch_m["image"][:1], batch_f["image"][:1], warped,
        disp.float().cpu().numpy(), deform, mseg.cpu().numpy(),
        batch_f["segmentation"][:1], warped_seg.cpu().numpy())
    for name, img in grids.items():
        writer.add_image(f"{prefix}/{name}", img, global_step)
    if importlib.util.find_spec("matplotlib") is None:
        print(f"=> matplotlib does not import: image summary "
              f"{prefix}/deform_grid not written")
    else:
        mid = deform.shape[1] // 2
        writer.add_image(f"{prefix}/deform_grid",
                         visualize.generate_deform_grid(
                             deform[0, mid, :, :, 0:2],
                             np.clip(warped[0, mid, :, :, 0], 0, 1)),
                         global_step)
    return moving, mseg


class RegistrationExperiment(BaseExperiment):
    debug_dir = "debug_reg"

    def __init__(self, config):
        super().__init__(config)
        self.best_score = 0.0

    def experiment_name(self) -> str:
        return "Reg_{}_{}_{}epochs_{}_{}_w{}_lr_{}{}".format(
            self.config["model"],
            os.path.basename(self.config["data_dir"]),
            self.config["n_epochs"],
            self.config["loss"],
            self.config.get("reg_loss", "bendingEnergy"),
            self.config.get("reg_weight", 1.0),
            self.config["learning_rate"],
            "_scheduler_{}".format(self.config["lr_mode"])
            if self.config.get("lr_mode", "const") != "const" else "")

    # ------------------------------------------------------------- setup
    def _transforms(self):
        transforms = [VolumeToArray()]
        if self.config.get("crop_size"):
            transforms.append(CropVolume(self.config["crop_size"]))
        return Compose(transforms)

    def setup_train_data(self):
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
        print("Initializing dataloader: {} decode threads".format(
            self.training_data_loader.num_workers))
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

    def _init_state(self):
        self.model.to(self.device)
        self.state = TrainState(
            self.model, make_optimizer(self.model,
                                       self.config["learning_rate"]))
        reg_weight = self.config.get("reg_weight", 1.0)
        if self.spatial:
            from ..parallel import make_spatial_reg_step, replicate
            if self.config["loss"] != "lncc" or self.config.get(
                    "reg_loss", "bendingEnergy") != "bendingEnergy":
                raise ValueError(
                    "spatial_shards supports the lncc + bendingEnergy "
                    "losses (the axis_name-capable pair, losses/)")
            replicate(self.model, self.mesh)
            self.train_step = make_spatial_reg_step(
                self.model, get_loss_function(self.config["loss"]),
                get_loss_function(self.config.get("reg_loss",
                                                  "bendingEnergy")),
                reg_weight, self.mesh,
                sim_kwargs=self.config.get("loss_settings", {}),
                reg_kwargs=self.config.get("reg_loss_settings", {}))
        elif self.mesh is not None:
            from ..parallel import make_dp_reg_train_step, replicate
            replicate(self.model, self.mesh)
            self.train_step = make_dp_reg_train_step(
                self.sim_loss, self.reg_loss, reg_weight, self.mesh,
                max_disp=self.model.max_disp)
        else:
            self.train_step = make_reg_train_step(
                self.sim_loss, self.reg_loss, reg_weight,
                # surface the clamped warp's saturation as a step metric
                max_disp=self.model.max_disp)
        self.eval_step = make_reg_eval_step(self.config["n_classes"])

    def _checkpoint_state(self) -> dict:
        return {"epoch": self.current_epoch,
                "model": self.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(),
                "reg_best_score": self.best_score,
                "scheduler": self.scheduler.state_dict()}

    def _restore(self, restored: dict, best: float) -> None:
        self.model.load_state_dict(restored["model"])
        self.state.optimizer.load_state_dict(restored["optimizer"])
        self.best_score = best

    # ------------------------------------------------------------- train
    def train_one_epoch(self):
        running = {"loss": 0.0, "sim": 0.0, "reg": 0.0}
        period = self.config["print_batch_period"]
        iters = (self.config["samples_per_epoch"]
                 // self.config["batch_size"])
        for i in range(iters):
            batch_m, batch_f = next(self._train_iter)
            moving, fixed = self._to_device(batch_m["image"],
                                            batch_f["image"], local=True)
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
            dice, folding, _ = self.eval_step(self.state, *self._to_device(
                batch_m["image"], batch_f["image"], batch_m["segmentation"],
                batch_f["segmentation"]))
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
        if self.config.get("image_summary", True):
            write_registration_summaries(
                self.writer, self.model, self.validation_data_loader,
                self.device, "validation", self.global_step)
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
        ckpoint_file, restored, last_epoch = self._test_checkpoint(best)
        self.model.load_state_dict(restored["model"])
        dice_per_class, dice_avg, folding = self.eval(
            self.validation_data_loader,
            max_pairs=self.config.get("max_validation_pairs"))
        if if_log and self.is_writer:
            with test_logger(os.path.join(self.ckpoint_dir,
                                          "test_log.txt")) as log:
                log.info("Testing Model: %s (%s epochs)", ckpoint_file,
                         last_epoch)
                log.info("Dice_avg: %s folding: %s", dice_avg, folding)
        return dice_per_class, dice_avg, folding
