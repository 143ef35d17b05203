"""Joint DeepAtlas experiment: alternating semi-supervised seg + reg training.

Counterpart of ``deepatlas_tpu/train/deepatlas.py``: a segmentation network
and a registration network trained alternately on image pairs of which only
the first ``n_labeled`` training volumes keep their labels --

  * seg phase (even iterations): supervised dice on the labelled sides +
    anatomy consistency through the frozen reg net's warp;
  * reg phase (odd iterations): similarity(warped moving, fixed) +
    smoothness(disp) + anatomy dice, with the frozen seg net predicting
    the anatomy of unlabelled volumes.

The same experiment name, checkpoint-dir layout, scalar tags (``seg/*``,
``reg/*``, ``validation_<data>/{seg_dice_avg,reg_dice_avg,
folding_fraction}``, into ``scalars.jsonl``), checkpoints carrying both
nets with ``seg_best_score`` / ``reg_best_score``, the pending-best rule,
resume, and a ``test()`` that falls back to the periodic checkpoint.  The
displacement-overflow guard escalates by default along the reference's
ladder: ``max_disp`` 8 -> 10 -> unclamped (the last rung also turns
``fused_anatomy`` and ``hard_fused`` off).

The device comes from the config key ``device`` (``cuda`` when absent; the
experiment raises without a card unless ``device="cpu"`` is asked for).
Not ported yet, and rejected rather than ignored when a config asks for
them: ``data_parallel``, ``spatial_shards`` (the parallel tiers),
``augmentation`` (the device-side augmenter) and ``image_summary`` (the
TensorBoard image panels); ``checkpoint_seg_apply`` is rejected for good
(see ``make_joint_seg_step``).
"""
from __future__ import annotations

import datetime
import os
import time
from functools import partial

import numpy as np
import torch

from .. import resolve_device
from ..data import (Compose, CropVolume, DataLoader, VolumeToArray, endless,
                    get_reg_dataset, get_seg_dataset)
from ..kernels import grid_sample
from ..losses import get_loss_function
from ..models import get_network, resolve_model_settings
from .base import BaseExperiment, ScalarWriter, test_logger
from .checkpoint import BEST_NAME, CKPT_NAME, initialize_from, save_checkpoint
from .guard import make_guard
from .reg_steps import (make_joint_reg_step, make_joint_seg_step,
                        make_reg_eval_step)
from .schedules import make_scheduler, scheduler_from_restored
from .steps import (TrainState, make_optimizer, make_seg_eval_step,
                    set_learning_rate)

_NOT_PORTED = ("data_parallel", "spatial_shards", "augmentation",
               "image_summary")

# The escalation ladder's last clamped rung, in voxels: the JAX package's
# MAX_PACKED_DISP (deepatlas_tpu/pallas/warp.py), the widest bound its TPU
# kernels resolve.  The port's kernels have no bound; the rung is kept so
# that a run clamps exactly where a JAX run does.
LAST_CLAMPED_RUNG = 10

# the one-hots and probabilities that the anatomy warps move, as the JAX
# experiment keeps them on both of its warp paths (the dice sums are float32)
ANATOMY_DTYPE = torch.bfloat16


class DeepAtlasExperiment(BaseExperiment):
    def __init__(self, config):
        super().__init__(config)
        for key in _NOT_PORTED:
            if self.config.get(key):
                raise NotImplementedError(
                    f"config key {key!r} is not ported to PyTorch yet; see "
                    f"Queue 1 of ROADMAP.md for the slice that brings it")
        if self.config.get("checkpoint_seg_apply"):
            raise NotImplementedError(
                "checkpoint_seg_apply is not ported: recomputing the seg "
                "net's train-mode forward would update BatchNorm twice")
        self.device = resolve_device(self.config.get("device"))
        if self.config.get("debug_mode"):
            print("Debug mode")
            self.config["print_batch_period"] = 2
            self.config["valid_epoch_period"] = 2

        self.exp_name = "DeepAtlas_{}_{}_{}labeled_{}epochs_lr_{}".format(
            os.path.basename(self.config["data_dir"]),
            self.config["seg_model"],
            self.config.get("n_labeled", "all"),
            self.config["n_epochs"],
            self.config["learning_rate"])
        self.ckpoint_dir = os.path.join(
            self.config["log_dir"],
            self.exp_name if not self.config.get("debug_mode")
            else "debug_deepatlas",
            str(self.config["random_seed"]))
        print("Init experiment {} seed {}".format(
            self.exp_name, self.config["random_seed"]))
        self.seg_best_score = 0.0
        self.reg_best_score = 0.0
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

    def _eval_loaders(self, list_file, data_dir):
        tf = self._transforms()
        preload = self.config.get("preload", False)
        reg = DataLoader(get_reg_dataset(self.config["data"])(
            list_file, data_dir, with_seg=True, preload=preload,
            pre_transform=tf), batch_size=1, shuffle=False, prefetch=2)
        seg = DataLoader(get_seg_dataset(self.config["data"])(
            list_file, data_dir, with_seg=True, preload=preload,
            pre_transform=tf), batch_size=1, shuffle=False, prefetch=2)
        return reg, seg

    def setup_train_data(self):
        print("Initializing dataloader")
        training_data = get_reg_dataset(self.config["data"])(
            self.config["training_list_file"], self.config["data_dir"],
            with_seg=True, preload=self.config.get("preload", False),
            pre_transform=self._transforms(),
            n_samples=self.config.get("num_samples"))
        self.training_data_loader = DataLoader(
            training_data, batch_size=self.config["batch_size"], shuffle=True,
            seed=self.config["random_seed"],
            prefetch=self.config.get("prefetch", 2),
            num_workers=self.config.get("num_workers"))
        # semi-supervision: only the first n_labeled scans keep their labels
        self.n_labeled = self.config.get("n_labeled")
        self.labeled_names = set(training_data.name_list[:self.n_labeled]
                                 if self.n_labeled else
                                 training_data.name_list)
        self.validation_reg_loader, self.validation_seg_loader = \
            self._eval_loaders(
                self.config["validation_list_file"],
                self.config.get("valid_data_dir", self.config["data_dir"]))

    def setup_model(self):
        self.seg_model = get_network(self.config["seg_model"])(
            **resolve_model_settings(self.config["seg_model_settings"]))
        self.reg_model = get_network(self.config["reg_model"])(
            **resolve_model_settings(
                self.config.get("reg_model_settings", {})))

    def setup_loss(self):
        self.sim_loss = get_loss_function(self.config.get("sim_loss", "lncc"))(
            **self.config.get("sim_loss_settings", {}))
        self.reg_loss = get_loss_function(
            self.config.get("reg_loss", "bendingEnergy"))(
            **self.config.get("reg_loss_settings", {}))
        self.sup_loss = get_loss_function(self.config.get("seg_loss", "dice"))(
            **self.config.get("seg_loss_settings",
                              {"n_class": self.config["n_classes"],
                               "weight_type": "Uniform", "softmax": True}))

    def setup_optimizer(self):
        self.scheduler = make_scheduler(
            self.config.get("lr_mode", "const"),
            self.config["learning_rate"], self.config["n_epochs"],
            self.config.get("milestones"), self.config.get("gamma", 0.2),
            self.config.get("valid_epoch_period", 1))

    def _init_state(self):
        self.seg_model.to(self.device)
        self.reg_model.to(self.device)
        self.seg_state = TrainState(self.seg_model, make_optimizer(
            self.seg_model, self.config["learning_rate"]))
        self.reg_state = TrainState(self.reg_model, make_optimizer(
            self.reg_model, self.config.get("reg_learning_rate",
                                            self.config["learning_rate"])))
        self._build_steps()
        # escalate by default: the unclamped warp is the reference's
        # semantics, and a clamp-saturated field trains a surrogate of it
        self.overflow_guard = make_guard(self.config,
                                         default_mode="escalate")

    def _build_steps(self):
        """(Re)build the phase steps from the current config; also what the
        overflow guard's actions call after they change ``max_disp``."""
        n_class = self.config["n_classes"]
        max_disp = self.config.get("max_disp", 8)
        # the seg phase's field is a constant: values-only warp backward
        seg_warp_fn = partial(grid_sample, max_disp=max_disp, grad="values")
        self.reg_step = make_joint_reg_step(
            self.sim_loss, self.reg_loss,
            self.config.get("reg_weight", 1.0),
            self.config.get("anatomy_weight", 1.0), n_class,
            warp_fn=partial(grid_sample, max_disp=max_disp),
            anatomy_dtype=ANATOMY_DTYPE, max_disp=max_disp,
            fused_anatomy=self.config.get("fused_anatomy",
                                          max_disp is not None))
        self.seg_step = make_joint_seg_step(
            self.sup_loss, self.config.get("anatomy_weight", 1.0),
            self.config.get("supervised_weight", 1.0), n_class,
            warp_fn=seg_warp_fn, anatomy_dtype=ANATOMY_DTYPE,
            hard_fused=self.config.get("hard_fused", max_disp is not None),
            max_disp=max_disp)
        self.seg_eval_step = make_seg_eval_step(n_class)
        self.reg_eval_step = make_reg_eval_step(n_class)

    def _apply_guard_action(self, action: dict):
        """Perform a DispOverflowGuard action: warn, widen ``max_disp``, or
        warp unclamped; the latter two rebuild the phase steps."""
        md = self.config.get("max_disp", 8)
        if action["action"] == "warn":
            print("=> WARNING: disp_overflow above threshold for {} "
                  "consecutive steps at max_disp={}: displacement fields "
                  "are saturating the warp's clamp. Raise --max-disp or set "
                  "overflow_guard={{'mode': 'escalate'}}."
                  .format(self.overflow_guard.patience, md))
            return
        if action["action"] == "escalate":
            new_md = action["max_disp"]
            if new_md > LAST_CLAMPED_RUNG > md:
                # the reference tries its last clamped rung before going
                # unclamped
                new_md = LAST_CLAMPED_RUNG
            if new_md > LAST_CLAMPED_RUNG:
                print("=> disp_overflow persistent: requested max_disp {} "
                      "is past the last clamped rung ({}): warping "
                      "unclamped instead".format(new_md, LAST_CLAMPED_RUNG))
                action = {"action": "xla"}
            else:
                print("=> disp_overflow persistent: escalating max_disp "
                      "{} -> {} and rebuilding the phase steps".format(
                          md, new_md))
                self._set_max_disp(new_md)
        if action["action"] == "xla":
            print("=> disp_overflow persistent: switching to the unclamped "
                  "warp and rebuilding the phase steps")
            self._set_max_disp(None)
            self.config["fused_anatomy"] = False
            self.config["hard_fused"] = False
        self._build_steps()

    def _set_max_disp(self, max_disp):
        self.config["max_disp"] = max_disp
        rs = dict(self.config.get("reg_model_settings", {}))
        rs["max_disp"] = max_disp
        self.config["reg_model_settings"] = rs
        self.reg_model.max_disp = max_disp

    def _checkpoint_state(self) -> dict:
        return {"epoch": self.current_epoch,
                "seg_model": self.seg_model.state_dict(),
                "seg_optimizer": self.seg_state.optimizer.state_dict(),
                "reg_model": self.reg_model.state_dict(),
                "reg_optimizer": self.reg_state.optimizer.state_dict(),
                "seg_best_score": self.seg_best_score,
                "reg_best_score": self.reg_best_score,
                "scheduler": self.scheduler.state_dict()}

    def _maybe_resume(self):
        resume_dir = self.config.get("resume_dir")
        if not resume_dir:
            return
        restored, finished_epoch, _ = initialize_from(
            resume_dir, map_location=self.device)
        self.seg_model.load_state_dict(restored["seg_model"])
        self.seg_state.optimizer.load_state_dict(restored["seg_optimizer"])
        self.reg_model.load_state_dict(restored["reg_model"])
        self.reg_state.optimizer.load_state_dict(restored["reg_optimizer"])
        scheduler_from_restored(self.scheduler, restored.get("scheduler"))
        for state in (self.seg_state, self.reg_state):
            set_learning_rate(state, self.scheduler.lr)
        self.seg_best_score = float(restored["seg_best_score"])
        self.reg_best_score = float(restored["reg_best_score"])
        self.current_epoch = finished_epoch + 1
        print("=> resumed from '{}' (epoch {})".format(resume_dir,
                                                       finished_epoch))

    def _to_device(self, batch, key):
        t = torch.from_numpy(batch[key]).to(self.device)
        return t.long() if key == "segmentation" else t

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
                save_checkpoint(self._checkpoint_state(), self._pending_best,
                                self.ckpoint_dir)
                self._pending_best = False
            self.current_epoch += 1
        self.close()
        print("Finished Training: {}".format(self.exp_name))

    def _has_label_flags(self, batch) -> torch.Tensor:
        """``(B,)`` bool on the host: which volumes keep their labels."""
        return torch.tensor([name in self.labeled_names
                             for name in batch["name"]], dtype=torch.bool)

    def train_one_epoch(self):
        period = self.config["print_batch_period"]
        iters = (self.config["samples_per_epoch"]
                 // self.config["batch_size"])
        run_reg = {"loss": 0.0, "sim": 0.0, "anatomy": 0.0}
        run_seg = {"loss": 0.0, "supervised": 0.0, "anatomy": 0.0}
        for i in range(iters):
            batch_m, batch_f = next(self._train_iter)
            args = (self._to_device(batch_m, "image"),
                    self._to_device(batch_f, "image"),
                    self._to_device(batch_m, "segmentation"),
                    self._to_device(batch_f, "segmentation"),
                    self._has_label_flags(batch_m),
                    self._has_label_flags(batch_f))
            # alternate phases (seg on even iterations, reg on odd)
            if i % 2 == 0:
                self.seg_state, metrics = self.seg_step(self.seg_state,
                                                        self.reg_state, *args)
                for k in run_seg:
                    run_seg[k] += float(metrics[k])
            else:
                self.reg_state, metrics = self.reg_step(self.reg_state,
                                                        self.seg_state, *args)
                for k in run_reg:
                    run_reg[k] += float(metrics[k])
                if self.overflow_guard is not None \
                        and "disp_overflow" in metrics:
                    act = self.overflow_guard.update(
                        float(metrics["disp_overflow"]),
                        self.config.get("max_disp", 8))
                    if act is not None:
                        self._apply_guard_action(act)
            self.global_step = ((self.current_epoch - 1) * iters + i + 1) \
                * self.config["batch_size"]
            if i % period == period - 1:
                n = max(period // 2, 1)
                print("Epoch[{}/{}] iter {} seg_loss {:.4f} reg_loss {:.4f} "
                      "anat {:.4f} {}".format(
                          self.current_epoch, self.config["n_epochs"], i + 1,
                          run_seg["loss"] / n, run_reg["loss"] / n,
                          run_reg["anatomy"] / n,
                          datetime.datetime.now().strftime("%D %H:%M:%S")))
                for k, v in run_seg.items():
                    self.writer.add_scalar(f"seg/{k}", v / n,
                                           self.global_step)
                for k, v in run_reg.items():
                    self.writer.add_scalar(f"reg/{k}", v / n,
                                           self.global_step)
                run_reg = {k: 0.0 for k in run_reg}
                run_seg = {k: 0.0 for k in run_seg}

    # -------------------------------------------------------------- eval
    def eval(self, seg_loader, reg_loader, max_pairs=None):
        """``(seg_dice_per_class, seg_dice_avg, reg_dice_per_class,
        reg_dice_avg, folding)``: the seg net's dice over ``seg_loader``'s
        volumes, the warped-label dice and folding fraction over
        ``reg_loader``'s pairs (the first ``max_pairs`` of them)."""
        n_fg = self.config["n_classes"] - 1
        dice_sum = np.zeros((n_fg,), np.float64)
        count = 0
        for batch in seg_loader:
            dice, _ = self.seg_eval_step(
                self.seg_state, self._to_device(batch, "image"),
                self._to_device(batch, "segmentation"))
            dice_sum += dice.double().sum(dim=0).cpu().numpy()
            count += dice.shape[0]
        seg_per_class = dice_sum / max(count, 1)

        dice_sum = np.zeros((n_fg,), np.float64)
        folding_sum = 0.0
        count = 0
        for batch_m, batch_f in reg_loader:
            dice, folding, _ = self.reg_eval_step(
                self.reg_state, self._to_device(batch_m, "image"),
                self._to_device(batch_f, "image"),
                self._to_device(batch_m, "segmentation"),
                self._to_device(batch_f, "segmentation"))
            dice_sum += dice.double().sum(dim=0).cpu().numpy()
            folding_sum += float(folding)
            count += dice.shape[0]
            if max_pairs and count >= max_pairs:
                break
        reg_per_class = dice_sum / max(count, 1)
        return (seg_per_class, float(seg_per_class.mean()), reg_per_class,
                float(reg_per_class.mean()), folding_sum / max(count, 1))

    def validate(self):
        if self.current_epoch % self.config["valid_epoch_period"]:
            return False
        start = time.time()
        _, seg_dice, _, reg_dice, folding = self.eval(
            self.validation_seg_loader, self.validation_reg_loader,
            self.config.get("max_validation_pairs"))
        new_lr = self.scheduler.step(
            seg_dice if self.config.get("lr_mode") == "plateau" else None)
        for state in (self.seg_state, self.reg_state):
            set_learning_rate(state, new_lr)

        seg_best = seg_dice > self.seg_best_score
        reg_best = reg_dice > self.reg_best_score
        if seg_best:
            self.seg_best_score = seg_dice
        if reg_best:
            self.reg_best_score = reg_dice

        data_name = self.config["data"]
        self.writer.add_scalar(f"validation_{data_name}/seg_dice_avg",
                               seg_dice, self.global_step)
        self.writer.add_scalar(f"validation_{data_name}/reg_dice_avg",
                               reg_dice, self.global_step)
        self.writer.add_scalar(f"validation_{data_name}/folding_fraction",
                               folding, self.global_step)
        print("Validation: seg dice {:.4f} reg dice {:.4f} folding {:.5f} "
              "({:.3f} sec) {}".format(
                  seg_dice, reg_dice, folding, time.time() - start,
                  datetime.datetime.now().strftime("%D %H:%M:%S")))
        return seg_best or reg_best

    # -------------------------------------------------------------- test
    def test(self, best: bool = True, if_log: bool = True):
        """Held-out evaluation of both restored nets on
        ``testing_list_file``: seg dice per class, warped-label dice and
        folding fraction over the test pairs, logged to ``test_log.txt``.
        Returns ``(seg_dice_per_class, seg_dice_avg, reg_dice_per_class,
        reg_dice_avg, folding)``."""
        self.setup_random_seed()
        self.setup_model()
        self.setup_loss()
        self.setup_optimizer()
        test_dir = self.config.get("test_data_dir", self.config["data_dir"])
        reg_loader, seg_loader = self._eval_loaders(
            self.config["testing_list_file"], test_dir)
        self._init_state()

        ckpoint_file = os.path.join(self.ckpoint_dir,
                                    BEST_NAME if best else CKPT_NAME)
        if best and not os.path.isfile(ckpoint_file):
            # no validation ever beat the initial scores (e.g. very short
            # runs): test the periodic checkpoint instead
            print("=> no best checkpoint yet; testing the latest periodic "
                  "checkpoint instead")
            ckpoint_file = os.path.join(self.ckpoint_dir, CKPT_NAME)
        restored, last_epoch, _ = initialize_from(ckpoint_file,
                                                  map_location=self.device)
        self.seg_model.load_state_dict(restored["seg_model"])
        self.reg_model.load_state_dict(restored["reg_model"])

        result = self.eval(seg_loader, reg_loader, self.config.get(
            "max_test_pairs", self.config.get("max_validation_pairs")))
        seg_per_class, seg_dice, reg_per_class, reg_dice, folding = result
        if if_log:
            n_fg = self.config["n_classes"] - 1
            class_name = self.config.get("class_name", {})
            with test_logger(os.path.join(self.ckpoint_dir,
                                          "test_log.txt")) as log:
                log.info("\n" + "=" * 50 + "\n")
                log.info("Testing Model: %s (%s epochs)\n", ckpoint_file,
                         last_epoch)
                log.info("Test data: %s\n", test_dir)
                log.info("Test list: %s\n",
                         self.config["testing_list_file"])
                log.info("\n" + "-" * 50 + "\n")
                log.info("Seg_Dice_avg: %s", seg_dice)
                for c in range(n_fg):
                    log.info("Seg_Dice_%s:%.3f",
                             class_name.get(c + 1, str(c + 1)),
                             seg_per_class[c])
                log.info("Reg_Dice_avg: %s folding: %s", reg_dice, folding)
                for c in range(n_fg):
                    log.info("Reg_Dice_%s:%.3f",
                             class_name.get(c + 1, str(c + 1)),
                             reg_per_class[c])
                log.info("\n" + "-" * 50 + "\n")
        return result
