"""Experiment lifecycle base.

Counterpart of ``deepatlas_tpu/train/base.py``: ``__init__(config)`` then
``train()`` / ``test()``, with the setup_log / seed / model / loss / data /
optimizer lifecycle.  Scalars and images go to ``ScalarWriter`` under the
tag names the JAX package gives its TensorBoard summaries: a JSON-lines
file and ``.npy`` files, and TensorBoard event files where the
``tensorboard`` package imports.

``BaseExperiment`` holds what the seg, reg and joint experiments share: the
constructor's device, mesh, debug overrides and checkpoint directory; the
log and the LR scheduler; ``train()``'s epoch loop (validation, the pending
best, the periodic save of ``_checkpoint_state()``, and the ``profile_dir``
key: a ``torch.profiler`` trace of the second epoch); resume; the copy of a
batch's arrays to the device (an ``experiment.copy_in`` span); and the
choice of ``test()``'s checkpoint.  Each experiment supplies its name, its
models, losses, data, steps, epoch, validation, ``_checkpoint_state()`` and
``_restore()``.

The parallel tiers (config keys ``data_parallel`` and ``spatial_shards``,
exclusive here as in the JAX experiments; DP x SP exists at the step level,
``parallel/spatial.py``) run one process per rank, as torchrun starts them
(``setup_parallel``).  Every rank loads the same batches with the same seed
and keeps its block (``local_batch``: its rows, or its depth slab); rank 0
alone writes logs, images and checkpoints.
"""
from __future__ import annotations

import json
import logging
import os
import random
import sys
import types

import numpy as np
import torch

from .. import resolve_device
from ..data import endless
from ..utils.config import save_dict_to_json
from ..utils.profiling import annotate, trace
from .checkpoint import BEST_NAME, CKPT_NAME, initialize_from
from .schedules import make_scheduler, scheduler_from_restored
from .steps import TrainState, set_learning_rate


def _summary_writer(log_dir: str):
    """``torch.utils.tensorboard.SummaryWriter(log_dir)``, or None where
    the ``tensorboard`` package does not import.  TensorBoard's TensorFlow
    switch is set to its stub first (``tensorboard.compat.notf``): the
    event files are the same, and the process does not import TensorFlow
    where it happens to be installed."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class ScalarWriter:
    """``add_scalar(tag, value, global_step)`` into ``<dir>/scalars.jsonl``,
    one JSON object per line, flushed as written; ``add_image(tag, img,
    global_step)`` into ``<dir>/images/<tag, "/" as "__">/<step>.npy``.
    Both go to TensorBoard event files in ``<dir>`` too where the
    ``tensorboard`` package imports (``tensorboard`` is None where it does
    not)."""

    FILE_NAME = "scalars.jsonl"
    IMAGE_DIR = "images"

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, self.FILE_NAME)
        self._file = open(self.path, "a")
        self.tensorboard = _summary_writer(log_dir)

    def add_scalar(self, tag: str, value, global_step: int) -> None:
        self._file.write(json.dumps({"tag": tag, "value": float(value),
                                     "step": int(global_step)}) + "\n")
        self._file.flush()
        if self.tensorboard is not None:
            self.tensorboard.add_scalar(tag, float(value), int(global_step))

    def image_path(self, tag: str, global_step: int) -> str:
        return os.path.join(self.log_dir, self.IMAGE_DIR,
                            tag.replace("/", "__"), f"{int(global_step)}.npy")

    def add_image(self, tag: str, img, global_step: int) -> None:
        """``img`` is a ``(3, H, W)`` array in [0, 1], stored as float32."""
        img = np.asarray(img, dtype=np.float32)
        if img.ndim != 3 or img.shape[0] != 3:
            raise ValueError(f"add_image {tag!r}: expected a (3, H, W) "
                             f"image, got {img.shape}")
        path = self.image_path(tag, global_step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, img)
        if self.tensorboard is not None:
            self.tensorboard.add_image(tag, img, int(global_step))

    def close(self) -> None:
        self._file.close()
        if self.tensorboard is not None:
            self.tensorboard.close()


class NullWriter:
    """The writer of a rank that logs nothing (ranks past 0)."""
    tensorboard = None

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    def add_image(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class BaseExperiment:
    mesh = None
    debug_dir: str      # the checkpoint directory's name under ``debug_mode``

    def __init__(self, config: dict):
        self.config = dict(config)
        self.writer = None
        self.device = resolve_device(self.config.get("device"))
        self.setup_parallel()
        if self.config.get("debug_mode"):
            print("Debug mode")
            self.config["print_batch_period"] = 2
            self.config["valid_epoch_period"] = 2
        self.exp_name = self.experiment_name()
        self.ckpoint_dir = os.path.join(
            self.config["log_dir"],
            self.exp_name if not self.config.get("debug_mode")
            else self.debug_dir,
            str(self.config["random_seed"]))
        print("Init experiment {} seed {}".format(
            self.exp_name, self.config["random_seed"]))
        self.current_epoch = 1
        self.global_step = 0
        self._pending_best = False

    def experiment_name(self) -> str:
        """The run's name, from the config: the checkpoint directory's."""
        raise NotImplementedError()

    # parallel tiers -------------------------------------------------------
    def setup_parallel(self) -> None:
        """The mesh the config asks for, in ``self.mesh`` (None for one
        process): ``spatial_shards`` > 1 splits depth over that many ranks,
        ``data_parallel`` the batch over every rank of the world.  Raises
        the JAX experiments' errors: the two are exclusive, and the batch
        must divide by the replicas.  ``dist_backend`` / ``dist_init``
        override the backend (NCCL on CUDA, gloo on the CPU) and the
        process group's address (torchrun's ``env://``)."""
        from ..parallel.mesh import env_world, make_mesh
        sp = int(self.config.get("spatial_shards") or 0)
        dp = bool(self.config.get("data_parallel"))
        if sp > 1 and dp:
            raise ValueError(
                "spatial_shards and data_parallel are exclusive in the "
                "experiment config; use the parallel/ API for a 2-D "
                "(data, space) mesh")
        if sp <= 1 and not dp:
            self.mesh = None
            return
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_initialized() \
            else env_world()[1]
        kw = dict(device=self.device, backend=self.config.get("dist_backend"),
                  init_method=self.config.get("dist_init"))
        if sp > 1:
            if world != sp:
                raise ValueError(f"spatial_shards={sp} needs {sp} ranks, the "
                                 f"world has {world}")
            self.mesh = make_mesh(space=sp, **kw)
        else:
            if self.config["batch_size"] % world:
                raise ValueError(
                    f"data_parallel needs batch_size divisible by {world} "
                    f"replicas, got {self.config['batch_size']}")
            self.mesh = make_mesh(data=world, **kw)
        self.device = self.mesh.device

    @property
    def is_writer(self) -> bool:
        """Whether this process writes logs and checkpoints (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def spatial(self) -> bool:
        return self.mesh is not None and self.mesh.axes["space"].size > 1

    def local_batch(self, x: np.ndarray) -> np.ndarray:
        """This rank's block of a loaded batch array: its depth slab under
        ``spatial_shards``, its rows under ``data_parallel``."""
        if self.mesh is None:
            return x
        from ..parallel.dp import shard_batch
        from ..parallel.spatial import shard_volume_batch
        if self.spatial:
            return shard_volume_batch(x, self.mesh)
        return shard_batch(x, self.mesh)

    def checkpoint(self, state: dict, is_best: bool, path: str) -> None:
        """``checkpoint.save_checkpoint`` on rank 0; every rank then waits
        until it is written (a later ``test()`` or resume reads it)."""
        from .checkpoint import save_checkpoint
        if self.is_writer:
            save_checkpoint(state, is_best, path)
        if self.mesh is not None and self.mesh.world_size > 1:
            import torch.distributed as dist
            dist.barrier()

    def make_writer(self, log_dir: str):
        """A ``ScalarWriter`` on rank 0, a ``NullWriter`` elsewhere."""
        return ScalarWriter(log_dir) if self.is_writer else NullWriter()

    # lifecycle hooks -----------------------------------------------------
    def setup_log(self):
        os.makedirs(self.ckpoint_dir, exist_ok=True)
        self.save_config_snapshot(self.ckpoint_dir)
        self.writer = self.make_writer(self.ckpoint_dir)

    def setup_random_seed(self):
        """Seed the numpy, Python and torch generators."""
        seed = self.config["random_seed"]
        np.random.seed(seed)
        random.seed(seed)
        torch.manual_seed(seed)

    def setup_train_data(self):
        pass

    def setup_model(self):
        pass

    def setup_loss(self):
        pass

    def setup_optimizer(self):
        self.scheduler = make_scheduler(
            self.config.get("lr_mode", "const"),
            self.config["learning_rate"], self.config["n_epochs"],
            self.config.get("milestones"), self.config.get("gamma", 0.2),
            self.config.get("valid_epoch_period", 1))

    def setup_train(self):
        self.setup_log()
        self.setup_random_seed()
        self.setup_model()
        self.setup_loss()
        self.setup_train_data()
        self.setup_optimizer()

    # helpers -------------------------------------------------------------
    def save_config_snapshot(self, path: str):
        if self.is_writer:
            save_dict_to_json(self.config, os.path.join(path,
                                                        "train_config.json"))

    def _to_device(self, *arrays, local: bool = False):
        """The numpy ``arrays`` on the device, in turn, inside one
        ``experiment.copy_in`` span; with ``local`` this rank's block of
        each (``local_batch``)."""
        cut = self.local_batch if local else (lambda x: x)
        with annotate("experiment.copy_in"):
            return [torch.from_numpy(cut(a)).to(self.device) for a in arrays]

    def _checkpoint_state(self) -> dict:
        """What the periodic save writes: the epoch, the models, their
        optimisers, the best scores and the scheduler."""
        raise NotImplementedError()

    def _restore(self, restored: dict, best: float) -> None:
        """Load the models, optimisers and best scores of a checkpoint
        (``best``: the score ``initialize_from`` found)."""
        raise NotImplementedError()

    def _maybe_resume(self):
        """Continue from ``resume_dir`` (a checkpoint file or its
        directory) where the config names one: the next epoch, the
        scheduler, and its learning rate on every ``TrainState``."""
        resume_dir = self.config.get("resume_dir")
        if not resume_dir:
            return
        restored, finished_epoch, best = initialize_from(
            resume_dir, map_location=self.device)
        self._restore(restored, best)
        # older checkpoints carry no scheduler state
        scheduler_from_restored(self.scheduler, restored.get("scheduler"))
        for state in vars(self).values():
            if isinstance(state, TrainState):
                set_learning_rate(state, self.scheduler.lr)
        self.current_epoch = finished_epoch + 1
        print("=> resumed from '{}' (epoch {})".format(resume_dir,
                                                       finished_epoch))

    def train(self):
        self.setup_train()
        print("Training {}".format(self.exp_name))
        self._init_state()
        self._maybe_resume()
        self._train_iter = endless(self.training_data_loader)
        print("Start Training:")
        profile_dir = self.config.get("profile_dir")
        for _ in range(self.current_epoch, self.config["n_epochs"] + 1):
            if profile_dir and self.current_epoch == 2:
                # trace the second epoch (the first builds the kernels)
                with trace(profile_dir):
                    self.train_one_epoch()
            else:
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
                self.checkpoint(self._checkpoint_state(), self._pending_best,
                                self.ckpoint_dir)
                self._pending_best = False
            self.current_epoch += 1
        self.close()
        print("Finished Training: {}".format(self.exp_name))

    def _test_checkpoint(self, best: bool):
        """``(path, restored, last_epoch)`` of the checkpoint ``test()``
        evaluates: the best one, or the periodic one where there is no best
        (no validation beat the initial score, e.g. in very short runs)."""
        ckpoint_file = os.path.join(self.ckpoint_dir,
                                    BEST_NAME if best else CKPT_NAME)
        if best and not os.path.isfile(ckpoint_file):
            print("=> no best checkpoint yet; testing the latest periodic "
                  "checkpoint instead")
            ckpoint_file = os.path.join(self.ckpoint_dir, CKPT_NAME)
        restored, last_epoch, _ = initialize_from(ckpoint_file,
                                                  map_location=self.device)
        return ckpoint_file, restored, last_epoch

    def close(self):
        if self.writer is not None:
            self.writer.close()
            self.writer = None


class test_logger:
    """Context manager yielding a logger that writes ``test_log.txt`` plus
    stderr, with explicit handlers: ``logging.basicConfig`` does nothing
    once an earlier experiment configured the root logger in-process."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self.logger = logging.getLogger(f"deepatlas_torch_test_{id(self)}")
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        self.fh = logging.FileHandler(self.path)
        self.sh = logging.StreamHandler()
        self.logger.addHandler(self.fh)
        self.logger.addHandler(self.sh)
        return self.logger

    def __exit__(self, *exc):
        self.logger.removeHandler(self.fh)
        self.logger.removeHandler(self.sh)
        self.fh.close()
        return False
