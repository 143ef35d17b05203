"""Training and inference: experiments, steps, schedules, checkpoints."""
from .base import BaseExperiment, ScalarWriter, test_logger
from .checkpoint import initialize_from, load_checkpoint, save_checkpoint
from .deepatlas import DeepAtlasExperiment
from .guard import DispOverflowGuard, make_guard
from .inference import (evaluate_sliding_window, make_tile_predictor,
                        sliding_window_predict, volume_dice)
from .reg_steps import (make_joint_reg_step, make_joint_seg_step,
                        make_reg_eval_step, make_reg_train_step)
from .registration import RegistrationExperiment
from .schedules import (ConstLR, MultiStepLR, ReduceLROnPlateau,
                        make_scheduler, scheduler_from_restored)
from .segmentation import SegmentationExperiment
from .steps import (TrainState, make_optimizer, make_seg_eval_step,
                    make_seg_train_step, set_learning_rate)

__all__ = ["BaseExperiment", "ConstLR", "DeepAtlasExperiment",
           "DispOverflowGuard", "MultiStepLR", "ReduceLROnPlateau",
           "RegistrationExperiment", "ScalarWriter",
           "SegmentationExperiment", "TrainState",
           "evaluate_sliding_window", "initialize_from", "load_checkpoint",
           "make_guard", "make_joint_reg_step", "make_joint_seg_step",
           "make_optimizer", "make_reg_eval_step", "make_reg_train_step",
           "make_scheduler", "make_seg_eval_step",
           "make_seg_train_step", "make_tile_predictor", "save_checkpoint",
           "scheduler_from_restored", "set_learning_rate",
           "sliding_window_predict", "test_logger", "volume_dice"]
