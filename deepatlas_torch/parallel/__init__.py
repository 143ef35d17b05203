"""Parallelism over ``torch.distributed``: the ``(data, space)`` mesh,
data-parallel and spatial (depth-sharded) train and eval steps.

Counterpart of ``deepatlas_tpu/parallel``: each mesh position is a rank,
the data-parallel steps average gradients, BatchNorm statistics and metrics
over the ``data`` axis in bucketed all-reduces (``dp.py``), and the spatial
tier splits each volume's depth over the ``space`` axis with halo-exchanged
convs on kernel A at depth padding 0 (``spatial.py``, ``ops/halo.py``);
the two compose on a 2-D mesh at the step level.

The step modules load on first use of their names (the models and losses
import this package's collectives, and the steps import the models).
"""
from .mesh import Axis, Mesh, local_device_count, make_mesh, shutdown

_LAZY = {
    "make_dp_seg_train_step": "dp", "make_dp_seg_eval_step": "dp",
    "make_dp_confusion_eval_step": "dp", "make_dp_reg_train_step": "dp",
    "make_dp_joint_steps": "dp", "shard_batch": "dp", "replicate": "dp",
    "make_spatial_joint_steps": "spatial", "make_spatial_reg_step": "spatial",
    "make_spatial_seg_eval_step": "spatial",
    "make_spatial_seg_forward": "spatial", "make_spatial_seg_step": "spatial",
    "shard_volume_batch": "spatial",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Axis", "Mesh", "local_device_count", "make_mesh", "shutdown",
           *_LAZY]
