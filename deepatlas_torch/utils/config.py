"""JSON persistence of experiment configs (the ``train_config.json``
snapshot; counterpart of ``deepatlas_tpu/utils/config.py``'s
``save_dict_to_json``)."""
from __future__ import annotations

import json
import os


def _jsonable(value):
    try:
        json.dumps(value)
        return value
    except TypeError:
        if hasattr(value, "tolist"):
            return value.tolist()
        return str(value)


def save_dict_to_json(d: dict, json_path: str) -> None:
    """Persist a config dict (tuples/arrays coerced to lists/strings)."""
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    obj = {k: _jsonable(v) for k, v in dict(d).items()}
    with open(json_path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=str)
