"""Config dictionaries with JSON persistence and per-key comments.

Counterpart of ``deepatlas_tpu/utils/config.py``: ``ParameterDict`` (a
dict whose entries may carry comments, with default-on-access reads),
``save_dict_to_json`` (the ``train_config.json`` snapshot) and
``load_json_to_dict`` / ``load_jason_to_dict``.  Comments serialize under a
parallel ``__comments__`` key, as in the JAX package, so a file written by
either package reads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

_COMMENTS_KEY = "__comments__"


class ParameterDict(dict):
    """A dict with optional per-key comments and default-on-access."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._comments: Dict[str, str] = {}

    def set(self, key: str, value: Any, comment: Optional[str] = None):
        self[key] = value
        if comment:
            self._comments[key] = comment
        return value

    def get_or_default(self, key: str, default: Any,
                       comment: Optional[str] = None) -> Any:
        """Return self[key], inserting (and so persisting) the default when
        absent."""
        if key not in self:
            self.set(key, default, comment)
        return self[key]

    def comment(self, key: str) -> Optional[str]:
        return self._comments.get(key)

    def to_json_obj(self) -> dict:
        obj = dict(self)
        if self._comments:
            obj[_COMMENTS_KEY] = dict(self._comments)
        return obj

    @classmethod
    def from_json_obj(cls, obj: dict) -> "ParameterDict":
        obj = dict(obj)
        comments = obj.pop(_COMMENTS_KEY, {})
        pd = cls(obj)
        pd._comments = dict(comments)
        return pd


def _jsonable(value):
    try:
        json.dumps(value)
        return value
    except TypeError:
        if hasattr(value, "tolist"):
            return value.tolist()
        return str(value)


def save_dict_to_json(d: dict, json_path: str) -> None:
    """Persist a config dict (tuples/arrays coerced to lists/strings; a
    ``ParameterDict``'s comments under ``__comments__``)."""
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    obj = d.to_json_obj() if isinstance(d, ParameterDict) else dict(d)
    obj = {k: _jsonable(v) for k, v in obj.items()}
    with open(json_path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=str)


def load_json_to_dict(json_path: str) -> ParameterDict:
    with open(json_path) as f:
        return ParameterDict.from_json_obj(json.load(f))


# the original reference's spelling of the loader
load_jason_to_dict = load_json_to_dict
