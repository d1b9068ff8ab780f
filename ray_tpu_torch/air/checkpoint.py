"""Checkpoint: the universal training-artifact currency.

Analog of Ray's python/ray/air/checkpoint.py:60 — a checkpoint
morphs between a dict, a directory, and bytes.  ray_tpu's copy also
speaks JAX (``from_jax`` / ``to_jax`` over orbax pytrees); those forms
wait for the trainer (ROADMAP.md, Queue 1, item 4).  A directory that
ray_tpu's ``Checkpoint.from_dict(...).to_directory()`` wrote reads here
as it is: both write the same pickled dict file.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tarfile
import tempfile
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch import cloudpickle

_DICT_FILE = "checkpoint_dict.pkl"
_META_FILE = "checkpoint_meta.json"


def _new_tmpdir() -> str:
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_checkpoints")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="ckpt_", dir=base)


class Checkpoint:
    """An immutable training artifact, convertible between forms.

    Construct with exactly one of ``from_dict``/``from_directory``/
    ``from_bytes``; consume with the matching ``to_*``.
    Conversions are lazy and cached.
    """

    def __init__(self, *, _data: Optional[Dict[str, Any]] = None,
                 _path: Optional[str] = None):
        if (_data is None) == (_path is None):
            raise ValueError("construct via from_dict/from_directory/"
                             "from_bytes")
        self._data = _data
        self._path = _path
        self.id = uuid.uuid4().hex[:16]

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(_data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(_path=os.path.abspath(path))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        return cls.from_dict(pickle.loads(blob))

    # -- converters --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        p = os.path.join(self._path, _DICT_FILE)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return pickle.load(f)
        raise ValueError(
            "directory checkpoint has no dict form; use to_directory")

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = _new_tmpdir()
        os.makedirs(path, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(path) != self._path:
                shutil.copytree(self._path, path, dirs_exist_ok=True)
            return path
        with open(os.path.join(path, _DICT_FILE), "wb") as f:
            cloudpickle.dump(self._data, f,
                             protocol=pickle.HIGHEST_PROTOCOL)
        return path

    def to_bytes(self) -> bytes:
        if self._data is not None:
            return cloudpickle.dumps(self._data,
                                 protocol=pickle.HIGHEST_PROTOCOL)
        # tar the directory into bytes (small checkpoints / tests only)
        import io
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            tar.add(self._path, arcname=".")
        return cloudpickle.dumps({"__dir_tar__": buf.getvalue()},
                                 protocol=pickle.HIGHEST_PROTOCOL)

    def metrics(self) -> Dict[str, Any]:
        try:
            path = self._resolve_dir()
        except ValueError:
            return {}
        p = os.path.join(path, _META_FILE)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f).get("metrics", {})
        return {}

    def _resolve_dir(self) -> str:
        if self._path is not None:
            return self._path
        if "__dir_tar__" in (self._data or {}):
            path = _new_tmpdir()
            import io
            with tarfile.open(
                    fileobj=io.BytesIO(self._data["__dir_tar__"])) as tar:
                tar.extractall(path)
            self._path = path
            return path
        raise ValueError("dict checkpoint has no directory form")

    def __reduce__(self):
        # Checkpoints travel through the object store as bytes; directory
        # checkpoints re-materialize on the receiving host.
        return (_checkpoint_from_bytes, (self.to_bytes(),))

    def __repr__(self):
        form = "dict" if self._data is not None else f"dir:{self._path}"
        return f"Checkpoint({form})"


def _checkpoint_from_bytes(blob: bytes) -> "Checkpoint":
    return Checkpoint.from_bytes(blob)

