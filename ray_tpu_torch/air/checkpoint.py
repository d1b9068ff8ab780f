"""Checkpoint: the universal training-artifact currency.

Analog of Ray's python/ray/air/checkpoint.py:60 — a checkpoint
morphs between a dict, a directory, and bytes.  ray_tpu's copy also
speaks JAX (``from_jax`` / ``to_jax`` over orbax pytrees); the port
speaks torch instead: ``from_torch`` / ``to_torch`` (``save_torch_state``
/ ``load_torch_state``) keep a nested dict of tensors, moved to the CPU
first, as one ``torch.save`` file in the directory form.  A directory
that ray_tpu's ``Checkpoint.from_dict(...).to_directory()`` wrote reads
here as it is: both write the same pickled dict file.  One that
``from_jax`` wrote does not (a ``jax`` treedef, or orbax's tensorstore):
read it with ray_tpu's ``to_jax`` and convert the numpy leaves with
``models/convert.py`` ``params_from_jax``.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import socket
import tarfile
import tempfile
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch import cloudpickle

_DICT_FILE = "checkpoint_dict.pkl"
_TORCH_DIR = "torch_state"
_TORCH_FILE = "state.pt"
_META_FILE = "checkpoint_meta.json"


def _new_tmpdir() -> str:
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_checkpoints")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="ckpt_", dir=base)


class Checkpoint:
    """An immutable training artifact, convertible between forms.

    Construct with exactly one of ``from_dict``/``from_directory``/
    ``from_bytes``/``from_torch``; consume with the matching ``to_*``.
    Conversions are lazy and cached.
    """

    def __init__(self, *, _data: Optional[Dict[str, Any]] = None,
                 _path: Optional[str] = None):
        if (_data is None) == (_path is None):
            raise ValueError("construct via from_dict/from_directory/"
                             "from_bytes/from_torch")
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

    @classmethod
    def from_torch(cls, state: Any,
                   metrics: Optional[Dict[str, Any]] = None,
                   path: Optional[str] = None) -> "Checkpoint":
        """Save ``state`` (a nested dict / list / tuple of tensors and
        plain values: a state dict, ``{"params": ...}``) into a
        directory-form checkpoint at ``path`` (default: a new temporary
        directory).  Tensors on the card are copied to the CPU first."""
        path = path or _new_tmpdir()
        save_torch_state(os.path.join(path, _TORCH_DIR), state)
        with open(os.path.join(path, _META_FILE), "w") as f:
            json.dump({"metrics": metrics or {}, "format": "torch"}, f)
        return cls.from_directory(path)

    # -- converters --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        p = os.path.join(self._path, _DICT_FILE)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return pickle.load(f)
        raise ValueError("directory checkpoint has no dict form; use "
                         "to_directory/to_torch")

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

    def to_torch(self, map_location: Any = None) -> Any:
        """Restore what ``from_torch`` saved; ``map_location`` as for
        ``torch.load`` (default: the CPU)."""
        path = self._resolve_dir()
        return load_torch_state(os.path.join(path, _TORCH_DIR),
                                map_location)

    def has_torch_state(self) -> bool:
        try:
            path = self._resolve_dir()
        except ValueError:
            return False
        return os.path.exists(os.path.join(path, _TORCH_DIR, _TORCH_FILE))

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
        # dict checkpoints travel through the object store as bytes; a
        # directory one travels as its path on this host (ray_tpu's copy
        # tars it: a trainer's 0.5 GB torch checkpoint would cross the
        # store twice), so only a process of this host can open it
        if self._path is not None:
            return (_checkpoint_from_path, (self._path, socket.gethostname()))
        return (_checkpoint_from_bytes, (self.to_bytes(),))

    def __repr__(self):
        form = "dict" if self._data is not None else f"dir:{self._path}"
        return f"Checkpoint({form})"


def _checkpoint_from_bytes(blob: bytes) -> "Checkpoint":
    return Checkpoint.from_bytes(blob)


def _checkpoint_from_path(path: str, host: str) -> "Checkpoint":
    if host != socket.gethostname():
        raise ValueError(
            f"directory checkpoint {path} lives on host {host}; move it "
            f"between hosts as Checkpoint.from_bytes(ckpt.to_bytes())")
    return Checkpoint.from_directory(path)



# -- torch state (de)serialization -----------------------------------------

def _to_cpu(x: Any) -> Any:
    import torch
    if torch.is_tensor(x):
        return x.detach().to("cpu")
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save_torch_state(path: str, state: Any) -> None:
    """``state`` with every tensor on the CPU, as one ``torch.save``
    file under ``path``."""
    import torch
    os.makedirs(path, exist_ok=True)
    torch.save(_to_cpu(state), os.path.join(path, _TORCH_FILE))


def load_torch_state(path: str, map_location: Any = None) -> Any:
    """What ``save_torch_state`` wrote; tensors and plain values only
    (``weights_only``)."""
    import torch
    return torch.load(os.path.join(path, _TORCH_FILE),
                      map_location=map_location or "cpu",
                      weights_only=True)
