"""Predictors: checkpoint -> batch inference, locally or over a Dataset
(the port's copy of ray_tpu/train/predictor.py).

Analog of Ray's python/ray/train/predictor.py (Predictor) and
batch_predictor.py (BatchPredictor: map_batches with an actor pool so each
actor deserializes the model once).  ray_tpu's JaxPredictor jits a flax
``apply``; the port's (its name kept, as ``JaxTrainer`` keeps its own)
runs an ``nn.Module`` in eval mode under ``torch.inference_mode()`` on
its device, the card unless the caller passes ``device="cpu"``.
BatchPredictor rides Dataset.map_batches' stateful-actor path, so scoring
N blocks costs one model load per actor, not per block; with
``num_gpus_per_worker`` each pool actor leases its share of a card.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Type

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint


class Predictor:
    """Base: subclass implements ``from_checkpoint`` and ``predict``."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray], **kwargs) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def predictor_checkpoint(model: Callable, params: Dict[str, Any],
                         path: Optional[str] = None) -> Checkpoint:
    """A directory checkpoint for :class:`JaxPredictor`: ``params`` (a
    state dict; tensors are saved on the CPU, ``Checkpoint.from_torch``)
    and ``model``, a picklable factory of the module that takes
    ``device=`` (``functools.partial(ViT, cfg)``), beside them as the
    checkpoint's dict form.  It travels between processes of one host as
    its path, so a pool of scoring actors never pulls the weights
    through the object store."""
    path = Checkpoint.from_dict({"model": model}).to_directory(path)
    return Checkpoint.from_torch({"params": params}, path=path)


class JaxPredictor(Predictor):
    """Runs a torch module with checkpointed weights.

    ``model`` is a factory of the module called with ``device=``;
    ``params`` its state dict (loaded with ``load_state_dict``).  Input
    batches use ``input_column``: the column moves to the predictor's
    device (the card unless ``device="cpu"``; without a card it raises)
    and the module's output comes back as numpy in ``output_column``.
    ``apply_fn(module, x)`` replaces ``module(x)`` where given.
    """

    def __init__(self, model: Callable, params: Dict[str, Any], *,
                 input_column: str = "features",
                 output_column: str = "predictions",
                 apply_fn: Optional[Callable] = None,
                 device=None):
        from ray_tpu_torch._private.device import resolve_device
        self.device = resolve_device(device)
        model = model(device=self.device)
        model.load_state_dict(params)
        self.model = model.eval()
        self.input_column = input_column
        self.output_column = output_column
        self._apply = apply_fn or (lambda module, x: module(x))

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        **kwargs) -> "JaxPredictor":
        """From :func:`predictor_checkpoint`'s layout: the module's
        factory in the dict form, its weights as torch state."""
        return cls(checkpoint.to_dict()["model"],
                   checkpoint.to_torch()["params"], **kwargs)

    def predict(self, batch: Dict[str, np.ndarray], **kwargs) -> Dict[str, np.ndarray]:
        import torch
        with warnings.catch_warnings():
            # a block read from the object store is read-only; the
            # tensor over it is only read
            warnings.filterwarnings("ignore", "The given NumPy array is "
                                    "not writable", UserWarning)
            x = torch.from_numpy(np.ascontiguousarray(
                batch[self.input_column])).to(self.device)
        with torch.inference_mode():
            out = self._apply(self.model, x)
        result = dict(batch)
        result[self.output_column] = out.float().cpu().numpy()
        return result


class _Scorer:
    """One pool actor's predictor, built once from the checkpoint."""

    def __init__(self, ckpt, pcls, pkw):
        self._p = pcls.from_checkpoint(ckpt, **pkw)

    def __call__(self, batch):
        return self._p.predict(batch)


class BatchPredictor:
    """Distributed inference: score a Dataset with an actor pool.

    ``BatchPredictor.from_checkpoint(ckpt, JaxPredictor)`` then
    ``.predict(ds)`` — one predictor per pool actor (reference
    batch_predictor.py semantics).
    """

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self.checkpoint = checkpoint
        self.predictor_cls = predictor_cls
        self.predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(self, ds, *, batch_size: Optional[int] = 4096,
                min_scoring_workers: int = 1,
                max_scoring_workers: int = 2,
                num_cpus_per_worker: float = 1.0,
                num_gpus_per_worker: float = 0.0):
        """Score ``ds``; each pool actor leases ``num_gpus_per_worker``
        of a card (a predictor on the card needs one: a worker without a
        GPU lease sees none)."""
        from ray_tpu_torch.data.dataset import ActorPoolStrategy
        return ds.map_batches(
            _Scorer, batch_size=batch_size, batch_format="numpy",
            compute=ActorPoolStrategy(min_scoring_workers,
                                      max_scoring_workers),
            num_cpus=num_cpus_per_worker, num_gpus=num_gpus_per_worker,
            fn_constructor_args=(self.checkpoint, self.predictor_cls,
                                 self.predictor_kwargs))

    def predict_pipelined(self, ds, *, blocks_per_window: int = 10,
                          num_gpus_per_worker: float = 0.0, **kwargs):
        """Windowed scoring over a DatasetPipeline (streaming ingest).
        Each scoring task leases ``num_gpus_per_worker`` of a card (a
        predictor on the card needs one); ``kwargs`` are ignored, as in
        ray_tpu's copy."""
        ckpt, pcls, pkw = self.checkpoint, self.predictor_cls, \
            self.predictor_kwargs
        holder: Dict[str, Predictor] = {}

        def score(batch):
            # one predictor per scoring process, not per batch
            if "p" not in holder:
                holder["p"] = pcls.from_checkpoint(ckpt, **pkw)
            return holder["p"].predict(batch)

        pipe = ds.window(blocks_per_window=blocks_per_window)
        return pipe.map_batches(score, batch_format="numpy",
                                num_gpus=num_gpus_per_worker)
