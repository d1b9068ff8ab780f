"""ray_tpu_torch.train: trainers over worker-group actors and the
one-device train step (counterpart of ray_tpu/train/).

Analog of Ray's python/ray/train: BaseTrainer / DataParallelTrainer
drive a WorkerGroup; JaxTrainer (ray_tpu's name, kept) trains on each
worker's card with ``make_train`` and syncs gradients over the host
collective; TorchTrainer keeps DDP over gloo; ``train.step`` holds
``make_train``; ``Predictor`` / ``JaxPredictor`` / ``BatchPredictor``
score a ``data.Dataset`` in an actor pool.  Not ported yet: ray_tpu's
``get_mesh``, ``LayoutPlan`` and ``train/sharded/`` (multi-device),
``HuggingFaceTrainer``, ``GBDTTrainer`` and ``SklearnPredictor``
(transformers, sklearn and xgboost are not on the card's machine);
ROADMAP.md, Queue 1, item 4.
"""

from ray_tpu_torch.train.base_trainer import (BackendConfig,  # noqa: F401
                                              BaseTrainer,
                                              DataParallelTrainer,
                                              TrainingFailedError)
from ray_tpu_torch.train.jax_trainer import (JaxConfig,  # noqa: F401
                                             JaxTrainer, PendingSync,
                                             sync_gradients)
from ray_tpu_torch.train.predictor import (BatchPredictor,  # noqa: F401
                                           JaxPredictor, Predictor,
                                           predictor_checkpoint)
from ray_tpu_torch.train.step import (OptimizerConfig,  # noqa: F401
                                      classification_loss_fn,
                                      lm_loss_chunked_fn, lm_loss_fn,
                                      make_train, make_vision_train)
from ray_tpu_torch.train.torch_trainer import (TorchConfig,  # noqa: F401
                                               TorchTrainer,
                                               prepare_data_loader,
                                               prepare_model)
from ray_tpu_torch.train.worker_group import (TrainWorker,  # noqa: F401
                                              WorkerGroup, get_device)
# training performance plane (docs/observability.md): the per-step
# phase clock + goodput ledger a train loop drives
from ray_tpu_torch._private.step_stats import (  # noqa: F401
    instrument_step, set_model_info, step_clock)

__all__ = [
    "BaseTrainer", "DataParallelTrainer", "BackendConfig",
    "TrainingFailedError", "JaxTrainer", "JaxConfig", "sync_gradients",
    "PendingSync", "step_clock", "instrument_step", "set_model_info",
    "TorchTrainer", "TorchConfig", "prepare_model", "prepare_data_loader",
    "WorkerGroup", "TrainWorker", "get_device", "make_train",
    "OptimizerConfig", "make_vision_train", "classification_loss_fn",
    "lm_loss_fn", "lm_loss_chunked_fn", "Predictor", "JaxPredictor",
    "BatchPredictor", "predictor_checkpoint",
]
