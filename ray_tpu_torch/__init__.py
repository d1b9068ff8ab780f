"""ray_tpu_torch: the PyTorch + CUDA port of ray_tpu, for NVIDIA Hopper.

The package mirrors ``ray_tpu``'s layout module for module
(``ray_tpu_torch/ops/paged_attention.py`` answers
``ray_tpu/ops/paged_attention.py``) and imports nothing of it: where the
port needs something from a JAX-free module of ``ray_tpu`` it keeps its
own copy.  Every TPU kernel on a ported path becomes a hand-written CUDA
C++ kernel under ``ray_tpu_torch/csrc/``, built with ``nvcc`` at first
use (``ray_tpu_torch/ops/_build.py``).

Ported so far: the continuous-batching serving engine's model side
(``serve/llm_engine.py``: the dense slot mode -> ``models/gpt.py`` dense
decode; the paged mode with its prefix cache and prefill handoffs ->
``models/gpt.py`` paged decode -> ``ops/paged_attention.py``; ``stream``;
``models/generate.py`` ``Generator``) and the one-device training path
(``train/step.py`` ``make_train`` with AdamW or Adafactor ->
``models/gpt.py`` training forward -> ``ops/attention.py`` ->
``ops/flash_attention.py`` or ``ops/splash.py``, with
``ops/losses.py``) of every model family: the GPT (dense and MoE),
``models/bert.py`` and ``models/t5.py`` over ``models/encoder.py``, and
the image classifiers ``models/vit.py`` and ``models/resnet.py`` through
``make_vision_train``.

Under all of it, the task, actor and object runtime (``api.py``,
``actor.py``, ``remote_function.py``, ``runtime/``: GCS, raylet, worker
zygote, workers, the shared-memory object store built from
``csrc/shmstore.cc`` with g++ at first use) is the port's own copy of
``ray_tpu``'s: ``init(num_gpus=...)``, ``@remote(num_gpus=1)``, its
settings read from ``RAY_TPU_TORCH_*`` variables, its sessions under
``ray_tpu_torch_sessions`` under the temporary directory (``TMPDIR``,
else /tmp).  A worker that leases GPUs sees only the cards of its lease
(``CUDA_VISIBLE_DEVICES``); one that leases none gets
``CUDA_VISIBLE_DEVICES=""``.  Tensors
cross the object store as CPU tensors with their bytes out of band
(``_private/serialization.py``).  ROADMAP.md lists what is still to come.
"""

from ray_tpu_torch._private.config import CONFIG  # noqa: F401

# debug-mode lock-order sanitizer (docs/static_analysis.md): installed
# BEFORE the runtime modules import so their module-level locks are
# instrumented too; a no-op unless RAY_TPU_TORCH_DEBUG_LOCKS /
# debug_locks is set (spawned daemons inherit the env and self-instrument
# here)
from ray_tpu_torch._private.analysis import lock_sanitizer as _lock_sanitizer
_lock_sanitizer.maybe_install()

from ray_tpu_torch.actor import get_actor, kill, method  # noqa: F401,E402
from ray_tpu_torch.api import (available_resources,  # noqa: F401,E402
                               cluster_resources, context, get,
                               get_runtime_context, init, is_initialized,
                               nodes, put, remote, shutdown, wait)
from ray_tpu_torch.cross_language import (cpp_actor_class,  # noqa: F401,E402
                                          cpp_function)
from ray_tpu_torch.runtime.core_worker import (  # noqa: F401,E402
    ObjectRef, ObjectRefGenerator, StreamingObjectRefGenerator)

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "get_actor", "kill", "nodes", "cluster_resources",
    "available_resources", "context", "get_runtime_context", "ObjectRef",
    "ObjectRefGenerator", "StreamingObjectRefGenerator", "CONFIG",
    "cpp_function", "cpp_actor_class", "__version__",
]
