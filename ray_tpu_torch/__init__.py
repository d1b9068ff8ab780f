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
``make_vision_train``.  ROADMAP.md lists what is still to come.
"""
