"""Runtime sanitizers for the runtime's hand-rolled concurrency
primitives, off unless asked for:

* ``RAY_TPU_TORCH_DEBUG_LOCKS=1`` (``lock_sanitizer.py``) swaps
  ``threading.Lock/RLock`` created by instrumented modules for wrappers
  that record the per-thread lock acquisition-order graph into a
  process-global table and raise at the FIRST A->B / B->A inversion
  (not at the one-in-a-thousand actual deadlock);
* ``RAY_TPU_TORCH_DEBUG_CHANNELS=1`` (``channel_check.py``) asserts the
  shm ring protocol's single-writer / seq-word-last / cumulative-ack
  discipline on every publish and ack.

``ray_tpu``'s static checker framework (its ``core.py``, ``callgraph.py``
and ``checkers/``, run with the baseline ``allowlist.txt``) is not part
of this copy: the ``# raylint: disable=...`` comments kept in the copied
modules name its rules.
"""
