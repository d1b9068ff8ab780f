"""Streaming rollout actor: free-running fragments over one generator
(counterpart of ray_tpu/rl/podracer/rollout.py).

One ``stream()`` call per actor lifetime: the executor consumes it via
``num_returns="streaming"``, so every fragment arrives per-yield with
ZERO further task submissions — the generator backpressure window
(``podracer_backpressure_fragments``, stamped at submit time) pauses
env stepping when the learner falls behind, which is the staleness
contract: at most ``window`` unconsumed fragments ever separate an
actor's policy from the fragment the learner trains on.

The actor leases no GPU, and its policy stays on the CPU
(``RolloutWorker``).  Weight adoption happens BETWEEN fragments: the
actor polls the KV pointer (one GCS RPC — cheap against a fragment of
env steps) and on a version bump pulls the payload striped from every
current holder.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional, Tuple

from ray_tpu_torch.rl.rollout_worker import RolloutWorker
from ray_tpu_torch.rl.podracer.weights import WeightFollower


class PodracerRolloutActor(RolloutWorker):
    """RolloutWorker + the streaming/weight-follower surface."""

    def pull_weights(self, weights_name: str) -> Dict[str, Any]:
        """Rendezvous pull (join path): adopt the newest published
        version before the stream starts, so a replacement actor's
        first fragment is already on-policy.  Returns the adoption
        report the executor stamps into RL_ACTOR_JOINED."""
        self._follower = WeightFollower(weights_name)
        update = self._follower.poll()
        if update is not None:
            params, _ = update
            self.set_weights(params)
        return {"weight_version": self._follower.version,
                "weight_pull_ms": self._follower.last_pull_ms,
                "worker_index": self.worker_index}

    def stream(self, weights_name: str, *, mode: str = "time_major",
               max_fragments: int = 0) -> Iterator[Tuple[Any, dict]]:
        """Yield ``(fragment, meta)`` forever (or ``max_fragments``).

        ``mode``: "time_major" yields IMPALA's [T, N] dict fragments
        (V-trace corrects off-policyness on the learner); "gae" yields
        GAE-postprocessed SampleBatches (the podracer PPO path —
        advantages computed under the behavior policy, one version
        stale at most within the backpressure window).
        """
        follower = getattr(self, "_follower", None)
        if follower is None or follower.name != weights_name:
            follower = WeightFollower(weights_name)
        sample = (self.sample_time_major if mode == "time_major"
                  else self.sample)
        n = 0
        while max_fragments <= 0 or n < max_fragments:
            sync_ms = 0.0
            update = follower.poll()
            if update is not None:
                params, _ = update
                self.set_weights(params)
                sync_ms = follower.last_pull_ms
            t0 = time.perf_counter()
            fragment = sample()
            meta = {
                "worker_index": self.worker_index,
                "fragment_index": n,
                "weight_version": follower.version,
                "weight_sync_ms": sync_ms,
                "versions_skipped": follower.versions_skipped,
                "sample_ms": (time.perf_counter() - t0) * 1000.0,
                "yield_ts": time.time(),
                "episodes": self.get_metrics(),
            }
            if n == 0:
                # once per stream: what this actor's process holds (no
                # GPU lease, no CUDA, its policy on the CPU), since a
                # streaming actor takes no other call while it runs
                meta["host"] = self.host_info()
            yield fragment, meta
            n += 1


def podracer_actor_class(num_cpus: float = 1.0):
    """The remote class the executor instantiates per fleet slot."""
    import ray_tpu_torch
    return ray_tpu_torch.remote(num_cpus=num_cpus)(PodracerRolloutActor)
