"""DQN on CartPole-v1 with the PyTorch port (ray_tpu_torch.rl), to the
reward-150 row of RLlib's cartpole-dqn.yaml (150 within 100,000 env
steps).

    PYTHONPATH=. python examples/torch_dqn_cartpole.py   # the card
    PYTHONPATH=. python examples/torch_dqn_cartpole.py --device cpu --seed 3

from the root of a checkout.

DQNConfig's widths (256 x 256, dueling, double-Q, Adam 5e-4), 2 rollout
actors x 2 envs with fragments of 64, and chip_smoke.py's training
settings (phase rl_replay) unless the flags say otherwise.  Prints one
JSON line: the env steps at which episode_reward_mean first reached 150
(null if it did not within the limit), the best mean, the iterations
and the wall time.
"""

import argparse
import json
import math
import time


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="the learner's device (default: the card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-batch-size", type=int, default=256)
    p.add_argument("--n-updates-per-iter", type=int, default=128)
    p.add_argument("--target", type=float, default=150.0)
    p.add_argument("--max-steps", type=int, default=100_000)
    args = p.parse_args()

    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import DQNConfig
    rt.init(num_cpus=3)
    try:
        cfg = (DQNConfig().environment("CartPole-v1")
               .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                         rollout_fragment_length=64)
               .training(train_batch_size=args.train_batch_size,
                         n_updates_per_iter=args.n_updates_per_iter,
                         target_update_freq=256, epsilon_timesteps=2500,
                         grad_clip=10.0)
               .debugging(seed=args.seed))
        if args.device is not None:
            cfg = cfg.resources(device=args.device)
        algo = cfg.build()
        best, reached, iters = -math.inf, None, 0
        t0 = time.perf_counter()
        try:
            while True:
                r = algo.train()
                iters += 1
                reward = r["episode_reward_mean"]
                if not math.isnan(reward):
                    best = max(best, reward)
                if reward >= args.target:
                    reached = r["timesteps_total"]
                    break
                if r["timesteps_total"] >= args.max_steps:
                    break
        finally:
            algo.stop()
        print(json.dumps({
            "seed": args.seed, "train_batch_size": args.train_batch_size,
            "n_updates_per_iter": args.n_updates_per_iter,
            "device": str(algo.device), "env_steps_to_target": reached,
            "best_reward": best, "train_iters": iters,
            "wall_s": time.perf_counter() - t0}))
    finally:
        rt.shutdown()


if __name__ == "__main__":
    main()
