"""The port's Tune (``ray_tpu_torch.tune``) against ray_tpu's.

Seeded searchers suggest the same configs; ASHA, HyperBand, the median
stopping rule and PBT make the same decisions on the same scripted
results; the grid + ASHA Tuner of ``tests/test_tune.py``'s
``test_tuner_asha_integration`` gives the same best config on both
runtimes, and each runtime's stopped trials are what ASHA decides on the
order its results arrived in (the same stopped trials where the orders
agree); a two-trial ``Tuner(JaxTrainer)`` of a tiny GPT reports the
losses of the port's in-driver ``make_train``, exactly (the same
arithmetic on the CPU).  One difference is deliberate and shown: an
actor's own actors and placement groups die with it on the port, and
outlive it on ray_tpu (ROADMAP.md, Queue 3).
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import cloudpickle as port_cloudpickle

TIMEOUT = 60


@pytest.fixture(scope="module")
def both():
    """{"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}, each with a
    running cluster."""
    import cloudpickle

    import ray_tpu
    for cp in (cloudpickle, port_cloudpickle):
        cp.register_pickle_by_value(sys.modules[__name__])
    if ray_tpu.is_initialized():     # left by an earlier test
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=6, object_store_memory=128 << 20)
    ray_tpu.init(num_cpus=6, object_store_memory=128 << 20)
    try:
        yield {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
    finally:
        ray_tpu.shutdown()
        ray_tpu_torch.shutdown()
        for cp in (cloudpickle, port_cloudpickle):
            cp.unregister_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def theirs(both):
    """ray_tpu's runs of the Tuner and owner tests, each started in a
    thread of its own with the clusters (a ray_tpu actor takes seconds
    to start; the port's tests run meanwhile).  {name: future}."""
    pools = {"asha": ThreadPoolExecutor(1), "owner": ThreadPoolExecutor(1)}
    futures = {"asha": pools["asha"].submit(_asha_run, "ray_tpu"),
               "owner": pools["owner"].submit(
                   _after_parent_killed, both["ray_tpu"], "ray_tpu")}
    try:
        yield futures
    finally:
        for pool in pools.values():
            pool.shutdown(wait=True, cancel_futures=True)


def _tune(pkg: str):
    from importlib import import_module
    return import_module(f"{pkg}.tune")


def _space(T):
    return {"lr": T.loguniform(1e-4, 1e-1), "layers": T.randint(1, 5),
            "act": T.choice(["relu", "gelu", "tanh"]),
            "wd": T.grid_search([0.0, 0.1]),
            "nested": {"m": T.uniform(0.5, 0.99), "q": T.quniform(0, 1, 0.25)},
            "twice": T.sample_from(lambda c: 2 * c["layers"])}


def _score(cfg):
    return -abs(np.log10(cfg["lr"]) + 2.5) - 0.1 * abs(cfg["layers"] - 3)


SEARCHERS = {
    "basic_variant": lambda T: T.BasicVariantGenerator(
        _space(T), num_samples=3, seed=5),
    "random": lambda T: T.RandomSearch(_space(T), seed=11),
    "tpe": lambda T: T.TPESearcher(_space(T), metric="score", mode="max",
                                   n_initial=4, n_candidates=8, seed=3),
    "hyperopt_style": lambda T: T.HyperOptStyleSearch(
        _space(T), metric="score", mode="max", n_initial=4,
        n_candidates=8, seed=3),
    "concurrency_limiter": lambda T: T.ConcurrencyLimiter(
        T.RandomSearch(_space(T), seed=2), max_concurrent=2),
}


def _suggestions(T, name):
    s = SEARCHERS[name](T)
    out = []
    for i in range(12):
        cfg = s.suggest(f"t{i}")
        out.append(cfg)
        if cfg is not None:
            s.on_trial_complete(f"t{i}", {"score": _score(cfg)})
    return out


@pytest.mark.parametrize("name", sorted(SEARCHERS))
def test_seeded_searcher_suggests_the_same(name):
    got = _suggestions(_tune("ray_tpu_torch"), name)
    want = _suggestions(_tune("ray_tpu"), name)
    assert got == want
    assert sum(c is not None for c in got) >= 6


# ------------------------------------------------------------ schedulers
class _Trial:
    def __init__(self, trial_id, config):
        self.trial_id, self.config = trial_id, config
        self.status = "RUNNING"
        self.checkpoint = f"ckpt-{trial_id}"


class _Runner:
    """What a scheduler sees of the TrialRunner, recording its calls."""

    def __init__(self, n):
        self.trials = [_Trial(f"t{i}", {"lr": 0.1 * (i + 1), "m": 0.5})
                       for i in range(n)]
        self.log = []

    def _stop_trial(self, trial, status):
        trial.status = status
        self.log.append(("stopped_while_paused", trial.trial_id))

    def request_exploit(self, trial, donor, config):
        self.log.append(("exploit", trial.trial_id, donor.trial_id,
                         dict(config)))


def _value(i, t):
    """Trial i's metric at iteration t: crossing curves, so rankings
    change over time."""
    return (i + 1) * t * 0.3 - ((i * 7) % 5) * np.sqrt(t) + (i % 2) * 0.7


SCHEDULERS = {
    "asha": lambda T: T.ASHAScheduler(metric="m", mode="max",
                                      grace_period=1, reduction_factor=2,
                                      max_t=12),
    "asha_min": lambda T: T.ASHAScheduler(metric="m", mode="min",
                                          grace_period=2,
                                          reduction_factor=3, max_t=12),
    "hyperband": lambda T: T.HyperBandScheduler(
        metric="m", mode="max", max_t=12, grace_period=1,
        reduction_factor=2),
    "median": lambda T: T.MedianStoppingRule(
        metric="m", mode="max", grace_period=2, min_samples_required=2),
    "pbt": lambda T: T.PopulationBasedTraining(
        metric="m", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.01, 0.1, 1.0],
                              "m": T.uniform(0.1, 0.9)},
        quantile_fraction=0.34, resample_probability=0.5, seed=4),
}


def _decisions(T, name, n=6, iters=12):
    sched = SCHEDULERS[name](T)
    runner = _Runner(n)
    for t in runner.trials:
        sched.on_trial_add(runner, t)
    for it in range(1, iters + 1):
        for i, trial in enumerate(runner.trials):
            if trial.status != "RUNNING":
                continue
            result = {"training_iteration": it, "m": _value(i, it)}
            d = sched.on_trial_result(runner, trial, result)
            runner.log.append((it, trial.trial_id, d))
            if d == "STOP":
                trial.status = "TERMINATED"
                sched.on_trial_complete(runner, trial, result)
            elif d == "PAUSE":
                trial.status = "PAUSED"
        while True:
            t = sched.choose_trial_to_run(runner)
            if t is None:
                break
            runner.log.append(("resume", t.trial_id))
            t.status = "RUNNING"
    return runner.log


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decides_the_same(name):
    got = _decisions(_tune("ray_tpu_torch"), name)
    want = _decisions(_tune("ray_tpu"), name)
    assert got == want
    kinds = {e[2] if isinstance(e[0], int) else e[0] for e in got}
    # each scheduler acts on this script, not only CONTINUE
    assert kinds - {"CONTINUE"}, kinds


# ------------------------------------------------- Tuner on both runtimes
def _asha_trainable(config):
    from importlib import import_module
    session = import_module(config["pkg"] + ".air.session")
    for i in range(10):
        session.report({"score": config["q"] * (i + 1)})


def _asha_run(pkg):
    T = _tune(pkg)
    order = []

    class Arrivals(T.Callback):
        def on_trial_result(self, iteration, trials, trial, result):
            order.append((trial.config["q"], result["training_iteration"],
                          result["score"]))

    from importlib import import_module
    air = import_module(f"{pkg}.air")
    grid = T.Tuner(
        _asha_trainable,
        param_space={"q": T.grid_search([1.0, 5.0, 10.0, 20.0]),
                     "pkg": pkg},
        tune_config=T.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=4,
            scheduler=T.ASHAScheduler(metric="score", mode="max",
                                      grace_period=2, reduction_factor=2,
                                      max_t=10)),
        run_config=air.RunConfig(callbacks=[Arrivals()])).fit()
    assert not grid.errors
    reached = {r.metrics["config"]["q"]: r.metrics["training_iteration"]
               for r in grid}
    return grid.get_best_result().metrics["config"]["q"], reached, order


def _asha_replay(order):
    """The iteration at which ray_tpu's ASHA leaves each trial, fed the
    results in ``order``."""
    from ray_tpu.tune import ASHAScheduler
    sched = ASHAScheduler(metric="score", mode="max", grace_period=2,
                          reduction_factor=2, max_t=10)
    trials, last = {}, {}
    for q, it, score in order:
        trial = trials.setdefault(q, _Trial(str(q), {"q": q}))
        last[q] = it
        sched.on_trial_result(None, trial, {"training_iteration": it,
                                            "score": score})
    return last


def test_tuner_asha_matches_ray_tpu(theirs):
    best, reached, order = _asha_run("ray_tpu_torch")
    jbest, jreached, jorder = theirs["asha"].result(timeout=TIMEOUT)
    assert best == jbest == 20.0
    assert reached == _asha_replay(order)
    assert jreached == _asha_replay(jorder)
    if [o[:2] for o in order] == [o[:2] for o in jorder]:
        assert reached == jreached


# ------------------------------------------- Tuner(JaxTrainer), tiny GPT
def _gpt_loop(config):
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.train import get_device
    from ray_tpu_torch.train.step import OptimizerConfig, make_train
    model = GPT(get_config("tiny"), device=get_device())
    model.load_state_dict(config["state"])
    init_fn, step_fn = make_train(model, OptimizerConfig(
        learning_rate=config["lr"], warmup_steps=0, decay_steps=10))
    state = init_fn()
    shard = session.get_dataset_shard("train")
    for step, batch in enumerate(shard.iter_batches(
            batch_size=2, batch_format="numpy"), start=1):
        state, m = step_fn(state, {"tokens": torch.from_numpy(
            np.array(batch["data"]))})
        session.report({"step": step, "loss": float(m["loss"])})


def _gpt_state_and_tokens():
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.models.convert import init_weights
    from ray_tpu_torch.models.gpt import GPT
    cfg = get_config("tiny")
    model = GPT(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33))
    return cfg, {k: v.clone() for k, v in model.state_dict().items()}, tokens


def test_tuner_of_jax_trainer_reports_make_train_losses(both):
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.train import JaxTrainer
    from ray_tpu_torch.train.step import OptimizerConfig, make_train
    cfg, state, tokens = _gpt_state_and_tokens()
    lrs = (1e-2, 1e-3)
    trainer = JaxTrainer(
        _gpt_loop, train_loop_config={"state": state},
        scaling_config=ScalingConfig(num_workers=1),
        datasets={"train": rd.from_numpy([tokens[:2], tokens[2:]])})
    grid = tune.Tuner(
        trainer, param_space={"lr": tune.grid_search(list(lrs))},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=2)).fit()
    assert not grid.errors and len(grid) == 2
    for r in grid:
        lr = r.metrics["config"]["lr"]
        assert r.metrics["step"] == 2
        model = GPT(cfg, device="cpu")
        model.load_state_dict(state)
        init_fn, step_fn = make_train(model, OptimizerConfig(
            learning_rate=lr, warmup_steps=0, decay_steps=10))
        s = init_fn()
        want = []
        for rows in (tokens[:2], tokens[2:]):
            s, m = step_fn(s, {"tokens": torch.from_numpy(rows)})
            want.append(float(m["loss"]))
        # the last report is step 2's; step 1's loss is every trial's
        # first, the same for both learning rates
        assert r.metrics["loss"] == want[1], lr
    best = grid.get_best_result()
    assert best.metrics["config"]["lr"] == min(
        lrs, key=lambda lr: [g.metrics["loss"] for g in grid
                             if g.metrics["config"]["lr"] == lr][0])


# ----------------------------------------------- owner fate sharing
class _Child:
    def ping(self):
        return "pong"


class _Parent:
    """Makes one actor and one placement group of its own."""

    def spawn(self, pkg):
        from importlib import import_module
        rt = import_module(pkg)
        pgmod = import_module(f"{pkg}.util.placement_group")
        self.child = rt.remote(num_cpus=0)(_Child).remote()
        rt.get(self.child.ping.remote())
        self.pg = pgmod.placement_group([{"CPU": 1}])
        assert self.pg.wait(30)
        return self.child, self.pg.id.hex()


def _after_parent_killed(rt, pkg):
    parent = rt.remote(num_cpus=0)(_Parent).remote()
    child, pg_id = rt.get(parent.spawn.remote(pkg), timeout=TIMEOUT)
    rt.kill(parent)
    from importlib import import_module
    cw = import_module(f"{pkg}.runtime.core_worker")
    gcs = cw.get_global_worker().gcs
    # the port reaps at once; ray_tpu is given a second to do anything
    deadline = time.monotonic() + (20 if pkg == "ray_tpu_torch" else 1)
    while True:
        info = gcs.call("get_actor", {"actor_id": child._actor_id.hex()})
        pg = gcs.call("get_placement_group", {"pg_id": pg_id})
        if info["state"] == "DEAD" or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    return info["state"], (pg or {}).get("state", "REMOVED")


def test_actors_die_with_their_owner_on_the_port_only(theirs):
    """ray_tpu keeps a killed actor's own actor and placement group
    alive (a trial's trainer worker would hold its card for good); the
    port's GCS kills the one and removes the other."""
    assert _after_parent_killed(ray_tpu_torch, "ray_tpu_torch") == (
        "DEAD", "REMOVED")
    state, pg = theirs["owner"].result(timeout=TIMEOUT)
    assert state == "ALIVE" and pg == "CREATED"
