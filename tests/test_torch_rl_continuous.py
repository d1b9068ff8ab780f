"""The port's continuous-control and actor-critic RL families
(ray_tpu_torch.rl: SAC, DDPG, TD3, PG, A2C, A3C, CQL, CRR, SACPolicy and
DDPGPolicy) held against ray_tpu.rl on the same numpy inputs, weights
and noise, on the CPU.

The JAX learners are built without a runtime (``setup_learner`` on an
object that skips ``Algorithm.__init__``; CQL and CRR over a small
Pendulum-v1 dataset), their initial weights drawn from numpy
(``test_torch_rl._numpy_init``) and their updates run jitted.  JAX draws
its noise inside the update; here ``jax.random.normal`` / ``uniform``
are made to return fixed arrays in the order the update is traced (its
code order), and the port's update takes the same arrays as its noise
input.  Tolerances, all fp32: one update's losses and aux rtol 1e-5
(atol 1e-6), the parameters after Adam or RMSProp atol 1e-5, as
tests/test_torch_rl.py holds PPO's; deterministic actions atol 1e-5;
the soft target update and the save / restore round trips exactly.
The runtime case starts one session with the learners on the CPU.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rl import a2c as ja2c
from ray_tpu.rl import cql as jcql
from ray_tpu.rl import crr as jcrr
from ray_tpu.rl import ddpg as jddpg
from ray_tpu.rl import models as JM
from ray_tpu.rl import pg as jpg
from ray_tpu.rl import sac as jsac
from ray_tpu.rl.env import Box as JaxBox
from ray_tpu.rl.env import Discrete as JaxDiscrete
from ray_tpu.rl.policy import DDPGPolicy as JaxDDPGPolicy
from ray_tpu.rl.policy import SACPolicy as JaxSACPolicy
from ray_tpu_torch.rl import (A2CConfig, A3CConfig, CQLConfig, CRRConfig,
                              DDPGConfig, DDPGPolicy, PGConfig, SACConfig,
                              SACPolicy, TD3Config, collect_dataset,
                              get_algorithm_class)
from ray_tpu_torch.rl.algorithm import (apply_full_training_state,
                                        full_training_state)
from ray_tpu_torch.rl.env import Box, Discrete
from ray_tpu_torch.rl.policy import module_weights

from test_torch_rl import ATOL, _assert_params, _numpy_init
from test_torch_rl_replay import _assert_aux, _bare, _load

HIDDEN = (32, 32)
CPU = torch.device("cpu")
B = 32                  # rows of an update's batch


def _cfg(cls, env="Pendulum-v1", **training):
    return cls().environment(env).training(hidden=HIDDEN, **training) \
        .debugging(seed=0)


@contextlib.contextmanager
def _jax_noise(normals=(), uniforms=()):
    """``jax.random.normal`` / ``uniform`` return these arrays, one per
    call, in the order the update is traced."""
    queues = {"normal": list(normals), "uniform": list(uniforms)}

    def fake(kind):
        def draw(key, shape, *args, **kwargs):
            out = queues[kind].pop(0)
            assert out.shape == tuple(shape), (kind, out.shape, shape)
            return jnp.asarray(out)
        return draw
    saved = jax.random.normal, jax.random.uniform
    jax.random.normal, jax.random.uniform = fake("normal"), fake("uniform")
    try:
        yield
    finally:
        jax.random.normal, jax.random.uniform = saved
    assert not queues["normal"] and not queues["uniform"], queues


@contextlib.contextmanager
def _numpy_inits(rng, *names):
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(_numpy_init(JM, name, rng, scale=0.3))
        yield


def _batch(rng, rows=B, obs_dim=3):
    return {"obs": rng.standard_normal((rows, obs_dim)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (rows, 1)).astype(np.float32),
            "rewards": (3 * rng.standard_normal(rows)).astype(np.float32),
            "next_obs": rng.standard_normal((rows, obs_dim)
                                            ).astype(np.float32),
            "terminateds": rng.random(rows) < 0.2}


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _normals(rng, n):
    return [rng.standard_normal((B, 1)).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 64-row Pendulum-v1 dataset with ``next_obs`` (the port's
    ``collect_dataset``; both packages read its JSON)."""
    path = str(tmp_path_factory.mktemp("pendulum"))
    collect_dataset("Pendulum-v1", path, n_steps=64, seed=2)
    return path


def _learners(kind, dataset=None, **training):
    """(JAX learner, port learner on the CPU) of one kind, the port's
    networks loaded with JAX's initial weights and its target critic
    with other weights than the critic's (so the soft update shows)."""
    jmod, jcfg_cls, tcfg_cls, actor = {
        "sac": (jsac.SAC, jsac.SACConfig, SACConfig,
                "SquashedGaussianActor"),
        "ddpg": (jddpg.DDPG, jddpg.DDPGConfig, DDPGConfig,
                 "DeterministicActor"),
        "td3": (jddpg.TD3, jddpg.TD3Config, TD3Config,
                "DeterministicActor"),
        "cql": (jcql.CQL, jcql.CQLConfig, CQLConfig,
                "SquashedGaussianActor"),
        "crr": (jcrr.CRR, jcrr.CRRConfig, CRRConfig,
                "SquashedGaussianActor")}[kind]
    rng = np.random.default_rng(30 + len(kind))
    jcfg, tcfg = (_cfg(c, **training) for c in (jcfg_cls, tcfg_cls))
    tcfg.resources(device="cpu")
    with _numpy_inits(rng, actor, "TwinQ"):
        if kind in ("cql", "crr"):
            jalg = jmod(jcfg.offline_data(input_path=dataset))
        else:
            jalg = _bare(jmod, jcfg)
    if kind in ("cql", "crr"):
        talg = get_algorithm_class(kind)(tcfg.offline_data(
            input_path=dataset))
    else:
        talg = _bare(get_algorithm_class(kind), tcfg, CPU)
    jalg.state["target_critic"] = jax.tree.map(
        lambda t: (t + 0.1 * rng.standard_normal(t.shape)).astype(
            np.float32), jalg.state["critic"])
    for name, module in talg.state.items():
        if isinstance(module, torch.nn.Module):
            _load(module, jalg.state[name])
    if "log_alpha" in talg.state:
        with torch.no_grad():
            talg.state["log_alpha"].fill_(float(jalg.state["log_alpha"]))
    return jalg, talg


def _check_update(jalg, talg, jnew, jaux, taux, before, tau):
    """Aux at RTOL, every trained network at ATOL, and the port's target
    critic equal to the soft update of its old weights toward the new
    critic."""
    assert set(taux) == set(jaux)
    _assert_aux(taux, jaux)
    for name, module in talg.state.items():
        if isinstance(module, torch.nn.Module):
            _assert_params(module, jnew[name])
    if "log_alpha" in talg.state:
        np.testing.assert_allclose(talg.state["log_alpha"].item(),
                                   float(jnew["log_alpha"]), atol=ATOL)
    critic = dict(talg.state["critic"].named_parameters())
    for n, p in talg.state["target_critic"].named_parameters():
        np.testing.assert_array_equal(
            p.numpy(), torch.lerp(torch.from_numpy(before[n]),
                                  critic[n].detach(), tau).numpy())


@pytest.mark.parametrize("kind", ["sac", "ddpg", "td3_critic", "td3_actor",
                                  "cql", "crr"])
def test_update_matches_jax(kind, dataset):
    """One update of each learner from JAX's weights on the same batch
    and noise.  SAC at alpha 0.5; DDPG (one critic head in the loss: the
    other's gradients are zeros and its weights stay); TD3 on an update
    that skips the actor (its actor, Adam state and target actor stay,
    ``actor_loss`` 0) and on one that trains it, its smoothing noise
    clipped in some rows; CQL at its defaults
    (4 random and 4 policy actions in the logsumexp); CRR with the
    exp weight clipped at 1.5 so that some rows take the clip."""
    algo = kind.split("_")[0]
    training = {"sac": dict(initial_alpha=0.5, lr=1e-3),
                "crr": dict(weight_clip=1.5),
                "ddpg": dict(actor_lr=1e-3, critic_lr=2e-3)}.get(algo, {})
    jalg, talg = _learners(algo, dataset, **training)
    rng = np.random.default_rng(40)
    batch = _batch(rng)
    before = module_weights(talg.state["target_critic"])
    if algo == "sac":
        eps = _normals(rng, 2)
        with _jax_noise(normals=eps):
            jnew, jaux = jalg._update(jalg.state, batch,
                                      jax.random.PRNGKey(0))
        taux = talg._update(talg.state, _tensors(batch),
                            torch.from_numpy(np.stack(eps)))
    elif algo in ("ddpg", "td3"):
        do_actor = kind != "td3_critic"
        # TD3's smoothing noise, spread so that its clip at 0.5 is taken
        eps = [3 * e for e in _normals(rng, 1)] if algo == "td3" else []
        if eps:
            assert (np.abs(0.2 * eps[0]) > 0.5).any()
        actor_before = module_weights(talg.state["actor"])
        critic_before = module_weights(talg.state["critic"])
        target_actor = module_weights(talg.state["target_actor"])
        with _jax_noise(normals=eps):
            jnew, jaux = jalg._update(jalg.state, batch,
                                      jax.random.PRNGKey(0), do_actor)
        taux = talg._update(talg.state, _tensors(batch),
                            torch.from_numpy(eps[0]) if eps else None,
                            do_actor)
        if not do_actor:
            assert float(taux["actor_loss"]) == 0.0
            assert talg.state["actor_opt"]["count"] == 0
            for n, w in module_weights(talg.state["actor"]).items():
                np.testing.assert_array_equal(w, actor_before[n])
        else:
            assert talg.state["actor_opt"]["count"] == 1
        if algo == "ddpg":
            for n, p in talg.state["critic"].named_parameters():
                if n.startswith("q2."):
                    np.testing.assert_array_equal(p.detach().numpy(),
                                                  critic_before[n])
                    assert not talg.state["critic_opt"]["mu"][n].any()
        actor = dict(talg.state["actor"].named_parameters())
        for n, p in talg.state["target_actor"].named_parameters():
            want = torch.lerp(torch.from_numpy(target_actor[n]),
                              actor[n].detach(), talg.config.tau) \
                if do_actor else torch.from_numpy(target_actor[n])
            np.testing.assert_array_equal(p.numpy(), want.numpy())
    elif algo == "cql":
        n = talg.config.num_actions
        eps, uniform = _normals(rng, 2), rng.uniform(
            -1, 1, (n, B, 1)).astype(np.float32)
        eps_cql = _normals(rng, n)
        with _jax_noise(normals=[eps[0]] + eps_cql + [eps[1]],
                        uniforms=[uniform]):
            jnew, jaux = jalg._update(jalg.state, batch,
                                      jax.random.PRNGKey(0))
        taux = talg._update(talg.state, _tensors(batch), {
            "eps": torch.from_numpy(np.stack(eps)),
            "uniform": torch.from_numpy(uniform),
            "eps_cql": torch.from_numpy(np.stack(eps_cql))})
        assert float(taux["cql_loss"]) > 0
    else:
        eps = _normals(rng, 1 + talg.config.n_action_samples)
        with _jax_noise(normals=eps):
            jnew, jaux = jalg._update(jalg.state, batch,
                                      jax.random.PRNGKey(0))
        taux = talg._update(talg.state, _tensors(batch),
                            torch.from_numpy(np.stack(eps)))
        assert 0 < float(taux["mean_weight"]) < 1.5
    _check_update(jalg, talg, jnew, jaux, taux, before, talg.config.tau)


def _ac_batch(rng, rows=8):
    adv = (rng.standard_normal(rows) * 2 + 0.5).astype(np.float32)
    return {"obs": rng.standard_normal((rows, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, rows).astype(np.int32),
            "advantages": adv,
            "value_targets": rng.standard_normal(rows).astype(np.float32)}


@pytest.mark.parametrize("kind", ["pg", "a2c"])
def test_sgd_step_matches_jax(kind):
    """One PG (advantages normalised by the population std; clip and
    Adam) or A2C (raw advantages; clip and RMSProp) step from JAX's
    weights on 8 rows, whose advantage std differs by 7% between ddof 0
    and 1: aux at RTOL, parameters at ATOL."""
    jcls, jcfg_cls, tcfg_cls = {
        "pg": (jpg.PG, jpg.PGConfig, PGConfig),
        "a2c": (ja2c.A2C, ja2c.A2CConfig, A2CConfig)}[kind]
    train = dict(lr=1e-3, grad_clip=0.5, entropy_coeff=0.01)
    with _numpy_init(JM, "ActorCritic", np.random.default_rng(41),
                     scale=0.3):
        jalg = _bare(jcls, _cfg(jcfg_cls, "CartPole-v1", **train))
    talg = _bare(get_algorithm_class(kind), _cfg(
        tcfg_cls, "CartPole-v1", **train).resources(device="cpu"), CPU)
    _load(talg.model, jalg.params)
    batch = _ac_batch(np.random.default_rng(42))
    adv = batch["advantages"]
    assert abs(adv.std(ddof=1) / adv.std() - 1) > 0.05
    jp, _, jaux = jalg._sgd_step(jalg.params, jalg.opt_state, batch)
    _, taux = talg._sgd_step(talg.opt_state, _tensors(batch))
    _assert_aux(taux, jaux)
    _assert_params(talg.model, jp)


@pytest.mark.parametrize("kind", ["sac", "ddpg"])
def test_continuous_policies_match_jax(kind):
    """Deterministic actions on JAX's weights at 1e-5, rescaled to
    [-2, 2]; exploring actions stay in the bounds and spread (SAC's
    logp finite); a discrete action space raises ValueError."""
    jcls, tcls, actor, kwargs = {
        "sac": (JaxSACPolicy, SACPolicy, "SquashedGaussianActor", {}),
        "ddpg": (JaxDDPGPolicy, DDPGPolicy, "DeterministicActor",
                 {"exploration_noise": 0.3})}[kind]
    spaces = (JaxBox(-1, 1, (3,)), JaxBox(-2.0, 2.0, (1,)))
    tspaces = (Box(-1, 1, (3,)), Box(-2.0, 2.0, (1,)))
    with _numpy_init(JM, actor, np.random.default_rng(43), scale=0.5):
        jpol = jcls(*spaces, hidden=(16,), seed=0, **kwargs)
    tpol = tcls(*tspaces, hidden=(16,), seed=0, device="cpu", **kwargs)
    _load(tpol.model, jpol.get_weights())
    obs = np.random.default_rng(43).standard_normal((16, 3)).astype(
        np.float32)
    ja, jlogp, jv = jpol.compute_actions(obs, explore=False)
    ta, tlogp, tv = tpol.compute_actions(obs, explore=False)
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    assert ta.dtype == np.float32 and len(np.unique(ta)) > 1
    for t, j in ((tlogp, jlogp), (tv, jv)):
        np.testing.assert_array_equal(t, np.asarray(j))
    a, logp, _ = tpol.compute_actions(np.zeros((64, 3), np.float32))
    assert a.shape == (64, 1) and np.all(np.abs(a) <= 2.0)
    assert np.std(a) > 1e-3 and np.all(np.isfinite(logp))
    a2, _, _ = tpol.compute_actions(np.zeros((8, 3), np.float32),
                                    explore=False)
    assert np.allclose(a2, a2[0])
    if kind == "ddpg":
        tpol.set_noise_scale(0.0)
        a3, _, _ = tpol.compute_actions(np.zeros((8, 3), np.float32))
        np.testing.assert_array_equal(a3, a2)
    with pytest.raises(ValueError, match="continuous"):
        tcls(tspaces[0], Discrete(2), device="cpu")
    with pytest.raises(ValueError):
        jcls(spaces[0], JaxDiscrete(2))


def _run_updates(algo, n, rng):
    for i in range(n):
        batch = _tensors(_batch(rng))
        if isinstance(algo.state.get("log_alpha"), torch.Tensor):
            algo._update(algo.state, batch, algo.draw_noise(B))
        elif "target_actor" in algo.state:
            algo._updates += 1
            algo._update(algo.state, batch, algo.draw_noise(B),
                         algo._updates % 2 == 0)
        else:
            algo.train()


@pytest.mark.parametrize("kind", ["sac", "td3", "cql", "crr"])
def test_full_state_round_trip(kind, dataset):
    """Save after a few updates, train on, restore: every network, the
    log temperature, each optimizer's moments and count and TD3's update
    count equal the saved ones bit for bit, restored in place into the
    modules and parameters the optimizers update."""
    train = dict(train_batch_size=B, num_sgd_iter=2)
    if kind in ("cql", "crr"):
        algo = get_algorithm_class(kind)(_cfg(
            CQLConfig if kind == "cql" else CRRConfig, **train)
            .resources(device="cpu").offline_data(input_path=dataset))
    else:
        algo = _bare(get_algorithm_class(kind), _cfg(
            SACConfig if kind == "sac" else TD3Config)
            .resources(device="cpu"), CPU)
    rng = np.random.default_rng(44)
    _run_updates(algo, 3, rng)
    live = dict(algo.state)
    if kind in ("cql", "crr"):
        ckpt = algo.save()
    saved = full_training_state(algo)
    _run_updates(algo, 2, rng)
    if kind in ("cql", "crr"):
        algo.restore(ckpt)
        assert algo.iteration == 3
    else:
        apply_full_training_state(algo, saved)
    back = full_training_state(algo)
    assert set(back["state"]) == set(saved["state"])
    for part, want in saved["state"].items():
        got = back["state"][part]
        flat = jax.tree_util.tree_leaves_with_path(want)
        got = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(got) == len(flat) > 0, part
        for path, leaf in flat:
            np.testing.assert_array_equal(got[path], leaf, err_msg=part)
    assert back.get("_counters") == saved.get("_counters")
    if kind == "td3":
        assert saved["_counters"]["_updates"] == 3
    for name, v in live.items():
        if isinstance(v, torch.Tensor) or isinstance(v, torch.nn.Module):
            assert algo.state[name] is v, name
    assert algo.model is algo.state["actor"]
    assert saved["state"]["actor_opt"]["count"] == \
        back["state"]["actor_opt"]["count"] > 0


@pytest.mark.parametrize("name", ["sac", "ddpg", "td3", "pg", "a2c",
                                  "a3c", "cql", "crr"])
def test_learners_take_the_card_or_the_cpu(name, dataset, monkeypatch):
    """Every learner's device is the card unless the caller asks for the
    CPU: with no CUDA device, building one without
    ``.resources(device="cpu")`` raises before any rollout worker
    starts.  The rollout policies build on the CPU."""
    from ray_tpu_torch.rl import RolloutWorker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    algo, cfg_cls = get_algorithm_class(name, return_config=True)
    cfg = cfg_cls().environment(
        "CartPole-v1" if name in ("pg", "a2c", "a3c") else "Pendulum-v1")
    if name in ("cql", "crr"):
        cfg.offline_data(input_path=dataset)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.build()
    if name in ("sac", "ddpg"):
        threads = torch.get_num_threads()
        try:
            worker = RolloutWorker("Pendulum-v1", policy=name,
                                   hidden=(16,), seed=0)
        finally:
            torch.set_num_threads(threads)
        assert isinstance(worker.policy, {"sac": SACPolicy,
                                          "ddpg": DDPGPolicy}[name])
        assert worker.sample_transitions().count == 200


@pytest.fixture(scope="module")
def runtime():
    import ray_tpu_torch as rt
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def test_families_train_on_the_runtime(runtime):
    """SAC and TD3 on Pendulum-v1, PG, A2C and A3C on CartPole-v1, two
    ``train()`` calls each with the learner on the CPU: finite losses,
    SAC's temperature positive, A3C's fragments applied as they arrive
    (two a call), and the rollout workers holding the learner's weights
    after a synchronous call."""
    small = dict(learning_starts=32, train_batch_size=16,
                 n_updates_per_iter=2)
    cases = (
        (_cfg(SACConfig, **small), "critic_loss"),
        (_cfg(TD3Config, **small), "critic_loss"),
        (_cfg(PGConfig, "CartPole-v1", train_batch_size=32),
         "total_loss"),
        (_cfg(A2CConfig, "CartPole-v1", train_batch_size=32),
         "total_loss"),
        (_cfg(A3CConfig, "CartPole-v1", batches_per_step=2)
         .rollouts(num_rollout_workers=2), "total_loss"))
    for cfg, loss in cases:
        algo = (cfg.rollouts(num_envs_per_worker=2,
                             rollout_fragment_length=16)
                .resources(device="cpu").build())
        try:
            for it in (1, 2):
                r = algo.train()
                assert r["training_iteration"] == it
            assert np.isfinite(r["info"][loss]), (cfg, r["info"])
            if isinstance(cfg, SACConfig):
                assert r["info"]["alpha"] > 0
            if isinstance(cfg, A3CConfig):
                assert r["info"]["batches_processed"] == 2
                assert r["timesteps_total"] == 4 * 32
            else:
                remote = runtime.get(
                    algo.workers.workers[0].get_weights.remote())
                for n, w in algo.get_weights().items():
                    np.testing.assert_array_equal(remote[n], w)
        finally:
            algo.stop()
