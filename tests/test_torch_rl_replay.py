"""The port's replay and asynchronous RL families (ray_tpu_torch.rl: DQN,
SimpleQ, Ape-X, R2D2, APPO, the replay buffers, the Q policies and their
samplers, the podracer executor and ``Algorithm.as_trainable``) held
against ray_tpu.rl on the same numpy inputs and weights, on the CPU.

The JAX learners are built without a runtime (``setup_learner`` on an
object that skips ``Algorithm.__init__``, so no WorkerSet starts), their
initial weights drawn from numpy at ``jax.eval_shape``'s shapes
(``test_torch_rl._numpy_init``) and their steps run jitted; weights cross
with ``params_from_jax``, loaded strictly.  Tolerances, all fp32: the
buffers, the greedy samplers and the weight codec exactly (the same
numpy code, the same env seeds); forward passes, Q-values and carries
atol 1e-5; one TD, R2D2 or APPO update: loss and aux rtol 1e-5 (atol
1e-6), ``td_error`` and the parameters after Adam atol 1e-5, as
tests/test_torch_rl.py holds PPO's.  The runtime cases share one
session of the port's runtime with the learners on the CPU.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rl import apex_dqn as japex
from ray_tpu.rl import appo as jappo
from ray_tpu.rl import dqn as jdqn
from ray_tpu.rl import models as JM
from ray_tpu.rl import r2d2 as jr2d2
from ray_tpu.rl import replay_buffer as jbuf
from ray_tpu.rl.env import CartPoleEnv as JaxCartPole
from ray_tpu.rl.podracer import weights as jweights
from ray_tpu.rl.policy import QPolicy as JaxQPolicy
from ray_tpu.rl.policy import R2D2Policy as JaxR2D2Policy
from ray_tpu.rl.rollout_worker import RolloutWorker as JaxRolloutWorker
from ray_tpu.rl.sample_batch import SampleBatch as JaxSampleBatch
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.rl import (APPOConfig, ApexDQNConfig, DQNConfig,
                              ImpalaConfig, PPOConfig, PrioritizedReplayBuffer,
                              QPolicy, R2D2Config, R2D2Policy, ReplayBuffer,
                              RolloutWorker, SampleBatch, SimpleQConfig,
                              get_algorithm_class)
from ray_tpu_torch.rl import models as TM
from ray_tpu_torch.rl.appo import make_appo_sgd_step
from ray_tpu_torch.rl.env import CartPoleEnv
from ray_tpu_torch.rl.podracer import weights as tweights
from ray_tpu_torch.rl.policy import load_weights, module_weights
from ray_tpu_torch.rl.ppo import make_ppo_optimizer

from test_torch_rl import (ATOL, RTOL, _assert_params, _fragment,
                           _jax_params, _numpy_init, _unboxed)

HIDDEN = (16, 16)
CPU = torch.device("cpu")


def _cfg(cls, **training):
    return (cls().environment("CartPole-v1").training(**training)
            .debugging(seed=0))


def _bare(cls, cfg, device=None):
    """An algorithm of ``cls`` with its learner set up and nothing else:
    no runtime, no rollout workers (``Algorithm.__init__`` skipped)."""
    algo = cls.__new__(cls)
    algo.config = cfg
    algo.podracer = None
    if device is not None:
        algo.device = device
    algo.setup_learner()
    return algo


def _load(module, jax_params):
    module.load_state_dict(params_from_jax(_unboxed(jax_params), module))


def _assert_aux(taux, jaux, skip=()):
    for k in jaux:
        if k in skip:
            continue
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- buffers

def _rows(rng, n, obs_dim=4):
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "terminateds": rng.random(n) < 0.1}


@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "prioritized"])
def test_replay_buffers_match_jax(prioritized):
    """The same adds (wrapping the ring twice) and the same seed: every
    sample's rows, and under PER its indices and importance weights,
    equal JAX's exactly, with priorities updated between samples."""
    rng = np.random.default_rng(20)
    make = ((lambda m: m.PrioritizedReplayBuffer(32, alpha=0.6, seed=3))
            if prioritized else (lambda m: m.ReplayBuffer(32, seed=3)))
    port = make(types.SimpleNamespace(
        ReplayBuffer=ReplayBuffer,
        PrioritizedReplayBuffer=PrioritizedReplayBuffer))
    ref = make(jbuf)
    for n in (7, 13, 5, 40, 9):
        rows = _rows(rng, n)
        port.add(SampleBatch(dict(rows)))
        ref.add(JaxSampleBatch(dict(rows)))
        assert len(port) == len(ref)
        got, want = port.sample(10), ref.sample(10)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
        if prioritized:
            prio = rng.standard_normal(10) * 3
            port.update_priorities(got["batch_indexes"], prio)
            ref.update_priorities(want["batch_indexes"], prio)
    if prioritized:
        np.testing.assert_array_equal(port._tree, ref._tree)
        assert len(np.unique(want["weights"])) > 1


# --------------------------------------------------------------- policies

def _spaces():
    return ((JaxCartPole().observation_space, JaxCartPole().action_space),
            (CartPoleEnv().observation_space, CartPoleEnv().action_space))


def test_q_policy_greedy_actions_match_jax():
    """QPolicy (dueling) on JAX's weights: greedy actions (int32) and
    max-Q at ATOL; exploring at epsilon 1 draws every action."""
    jspaces, tspaces = _spaces()
    with _numpy_init(JM, "QNetwork", np.random.default_rng(21), scale=0.5):
        jpol = JaxQPolicy(*jspaces, hidden=HIDDEN, seed=1)
    tpol = QPolicy(*tspaces, hidden=HIDDEN, seed=1, device="cpu")
    _load(tpol.model, jpol.get_weights())
    obs = np.random.default_rng(21).standard_normal((32, 4)).astype(
        np.float32)
    ja, jlogp, jq = jpol.compute_actions(obs, explore=False)
    ta, tlogp, tq = tpol.compute_actions(obs, explore=False)
    np.testing.assert_array_equal(ta, ja)
    assert ta.dtype == ja.dtype and len(np.unique(ta)) == 2
    np.testing.assert_allclose(tq, jq, atol=ATOL)
    np.testing.assert_array_equal(tlogp, jlogp)
    tpol.set_epsilon(1.0)
    ta, _, _ = tpol.compute_actions(np.repeat(obs[:1], 64, 0))
    assert set(ta.tolist()) == {0, 1}


def test_r2d2_policy_carry_matches_jax():
    """R2D2Policy over 6 steps of 3 envs from a zero carry, with
    ``reset_carry`` of envs 0 and 2 after step 3: greedy actions, max-Q
    and the (c, h) carry, read as numpy, at ATOL."""
    jspaces, tspaces = _spaces()
    with _numpy_init(JM, "RecurrentQNetwork", np.random.default_rng(22),
                     scale=0.5):
        jpol = JaxR2D2Policy(*jspaces, hidden=(16,), lstm_size=8,
                             num_envs=3, seed=2)
    tpol = R2D2Policy(*tspaces, hidden=(16,), lstm_size=8, num_envs=3,
                      seed=2, device="cpu")
    _load(tpol.model, jpol.get_weights())
    rng = np.random.default_rng(22)
    for step in range(6):
        obs = rng.standard_normal((3, 4)).astype(np.float32)
        ja, _, jq = jpol.compute_actions(obs, explore=False)
        ta, _, tq = tpol.compute_actions(obs, explore=False)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_allclose(tq, jq, atol=ATOL)
        if step == 3:
            jpol.reset_carry(np.array([1, 0, 1]))
            tpol.reset_carry(np.array([1, 0, 1]))
            assert not tpol.carry[1][0].any() and tpol.carry[1][1].any()
        for g, w in zip(tpol.carry, jpol.carry):
            assert isinstance(g, np.ndarray) and g.shape == (3, 8)
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("kind", ["transitions", "sequences"])
def test_greedy_samplers_match_jax(kind):
    """``sample_transitions`` (Q policy) and ``sample_sequences`` (R2D2
    policy) at epsilon 0 on the same env seeds and weights: every column
    equal to JAX's (obs, the terminal obs put in NEXT_OBS at episode
    ends, ``seq_valid`` after an episode's end), over two fragments that
    cross episode ends."""
    policy, hidden, kwargs, network = (
        ("q", HIDDEN, {}, "QNetwork") if kind == "transitions" else
        ("r2d2", (16,), {"lstm_size": 8}, "RecurrentQNetwork"))
    threads = torch.get_num_threads()
    try:
        with _numpy_init(JM, network, np.random.default_rng(23), scale=0.5):
            jw = JaxRolloutWorker("CartPole-v1", num_envs=2,
                                  rollout_fragment_length=40, policy=policy,
                                  hidden=hidden, policy_kwargs=kwargs,
                                  seed=0)
        tw = RolloutWorker("CartPole-v1", num_envs=2,
                           rollout_fragment_length=40, policy=policy,
                           hidden=hidden, policy_kwargs=kwargs, seed=0)
    finally:
        torch.set_num_threads(threads)
    _load(tw.policy.model, jw.get_weights())
    for w in (jw, tw):
        w.set_epsilon(0.0)
    ends = 0
    for _ in range(2):
        want = getattr(jw, f"sample_{kind}")()
        got = getattr(tw, f"sample_{kind}")()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        ends += int(np.sum(want["terminateds"]))
    assert ends > 0
    if kind == "sequences":
        assert (want["seq_valid"] == 0).any()
    assert tw.get_metrics() == jw.get_metrics()


# ----------------------------------------------------------- learner steps

def _td_batch(rng, n=32, per=False):
    b = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
         "actions": rng.integers(0, 2, n).astype(np.int32),
         "rewards": (2 * rng.standard_normal(n)).astype(np.float32),
         "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
         "terminateds": rng.random(n) < 0.2}
    if per:
        b["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return b


def _jax_learner(cls, cfg, network, seed):
    with _numpy_init(JM, network, np.random.default_rng(seed), scale=0.5):
        return _bare(cls, cfg)


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
@pytest.mark.parametrize("dueling", [False, True], ids=["plain", "dueling"])
@pytest.mark.parametrize("double_q", [False, True], ids=["max", "double"])
def test_dqn_td_step_matches_jax(double_q, dueling, per):
    """One TD step from JAX's weights, with a target network that differs
    from the online one: loss, mean Q and grad norm at RTOL, the per-row
    ``td_error`` and the parameters after clip + Adam at ATOL; the Huber
    loss takes both its branches, the double-Q argmax differs from the
    target's in some rows, and the target network does not move."""
    train = dict(hidden=HIDDEN, double_q=double_q, dueling=dueling,
                 lr=1e-3, grad_clip=0.5)
    jalg = _jax_learner(jdqn.DQN, _cfg(jdqn.DQNConfig, **train),
                        "QNetwork", 24)
    rng = np.random.default_rng(124)
    jalg.target_params = _jax_params(
        JM.QNetwork(2, HIDDEN, dueling=dueling), rng, jnp.zeros((1, 4)),
        scale=0.5)
    talg = _bare(get_algorithm_class("dqn"),
                 _cfg(DQNConfig, **train).resources(device="cpu"), CPU)
    _load(talg.model, jalg.params)
    _load(talg.target_model, jalg.target_params)
    target_before = module_weights(talg.target_model)
    batch = _td_batch(rng, per=per)
    jp, _, jaux = jalg._td_step(jalg.params, jalg.target_params,
                                jalg.opt_state, batch)
    talg.opt_state, taux = talg._td_step(
        talg.opt_state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(taux) == set(jaux)
    _assert_aux(taux, jaux, skip=("td_error",))
    np.testing.assert_allclose(taux["td_error"].numpy(),
                               np.asarray(jaux["td_error"]), atol=ATOL)
    _assert_params(talg.model, jp)
    td = np.abs(np.asarray(jaux["td_error"]))
    assert (td > 1).any() and (td < 1).any()
    for n, w in module_weights(talg.target_model).items():
        np.testing.assert_array_equal(w, target_before[n])
    if double_q:
        with torch.no_grad():
            nxt = torch.from_numpy(batch["next_obs"])
            online = talg.model(nxt).argmax(-1)
            assert (online != talg.target_model(nxt).argmax(-1)).any()


def _sequences(rng, B=4, L=10, burn_in=3):
    seq_valid = np.ones((B, L), np.float32)
    seq_valid[0, 7:] = 0.0
    seq_valid[2, 5:] = 0.0
    truncs = np.zeros((B, L), bool)
    truncs[1, 6] = truncs[3, 4] = True
    terms = np.zeros((B, L), bool)
    terms[0, 6] = terms[2, 4] = True
    return {"obs": rng.standard_normal((B, L, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (B, L)).astype(np.int32),
            "rewards": (2 * rng.standard_normal((B, L))).astype(np.float32),
            "terminateds": terms, "truncateds": truncs,
            "seq_valid": seq_valid}


def test_r2d2_step_matches_jax():
    """One sequence TD step from JAX's weights (LSTM 8, burn-in 3,
    sequences of 10) with a distinct target network, where the burn-in,
    the last column, the truncated steps and the steps after an
    episode's end each take steps out of the loss: loss, mean Q,
    ``trained_steps`` and grad norm at RTOL, parameters at ATOL."""
    train = dict(hidden=(16,), lstm_size=8, burn_in=3, lr=1e-3,
                 grad_clip=0.5)
    jalg = _jax_learner(jr2d2.R2D2, _cfg(jr2d2.R2D2Config, **train),
                        "RecurrentQNetwork", 25)
    rng = np.random.default_rng(125)
    jm = JM.RecurrentQNetwork(2, (16,), lstm_size=8)
    jalg.target_params = _jax_params(jm, rng, jnp.zeros((1, 1, 4)),
                                     jm.initial_state(1), scale=0.5)
    talg = _bare(get_algorithm_class("r2d2"),
                 _cfg(R2D2Config, **train).resources(device="cpu"), CPU)
    _load(talg.model, jalg.params)
    _load(talg.target_model, jalg.target_params)
    batch = _sequences(rng)
    jp, _, jaux = jalg._td_step(jalg.params, jalg.target_params,
                                jalg.opt_state, batch)
    talg.opt_state, taux = talg._td_step(
        talg.opt_state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(taux) == set(jaux)
    _assert_aux(taux, jaux)
    _assert_params(talg.model, jp)
    # valid steps after the burn-in (columns 3-9): rows 0 and 2 end their
    # episodes at 6 and 4, so 4 and 2 of them; rows 1 and 3 lose their
    # last column and one truncated step each: 5 and 5
    assert float(taux["trained_steps"]) == 4 + 5 + 2 + 5


def test_appo_step_matches_jax():
    """One APPO step from JAX's weights on a [7, 3] fragment with a
    target network that differs from the online one (so V-trace's anchor
    is not the learner's logp) and behaviour logps far from both (so the
    surrogate's clip is taken): aux at RTOL, parameters at ATOL."""
    train = dict(hidden=HIDDEN, lr=1e-3, grad_clip=40.0)
    jcfg = _cfg(jappo.APPOConfig, **train)
    jalg = _jax_learner(jappo.APPO, jcfg, "ActorCritic", 26)
    rng = np.random.default_rng(126)
    jalg.target_params = _jax_params(
        JM.ActorCritic(action_dim=2, hidden=HIDDEN), rng,
        jnp.zeros((1, 4)), scale=0.5)
    tcfg = _cfg(APPOConfig, **train).resources(device="cpu")
    tm = TM.ActorCritic(4, 2, HIDDEN, device="cpu")
    target = TM.ActorCritic(4, 2, HIDDEN, device="cpu")
    _load(tm, jalg.params)
    _load(target, jalg.target_params)
    tx = make_ppo_optimizer(tcfg)
    step = make_appo_sgd_step(tm, target, TM.categorical_logp,
                              TM.categorical_entropy, tx, tcfg)
    frag = _fragment(rng, 7, 3)
    jp, _, jaux = jalg._appo_step(jalg.params, jalg.target_params,
                                  jalg.opt_state, frag)
    tbatch = {k: torch.from_numpy(v) for k, v in frag.items()}
    with torch.no_grad():
        logits, _ = tm(tbatch["obs"].reshape(21, 4))
        ratio = torch.exp(TM.categorical_logp(logits.reshape(7, 3, 2),
                                              tbatch["actions"])
                          - tbatch["action_logp"])
    assert ((ratio - 1).abs() > tcfg.clip_param).any()
    _, taux = step(tx.init(dict(tm.named_parameters())), tbatch)
    assert set(taux) == set(jaux)
    _assert_aux(taux, jaux)
    _assert_params(tm, jp)


def _steps(algo, kind, rng, n):
    for _ in range(n):
        if kind == "appo":
            batch = _fragment(rng, 5, 2)
            step = algo._sgd_step
        else:
            batch = (_td_batch(rng) if kind == "dqn" else _sequences(rng))
            step = algo._td_step
        algo.opt_state, _ = step(
            algo.opt_state, {k: torch.from_numpy(v)
                             for k, v in batch.items()})


@pytest.mark.parametrize("kind", ["dqn", "r2d2", "appo"])
def test_target_network_is_a_copy(kind):
    """The target network is a copy of the online one, never an alias:
    it holds still across learner steps between two syncs (APPO's
    refresh every ``target_update_frequency`` steps, made longer than the
    steps taken), a sync copies the online weights in, and the steps
    after it move the online network only.  With ``target_model =
    model`` (or the JAX package's ``target_params = params`` carried over
    to modules updated in place) the target would track every step."""
    cfg = {"dqn": _cfg(DQNConfig, hidden=HIDDEN, lr=1e-2),
           "r2d2": _cfg(R2D2Config, hidden=(16,), lstm_size=8, burn_in=2,
                        lr=1e-2),
           "appo": _cfg(APPOConfig, hidden=HIDDEN, lr=1e-2,
                        target_update_frequency=100)}[kind]
    algo = _bare(get_algorithm_class(kind), cfg.resources(device="cpu"),
                 CPU)
    rng = np.random.default_rng(27)
    for _ in range(2):
        before = module_weights(algo.target_model)
        online = module_weights(algo.model)
        _steps(algo, kind, rng, 3)
        after = module_weights(algo.target_model)
        moved = module_weights(algo.model)
        for n in before:
            np.testing.assert_array_equal(after[n], before[n], err_msg=n)
        assert any(not np.array_equal(moved[n], online[n]) for n in moved)
        algo.sync_target()
        for n, w in module_weights(algo.target_model).items():
            np.testing.assert_array_equal(w, moved[n])
    # set_weights syncs the target as JAX's does, by copy
    algo.set_weights({n: w + 1 for n, w in moved.items()})
    _steps(algo, kind, rng, 1)
    for n, w in module_weights(algo.target_model).items():
        np.testing.assert_array_equal(w, moved[n] + 1)


def test_apex_epsilon_ladder_matches_jax():
    """Ape-X's per-worker epsilons for 4 workers: JAX's formula
    eps_base^(1 + i alpha / (N - 1)) exactly, strictly falling."""
    jcfg = _cfg(japex.ApexDQNConfig, hidden=HIDDEN)
    jalg = japex.ApexDQN.__new__(japex.ApexDQN)
    jalg.config = jcfg
    jalg.workers = types.SimpleNamespace(workers=[None] * 4)
    with _numpy_init(JM, "QNetwork", np.random.default_rng(28)):
        jalg.setup_learner()
    talg = _bare(get_algorithm_class("ApexDQN"),
                 _cfg(ApexDQNConfig, hidden=HIDDEN).resources(device="cpu"),
                 CPU)
    assert talg._epsilons == jalg._epsilons
    assert len(talg._epsilons) == 4 and talg._epsilons[0] == 0.4
    assert all(a > b for a, b in zip(talg._epsilons, talg._epsilons[1:]))
    assert isinstance(talg.buffer, PrioritizedReplayBuffer)


# -------------------------------------------------------- podracer weights

@pytest.mark.parametrize("quantize", [False, True], ids=["raw", "int8"])
def test_podracer_weights_codec_matches_jax(quantize):
    """A port network's weights (flat state-dict names, plus an integer
    leaf) encode to the payload JAX's ``encode_weights`` makes, each
    package decodes the other's payload to the same arrays, and the
    decoded dict loads back into the network: exactly when raw, within
    the int8 codec's blockmax/254 when quantized."""
    model = TM.init_params(TM.QNetwork(4, 2, HIDDEN, device="cpu"), 3)
    weights = dict(module_weights(model), step=np.array(7))
    tp = tweights.encode_weights(weights, quantize=quantize, block=64)
    jp = jweights.encode_weights(weights, quantize=quantize, block=64)
    assert tp["codec"] == jp["codec"]
    assert [leaf[0] for leaf in tp["leaves"]] == \
        [leaf[0] for leaf in jp["leaves"]]
    assert tweights.payload_nbytes(tp) == jweights.payload_nbytes(jp)
    outs = (tweights.decode_weights(tp), tweights.decode_weights(jp),
            jweights.decode_weights(tp))
    for out in outs:
        assert set(out) == set(weights) and out["step"] == 7
        for n in weights:
            np.testing.assert_array_equal(out[n], outs[0][n], err_msg=n)
    back = outs[0]
    back.pop("step")
    load_weights(model, back)
    for n, w in module_weights(model).items():
        if quantize:
            bound = np.abs(weights[n]).max() / 254 + 1e-7
            assert np.abs(w - weights[n]).max() <= bound, n
        else:
            np.testing.assert_array_equal(w, weights[n])


# -------------------------------------------------------------- registry

def test_registry_resolves_the_replay_family():
    """The slice's names resolve to their classes, as do the continuous
    and actor-critic families ported since; later slices still raise,
    naming their slice; ``.podracer()`` raises where JAX's
    does (DQN, SimpleQ, Ape-X, R2D2) and for APPO, whose JAX class would
    train IMPALA's loss on the executor."""
    for name, cls in (("APPO", "APPO"), ("dqn", "DQN"),
                      ("simple_q", "SimpleQ"), ("apex-dqn", "ApexDQN"),
                      ("R2D2", "R2D2")):
        algo, cfg = get_algorithm_class(name, return_config=True)
        assert (algo.__name__, cfg.__name__) == (cls, cls + "Config")
        assert cfg().algo_class is algo
    for name, cls in (("sac", "SAC"), ("td3", "TD3"), ("a2c", "A2C"),
                      ("cql", "CQL")):
        assert get_algorithm_class(name).__name__ == cls
    for name, slice_ in (("maddpg", "multi_agent"), ("qmix", "QMIX"),
                         ("dreamer", "model-based"), ("es", "search")):
        with pytest.raises(NotImplementedError, match=slice_):
            get_algorithm_class(name)
    for cfg in (DQNConfig(), SimpleQConfig(), ApexDQNConfig(),
                R2D2Config(), APPOConfig()):
        with pytest.raises(ValueError, match="podracer"):
            cfg.environment("CartPole-v1").resources(
                device="cpu").podracer().build()
    for jcfg in (jdqn.DQNConfig(), japex.ApexDQNConfig(),
                 jr2d2.R2D2Config()):
        with pytest.raises(ValueError, match="podracer"):
            jcfg.environment("CartPole-v1").podracer().build()
    assert ImpalaConfig().podracer().use_podracer
    assert PPOConfig().podracer(strict_zero_submit=False).podracer_kwargs \
        == {"strict_zero_submit": False}


# ------------------------------------------------------ on the runtime

@pytest.fixture(scope="module")
def runtime():
    """One session of the port's runtime for the cases below: a podracer
    fleet is a learner and two rollout actors, a trial of the sweep one
    trial actor and one rollout worker."""
    import ray_tpu_torch as rt
    rt.init(num_cpus=6)
    yield rt
    rt.shutdown()


def test_impala_podracer_zero_submissions_steady_state(runtime):
    """IMPALA on the podracer plane with its learner on the CPU (a copy
    of tests/test_rl_podracer.py's case): timesteps advance, losses flow,
    the learner publishes versions and the fleet adopts them, and the
    driver submits ZERO classic actor tasks per steady-state learner
    step (``strict_zero_submit`` raises inside ``train()`` otherwise)."""
    algo = (ImpalaConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=25)
            .training(batches_per_step=4, hidden=HIDDEN)
            .resources(device="cpu").debugging(seed=0).podracer().build())
    try:
        ts = []
        for _ in range(3):
            r = algo.train()
            ts.append(r["timesteps_total"])
        assert ts[0] > 0 and ts[2] > ts[1] > ts[0]
        assert np.isfinite(r["info"]["total_loss"])
        ex = algo.podracer
        assert ex.telemetry["classic_submits_steady"] == 0
        assert ex.telemetry["learner_steps"] >= 12
        assert r["info"]["weight_version"] >= 2
        assert len(ex.telemetry["weight_adoption_s"]) >= 1
        assert ex.learner_stats()["device"] == "cpu"
        assert isinstance(algo.get_weights()["pi_0.weight"], np.ndarray)
    finally:
        algo.stop()


def test_ppo_podracer_checkpoint_roundtrip(runtime):
    """PPO on the same executor (a copy of tests/test_rl_podracer.py's
    case): a full save and restore gives back the learner's weights,
    Adam's moments and its counters bit for bit, and training resumes."""
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=50)
            .training(train_batch_size=200, sgd_minibatch_size=100,
                      hidden=HIDDEN)
            .resources(device="cpu").debugging(seed=0).podracer().build())
    try:
        r1 = algo.train()
        assert r1["timesteps_total"] > 0
        assert algo.podracer.telemetry["classic_submits_steady"] == 0
        ckpt = algo.save()
        saved = algo.get_full_state()
        algo.set_weights({n: w + 1 for n, w in algo.get_weights().items()})
        algo.restore(ckpt)
        back = algo.get_full_state()
        for part in ("params", "opt_state"):
            flat = jax.tree_util.tree_leaves_with_path(saved[part])
            got = dict(jax.tree_util.tree_leaves_with_path(back[part]))
            for path, leaf in flat:
                np.testing.assert_array_equal(got[path], leaf)
        assert back["_step_no"] == saved["_step_no"] > 0
        r2 = algo.train()
        assert r2["timesteps_total"] > r1["timesteps_total"]
    finally:
        algo.stop()


def test_as_trainable_through_the_port_tuner(runtime, tmp_path):
    """``Tuner(PPO.as_trainable(cfg))`` over two learning rates, two
    iterations each (the run's stop rule): both trials report their
    ``train()`` results with a checkpoint that restores, and each
    trial's learning rate reaches its learner."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig
    from ray_tpu_torch.rl import PPO
    cfg = (PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=1, num_envs_per_worker=2,
                     rollout_fragment_length=16)
           .training(train_batch_size=32, sgd_minibatch_size=16,
                     num_sgd_iter=1, hidden=HIDDEN)
           .resources(device="cpu").debugging(seed=0))
    tuner = tune.Tuner(
        PPO.as_trainable(cfg),
        param_space={"lr": tune.grid_search([1e-3, 1e-4])},
        tune_config=tune.TuneConfig(metric="episode_len_mean", mode="max",
                                    trial_resources={"CPU": 1}),
        run_config=RunConfig(name="as_trainable",
                             storage_path=str(tmp_path),
                             stop={"training_iteration": 2}))
    grid = tuner.fit()
    assert not grid.errors
    assert len(grid) == 2
    lrs = set()
    for r in grid:
        assert r.metrics["training_iteration"] == 2
        assert r.metrics["timesteps_total"] == 64
        assert r.checkpoint is not None
        state = r.checkpoint.to_dict()
        assert state["iteration"] == 2
        assert state["state"]["opt_state"]["count"] == 4
        lrs.add(r.config["lr"])
    assert lrs == {1e-3, 1e-4}


def test_replay_family_trains_on_the_runtime(runtime):
    """DQN (PER), Ape-X and R2D2 on the runtime with their learners on
    the CPU, two ``train()`` calls each past ``learning_starts``:
    results as JAX's report them, finite losses, priorities that moved,
    and a save / restore that gives back the online and target
    networks, the moments and the sync counter."""
    small = dict(hidden=HIDDEN, learning_starts=64)
    for cfg in (_cfg(DQNConfig, prioritized_replay=True,
                     n_updates_per_iter=4, **small),
                _cfg(ApexDQNConfig, n_updates_per_iter=4, **small)
                .rollouts(num_rollout_workers=2),
                _cfg(R2D2Config, hidden=(16,), lstm_size=8, burn_in=2,
                     learning_starts=4, n_updates_per_iter=2)):
        algo = (cfg.rollouts(num_envs_per_worker=2,
                             rollout_fragment_length=16)
                .resources(device="cpu").build())
        try:
            for it in (1, 2, 3):
                r = algo.train()
                assert r["training_iteration"] == it
            assert np.isfinite(r["info"]["loss"])
            if algo.config.algo_class is not get_algorithm_class("r2d2"):
                tree = algo.buffer._tree
                leaves = tree[algo.buffer._tree_size:][:len(algo.buffer)]
                assert len(np.unique(leaves)) > 1
            ckpt = algo.save()
            saved = algo.get_full_state()
            assert "target_params" in saved and "_counters" in saved
            algo.set_weights({n: w + 1 for n, w in
                              algo.get_weights().items()})
            algo._steps_since_target_sync += 7
            algo.restore(ckpt)
            back = algo.get_full_state()
            for part in ("params", "target_params"):
                for n, w in saved[part].items():
                    np.testing.assert_array_equal(back[part][n], w)
            assert back["_counters"] == saved["_counters"]
            assert back["opt_state"]["count"] == saved["opt_state"]["count"]
        finally:
            algo.stop()
