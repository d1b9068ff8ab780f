"""The port's RL slice (ray_tpu_torch.rl) held against ray_tpu.rl on the
same numpy inputs and weights, on the CPU.

Weights cross with ``params_from_jax`` (``models/convert.py``: a flax
``kernel`` [in, out] is an ``nn.Linear.weight`` [out, in]; the Decision
Transformer's scanned ``Block`` stack goes through the GPT's leaves).
JAX's ``jax.random`` streams cannot be reproduced in torch, so sampled
quantities are held to their distributions (and PPO's learning to the
CartPole target on the card, ``chip_smoke.py`` phase ``rl``), while the
deterministic parts are held to JAX numerically.  Tolerances, all fp32:
forward passes, logp, entropy and V-trace atol 1e-5 (summation order of
a few products); GAE exact (the same numpy code); one PPO, IMPALA or DT
update: loss and aux rtol 1e-5, parameters atol 1e-5 (Adam and RMSProp
divide by the square root of small second moments, which scales the
gradients' rounding up to ~1e-6).  The JAX side starts no runtime; the
port's one PPO run starts one session with one rollout worker.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ray_tpu.ops.attention import attention as jax_attention
from ray_tpu.rl import impala as jimpala
from ray_tpu.rl import models as JM
from ray_tpu.rl import offline as joffline
from ray_tpu.rl import ppo as jppo
from ray_tpu.rl import dt as jdt_mod
from ray_tpu.rl.dt import DTConfig as JaxDTConfig
from ray_tpu.rl.env import CartPoleEnv as JaxCartPole
from ray_tpu.rl.env import PendulumEnv as JaxPendulum
from ray_tpu.rl.policy import JaxPolicy as JaxJaxPolicy
from ray_tpu.rl.sample_batch import SampleBatch as JaxSampleBatch
from ray_tpu.rl.sample_batch import compute_gae as jax_gae
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops import flash_attention as flash_mod
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.rl import (DTConfig, ImpalaConfig, JsonReader, JsonWriter,
                              PPOConfig, SampleBatch, collect_dataset,
                              compute_gae, get_algorithm_class, vtrace)
from ray_tpu_torch.rl import models as TM
from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.env import CartPoleEnv, PendulumEnv
from ray_tpu_torch.rl.impala import make_impala_optimizer, \
    make_impala_sgd_step
from ray_tpu_torch.rl.offline import BCConfig, MARWILConfig, \
    importance_sampling_estimate
from ray_tpu_torch.rl.policy import JaxPolicy
from ray_tpu_torch.rl.ppo import make_ppo_optimizer, make_ppo_sgd_step

ATOL = 1e-5
RTOL = 1e-5
HIDDEN = (16, 16)


def _unboxed(tree):
    return jax.tree.map(np.asarray, fnn.meta.unbox(tree))


def _numpy_variables(init, key, args, rng, scale):
    """What flax's ``init(key, *args)`` returns, drawn from numpy
    (normal, std ``scale``, biases and log_std too) at the shapes
    ``jax.eval_shape`` gives: it traces the init and compiles nothing,
    where an eager init compiles each of its operations (the JAX side of
    every test here runs jitted, one compilation per function)."""
    shapes = jax.eval_shape(lambda: init(key, *args))
    return jax.tree.map(lambda t: (scale * rng.standard_normal(
        t.shape)).astype(np.float32), shapes)


def _jax_params(jm, rng, *inputs, scale=0.3):
    """JAX module ``jm``'s parameters from numpy (``_numpy_variables``)."""
    return _numpy_variables(jm.init, jax.random.PRNGKey(0), inputs, rng,
                            scale)["params"]


@contextlib.contextmanager
def _numpy_init(module, name: str, rng, scale=0.2):
    """Within the block, flax class ``module.name`` draws its initial
    variables from numpy (``_numpy_variables``): the JAX algorithms'
    own constructors call its ``init``."""
    base = getattr(module, name)

    class NumpyInit(base):
        def init(self, key, *args):
            return _numpy_variables(functools.partial(base.init, self), key,
                                    args, rng, scale)
    setattr(module, name, NumpyInit)
    try:
        yield
    finally:
        setattr(module, name, base)


def _jax_ac(continuous: bool, obs_dim=4, act_dim=2, seed=0):
    """A JAX ActorCritic, its params (numpy) and the port's copy on the
    CPU."""
    jm = JM.ActorCritic(action_dim=act_dim, hidden=HIDDEN,
                        continuous=continuous)
    p = _jax_params(jm, np.random.default_rng(seed),
                    jnp.zeros((1, obs_dim)))
    tm = TM.ActorCritic(obs_dim, act_dim, HIDDEN, continuous, device="cpu")
    tm.load_state_dict(params_from_jax(p, tm))
    return jm, p, tm


def _assert_params(tm, jax_params):
    want = params_from_jax(_unboxed(jax_params), tm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=ATOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_actor_critic_matches_jax(continuous):
    jm, p, tm = _jax_ac(continuous, obs_dim=3, act_dim=2)
    obs = np.random.default_rng(1).standard_normal((6, 3)).astype(np.float32)
    lj, vj = jax.jit(jm.apply)({"params": p}, obs)
    lt, vt = tm(torch.from_numpy(obs))
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               atol=ATOL)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj),
                               atol=ATOL)


# each network: (JAX module, port module, input shapes); obs of width 4,
# actions of width 2, 3 discrete actions; the actor's log_std bounds are
# narrow so that the clip is taken for some outputs
NETWORKS = {
    "q_dueling": (lambda: JM.QNetwork(3, HIDDEN),
                  lambda: TM.QNetwork(4, 3, HIDDEN, device="cpu"),
                  [(6, 4)]),
    "q_plain": (lambda: JM.QNetwork(3, HIDDEN, dueling=False),
                lambda: TM.QNetwork(4, 3, HIDDEN, dueling=False,
                                    device="cpu"), [(6, 4)]),
    "recurrent_q": (lambda: JM.RecurrentQNetwork(3, (16,), lstm_size=8),
                    lambda: TM.RecurrentQNetwork(4, 3, (16,), lstm_size=8,
                                                 device="cpu"),
                    [(2, 5, 4), ((2, 8), (2, 8))]),
    "squashed_gaussian": (
        lambda: JM.SquashedGaussianActor(2, HIDDEN, -0.1, 0.1),
        lambda: TM.SquashedGaussianActor(4, 2, HIDDEN, -0.1, 0.1,
                                         device="cpu"), [(6, 4)]),
    "deterministic": (lambda: JM.DeterministicActor(2, HIDDEN),
                      lambda: TM.DeterministicActor(4, 2, HIDDEN,
                                                    device="cpu"),
                      [(6, 4)]),
    "continuous_q": (lambda: JM.ContinuousQ(HIDDEN),
                     lambda: TM.ContinuousQ(4, 2, HIDDEN, device="cpu"),
                     [(6, 4), (6, 2)]),
    "twin_q": (lambda: JM.TwinQ(HIDDEN),
               lambda: TM.TwinQ(4, 2, HIDDEN, device="cpu"),
               [(6, 4), (6, 2)]),
}


@pytest.mark.parametrize("name", list(NETWORKS))
def test_networks_match_jax(name):
    """Each network of rl/models.py on JAX's weights, loaded strictly, so every flax leaf has its port
    parameter: outputs (and the LSTM's carry) at ATOL."""
    jmake, tmake, shapes = NETWORKS[name]
    rng = np.random.default_rng(11)
    inputs = jax.tree.map(
        lambda n: rng.standard_normal(n).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], int))
    jm, tm = jmake(), tmake()
    p = _jax_params(jm, rng, *inputs)
    tm.load_state_dict(params_from_jax(p, tm))
    want = jax.tree.leaves(jax.jit(jm.apply)({"params": p}, *inputs))
    with torch.no_grad():
        got = jax.tree.leaves(tm(*jax.tree.map(torch.from_numpy, inputs)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    if name == "squashed_gaussian":
        assert (np.abs(np.asarray(want[1])) == np.float32(0.1)).any()


def test_params_from_jax_refuses_a_non_dense_weight():
    """A model outside the known families maps through its dense layers
    only: an embedding's ``.weight`` has no flax kernel layout."""
    model = torch.nn.Sequential(torch.nn.Embedding(5, 3),
                                torch.nn.Linear(3, 2))
    with pytest.raises(TypeError, match="0.weight"):
        params_from_jax({}, model)


def test_squashed_sample_logp_matches_jax(monkeypatch):
    """The tanh-squashed sample and its logp at one fixed eps, which both
    packages' normal draws are made to return; pre-tanh values up to ~6
    take the stable change of variables into saturation; atol 1e-5 on
    the action, 1e-4 on the logp (sums of two terms of up to ~10 per
    action dimension)."""
    rng = np.random.default_rng(12)
    mean = (3 * rng.standard_normal((8, 3))).astype(np.float32)
    log_std = rng.uniform(-2, 0.5, (8, 3)).astype(np.float32)
    eps = rng.standard_normal((8, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(eps))
    ja, jlogp = JM.squashed_sample_logp(jax.random.PRNGKey(0), mean,
                                        log_std)
    monkeypatch.setattr(torch, "randn",
                        lambda shape, **kw: torch.from_numpy(eps))
    ta, tlogp = TM.squashed_sample_logp(torch.Generator(),
                                        torch.from_numpy(mean),
                                        torch.from_numpy(log_std))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=1e-4)


@pytest.mark.parametrize("family", ["categorical", "diag_gaussian"])
def test_distributions_match_jax(family):
    """logp and entropy equal JAX's; the generator-driven samples follow
    the same distribution (20,000 draws: category frequencies within
    0.02 of the softmax, Gaussian mean and std within 0.03)."""
    rng = np.random.default_rng(2)
    if family == "categorical":
        logits = rng.standard_normal((5, 3)).astype(np.float32)
        acts = rng.integers(0, 3, 5).astype(np.int32)
    else:
        logits = rng.standard_normal((5, 4)).astype(np.float32) * 0.5
        acts = rng.standard_normal((5, 2)).astype(np.float32)
    tl, ta = torch.from_numpy(logits), torch.from_numpy(acts)
    for fn in ("logp", "entropy"):
        jfn, tfn = (getattr(mod, f"{family}_{fn}") for mod in (JM, TM))
        args = (logits, acts) if fn == "logp" else (logits,)
        targs = (tl, ta) if fn == "logp" else (tl,)
        np.testing.assert_allclose(tfn(*targs).numpy(),
                                   np.asarray(jax.jit(jfn)(*args)),
                                   atol=ATOL)
    gen = torch.Generator().manual_seed(0)
    row = tl[:1].expand(20000, -1)
    draws = getattr(TM, f"{family}_sample")(gen, row)
    if family == "categorical":
        freq = torch.bincount(draws, minlength=3).float() / 20000
        np.testing.assert_allclose(freq.numpy(), torch.softmax(
            tl[0], -1).numpy(), atol=0.02)
    else:
        mean, log_std = tl[0].chunk(2)
        np.testing.assert_allclose(draws.mean(0).numpy(), mean.numpy(),
                                   atol=0.03)
        np.testing.assert_allclose(draws.std(0).numpy(),
                                   log_std.exp().numpy(), atol=0.03)


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(3)
    n = 40
    cols = {"rewards": rng.standard_normal(n).astype(np.float32),
            "vf_preds": rng.standard_normal(n).astype(np.float32),
            "terminateds": rng.random(n) < 0.1}
    got = compute_gae(SampleBatch(dict(cols)), gamma=0.97, lam=0.9,
                      last_value=0.7)
    want = jax_gae(JaxSampleBatch(dict(cols)), gamma=0.97, lam=0.9,
                   last_value=0.7)
    for k in ("advantages", "value_targets"):
        np.testing.assert_array_equal(got[k], want[k])


def _fragment(rng, T, B, obs_dim=4):
    return {"obs": rng.standard_normal((T, B, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
            "rewards": rng.standard_normal((T, B)).astype(np.float32),
            "terminateds": rng.random((T, B)) < 0.15,
            "action_logp": np.log(rng.uniform(0.2, 0.8, (T, B))
                                  ).astype(np.float32),
            "bootstrap_obs": rng.standard_normal((B, obs_dim)
                                                 ).astype(np.float32)}


def test_vtrace_matches_jax():
    rng = np.random.default_rng(4)
    T, B = 9, 3
    args = [rng.standard_normal((T, B)).astype(np.float32) * 0.5,
            rng.standard_normal((T, B)).astype(np.float32) * 0.5,
            rng.standard_normal((T, B)).astype(np.float32),
            rng.standard_normal((T, B)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32),
            (0.99 * (rng.random((T, B)) > 0.2)).astype(np.float32)]
    for rho_bar, c_bar in ((1.0, 1.0), (0.8, 0.6)):
        got = vtrace(*(torch.from_numpy(a) for a in args), rho_bar, c_bar)
        want = jimpala.vtrace(*args, rho_bar, c_bar)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_ppo_sgd_step_matches_jax():
    """One clipped-surrogate update: loss, aux (the advantage normalised
    by the population std, ``jnp.std``; torch's default sample std moves
    the policy loss by ~1% at 64 rows) and the parameters after Adam."""
    cfg = jppo.PPOConfig().training(entropy_coeff=0.01, grad_clip=0.5,
                                    lr=3e-3)
    jm, p, tm = _jax_ac(False, seed=5)
    rng = np.random.default_rng(5)
    n = 64
    batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32),
             "action_logp": np.log(rng.uniform(0.3, 0.7, n)
                                   ).astype(np.float32),
             "advantages": (3 * rng.standard_normal(n) + 1
                            ).astype(np.float32),
             "value_targets": rng.standard_normal(n).astype(np.float32),
             "vf_preds": rng.standard_normal(n).astype(np.float32)}
    tx = jppo.make_ppo_optimizer(cfg)
    jstep = jppo.make_ppo_sgd_step(jm, JM.categorical_logp,
                                   JM.categorical_entropy, tx, cfg)
    jp, _, jaux = jstep(p, tx.init(p), batch)
    ttx = make_ppo_optimizer(cfg)
    tstep = make_ppo_sgd_step(tm, TM.categorical_logp,
                              TM.categorical_entropy, ttx, cfg)
    _, taux = tstep(ttx.init(dict(tm.named_parameters())),
                    {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)
    _assert_params(tm, jp)


def test_impala_steps_match_jax_rmsprop():
    """Two V-trace updates with optax's rmsprop (eps inside the square
    root, the second moment from 0; torch.optim.RMSprop puts eps
    outside): aux of the second and the parameters after both."""
    cfg = jimpala.ImpalaConfig().training(grad_clip=40.0)
    jm, p, tm = _jax_ac(False, seed=6)
    rng = np.random.default_rng(6)
    frags = [_fragment(rng, 7, 3) for _ in range(2)]
    tx = jimpala.make_impala_optimizer(cfg)
    jstep = jimpala.make_impala_sgd_step(jm, JM.categorical_logp,
                                         JM.categorical_entropy, tx, cfg)
    ttx = make_impala_optimizer(cfg)
    tstep = make_impala_sgd_step(tm, TM.categorical_logp,
                                 TM.categorical_entropy, ttx, cfg)
    js, ts = tx.init(p), ttx.init(dict(tm.named_parameters()))
    for frag in frags:
        p, js, jaux = jstep(p, js, frag)
        ts, taux = tstep(ts, {k: torch.from_numpy(v)
                              for k, v in frag.items()})
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    _assert_params(tm, p)


def test_rmsprop_matches_optax_where_eps_counts():
    """RMSProp against optax.chain(clip_by_global_norm, rmsprop(lr,
    decay=0.99)) over three updates of a leaf with gradients near 1e-5,
    where eps = 1e-8 inside the square root (optax) and outside
    (torch.optim.RMSprop) differ ~100-fold, and of a leaf with O(1)
    gradients that the clip scales; rtol 1e-6."""
    import optax
    from ray_tpu_torch.rl.impala import RMSProp
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal(6).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{"a": (1e-5 * rng.standard_normal(6)).astype(np.float32),
              "b": (3 * rng.standard_normal(4)).astype(np.float32)}
             for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(2.0),
                     optax.rmsprop(1e-3, decay=0.99))
    want = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(want)
    port = RMSProp(lambda count: 1e-3, decay=0.99, grad_clip=2.0)
    got = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = port.init(got)

    @jax.jit
    def step(params, state, g):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state
    for g in grads:
        want, state = step(want, state, g)
        pstate = port.update(got, {k: torch.from_numpy(v)
                                   for k, v in g.items()}, pstate)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("env", ["CartPole-v1", "Pendulum-v1"])
def test_policy_deterministic_actions_match_jax(env):
    """JaxPolicy.compute_actions(explore=False) on JAX's weights: the
    same actions (argmax, or the Gaussian mean at ATOL) and values."""
    jenv, tenv = ((JaxCartPole(), CartPoleEnv()) if env == "CartPole-v1"
                  else (JaxPendulum(), PendulumEnv()))
    with _numpy_init(JM, "ActorCritic", np.random.default_rng(7)):
        jpol = JaxJaxPolicy(jenv.observation_space, jenv.action_space,
                            hidden=HIDDEN, seed=7)
    tpol = JaxPolicy(tenv.observation_space, tenv.action_space,
                     hidden=HIDDEN, seed=7, device="cpu")
    tpol.set_weights({n: t.numpy() for n, t in params_from_jax(
        jpol.get_weights(), tpol.model).items()})
    obs = np.random.default_rng(7).standard_normal(
        (16,) + tenv.observation_space.shape).astype(np.float32)
    ja, _, jv = jpol.compute_actions(obs, explore=False)
    ta, tlogp, tv = tpol.compute_actions(obs, explore=False)
    if env == "CartPole-v1":
        np.testing.assert_array_equal(ta, ja)
        assert ta.dtype == ja.dtype
    else:
        np.testing.assert_allclose(ta, ja, atol=ATOL)
    np.testing.assert_allclose(tv, jv, atol=ATOL)
    np.testing.assert_array_equal(tlogp, 0.0)
    # exploring samples lie in the action space and carry their logp
    ta, tlogp, _ = tpol.compute_actions(obs)
    assert ta.shape[0] == 16 and np.isfinite(tlogp).all()


def test_json_round_trip_between_packages(tmp_path):
    """A dataset the port's collect_dataset writes reads back equal
    through JAX's JsonReader, and a batch JAX's JsonWriter writes reads
    back equal through the port's."""
    collect_dataset("CartPole-v1", str(tmp_path / "port"), n_steps=200,
                    seed=0)
    got = JsonReader(str(tmp_path / "port")).read_all()
    want = joffline.JsonReader(str(tmp_path / "port")).read_all()
    assert set(got) == set(want) and got.count == 200
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    batch = JaxSampleBatch({"obs": np.arange(12, dtype=np.float32)
                            .reshape(6, 2),
                            "actions": np.arange(6, dtype=np.int32),
                            "eps_id": np.array([0, 0, 0, 1, 1, 2])})
    w = joffline.JsonWriter(str(tmp_path / "jax"))
    w.write(batch)
    w.close()
    back = JsonReader(str(tmp_path / "jax")).read_all()
    for k in batch:
        np.testing.assert_array_equal(back[k], batch[k])
        assert back[k].dtype == batch[k].dtype
    assert [len(e) for e in back.split_by_episode()] == [3, 2, 1]
    JsonWriter(str(tmp_path / "w")).close()


@pytest.fixture(scope="module")
def offline_data(tmp_path_factory):
    """400 CartPole steps that the port's collect_dataset writes, read by
    the offline tests and the DT pair."""
    path = str(tmp_path_factory.mktemp("offline") / "data")
    collect_dataset("CartPole-v1", path, n_steps=400, seed=0)
    return path


@pytest.mark.parametrize("algo", ["MARWIL", "BC"])
def test_offline_step_matches_jax(offline_data, algo):
    """MARWIL (beta 1) and BC (beta 0) on one dataset: the Monte-Carlo
    value targets equal JAX's (the same numpy code); one update from
    JAX's weights on its first 64 rows with the advantage norm at 1, so
    that the exp-advantage weight is clamped at 20 for some rows and not
    for others: loss and aux at RTOL, parameters at ATOL; the dataset's
    new logp at ATOL; IS and WIS on JAX's new logp equal JAX's."""
    jcfg, tcfg = ((joffline.MARWILConfig, MARWILConfig) if algo == "MARWIL"
                  else (joffline.BCConfig, BCConfig))

    def cfg(cls):
        return (cls().environment("CartPole-v1")
                .offline_data(input_path=offline_data)
                .training(hidden=HIDDEN, lr=3e-3).debugging(seed=0))
    with _numpy_init(JM, "ActorCritic", np.random.default_rng(13)):
        jalg = cfg(jcfg).build()
    talg = cfg(tcfg).resources(device="cpu").build()
    for k in (SB.VALUE_TARGETS, SB.ADVANTAGES):
        np.testing.assert_array_equal(talg.dataset[k], jalg.dataset[k])
    talg.model.load_state_dict(params_from_jax(_unboxed(jalg.params),
                                               talg.model))
    batch = {k: np.asarray(jalg.dataset[k])[:64]
             for k in (SB.OBS, SB.ACTIONS, SB.VALUE_TARGETS)}
    with torch.no_grad():
        _, values = talg.model(torch.from_numpy(batch[SB.OBS]))
    adv = batch[SB.VALUE_TARGETS] - values.numpy()
    assert (adv > np.log(20)).any() and (adv < np.log(20)).any()
    p, _, jaux = jalg._sgd_step(jalg.params, jalg.opt_state,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                1.0)
    taux = talg._sgd_step({k: torch.from_numpy(v)
                           for k, v in batch.items()}, 1.0)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    _assert_params(talg.model, p)
    new_logp = np.asarray(jax.jit(lambda p, obs, acts: JM.categorical_logp(
        jalg.model.apply({"params": p}, obs)[0], acts))(
            p, jalg.dataset[SB.OBS], jalg.dataset[SB.ACTIONS]))
    np.testing.assert_allclose(talg._new_logp().numpy(), new_logp,
                               atol=ATOL)
    for weighted in (False, True):
        assert importance_sampling_estimate(
            talg.dataset, new_logp, 0.99, weighted) == \
            joffline.importance_sampling_estimate(
                jalg.dataset, new_logp, 0.99, weighted)


@pytest.fixture(scope="module")
def dt_pair(offline_data):
    """JAX's DT and the port's on the CPU at the JAX test's tiny widths
    (d_model 32, 2 layers, 2 heads, context 8), from one dataset that the
    port's collect_dataset writes, with the port holding JAX's initial
    weights."""
    path = offline_data
    # JAX's DT with its initial weights drawn from a numpy seed (flax's
    # init would compile the whole model first, ~3 s); the loss, the
    # update and the forward are JAX's
    def cfg(cls):
        return (cls().environment("CartPole-v1")
                .offline_data(input_path=path)
                .training(num_sgd_iter=1, train_batch_size=8, context_len=8,
                          d_model=32, n_layers=2, n_heads=2)
                .debugging(seed=0))
    with _numpy_init(jdt_mod, "_DTModel", np.random.default_rng(10)):
        jdt = cfg(JaxDTConfig).build()
    tdt = cfg(DTConfig).resources(device="cpu").build()
    tdt.model.load_state_dict(params_from_jax(_unboxed(jdt.params),
                                              tdt.model))
    return jdt, tdt


def test_dt_logits_match_jax(dt_pair):
    jdt, tdt = dt_pair
    rtg, obs, onehot, _, _ = tdt._sample_batch(4)
    want = jax.jit(jdt.model.apply)({"params": jdt.params}, rtg, obs,
                                    onehot)
    with torch.no_grad():
        got = tdt.model(*(torch.from_numpy(a) for a in (rtg, obs, onehot)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dt_sgd_step_matches_jax(dt_pair):
    """One update: the masked NLL, the accuracy and the parameters after
    optax.chain(clip_by_global_norm(1), adamw(lr, 1e-4)) with no mask.
    That decays every leaf, biases and norm scales too, by lr * 1e-4 * p
    per step: 1e-8 beside Adam's 1e-4, below what one step's parameters
    can show, so the mask is checked as the optimizer's own (AdamW with
    ``decay_all`` is held against optax's unmasked adamw in
    tests/test_torch_train.py)."""
    jdt, tdt = dt_pair
    arrays = tdt._sample_batch(8)
    p, s, jloss, jacc = jdt._sgd_step(jdt.params, jdt.opt_state,
                                      *(jnp.asarray(a) for a in arrays))
    tloss, tacc = tdt.sgd_step(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(tacc), float(jacc), rtol=RTOL)
    _assert_params(tdt.model, p)
    assert tdt.opt_state["count"] == 1
    decays = tdt.tx.mask(tdt.params)
    assert all(decays.values()) and "final_norm.scale" in decays
    assert tdt.tx.weight_decay == 1e-4


def test_head_dim_32_flash_matches_jax():
    """DT's attention shape cut to batch 1 and 2 heads (60 tokens, heads
    of 32, causal, fp32): the kernels' plain versions, which the CPU runs
    through flash_attention, against JAX's attention through its plain
    reference (``impl="xla"``; tests/test_torch_flash.py holds the plain
    versions against JAX's Pallas kernels in interpret mode at head_dim
    64 to 256, and nothing in them depends on the head_dim): forward atol
    2e-5, gradients of sum(o^2) atol 2e-4, the flash tests' tolerances;
    the kernels' head_dims include 32."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((1, 60, 2, 32)).astype(np.float32)
               for _ in range(3))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = attention(*ts, impl="flash")
    (o ** 2).sum().backward()

    def ref(*a):
        return jax_attention(*a, causal=True, impl="xla")
    want = jax.jit(ref)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: (ref(*a) ** 2).sum(),
                             (0, 1, 2)))(q, k, v)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-4)
    assert 32 in flash_mod._HEAD_DIMS


def test_registry_and_unported_paths():
    assert get_algorithm_class("PPO").__name__ == "PPO"
    algo, cfg = get_algorithm_class("impala", return_config=True)
    assert (algo.__name__, cfg.__name__) == ("Impala", "ImpalaConfig")
    for name in ("bc", "marwil", "dt"):
        get_algorithm_class(name)
    for name in ("appo", "dqn", "simpleq", "apexdqn", "r2d2"):
        get_algorithm_class(name)
    for name, cls in (("SAC", "SAC"), ("a3c", "A3C"), ("crr", "CRR")):
        assert get_algorithm_class(name).__name__ == cls
    for name, slice_ in (("maddpg", "MADDPG"), ("qmix", "MADDPG"),
                         ("dreamer", "model-based"),
                         ("alpha_zero", "search")):
        with pytest.raises(NotImplementedError, match=slice_):
            get_algorithm_class(name)
    with pytest.raises(ValueError, match="unknown"):
        get_algorithm_class("nope")
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        PPOConfig().resources(mesh_shape={"data": 2})
    assert ImpalaConfig().podracer(enabled=True).use_podracer


def test_ppo_on_the_port_runtime_with_save_and_restore():
    """Two PPO iterations on the port's runtime (one rollout worker, the
    learner on the CPU): results as JAX's Algorithm reports them, weights
    synced to the worker as numpy; save, other weights and moments,
    restore: the weights and Adam's moments equal the saved ones bit for
    bit, and the worker holds the restored weights."""
    import ray_tpu_torch as rt
    rt.init(num_cpus=2)
    algo = None
    try:
        algo = (PPOConfig().environment("CartPole-v1")
                .rollouts(num_rollout_workers=1, num_envs_per_worker=2,
                          rollout_fragment_length=32)
                .training(train_batch_size=64, sgd_minibatch_size=32,
                          num_sgd_iter=2, hidden=(32, 32))
                .resources(device="cpu").debugging(seed=0).build())
        for it in (1, 2):
            r = algo.train()
            assert r["training_iteration"] == it
            assert r["timesteps_total"] == 64 * it
            assert r["info"]["num_sgd_updates"] == 4
            assert np.isfinite(r["info"]["total_loss"])
        remote = rt.get(algo.workers.workers[0].get_weights.remote())
        local = algo.get_weights()
        assert all(isinstance(v, np.ndarray) for v in remote.values())
        for n in local:
            np.testing.assert_array_equal(remote[n], local[n])
        ckpt = algo.save()
        saved = algo.get_full_state()
        algo.set_weights({n: v + 1 for n, v in local.items()})
        algo.opt_state["mu"]["pi_0.weight"].add_(1.0)
        algo.restore(ckpt)
        back = algo.get_full_state()
        assert algo.iteration == 2 and back["opt_state"]["count"] == 8
        for part in ("params", "opt_state"):
            flat = jax.tree_util.tree_leaves_with_path(saved[part])
            got = dict(jax.tree_util.tree_leaves_with_path(back[part]))
            for path, leaf in flat:
                np.testing.assert_array_equal(got[path], leaf)
        remote = rt.get(algo.workers.workers[0].get_weights.remote())
        for n in local:
            np.testing.assert_array_equal(remote[n], local[n])
    finally:
        if algo is not None:
            algo.stop()
        rt.shutdown()
