"""Policy and value networks as ``nn.Module``s (counterpart of
ray_tpu/rl/models.py).

The JAX package's flax modules infer their input width at ``init``; a
torch module takes it at construction, so every network here takes
``obs_dim`` (and ``act_dim`` where the JAX module concatenates actions)
first.  Submodules carry the flax names (``pi_0``, ``vf_out``,
``q1.q_0``, ``OptimizedLSTMCell_0.ii``), so a state-dict name is the
flax path with ``.weight`` for ``/kernel`` (``models/convert.py``
``params_from_jax``).  ``init_params`` draws the flax initialisers:
lecun-normal kernels, zero biases and ``pi_log_std``, orthogonal
recurrent kernels.

The distribution functions take an explicit ``torch.Generator`` where
the JAX ones take a PRNG key; the streams differ, so samples agree with
JAX's only in distribution, while logp and entropy agree numerically.
The networks are small MLPs whose products the JAX package leaves to
XLA outside any Pallas kernel, so they stay ``torch`` matmuls here.
"""

from __future__ import annotations

import copy
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device

_LOG_2PI = math.log(2 * math.pi)


def _tower(module: nn.Module, prefix: str, dims: Sequence[int]) -> None:
    """Hidden layers ``{prefix}_{i}`` of widths dims[1:] from dims[0]."""
    for i in range(len(dims) - 1):
        setattr(module, f"{prefix}_{i}", nn.Linear(dims[i], dims[i + 1]))


def _run(module: nn.Module, prefix: str, n: int, x, act) -> torch.Tensor:
    for i in range(n):
        x = act(getattr(module, f"{prefix}_{i}")(x))
    return x


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights in place with flax's default initialisers, drawn on
    the CPU from ``seed`` (so a model on the card and its CPU copy start
    equal): lecun-normal kernels (``models/convert.py`` ``init_weights``),
    zero biases, ones for norm scales, zeros for ``pi_log_std``, and
    orthogonal recurrent kernels (the LSTM's ``h*`` kernels).  Returns
    ``model``."""
    from ray_tpu_torch.models.convert import init_weights
    on_cpu = next(model.parameters()).device.type == "cpu"
    src = model if on_cpu else copy.deepcopy(model).cpu()
    gen = torch.Generator().manual_seed(seed)
    init_weights(src, gen)
    for n, p in src.named_parameters():
        if n.endswith("pi_log_std"):
            p.zero_()
        elif "LSTMCell" in n and n.split(".")[-2][0] == "h" \
                and n.endswith(".weight"):
            nn.init.orthogonal_(p, generator=gen)
    if not on_cpu:
        model.load_state_dict(src.state_dict())
    return model


class ActorCritic(nn.Module):
    """Shared-nothing actor and critic MLP towers (tanh), as RLlib's
    default ``vf_share_layers=False``.  ``forward`` returns (logits,
    value): discrete logits [..., act_dim], or for continuous actions
    [mean, log_std] [..., 2 act_dim] with a state-independent
    ``pi_log_std``."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 continuous: bool = False, *, device=None):
        super().__init__()
        self.hidden, self.continuous = tuple(hidden), continuous
        dims = (obs_dim,) + self.hidden
        _tower(self, "pi", dims)
        if continuous:
            self.pi_mean = nn.Linear(dims[-1], action_dim)
            self.pi_log_std = nn.Parameter(torch.zeros(action_dim))
        else:
            self.pi_out = nn.Linear(dims[-1], action_dim)
        _tower(self, "vf", dims)
        self.vf_out = nn.Linear(dims[-1], 1)
        self.to(resolve_device(device))

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        n = len(self.hidden)
        x = _run(self, "pi", n, obs, torch.tanh)
        if self.continuous:
            mean = self.pi_mean(x)
            logits = torch.cat([mean, self.pi_log_std.expand_as(mean)], -1)
        else:
            logits = self.pi_out(x)
        v = _run(self, "vf", n, obs, torch.tanh)
        return logits, self.vf_out(v)[..., 0]


def categorical_sample(gen: torch.Generator, logits) -> torch.Tensor:
    """One action per row by the Gumbel-max rule (as
    ``jax.random.categorical``); ``gen`` lives on the logits' device."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=logits.dtype)
    tiny = torch.finfo(logits.dtype).tiny
    return torch.argmax(logits - torch.log(-torch.log(u.clamp_min(tiny))),
                        dim=-1)


def categorical_logp(logits, actions) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return logp.gather(-1, actions.long()[..., None])[..., 0]


def categorical_entropy(logits) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(-1)


def diag_gaussian_sample(gen: torch.Generator, logits) -> torch.Tensor:
    mean, log_std = logits.chunk(2, dim=-1)
    noise = torch.randn(mean.shape, generator=gen, device=mean.device,
                        dtype=mean.dtype)
    return mean + noise * log_std.exp()


def diag_gaussian_logp(logits, actions) -> torch.Tensor:
    mean, log_std = logits.chunk(2, dim=-1)
    var = torch.exp(2 * log_std)
    logp = -0.5 * ((actions - mean).square() / var + 2 * log_std + _LOG_2PI)
    return logp.sum(-1)


def diag_gaussian_entropy(logits) -> torch.Tensor:
    _, log_std = logits.chunk(2, dim=-1)
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)


class QNetwork(nn.Module):
    """MLP state-action values (relu) for the DQN family; dueling heads
    Q = V + A - mean(A) when ``dueling``."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256), dueling: bool = True,
                 *, device=None):
        super().__init__()
        self.hidden, self.dueling = tuple(hidden), dueling
        dims = (obs_dim,) + self.hidden
        _tower(self, "q", dims)
        self.q_out = nn.Linear(dims[-1], action_dim)
        if dueling:
            self.v_out = nn.Linear(dims[-1], 1)
        self.to(resolve_device(device))

    def forward(self, obs) -> torch.Tensor:
        x = _run(self, "q", len(self.hidden), obs, F.relu)
        adv = self.q_out(x)
        if not self.dueling:
            return adv
        return self.v_out(x) + adv - adv.mean(-1, keepdim=True)


class _LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``: input kernels ``i{i,f,g,o}`` without
    bias, hidden kernels ``h{i,f,g,o}`` with bias; carry (c, h)."""

    def __init__(self, d_in: int, size: int):
        super().__init__()
        for gate in "ifgo":
            self.add_module(f"i{gate}", nn.Linear(d_in, size, bias=False))
            self.add_module(f"h{gate}", nn.Linear(size, size))

    def forward(self, carry, x):
        c, h = carry
        pre = {g: getattr(self, f"i{g}")(x) + getattr(self, f"h{g}")(h)
               for g in "ifgo"}
        c = torch.sigmoid(pre["f"]) * c + torch.sigmoid(pre["i"]) * \
            torch.tanh(pre["g"])
        h = torch.sigmoid(pre["o"]) * torch.tanh(c)
        return (c, h), h


class RecurrentQNetwork(nn.Module):
    """LSTM Q-network for R2D2: obs -> relu MLP -> LSTM -> Q values.
    ``forward(obs_seq [B, T, obs], carry)`` returns (q [B, T, act],
    carry); ``initial_state(batch)`` is the zero carry (c, h).  The JAX
    module builds its ``OptimizedLSTMCell`` in its own compact scope and
    hands it to ``nn.RNN(..., name="lstm")``, so flax binds the cell to
    the network as ``OptimizedLSTMCell_0`` and the RNN wrapper holds no
    parameters: the tree is ``OptimizedLSTMCell_0/{ii,...,ho}``."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64,), lstm_size: int = 64, *,
                 device=None):
        super().__init__()
        self.hidden, self.lstm_size = tuple(hidden), lstm_size
        dims = (obs_dim,) + self.hidden
        _tower(self, "fc", dims)
        self.OptimizedLSTMCell_0 = _LSTMCell(dims[-1], lstm_size)
        self.q_out = nn.Linear(lstm_size, action_dim)
        self.to(resolve_device(device))

    def forward(self, obs_seq, carry):
        x = _run(self, "fc", len(self.hidden), obs_seq, F.relu)
        outs = []
        for t in range(x.shape[1]):
            carry, h = self.OptimizedLSTMCell_0(carry, x[:, t])
            outs.append(h)
        return self.q_out(torch.stack(outs, 1)), carry

    def initial_state(self, batch_size: int):
        dev = self.q_out.weight.device
        z = torch.zeros(batch_size, self.lstm_size, device=dev)
        return z, z.clone()


class SquashedGaussianActor(nn.Module):
    """SAC actor: (mean, log_std clipped to [min, max]) of a
    tanh-squashed diagonal Gaussian."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 log_std_min: float = -20.0, log_std_max: float = 2.0, *,
                 device=None):
        super().__init__()
        self.hidden = tuple(hidden)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        dims = (obs_dim,) + self.hidden
        _tower(self, "pi", dims)
        self.pi_mean = nn.Linear(dims[-1], action_dim)
        self.pi_log_std = nn.Linear(dims[-1], action_dim)
        self.to(resolve_device(device))

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _run(self, "pi", len(self.hidden), obs, F.relu)
        log_std = self.pi_log_std(x).clamp(self.log_std_min,
                                           self.log_std_max)
        return self.pi_mean(x), log_std


def squashed_sample_logp(gen: torch.Generator, mean, log_std):
    """A reparameterised tanh-Gaussian sample and its log-prob."""
    eps = torch.randn(mean.shape, generator=gen, device=mean.device,
                      dtype=mean.dtype)
    return squash(mean, log_std, eps)


def squash(mean, log_std, eps):
    """``squashed_sample_logp`` at a given standard-normal ``eps``: the
    learners draw their noise ahead of an update and pass it in."""
    pre = mean + log_std.exp() * eps
    logp = (-0.5 * eps.square() - log_std - 0.5 * _LOG_2PI).sum(-1)
    # tanh change of variables (numerically stable form)
    logp = logp - (2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))
                   ).sum(-1)
    return torch.tanh(pre), logp


class DeterministicActor(nn.Module):
    """DDPG/TD3 actor: relu MLP -> tanh, in [-1, 1]^action_dim."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256), *, device=None):
        super().__init__()
        self.hidden = tuple(hidden)
        dims = (obs_dim,) + self.hidden
        _tower(self, "pi", dims)
        self.pi_out = nn.Linear(dims[-1], action_dim)
        self.to(resolve_device(device))

    def forward(self, obs) -> torch.Tensor:
        x = _run(self, "pi", len(self.hidden), obs, F.relu)
        return torch.tanh(self.pi_out(x))


class ContinuousQ(nn.Module):
    """Q(s, a) tower over [obs, act] (relu)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (256, 256), *, device=None):
        super().__init__()
        self.hidden = tuple(hidden)
        dims = (obs_dim + act_dim,) + self.hidden
        _tower(self, "q", dims)
        self.q_out = nn.Linear(dims[-1], 1)
        self.to(resolve_device(device))

    def forward(self, obs, act) -> torch.Tensor:
        x = _run(self, "q", len(self.hidden), torch.cat([obs, act], -1),
                 F.relu)
        return self.q_out(x)[..., 0]


class TwinQ(nn.Module):
    """SAC's and TD3's twin critics ``q1`` and ``q2``."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (256, 256), *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.q1 = ContinuousQ(obs_dim, act_dim, hidden, device=device)
        self.q2 = ContinuousQ(obs_dim, act_dim, hidden, device=device)

    def forward(self, obs, act):
        return self.q1(obs, act), self.q2(obs, act)
