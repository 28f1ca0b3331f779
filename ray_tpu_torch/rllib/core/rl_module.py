"""RLModule: the model abstraction of RLlib's new stack, as nn.Modules.

Port of `ray_tpu/rllib/core/rl_module.py`. There a module is a pure Flax
network whose params live with the Learner and travel to env runners as
numpy trees; here a module is an ``nn.Module`` that holds its own
parameters, and weights travel as flat ``{name: numpy array}`` dicts
(`get_weights` / `set_weights`, which copy into the live tensors, so a
captured update keeps reading the same storage).

The three forward passes keep their names and outputs:
`forward_inference(obs)` (greedy), `forward_exploration(obs, generator)`
(sampling) and `forward_train(batch)` (differentiable, used in losses).
Random draws come from the ``torch.Generator`` the caller passes: the JAX
module splits a PRNG key per call, and its DQN draws the explore coin and
the random action from one key; here both come, one after the other, from
the generator.

Networks mirror the Flax ones: `ActorCriticModule` keeps two separate tanh
torsos, one under the policy logits and one under the value head; Dense
layers initialise as Flax's default (LeCun normal, truncated at two
standard deviations; zero bias) from a generator seeded by `build(seed)`.
`models.convert.rl_module_params_from_jax` carries Flax weights across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Columns = type("Columns", (), {
    "OBS": "obs", "ACTIONS": "actions", "REWARDS": "rewards",
    "TERMINATEDS": "terminateds", "TRUNCATEDS": "truncateds",
    "NEXT_OBS": "next_obs", "ACTION_LOGP": "action_logp",
    "VF_PREDS": "vf_preds", "ADVANTAGES": "advantages",
    "VALUE_TARGETS": "value_targets", "ACTION_DIST_INPUTS":
    "action_dist_inputs",
})


@dataclasses.dataclass
class RLModuleSpec:
    """Reference: `rllib/core/rl_module/rl_module.py` RLModuleSpec."""

    observation_dim: int
    action_dim: int
    hidden: Tuple[int, ...] = (64, 64)
    discrete: bool = True
    # continuous (Box) action spaces: per-dim affine tanh squashing —
    # action = tanh(u) * action_scale + action_offset (SAC-family modules)
    action_scale: Any = 1.0
    action_offset: Any = 0.0
    module_class: Optional[type] = None

    def build(self, seed: int = 0) -> "RLModule":
        """The module, its weights drawn from a generator seeded by
        `seed` (on the CPU; `.to(device)` moves it)."""
        cls = self.module_class or ActorCriticModule
        module = cls(self)
        module.init_params(torch.Generator().manual_seed(seed))
        return module


def _linear(n_in: int, n_out: int) -> nn.Linear:
    # no default init (it would draw from torch's global generator);
    # `init_params` fills every layer
    return torch.nn.utils.skip_init(nn.Linear, n_in, n_out)


def _dense(layer: nn.Linear, x: torch.Tensor, frozen: bool) -> torch.Tensor:
    """`layer(x)`; with `frozen`, through detached weights (Flax's
    `stop_gradient` on a param subtree): gradients still reach `x`."""
    if frozen:
        return F.linear(x, layer.weight.detach(), layer.bias.detach())
    return layer(x)


class _MLP(nn.Module):
    """Dense + tanh torso (Flax `_MLPTorso`) and linear heads."""

    def __init__(self, n_in: int, hidden: Sequence[int],
                 heads: Sequence[int]):
        super().__init__()
        dims = (n_in, *hidden)
        self.torso = nn.ModuleList(
            _linear(a, b) for a, b in zip(dims, dims[1:]))
        self.heads = nn.ModuleList(_linear(dims[-1], n) for n in heads)

    def forward(self, x: torch.Tensor, frozen: bool = False):
        for layer in self.torso:
            x = torch.tanh(_dense(layer, x, frozen))
        return tuple(_dense(h, x, frozen) for h in self.heads)


class RLModule(nn.Module):
    """Base: an nn.Module with the three RLlib forward passes."""

    def __init__(self, spec: RLModuleSpec):
        super().__init__()
        self.spec = spec

    def init_params(self, generator: torch.Generator) -> None:
        """Flax's Dense init in registration order: kernels LeCun normal
        truncated at 2 sigma, biases zero; scalar params zero."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    std = (1.0 / mod.in_features) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std,
                                          b=2 * std, generator=generator)
                    mod.bias.zero_()
            for p in self.parameters(recurse=False):
                p.zero_()

    def forward_inference(self, obs: torch.Tensor) -> Dict:
        """Deterministic action computation (greedy)."""
        raise NotImplementedError

    def forward_exploration(self, obs: torch.Tensor,
                            generator: Optional[torch.Generator] = None
                            ) -> Dict:
        """Stochastic sampling for rollout collection."""
        raise NotImplementedError

    def forward_train(self, batch: Mapping) -> Dict:
        """Differentiable pass used inside the learner's loss."""
        raise NotImplementedError

    # -- weights ------------------------------------------------------------

    def get_weights(self) -> Dict[str, np.ndarray]:
        return params_to_numpy(self)

    def set_weights(self, weights: Mapping[str, Any]) -> None:
        """Copy `weights` (numpy arrays or tensors by parameter name) into
        the live parameters, in place."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(as_tensor(weights[name]))


def as_tensor(value) -> torch.Tensor:
    """A tensor as it is; a numpy array (or anything numpy takes) as a
    tensor copy (the array may be read-only)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.tensor(np.asarray(value))


def params_to_numpy(module: nn.Module) -> Dict[str, np.ndarray]:
    """A module's parameters as ``{name: numpy array}`` (host copies)."""
    return {name: p.detach().cpu().numpy().copy()
            for name, p in module.named_parameters()}


def _gumbel_argmax(logits: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """A categorical draw by the Gumbel-max trick (the method of
    `jax.random.categorical`)."""
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device)
    u = u.clamp_min(torch.finfo(logits.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class ActorCriticModule(RLModule):
    """Discrete-action actor-critic (the default PPO module): policy
    logits and the value each on their own tanh torso."""

    def __init__(self, spec: RLModuleSpec):
        super().__init__(spec)
        self.pi = _MLP(spec.observation_dim, spec.hidden, (spec.action_dim,))
        self.vf = _MLP(spec.observation_dim, spec.hidden, (1,))

    def forward(self, obs: torch.Tensor):
        (logits,) = self.pi(obs)
        (value,) = self.vf(obs)
        return logits, value.squeeze(-1)

    @torch.no_grad()
    def forward_inference(self, obs):
        logits, value = self(obs)
        return {"actions": torch.argmax(logits, dim=-1),
                Columns.ACTION_DIST_INPUTS: logits,
                Columns.VF_PREDS: value}

    @torch.no_grad()
    def forward_exploration(self, obs, generator=None):
        logits, value = self(obs)
        actions = _gumbel_argmax(logits, generator)
        logp = torch.log_softmax(logits, -1).gather(
            -1, actions[:, None])[:, 0]
        return {"actions": actions, Columns.ACTION_LOGP: logp,
                Columns.ACTION_DIST_INPUTS: logits,
                Columns.VF_PREDS: value}

    def forward_train(self, batch):
        logits, value = self(batch[Columns.OBS])
        return {Columns.ACTION_DIST_INPUTS: logits,
                Columns.VF_PREDS: value}


class QModule(RLModule):
    """Q-network module for DQN."""

    def __init__(self, spec: RLModuleSpec):
        super().__init__(spec)
        self.q = _MLP(spec.observation_dim, spec.hidden, (spec.action_dim,))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.q(obs)[0]

    @torch.no_grad()
    def forward_inference(self, obs):
        q = self(obs)
        return {"actions": torch.argmax(q, dim=-1), "q_values": q}

    @torch.no_grad()
    def forward_exploration(self, obs, generator=None, epsilon: float = 0.1):
        q = self(obs)
        greedy = torch.argmax(q, dim=-1)
        random_a = torch.randint(0, self.spec.action_dim, greedy.shape,
                                 generator=generator, device=q.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=q.device) < epsilon
        return {"actions": torch.where(explore, random_a, greedy),
                "q_values": q}

    def forward_train(self, batch):
        return {"q_values": self(batch[Columns.OBS])}
