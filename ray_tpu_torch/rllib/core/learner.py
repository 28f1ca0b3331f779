"""Learner: gradient-based update of one RLModule, in PyTorch.

Port of `ray_tpu/rllib/core/learner.py`. Reference:
`rllib/core/learner/learner.py:107` — `compute_gradients` /
`apply_gradients` / `update_from_batch` (:456, :586, :1074).

The update is one `compiled_step` (`parallel.compile_cache`), the
counterpart of the JAX learner's `jax.jit(self._update)`: on the card the
forward, the backward (`torch.autograd.grad`) and the optimizer step are
one CUDA graph per batch signature (a new batch shape captures a new
graph, as a new shape retraces a jit); on the CPU the same function runs
eagerly. The module's parameters, the optimizer's moments and the target
networks are updated in place, so every graph keeps reading them where it
captured them; `set_weights` / `set_state` copy into the same storage.
Losses are plain functions of the batch's tensors and the learner's
modules. ``config["compiled_update"] = False`` runs every update eagerly
(the yardstick a graphed update is held to on the card).

The optimizer is the JAX learner's `optax.chain(clip_by_global_norm(clip),
adam(lr))`, written to optax's formulas: the global norm is the square
root of the summed squares (no epsilon, unlike `clip_grad_norm_`), a
gradient is scaled by ``clip / norm`` only when ``norm >= clip``; Adam's
moments are bias-corrected by the step count and its epsilon (1e-8) is
added outside the square root.

``num_devices > 1`` keeps the JAX batch semantics of a learner that
shards its batch over a `dp` mesh: the rows are trimmed to a multiple of
n (tiled up to n when there are fewer), and `BROADCAST_KEYS` entries are
replicated, not split. The update runs on the learner's one device: a
learner spans cards the torch way, one learner actor per card
(`LearnerGroup(num_learners=...)`).

A batch arrives as numpy arrays; host tensors go to the graph through its
pinned staging buffers. Float64 columns become float32 (JAX's default).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel.compile_cache import ExecutableCache, compiled_step
from ray_tpu_torch.rllib.core.rl_module import (
    Columns,
    RLModule,
    RLModuleSpec,
    as_tensor,
    params_to_numpy,
)
from ray_tpu_torch.rllib.utils.actor_manager import set_actor_threads

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _host_tensor(v) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a)


def _floats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A dict of 0-d tensors as Python floats, with one device sync."""
    values = torch.stack([v.detach().float().reshape(())
                          for v in stats.values()]).tolist()
    return dict(zip(stats, values))


def _copy_into(tensors: List[torch.Tensor], sources) -> None:
    """Copy tensors or numpy arrays into live tensors, in place."""
    with torch.no_grad():
        for t, s in zip(tensors, sources):
            t.copy_(as_tensor(s))


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """`x[..., index]` per row: the entry of the last axis that `index`
    picks (an action's log-prob or Q-value)."""
    return x.gather(-1, index.long()[..., None])[..., 0]


class Learner:
    """Owns the module and the optimizer state; subclasses define
    `compute_loss(batch) -> (loss, stats)`.

    ``BROADCAST_KEYS`` names batch entries that are NOT row columns (the
    words that seed SAC's and CQL's noise): they replicate to every
    learner instead of being split by rows. The JAX learner names only
    ``rng``, so there CQL's two ``cql_rng`` words count as rows and cut a
    split or trimmed batch to them (F18); the port names both.
    """

    BROADCAST_KEYS = frozenset({"rng", "cql_rng"})

    def __init__(self, spec: RLModuleSpec,
                 config: Optional[Dict[str, Any]] = None, seed: int = 0,
                 num_devices: int = 1, device=None,
                 num_threads: Optional[int] = None):
        set_actor_threads(num_threads)
        self.spec = spec
        self.config = dict(config or {})
        self.device = resolve_device(device)
        self.num_devices = num_devices
        self.module: RLModule = spec.build(seed).to(self.device)
        self._names = [n for n, _ in self.module.named_parameters()]
        self._params = [p for _, p in self.module.named_parameters()]
        self.lr = self.config.get("lr", 3e-4)
        self.grad_clip = self.config.get("grad_clip", 0.5)
        # optax.adam's state: the step count and both moments
        self._count = torch.zeros((), dtype=torch.int32, device=self.device)
        self._mu = [torch.zeros_like(p) for p in self._params]
        self._nu = [torch.zeros_like(p) for p in self._params]
        self.compiled = bool(self.config.get("compiled_update", True))
        self.cache = ExecutableCache()
        if self.compiled:
            wrap = lambda fn: compiled_step(  # noqa: E731
                fn, cache=self.cache, device=self.device)
        else:
            wrap = lambda fn: fn  # noqa: E731
        self._update_step = wrap(self._update)
        self._gradients_step = wrap(self._gradients)
        self._apply_step = wrap(self._apply_gradients)

    # -- batches -------------------------------------------------------------

    def _dp_rows(self, batch: Dict[str, np.ndarray]) -> Dict:
        """The JAX learner's `_device_batch` over a `dp` mesh of
        `num_devices`: rows trimmed to a divisible count, or tiled up to
        one per device; broadcast entries whole."""
        n = self.num_devices
        bcast = {k: v for k, v in batch.items() if k in self.BROADCAST_KEYS}
        rows_batch = {k: v for k, v in batch.items() if k not in bcast}
        rows = min(v.shape[0] for v in rows_batch.values())
        keep = (rows // n) * n
        if keep == 0:
            # fewer rows than devices: tile up to one row per device
            # rather than producing an empty (NaN-gradient) batch
            reps = -(-n // rows)
            out = {k: np.concatenate([np.asarray(v[:rows])] * reps)[:n]
                   for k, v in rows_batch.items()}
        else:
            out = {k: np.asarray(v[:keep]) for k, v in rows_batch.items()}
        out.update(bcast)
        return out

    def _noise(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Noise the loss reads as inputs, drawn on the host from the
        batch's `BROADCAST_KEYS` words (SAC, CQL); none here."""
        return {}

    def _batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The update's inputs: rows as `num_devices` gives them, the noise
        drawn, every entry a tensor (on the learner's device unless a
        graph copies it there)."""
        batch = dict(batch)
        if self.num_devices > 1:
            batch = self._dp_rows(batch)
        batch.update(self._noise(batch))
        out = {k: _host_tensor(v) for k, v in batch.items()
               if k not in self.BROADCAST_KEYS}
        if not self.compiled:
            out = {k: v.to(self.device) for k, v in out.items()}
        return out

    # -- to be provided by algorithm-specific subclasses -------------------

    def compute_loss(self, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    # -- update machinery --------------------------------------------------

    def _grads(self, batch):
        loss, stats = self.compute_loss(batch)
        grads = torch.autograd.grad(loss, self._params, allow_unused=True,
                                    materialize_grads=True)
        stats["total_loss"] = loss
        return grads, stats

    @torch.no_grad()
    def _optimizer_step(self, grads) -> torch.Tensor:
        """clip_by_global_norm(grad_clip) then adam(lr), in place; returns
        the gradients' global norm before clipping."""
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        clip = self.grad_clip
        self._count.add_(1)
        bc1 = 1 - ADAM_B1 ** self._count
        bc2 = 1 - ADAM_B2 ** self._count
        for p, g, mu, nu in zip(self._params, grads, self._mu, self._nu):
            g = torch.where(norm < clip, g, g / norm * clip)
            mu.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
            p.sub_(self.lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
        return norm

    def _update(self, batch):
        grads, stats = self._grads(batch)
        stats["grad_norm"] = self._optimizer_step(grads)
        return {k: v.detach() for k, v in stats.items()}

    def _gradients(self, batch):
        grads, stats = self._grads(batch)
        return grads, {k: v.detach() for k, v in stats.items()}

    def _apply_gradients(self, grads) -> None:
        self._optimizer_step(grads)

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        stats = _floats(self._update_step(self._batch(batch)))
        self._after_update()
        return stats

    def compute_gradients(self, batch: Dict[str, np.ndarray]):
        """Grads without applying (LearnerGroup DP averaging path)."""
        grads, stats = self._gradients_step(self._batch(batch))
        return ({n: g.cpu().numpy() for n, g in zip(self._names, grads)},
                _floats(stats))

    def apply_gradients(self, grads) -> None:
        grads = [_host_tensor(grads[n]) for n in self._names]
        if not self.compiled:
            grads = [g.to(self.device) for g in grads]
        self._apply_step(grads)
        self._after_update()

    def _after_update(self) -> None:
        """Post-optimizer-step hook (DQN target sync); runs on every
        update path — local `update_from_batch` AND the LearnerGroup
        grad-averaging `apply_gradients` path."""

    def ping(self) -> bool:
        return True

    # -- weights -----------------------------------------------------------

    def get_weights(self) -> Dict[str, np.ndarray]:
        return params_to_numpy(self.module)

    def set_weights(self, weights) -> None:
        self.module.set_weights(weights)

    def get_state(self) -> Dict[str, Any]:
        """Full learner state: weights AND optimizer moments — a restore
        that drops Adam state silently resets the optimizer (reference
        `Learner.get_state` also carries optimizer state)."""
        return {"weights": self.get_weights(), "opt_state": {
            "count": int(self._count),
            "mu": {n: m.cpu().numpy().copy()
                   for n, m in zip(self._names, self._mu)},
            "nu": {n: v.cpu().numpy().copy()
                   for n, v in zip(self._names, self._nu)},
        }}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["weights"])
        if "opt_state" in state:
            opt = state["opt_state"]
            self._count.fill_(int(opt["count"]))
            _copy_into(self._mu, [opt["mu"][n] for n in self._names])
            _copy_into(self._nu, [opt["nu"][n] for n in self._names])


class PPOLearner(Learner):
    """Clipped-surrogate PPO loss (reference `rllib/algorithms/ppo/
    torch/ppo_torch_learner.py`)."""

    def compute_loss(self, batch):
        out = self.module.forward_train(batch)
        logits = out[Columns.ACTION_DIST_INPUTS]
        values = out[Columns.VF_PREDS]
        logp_all = torch.log_softmax(logits, -1)
        logp = _take(logp_all, batch[Columns.ACTIONS])
        ratio = torch.exp(logp - batch[Columns.ACTION_LOGP])
        adv = batch[Columns.ADVANTAGES]
        clip_eps = self.config.get("clip_param", 0.2)
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv)
        policy_loss = -surrogate.mean()
        vf_loss = ((values - batch[Columns.VALUE_TARGETS]) ** 2).mean()
        probs = torch.softmax(logits, -1)
        entropy = -(probs * logp_all).sum(-1).mean()
        vf_coeff = self.config.get("vf_loss_coeff", 0.5)
        ent_coeff = self.config.get("entropy_coeff", 0.0)
        loss = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return loss, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                      "entropy": entropy,
                      "mean_kl": (batch[Columns.ACTION_LOGP] - logp).mean()}


class DQNLearner(Learner):
    """Double-DQN loss with a target network (reference
    `rllib/algorithms/dqn/torch/dqn_torch_learner.py`). The target network
    is a copy of the module, synced in place every `target_update_freq`
    updates."""

    def __init__(self, spec: RLModuleSpec,
                 config: Optional[Dict[str, Any]] = None, seed: int = 0,
                 num_devices: int = 1, device=None,
                 num_threads: Optional[int] = None):
        super().__init__(spec, config, seed, num_devices, device,
                         num_threads)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._steps = 0
        self.target_update_freq = self.config.get("target_update_freq", 100)

    def _td(self, batch):
        q = self.module.forward_train(batch)["q_values"]
        q_taken = _take(q, batch[Columns.ACTIONS])
        with torch.no_grad():
            # double-DQN: online net picks argmax, target net evaluates
            next_obs = {Columns.OBS: batch[Columns.NEXT_OBS]}
            next_a = torch.argmax(
                self.module.forward_train(next_obs)["q_values"], -1)
            q_next = _take(self.target.forward_train(next_obs)["q_values"],
                              next_a)
        gamma = self.config.get("gamma", 0.99)
        not_done = 1.0 - batch[Columns.TERMINATEDS].float()
        target = batch[Columns.REWARDS] + gamma * not_done * q_next
        return q_taken, q_taken - target

    def compute_loss(self, batch):
        q_taken, td = self._td(batch)
        if "weights" in batch:  # prioritized replay IS weights
            loss = (batch["weights"] * td ** 2).mean()
        else:
            loss = (td ** 2).mean()
        return loss, {"td_error_mean": td.abs().mean(),
                      "q_mean": q_taken.mean()}

    def _after_update(self) -> None:
        self._steps += 1
        if self._steps % self.target_update_freq == 0:
            _copy_into(list(self.target.parameters()), self._params)

    def get_state(self):
        state = super().get_state()
        state["target_params"] = params_to_numpy(self.target)
        state["steps"] = self._steps
        return state

    def set_state(self, state) -> None:
        super().set_state(state)
        if "target_params" in state:
            self.target.set_weights(state["target_params"])
            self._steps = state.get("steps", self._steps)

    @torch.no_grad()
    def td_errors(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """|TD| per transition (for prioritized-replay updates)."""
        b = {k: _host_tensor(v).to(self.device) for k, v in batch.items()}
        return self._td(b)[1].abs().cpu().numpy()


def vtrace_returns(behavior_logp, target_logp, rewards, values,
                   bootstrap_value, mask, gamma: float,
                   rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace targets (Espeholt et al. 2018; reference:
    `rllib/algorithms/impala/vtrace_tf.py`) over [B, T] row-major
    trajectories with a validity mask.

    Returns (vs, pg_advantages), both [B, T]. The JAX function's reversed
    `lax.scan` is a loop over T here: unrolled into the update's graph,
    with no host sync.
    """
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_clip) * mask
    c = torch.clamp(ratio, max=c_clip) * mask
    # V(x_{t+1}): shifted values, with the bootstrap placed at each
    # row's LAST VALID step — rows shorter than T must not bootstrap
    # from the network's value of zero-padding
    T = values.shape[1]
    is_last = (torch.arange(T, device=values.device)[None, :]
               == (mask.sum(dim=1, keepdim=True) - 1))
    zero = torch.zeros_like(values[:, :1])
    next_values = torch.where(is_last, bootstrap_value[:, None],
                              torch.cat([values[:, 1:], zero], dim=1))
    # padded steps contribute no TD (mask zeroes delta AND c, so the
    # reversed accumulator stays 0 until the valid region)
    deltas = rho * (rewards + gamma * next_values - values) * mask
    acc = torch.zeros_like(values[:, 0])
    corrections = []
    for t in range(T - 1, -1, -1):
        acc = deltas[:, t] + gamma * c[:, t] * acc
        corrections.append(acc)
    vs = values + torch.stack(corrections[::-1], dim=1)  # vs_t - V_t
    next_vs = torch.where(is_last, bootstrap_value[:, None],
                          torch.cat([vs[:, 1:], zero], dim=1))
    pg_adv = rho * (rewards + gamma * next_vs - values) * mask
    return vs, pg_adv


class IMPALALearner(Learner):
    """IMPALA's off-policy actor-critic loss with V-trace corrections
    (reference: `rllib/algorithms/impala/` torch/tf policies). The
    behavior policy's log-probs come from the (possibly stale) sampling
    weights; importance ratios correct the lag."""

    def compute_loss(self, batch):
        mask = batch["mask"]
        B, T = mask.shape
        obs_flat = batch[Columns.OBS].reshape(B * T, -1)
        out = self.module.forward_train({Columns.OBS: obs_flat})
        logits = out[Columns.ACTION_DIST_INPUTS].reshape(B, T, -1)
        values = out[Columns.VF_PREDS].reshape(B, T)
        logp_all = torch.log_softmax(logits, -1)
        target_logp = _take(logp_all, batch[Columns.ACTIONS])

        with torch.no_grad():
            boot_out = self.module.forward_train(
                {Columns.OBS: batch["last_obs"]})
            bootstrap = boot_out[Columns.VF_PREDS] * \
                (1.0 - batch[Columns.TERMINATEDS])
            gamma = self.config.get("gamma", 0.99)
            vs, pg_adv = vtrace_returns(
                batch[Columns.ACTION_LOGP], target_logp, batch[Columns.REWARDS],
                values, bootstrap, mask, gamma,
                self.config.get("vtrace_rho_clip", 1.0),
                self.config.get("vtrace_c_clip", 1.0))

        n = torch.clamp(mask.sum(), min=1.0)
        policy_loss, extra = self._policy_loss(
            target_logp, batch[Columns.ACTION_LOGP], pg_adv, mask, n)
        vf_loss = ((vs - values) ** 2 * mask).sum() / n
        probs = torch.softmax(logits, -1)
        entropy = -((probs * logp_all).sum(-1) * mask).sum() / n
        loss = policy_loss \
            + self.config.get("vf_loss_coeff", 0.5) * vf_loss \
            - self.config.get("entropy_coeff", 0.01) * entropy
        return loss, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                      "entropy": entropy, **extra}

    def _policy_loss(self, target_logp, behavior_logp, pg_adv, mask, n):
        """Policy objective over V-trace advantages; subclasses swap
        the surrogate (APPO uses the PPO clip) while sharing all the
        V-trace machinery above. Returns (loss, extra_stats)."""
        return -(target_logp * pg_adv * mask).sum() / n, {}
