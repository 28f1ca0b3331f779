"""Shared inputs and checks of the RLlib port's tests against the JAX
package (`tests/test_torch_rllib*.py`): numpy batches from a seed, the
JAX SAC/CQL loss's noise drawn from a batch's words, and the comparisons
with their tolerances."""

import numpy as np
import jax
import jax.numpy as jnp

from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu_torch.models.convert import rl_module_params_from_jax
from ray_tpu_torch.rllib.env.env_runner import Episode

TOL = 1e-5
OBS, ACT, B = 4, 3, 48


def rows(n, seed, continuous=False):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, OBS)).astype(np.float32),
        "actions": (rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
                    if continuous else rng.integers(0, ACT, size=n)),
        "action_logp": rng.normal(size=n).astype(np.float32) - 1.1,
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, OBS)).astype(np.float32),
        "terminateds": (rng.uniform(size=n) < 0.2).astype(np.float32),
    }


def sequences(seed):
    rng = np.random.default_rng(seed)
    eps = []
    for n, term in ((12, True), (7, False), (20, False), (3, True)):
        ep = Episode()
        for _ in range(n):
            ep.obs.append(rng.normal(size=OBS).astype(np.float32))
            ep.actions.append(int(rng.integers(0, ACT)))
            ep.rewards.append(float(rng.normal()))
            ep.logps.append(float(rng.normal() - 1.1))
            ep.vf_preds.append(0.0)
        ep.terminated = term
        ep.last_obs = rng.normal(size=OBS).astype(np.float32)
        eps.append(ep)
    return jconn.sequence_batch(eps, max_len=8)


def box(spec_cls, module_class=None):
    return spec_cls(observation_dim=OBS, action_dim=2, hidden=(16, 16),
                    discrete=False, action_scale=(2.0, 0.5),
                    action_offset=(0.0, 0.25),
                    **({"module_class": module_class}
                       if module_class else {}))


def check_weights(want_tree, spec, got, tol=TOL):
    want = rl_module_params_from_jax(jrm.params_to_numpy(want_tree), spec)
    assert set(want) == set(got)
    worst = max(float(np.abs(want[k] - got[k]).max()) for k in want)
    assert worst <= tol, worst


def check_stats(want, got, tols=None):
    assert set(want) == set(got)
    for k in want:
        tol = (tols or {}).get(k, TOL)
        assert abs(want[k] - got[k]) <= tol, (k, want[k], got[k])


def logp_tol(u):
    """Bound on the two packages' difference in a squashed sample's
    log-prob at pre-squash `u` [..., A]: XLA's and torch's tanh differ by
    up to 2 ulp (2.4e-7 near 1) for most inputs, and
    log(1 - tanh(u)^2) multiplies that by 2 |tanh(u)| / (1 - tanh(u)^2);
    1e-5 on top."""
    t = np.tanh(np.asarray(u, np.float64))
    return 1e-5 + (4.8e-7 * np.abs(t) / (1 - t ** 2 + 1e-6)).sum(-1)


def jax_noise(batch, n_cql=0):
    """The values the JAX SAC/CQL loss draws from the batch's words."""
    rows, act = batch["obs"].shape[0], 2
    k_next, k_new = jax.random.split(jax.random.wrap_key_data(
        jnp.asarray(batch["rng"], jnp.uint32)))
    out = {"noise_next": jax.random.normal(k_next, (rows, act)),
           "noise_new": jax.random.normal(k_new, (rows, act))}
    if n_cql:
        k_unif, k_pol, k_nxt = jax.random.split(jax.random.wrap_key_data(
            jnp.asarray(batch["cql_rng"], jnp.uint32)), 3)
        out["cql_uniform"] = jax.random.uniform(k_unif, (n_cql, rows, act))
        for name, key in (("cql_noise_pol", k_pol), ("cql_noise_next", k_nxt)):
            out[name] = jnp.stack([jax.random.normal(k, (rows, act))
                                   for k in jax.random.split(key, n_cql)])
    return {k: np.asarray(v) for k, v in out.items()}
