"""The port's SAC and CQL Learners against the JAX ones, on the CPU.

SAC and CQL draw their noise from key words inside the JAX loss; the port
reads it as inputs of the update (drawn on the host from the same words
by its own generator), so the test draws the JAX loss's exact
`jax.random` values from the words and hands them over. Weights and
target critics are the JAX learner's, carried across.

Their log-probs go through log(1 - tanh(u)^2), which multiplies the
last-bit difference between XLA's and torch's tanh by
2 |tanh(u)| / (1 - tanh(u)^2); where tanh(u) rounds to within a few ulp
of 1 (|u| > ~4.5, which a freshly initialised policy reaches) neither
package resolves the term in f32, and the two differ by up to ~0.4 per
element. So the stats are held to bounds computed from the batch
(`_sac_tolerances`): each row's log-prob within `logp_tol(u)`, carried
through the loss's formula (the critic's backup, the policy, alpha and
CQL terms); the gradients' norm within 1e-3 relative. Where every sample
stays below |u| = 4 (the `resolved` regime) the updated weights and the
target critics are held to 1e-5, as the other learners'.

F18: CQL's noise words are a broadcast entry, not rows (the JAX package
splits them as rows).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_rllib_helpers import (TOL, box, check_stats,  # noqa: E402
                                  check_weights, jax_noise, logp_tol, rows)
from ray_tpu.rllib.algorithms import cql as jcql  # noqa: E402
from ray_tpu.rllib.algorithms import sac as jsac  # noqa: E402
from ray_tpu.rllib.core import rl_module as jrm  # noqa: E402
from ray_tpu_torch.models.convert import rl_module_params_from_jax  # noqa: E402
from ray_tpu_torch.rllib.algorithms import cql as tcql  # noqa: E402
from ray_tpu_torch.rllib.algorithms import sac as tsac  # noqa: E402
from ray_tpu_torch.rllib.core import rl_module as trm  # noqa: E402

GRAD_NORM_RTOL = 1e-3


def _sac_tolerances(jlr, batch, noise, n_cql, cql_alpha):
    """(each stat's bound for this batch, the largest |u| sampled), from
    the JAX learner's values before its update: the per-row log-prob
    bounds carried through the SAC (and CQL) loss."""
    m, p = jlr.module, jlr.params
    obs, nobs = jnp.asarray(batch["obs"]), jnp.asarray(batch["next_obs"])
    gamma = jlr.config.get("gamma", 0.99)
    alpha = float(np.exp(p["log_alpha"]))

    def u_of(o, eps):
        mean, log_std = m.policy.apply(p["policy"], o)
        return np.asarray(mean + jnp.exp(log_std) * eps)

    us = [u_of(nobs, noise["noise_next"]), u_of(obs, noise["noise_new"])]
    e_next, e_new = map(logp_tol, us)
    # the critic's backup as the JAX loss computes it
    k_next, _ = jax.random.split(jax.random.wrap_key_data(
        jnp.asarray(batch["rng"], jnp.uint32)))
    a_next, logp_next = jsac._squash(*m.policy.apply(p["policy"], nobs),
                                     k_next, m.scale, m.offset)
    not_done = 1.0 - batch["terminateds"]
    backup = batch["rewards"] + gamma * not_done * np.asarray(
        jnp.minimum(m.q.apply(jlr.target_q["q1"], nobs, a_next),
                    m.q.apply(jlr.target_q["q2"], nobs, a_next))
        - alpha * logp_next)
    delta = gamma * not_done * alpha * e_next
    q_tol = 1e-5 + sum(
        float(np.mean(2 * np.abs(np.asarray(q) - backup) * delta
                      + delta ** 2))
        for q in m.q_values(p, obs, jnp.asarray(batch["actions"])))
    tols = {"q_loss": q_tol, "entropy": 1e-5 + float(np.mean(e_new)),
            "policy_loss": 1e-5 + alpha * float(np.mean(e_new)),
            "alpha_loss": 1e-5 + abs(float(p["log_alpha"]))
            * float(np.mean(e_new))}
    total = q_tol + tols["policy_loss"] + tols["alpha_loss"]
    if n_cql:
        # each critic's logsumexp moves by at most its worst candidate's
        us += [u_of(obs, noise["cql_noise_pol"]),
               u_of(nobs, noise["cql_noise_next"])]
        worst = np.maximum(logp_tol(us[2]), logp_tol(us[3])).max(axis=0)
        tols["cql_loss"] = 1e-5 + 2 * float(np.mean(worst))
        total += cql_alpha * tols["cql_loss"]
    tols["total_loss"] = total
    return tols, max(float(np.abs(u).max()) for u in us)


@pytest.mark.parametrize("regime", ["resolved", "saturating"])
@pytest.mark.parametrize("algo", ["sac", "cql"])
def test_sac_and_cql_updates_match_jax_given_the_same_noise(algo, regime):
    """`resolved`: the policy's log-std head starts at zero (std 1), and
    every pre-squash sample stays below |u| = 4 (asserted), where f32
    resolves log(1 - tanh(u)^2) in both packages: the updated weights and
    target critics are compared. `saturating`: the Flax initialisation as
    it is, whose samples reach |u| > 4.5: one update's stats within their
    bounds (the weights then differ where a gradient near zero changed
    sign, so a second update is not compared)."""
    jcls, tcls = {"sac": (jsac.SACLearner, tsac.SACLearner),
                  "cql": (jcql.CQLLearner, tcql.CQLLearner)}[algo]
    jspec = box(jrm.RLModuleSpec, jsac.SACModule)
    tspec = box(trm.RLModuleSpec, tsac.SACModule)
    n_cql = 4 if algo == "cql" else 0
    config = {"lr": 1e-3, "tau": 0.1, "grad_clip": 10.0,
              "num_sampled_actions": n_cql, "cql_alpha": 2.0}
    jlr = jcls(jspec, config, seed=0)
    if regime == "resolved":
        head = jlr.params["policy"]["params"]["Dense_3"]  # the log-std head
        jlr.params["policy"]["params"]["Dense_3"] = jax.tree_util.tree_map(
            jnp.zeros_like, head)
    tlr = tcls(tspec, config, seed=0, device="cpu")
    tlr.set_state({
        "weights": rl_module_params_from_jax(jlr.get_weights(), tspec),
        "target_q": rl_module_params_from_jax(jlr.target_q, tspec)})
    max_u = 0.0
    for step in range(2 if regime == "resolved" else 1):
        batch = rows(32, 13 + step, continuous=True)
        batch["rng"] = np.asarray([0, 977 * step], np.uint32)
        batch["cql_rng"] = np.asarray([1, 991 * step], np.uint32)
        noise = jax_noise(batch, n_cql)
        tols, u = _sac_tolerances(jlr, batch, noise, n_cql, 2.0)
        max_u = max(max_u, u)
        want = jlr.update_from_batch(batch)
        port_batch = {k: v for k, v in batch.items()
                      if k not in ("rng", "cql_rng")}
        got = tlr.update_from_batch({**port_batch, **noise})
        tols["grad_norm"] = GRAD_NORM_RTOL * want["grad_norm"]
        check_stats(want, got, tols)
        if regime == "resolved":
            assert max_u < 4.0, max_u
            check_weights(jlr.params, tspec, tlr.get_weights())
            # the polyak-updated target critics
            target = rl_module_params_from_jax(jlr.target_q, tspec)
            for k, v in trm.params_to_numpy(tlr.target_q).items():
                np.testing.assert_allclose(v, target[k], rtol=0, atol=TOL)
    if regime == "saturating":
        assert max_u > 4.5, max_u


def test_noise_is_drawn_from_the_batch_words_outside_the_update():
    """New words, new noise (a captured update never replays the noise of
    its capture); the same words, the same noise, on any device."""
    tlr = tcql.CQLLearner(box(trm.RLModuleSpec, tsac.SACModule),
                          {"num_sampled_actions": 3}, device="cpu")
    batch = rows(16, 14, continuous=True)

    def noise(w0, w1):
        b = dict(batch, rng=np.asarray([w0, w1], np.uint32),
                 cql_rng=np.asarray([w0 + 1, w1], np.uint32))
        out = tlr._batch(b)
        assert "rng" not in out and "cql_rng" not in out
        return out

    a, b, c = noise(0, 1), noise(0, 1), noise(0, 2)
    keys = ("noise_next", "noise_new", "cql_uniform", "cql_noise_pol",
            "cql_noise_next")
    assert a["noise_next"].shape == (16, 2)
    assert a["cql_uniform"].shape == (3, 16, 2)
    for k in keys:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    assert not torch.equal(a["noise_next"], a["noise_new"])


def test_f18_cql_words_are_broadcast_not_split_as_rows():
    """F18: the JAX package names only SAC's ``rng`` a broadcast entry, so
    CQL's two ``cql_rng`` words count as rows: a LearnerGroup splitting a
    48-row CQL batch over two learners gives each one row, and a learner
    over a 4-device mesh trains on 4 rows tiled from 2. The port names
    ``cql_rng`` too."""
    from ray_tpu.rllib.core import learner_group as jlg
    from ray_tpu_torch.rllib.core import learner_group as tlg

    batch = rows(48, 16, continuous=True)
    batch["rng"] = np.asarray([0, 1], np.uint32)
    batch["cql_rng"] = np.asarray([2, 3], np.uint32)
    jax_shards = jlg._split_batch(batch, 2)
    port_shards = tlg._split_batch(batch, 2, tcql.CQLLearner.BROADCAST_KEYS)
    assert [len(s["obs"]) for s in jax_shards] == [1, 1]
    assert [len(s["obs"]) for s in port_shards] == [24, 24]
    for s in port_shards:
        np.testing.assert_array_equal(s["cql_rng"], batch["cql_rng"])
    learner = tcql.CQLLearner(box(trm.RLModuleSpec, tsac.SACModule), {},
                              num_devices=4, device="cpu")
    assert len(learner._batch(batch)["obs"]) == 48
