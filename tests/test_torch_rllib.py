"""The port's RLlib modules, env runner and connectors against the JAX
package, on the CPU.

Weights are the JAX modules' (`jax.random.PRNGKey`), carried across by
`ray_tpu_torch.models.convert.rl_module_params_from_jax`; every other
input comes from numpy with a seed. Tolerance 1e-5 (absolute, on values
of order one) unless a test says otherwise.

* Forwards of the actor-critic, Q and SAC modules, and SAC's squashed
  sample given the JAX noise.
* Greedy rollouts on CartPole-v1: the port's episodes equal the JAX
  runner's once the JAX runner's reset transitions are removed; and F16,
  the JAX runner's reset transitions themselves (a reward-0 first
  transition from a terminal observation), which the port's runner does
  not record; and F17, the JAX runner's episode returns cut to the last
  fragment of an episode that spans `sample` calls.
* GAE (bootstrapped through each package's module), advantage
  standardisation, `sequence_batch`, `vtrace_returns` and both replay
  buffers (same numpy seed, same samples).
* Exploration draws from the caller's generator.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores
gym = pytest.importorskip("gymnasium")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_rllib_helpers import logp_tol  # noqa: E402

from ray_tpu.rllib import connectors as jconn  # noqa: E402
from ray_tpu.rllib.algorithms import sac as jsac  # noqa: E402
from ray_tpu.rllib.core import learner as jlearner  # noqa: E402
from ray_tpu.rllib.core import rl_module as jrm  # noqa: E402
from ray_tpu.rllib.env import env_runner as jrunner  # noqa: E402
from ray_tpu.rllib.utils import replay_buffers as jreplay  # noqa: E402
from ray_tpu_torch.models.convert import rl_module_params_from_jax  # noqa: E402
from ray_tpu_torch.rllib import connectors as tconn  # noqa: E402
from ray_tpu_torch.rllib.algorithms import sac as tsac  # noqa: E402
from ray_tpu_torch.rllib.core import learner as tlearner  # noqa: E402
from ray_tpu_torch.rllib.core import rl_module as trm  # noqa: E402
from ray_tpu_torch.rllib.env import env_runner as trunner  # noqa: E402
from ray_tpu_torch.rllib.utils import replay_buffers as treplay  # noqa: E402

TOL = 1e-5

# CartPole-v1 terminates past these (gymnasium's classic_control source)
THETA_LIMIT = 12 * 2 * np.pi / 360
X_LIMIT = 2.4

KINDS = {
    "actor_critic": (jrm.ActorCriticModule, trm.ActorCriticModule, True),
    "q": (jrm.QModule, trm.QModule, True),
    "sac": (jsac.SACModule, tsac.SACModule, False),
}


def _pair(kind, obs_dim=4, act_dim=3, hidden=(16, 16), seed=0):
    """(JAX module, its params, port module with the same weights)."""
    jcls, tcls, discrete = KINDS[kind]
    box = {} if discrete else dict(action_scale=(2.0, 0.5)[:act_dim],
                                    action_offset=(0.0, 0.25)[:act_dim])
    jspec = jrm.RLModuleSpec(observation_dim=obs_dim, action_dim=act_dim,
                             hidden=hidden, discrete=discrete, **box)
    tspec = trm.RLModuleSpec(observation_dim=obs_dim, action_dim=act_dim,
                             hidden=hidden, discrete=discrete,
                             module_class=tcls, **box)
    jmod = jcls(jspec)
    params = jmod.init_params(jax.random.PRNGKey(seed))
    tmod = tspec.build()
    tmod.set_weights(rl_module_params_from_jax(jrm.params_to_numpy(params),
                                               tspec))
    return jmod, params, tmod


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_module_forwards_match_jax(kind):
    act_dim = 2 if kind == "sac" else 3
    jmod, params, tmod = _pair(kind, act_dim=act_dim)
    assert set(tmod.get_weights()) == set(rl_module_params_from_jax(
        jrm.params_to_numpy(params), tmod.spec))
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(7, 4)).astype(np.float32)
    want = jmod.forward_inference(params, jnp.asarray(obs))
    got = tmod.forward_inference(torch.from_numpy(obs))
    assert set(want) == set(got)
    for k in want:
        _close(want[k], got[k])
    want = jmod.forward_train(params, {"obs": jnp.asarray(obs)})
    got = tmod.forward_train({"obs": torch.from_numpy(obs)})
    for k in want:
        _close(want[k], got[k].detach())
    if kind == "sac":
        act = rng.uniform(-1, 1, size=(7, act_dim)).astype(np.float32)
        for w, g in zip(jmod.q_values(params, jnp.asarray(obs),
                                      jnp.asarray(act)),
                        tmod.q_values(torch.from_numpy(obs),
                                      torch.from_numpy(act))):
            _close(w, g.detach())
        # the squashed sample and its log-prob, given the JAX draw
        key = jax.random.PRNGKey(5)
        mean, log_std = jmod.policy.apply(params["policy"], jnp.asarray(obs))
        a_j, logp_j = jsac._squash(mean, log_std, key, jmod.scale,
                                   jmod.offset)
        noise = jax.random.normal(key, mean.shape)
        a_t, logp_t = tsac._squash(
            *(torch.tensor(np.asarray(x)) for x in (mean, log_std, noise)),
            tmod.scale, tmod.offset)
        _close(a_j, a_t)
        tol = logp_tol(mean + jnp.exp(log_std) * noise)
        assert (np.abs(np.asarray(logp_j) - logp_t.numpy()) <= tol).all()


def test_exploration_draws_from_the_callers_generator():
    _, _, ac = _pair("actor_critic")
    _, _, q = _pair("q")
    _, _, sac = _pair("sac", act_dim=2)
    obs = torch.from_numpy(
        np.random.default_rng(2).normal(size=(64, 4)).astype(np.float32))

    def draw(mod, seed, **kw):
        return mod.forward_exploration(
            obs, torch.Generator().manual_seed(seed), **kw)

    for mod in (ac, sac):
        a, b, c = draw(mod, 0), draw(mod, 0), draw(mod, 1)
        assert torch.equal(a["actions"], b["actions"])
        assert not torch.equal(a["actions"], c["actions"])
    out = draw(ac, 0)
    logp = torch.log_softmax(out["action_dist_inputs"], -1)
    _close(out["action_logp"], logp.gather(-1, out["actions"][:, None])[:, 0])
    greedy = q.forward_inference(obs)["actions"]
    assert torch.equal(draw(q, 3, epsilon=0.0)["actions"], greedy)
    random = draw(q, 3, epsilon=1.0)["actions"]
    assert torch.equal(random, draw(q, 3, epsilon=1.0)["actions"])
    assert not torch.equal(random, greedy)
    box = sac.forward_exploration(obs)["actions"]
    assert bool(((box >= sac.offset - sac.scale)
                 & (box <= sac.offset + sac.scale)).all())


# -- the env runner ------------------------------------------------------------


@pytest.fixture(scope="module")
def greedy_rollouts(num_envs=2, steps=200, seed=3):
    """(JAX runner's episodes, port runner's episodes): CartPole-v1, greedy
    with the same weights (a module whose episodes last 10-30 steps), the
    same seed and number of steps."""
    jmod, params, tmod = _pair("actor_critic", act_dim=2, seed=5)
    jspec = jmod.spec
    tspec = trm.RLModuleSpec(observation_dim=4, action_dim=2,
                             hidden=jspec.hidden)
    make = lambda: gym.make("CartPole-v1")  # noqa: E731
    jr = jrunner.SingleAgentEnvRunner(make, jspec, num_envs, seed)
    jr.set_weights(params)
    tr = trunner.SingleAgentEnvRunner(make, tspec, num_envs, seed)
    tr.set_weights(tmod.get_weights())
    return jr.sample(steps, explore=False), tr.sample(steps, explore=False)


def _terminal(obs):
    return abs(obs[0]) > X_LIMIT or abs(obs[2]) > THETA_LIMIT


def _reset_transitions(episodes):
    """The JAX runner's episodes whose first transition is the reset step
    after an episode's end: reward 0 from that episode's terminal
    observation."""
    ends = {ep.last_obs.tobytes() for ep in episodes
            if ep.terminated or ep.truncated}
    return [ep for ep in episodes
            if ep.rewards[0] == 0.0 and ep.obs[0].tobytes() in ends]


def test_greedy_rollouts_equal_jax_runner_without_its_reset_transitions(
        greedy_rollouts):
    jax_eps, port_eps = greedy_rollouts
    resets = _reset_transitions(jax_eps)
    done = [ep for ep in jax_eps if ep.terminated or ep.truncated]
    assert len(done) >= 8 and resets
    by_start = {ep.obs[0].tobytes(): ep for ep in port_eps}
    for ep in done:
        cut = 1 if any(ep is r for r in resets) else 0
        other = by_start[ep.obs[cut].tobytes()]
        assert other.length == ep.length - cut
        np.testing.assert_array_equal(np.stack(other.obs),
                                      np.stack(ep.obs[cut:]))
        assert other.actions == ep.actions[cut:]
        assert other.rewards == ep.rewards[cut:]
        assert (other.terminated, other.truncated) == (ep.terminated,
                                                       ep.truncated)
        np.testing.assert_array_equal(other.last_obs, ep.last_obs)
        # the port's logp/vf are the module's (greedy: zeros, and values)
        _close(other.vf_preds, ep.vf_preds[cut:])
    # without the wasted reset steps the port finishes more episodes
    assert sum(ep.terminated or ep.truncated for ep in port_eps) > len(done)


def test_f16_jax_runner_records_reset_transitions_from_terminal_states(
        greedy_rollouts):
    """F16: gymnasium 1.x vector envs reset one step after an episode
    ends; the JAX runner records that step as the next episode's first
    transition (reward 0, from the terminal observation). The port's
    runner resets on the step the episode ends and records none."""
    jax_eps, port_eps = greedy_rollouts
    resets = _reset_transitions(jax_eps)
    # every episode after each env's first starts so
    n_done = sum(ep.terminated or ep.truncated for ep in jax_eps)
    assert len(resets) >= n_done - 2 > 0
    assert all(ep.rewards[0] == 0.0 and _terminal(ep.obs[0])
               for ep in resets)
    assert not _reset_transitions(port_eps)
    for ep in port_eps:
        assert all(r == 1.0 for r in ep.rewards)
        assert not any(_terminal(o) for o in ep.obs)
        if ep.terminated:
            assert _terminal(ep.last_obs)


def test_f17_returns_of_episodes_that_span_sample_calls():
    """F17: an episode still running when `sample` returns goes on in the
    next call; the JAX runner's `episode_return_mean` counts only its
    last fragment's reward, the port's the whole episode's."""
    jmod, params, tmod = _pair("actor_critic", act_dim=2)  # ~80 steps
    tspec = trm.RLModuleSpec(observation_dim=4, action_dim=2,
                             hidden=jmod.spec.hidden)
    make = lambda: gym.make("CartPole-v1")  # noqa: E731
    jr = jrunner.SingleAgentEnvRunner(make, jmod.spec, 1, 3)
    jr.set_weights(params)
    runners = [trunner.SingleAgentEnvRunner(make, tspec, 1, 3)
               for _ in range(2)]
    for r in runners:
        r.set_weights(tmod.get_weights())
    whole = runners[0].sample(200, explore=False)  # one call
    lengths = [ep.length for ep in whole if ep.terminated or ep.truncated]
    assert len(lengths) >= 2 and min(lengths) > 20
    for _ in range(10):  # the same 200 steps in calls of 20
        runners[1].sample(20, explore=False)
        jr.sample(20, explore=False)
    port = runners[1].get_metrics()
    assert port == runners[0].get_metrics()
    assert port["num_episodes"] == len(lengths)
    assert port["episode_return_mean"] == float(np.mean(lengths))
    assert jr.get_metrics()["episode_return_mean"] <= 20.0


# -- connectors -----------------------------------------------------------------


def _episodes(seed=4, obs_dim=4, continuous=False):
    """Fragments of every kind: terminated, truncated, open."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (n, term, trunc) in enumerate([(9, True, False), (5, False, True),
                                          (13, False, False), (1, True, False),
                                          (7, False, False)]):
        ep = trunner.Episode()
        for _ in range(n):
            ep.obs.append(rng.normal(size=obs_dim).astype(np.float32))
            ep.actions.append(rng.uniform(-1, 1, 2).astype(np.float32)
                              if continuous else int(rng.integers(0, 3)))
            ep.rewards.append(float(rng.normal()))
            ep.logps.append(float(rng.normal() - 1.0))
            ep.vf_preds.append(float(rng.normal()))
        ep.terminated, ep.truncated = term, trunc
        ep.last_obs = rng.normal(size=obs_dim).astype(np.float32)
        out.append(ep)
    return out


def test_gae_and_standardize_match_jax():
    jmod, params, tmod = _pair("actor_critic")
    eps = _episodes()
    jgae = jconn.GAE(0.99, 0.95, module=jmod, params_getter=lambda: params)
    tgae = tconn.GAE(0.99, 0.95, module=tmod.spec.build(seed=9),
                     params_getter=tmod.get_weights)
    want = jconn.standardize_advantages(
        eps, jgae(eps, jconn.columns_from_episodes(eps, {})))
    got = tconn.standardize_advantages(
        eps, tgae(eps, tconn.columns_from_episodes(eps, {})))
    assert set(want) == set(got)
    for k in want:
        _close(want[k], got[k])
    # without a module the bootstrap is 0 in both
    want = jconn.GAE(0.9, 1.0)(eps, {})
    got = tconn.GAE(0.9, 1.0)(eps, {})
    for k in want:
        _close(want[k], got[k])


def test_sequence_batch_matches_jax():
    eps = _episodes(seed=5)
    for max_len in (0, 4):
        want = jconn.sequence_batch(eps, max_len=max_len)
        got = tconn.sequence_batch(eps, max_len=max_len)
        assert set(want) == set(got)
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(want[k], got[k])


def test_vtrace_matches_jax():
    rng = np.random.default_rng(6)
    B, T = 4, 7
    args = [rng.normal(size=(B, T)).astype(np.float32) - 1.0,
            rng.normal(size=(B, T)).astype(np.float32) - 1.0,
            rng.normal(size=(B, T)).astype(np.float32),
            rng.normal(size=(B, T)).astype(np.float32),
            rng.normal(size=(B,)).astype(np.float32)]
    mask = np.ones((B, T), np.float32)
    mask[1, 4:] = 0.0  # short rows bootstrap at their last valid step
    mask[3, 1:] = 0.0
    for rho, c in ((1.0, 1.0), (0.8, 1.2)):
        want = jlearner.vtrace_returns(*map(jnp.asarray, args),
                                       jnp.asarray(mask), 0.95, rho, c)
        got = tlearner.vtrace_returns(*map(torch.from_numpy, args),
                                      torch.from_numpy(mask), 0.95, rho, c)
        for w, g in zip(want, got):
            _close(w, g)


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffers_sample_as_jax(prioritized):
    eps = _episodes(seed=7, continuous=True)
    if prioritized:
        bufs = [m.PrioritizedReplayBuffer(capacity=20, seed=11)
                for m in (jreplay, treplay)]
    else:
        bufs = [m.ReplayBuffer(capacity=20, seed=11)
                for m in (jreplay, treplay)]
    for buf in bufs:
        for ep in eps:
            buf.add_episode(ep)
    assert len(bufs[0]) == len(bufs[1]) == 20  # FIFO past capacity
    td = np.random.default_rng(8).normal(size=16)
    for _ in range(3):
        want, got = (buf.sample(16) for buf in bufs)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(want[k], got[k])
        if prioritized:
            for buf, b in zip(bufs, (want, got)):
                buf.update_priorities(b["_indices"], td)
