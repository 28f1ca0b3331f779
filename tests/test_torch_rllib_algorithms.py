"""The port's RLlib algorithms, offline IO, estimators and multi-agent
runner, on the CPU (learners with ``learner_device="cpu"``), and the
learner and env-runner actors on the port's runtime.

* A remote `LearnerGroup`: two learner actors stay identical after an
  averaged-gradient update; one learner actor takes the local learner's
  step on the same batch (phase 18 (b) of `chip_smoke.py` on the card).
* PPO with remote env runners, `Tuner(PPO)`, the checkpoint round trip
  (weights, Adam's state, the iteration), and PPO learning CartPole-v1
  (the JAX test's check: a mean return of 120 within 40 iterations).
* DQN (prioritized replay), IMPALA, APPO, SAC and CQL (on SAC's recorded
  episodes) through their `training_step`s.
* Offline shards written by each package read by the other, one MARWIL
  and one BC iteration of both packages on them (same weights, same
  sampled episodes and minibatches: stats within 1e-5 of max(1, |value|),
  weights within 1e-5), and
  the IS/WIS estimators of both on the same episodes and target policy.
* The multi-agent runner's routing: greedy rollouts equal the JAX
  runner's module by module (it resets on the episode's last step in
  both packages), exploration routes each agent's fragments to its
  module, and MultiAgentPPO trains and checkpoints.
* The smoke's CartPole-v1 and Pendulum-v1 (defined in `chip_smoke.py`
  so that phase 18 needs no gymnasium) step as gymnasium's do.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores
gym = pytest.importorskip("gymnasium")

import jax  # noqa: E402

import ray_tpu.rllib as jrl  # noqa: E402
from ray_tpu.rllib import offline as joff  # noqa: E402
from ray_tpu.rllib.core import rl_module as jrm  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.rllib as trl  # noqa: E402
from ray_tpu_torch.models.convert import rl_module_params_from_jax  # noqa: E402
from ray_tpu_torch.rllib import offline as toff  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=128 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


def _ppo_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=n),
        "action_logp": np.full(n, -0.69, np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }


def _max_diff(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def test_remote_learner_group_stays_in_sync(cluster):
    spec = trl.RLModuleSpec(observation_dim=4, action_dim=2, hidden=(16,))
    group = trl.LearnerGroup(trl.PPOLearner, spec, {"lr": 1e-2},
                             num_learners=2, device="cpu")
    one = trl.LearnerGroup(trl.PPOLearner, spec, {"lr": 1e-2},
                           num_learners=1, device="cpu")
    local = trl.LearnerGroup(trl.PPOLearner, spec, {"lr": 1e-2},
                             device="cpu")
    try:
        w0 = group.get_weights()
        assert _max_diff(w0, local.get_weights()) == 0.0  # one seed
        batch = _ppo_batch()
        stats = group.update_from_batch(batch)
        assert np.isfinite(stats["total_loss"])
        a, b = group._manager.foreach(lambda x: x.get_weights.remote())
        assert _max_diff(a, b) == 0.0
        assert _max_diff(w0, a) > 0.0
        # one learner actor takes the local learner's step
        s_one = one.update_from_batch(batch)
        s_local = local.update_from_batch(batch)
        assert abs(s_one["total_loss"] - s_local["total_loss"]) <= TOL
        assert _max_diff(one.get_weights(), local.get_weights()) <= TOL
        assert local.local_learner is not None and one.local_learner is None
    finally:
        group.stop()
        one.stop()


def _cartpole_ppo(**overrides):
    cfg = (trl.PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=0, num_envs_per_env_runner=4)
           .training(lr=3e-4, train_batch_size=1024, minibatch_size=128,
                     num_epochs=6, entropy_coeff=0.01)
           .learners(learner_device="cpu").debugging(seed=0))
    cfg.update_from_dict(overrides)
    return cfg


def test_ppo_with_remote_env_runners(cluster):
    algo = trl.PPO(config=_cartpole_ppo(
        num_env_runners=2, num_envs_per_env_runner=2, train_batch_size=512,
        num_epochs=2))
    try:
        result = algo.train()
        assert result["num_env_steps_sampled"] >= 512
        assert np.isfinite(result["total_loss"])
        assert set(result["timers"]) == {"sample_s", "learn_s"}
        assert len(algo.env_runner_group.get_metrics()) == 2
    finally:
        algo.stop()


def test_tuner_runs_ppo(cluster, tmp_path):
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig

    grid = tune.Tuner(
        trl.PPO,
        param_space={"env": "CartPole-v1", "learner_device": "cpu",
                     "train_batch_size": 256, "minibatch_size": 128,
                     "num_epochs": 1, "num_envs_per_env_runner": 2,
                     "lr": tune.grid_search([1e-3, 3e-4])},
        tune_config=tune.TuneConfig(metric="episode_return_mean",
                                    mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path),
                             stop={"training_iteration": 2}),
    ).fit()
    assert len(grid) == 2
    for res in grid:
        assert res.error is None
        assert res.metrics["training_iteration"] == 2
        assert "episode_return_mean" in res.metrics


def test_checkpoint_round_trip(tmp_path):
    algo = trl.PPO(config=_cartpole_ppo(train_batch_size=256, num_epochs=1))
    other = trl.PPO(config=_cartpole_ppo(train_batch_size=256, num_epochs=1,
                                         seed=5))
    try:
        algo.train()
        algo.save_checkpoint(str(tmp_path))
        other.load_checkpoint(str(tmp_path))
        assert other._iteration == algo._iteration == 1
        want, got = (a.learner_group.get_state() for a in (algo, other))
        assert _max_diff(want["weights"], got["weights"]) == 0.0
        for part in ("mu", "nu"):
            assert _max_diff(want["opt_state"][part],
                             got["opt_state"][part]) == 0.0
        assert want["opt_state"]["count"] == got["opt_state"]["count"] > 0
    finally:
        algo.stop()
        other.stop()


def test_ppo_learns_cartpole():
    """The check of the JAX package's test_ppo_cartpole_learns."""
    algo = trl.PPO(config=_cartpole_ppo())
    try:
        best = 0.0
        for _ in range(40):
            r = algo.train()["episode_return_mean"]
            if np.isfinite(r):
                best = max(best, r)
            if best >= 120.0:
                break
        assert best >= 120.0, f"PPO failed to learn: best return {best}"
    finally:
        algo.stop()


def test_other_algorithms_train(tmp_path):
    dqn = trl.DQN(config=(
        trl.DQNConfig().environment("CartPole-v1")
        .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=200)
        .training(train_batch_size=32, learning_starts=300,
                  num_updates_per_iteration=4, prioritized_replay=True)
        .learners(learner_device="cpu").debugging(seed=0)))
    try:
        eps0 = dqn.train()["epsilon"]
        stats = dqn.train()
        assert stats["replay_size"] >= 300 and stats["epsilon"] < eps0
        assert np.isfinite(stats["td_error_mean"])
    finally:
        dqn.stop()
    for cfg_cls in (trl.IMPALAConfig, trl.APPOConfig):
        algo = (cfg_cls().environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=2,
                             rollout_fragment_length=50)
                .training(train_batch_size=200)
                .learners(learner_device="cpu").debugging(seed=0)
                .build_algo())
        try:
            stats = algo.train()
            assert np.isfinite(stats["total_loss"]), cfg_cls
        finally:
            algo.stop()
    data = str(tmp_path / "pendulum")
    sac = trl.SAC(config=(
        trl.SACConfig().environment("Pendulum-v1")
        .env_runners(rollout_fragment_length=200)
        .training(train_batch_size=32, learning_starts=200,
                  num_updates_per_iteration=2)
        .offline_data(output=data)
        .learners(learner_device="cpu").debugging(seed=0)))
    try:
        stats = sac.train()
        assert stats["num_updates"] == 2 and np.isfinite(stats["q_loss"])
    finally:
        sac.stop()
    cql = trl.CQL(config=(
        trl.CQLConfig().environment("Pendulum-v1")
        .training(train_batch_size=32, num_updates_per_iteration=2,
                  num_sampled_actions=3)
        .offline_data(input_=data)
        .learners(learner_device="cpu").debugging(seed=0)))
    try:
        stats = cql.train()
        assert np.isfinite(stats["cql_loss"])
        assert stats["num_offline_steps_trained"] == 64
    finally:
        cql.stop()


# -- offline ------------------------------------------------------------------


def _heuristic_episodes(n, seed=0):
    """CartPole-v1 demonstrations of the balancing heuristic, with the
    log-prob of a policy that takes its action with probability 0.9."""
    env = gym.make("CartPole-v1")
    out = []
    for i in range(n):
        obs, _ = env.reset(seed=seed + i)
        ep = trl.Episode()
        for _ in range(120):
            action = 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0
            ep.obs.append(np.asarray(obs, np.float32))
            ep.actions.append(action)
            ep.logps.append(float(np.log(0.9)))
            ep.vf_preds.append(0.0)
            obs, reward, term, trunc, _ = env.step(action)
            ep.rewards.append(float(reward))
            if term or trunc:
                ep.terminated, ep.truncated = bool(term), bool(trunc)
                break
        ep.last_obs = np.asarray(obs, np.float32)
        out.append(ep)
    env.close()
    return out


def _same_episodes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.stack(x.obs), np.stack(y.obs))
        assert x.actions == y.actions and x.rewards == y.rewards
        assert x.logps == y.logps and x.vf_preds == y.vf_preds
        assert (x.terminated, x.truncated) == (y.terminated, y.truncated)
        np.testing.assert_array_equal(x.last_obs, y.last_obs)


@pytest.mark.parametrize("algo", ["MARWIL", "BC"])
def test_offline_shards_cross_read_and_marwil_bc_match_jax(tmp_path, algo):
    eps = _heuristic_episodes(12)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    joff.JsonWriter(jdir, max_rows_per_shard=400).write(eps)
    toff.JsonWriter(tdir, max_rows_per_shard=400).write(eps)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    assert len(os.listdir(jdir)) > 1
    _same_episodes(list(toff.JsonReader(jdir).iter_episodes()), eps)
    _same_episodes(list(joff.JsonReader(tdir).iter_episodes()), eps)

    def config(pkg):
        return (getattr(pkg, f"{algo}Config")().environment("CartPole-v1")
                .training(train_batch_size=600, minibatch_size=256, lr=1e-3,
                          num_epochs=2)
                .offline_data(input_=jdir).debugging(seed=3))

    jalgo = getattr(jrl, algo)(config=config(jrl))
    talgo = getattr(trl, algo)(config=config(trl).learners(
        learner_device="cpu"))
    try:
        talgo.learner_group.set_weights(rl_module_params_from_jax(
            jalgo.learner_group.get_weights(), talgo.spec))
        want, got = jalgo.train(), talgo.train()
        for k in ("policy_loss", "vf_loss", "entropy", "total_loss",
                  "grad_norm", "num_offline_steps_trained"):
            # MARWIL's exp(beta * adv) weights reach exp(10): relative
            assert abs(want[k] - got[k]) <= TOL * max(1.0, abs(want[k])), \
                (k, want[k], got[k])
        jw = rl_module_params_from_jax(jalgo.learner_group.get_weights(),
                                       talgo.spec)
        assert _max_diff(jw, talgo.learner_group.get_weights()) <= TOL
    finally:
        jalgo.stop()
        talgo.stop()


def test_estimators_match_jax():
    eps = _heuristic_episodes(6, seed=20)
    jspec = jrm.RLModuleSpec(observation_dim=4, action_dim=2, hidden=(16,))
    jmod = jrm.ActorCriticModule(jspec)
    params = jmod.init_params(jax.random.PRNGKey(4))
    tspec = trl.RLModuleSpec(observation_dim=4, action_dim=2, hidden=(16,))
    weights = rl_module_params_from_jax(jrm.params_to_numpy(params), tspec)
    for name in ("ImportanceSampling", "WeightedImportanceSampling"):
        want = getattr(joff, name)(jmod, params, gamma=0.98).estimate(eps)
        got = getattr(toff, name)(tspec.build(), weights,
                                  gamma=0.98).estimate(eps)
        assert set(want) == set(got)
        for k in want:
            assert abs(want[k] - got[k]) <= TOL * max(1.0, abs(want[k])), \
                (name, k, want[k], got[k])


# -- multi-agent -----------------------------------------------------------------


def _matching_env(pkg):
    """The JAX test's cooperative 2-agent game: each agent sees a 4-state
    one-hot and earns +1 for action == state % 2; episodes of 8 steps."""

    class MatchingEnv(pkg.MultiAgentEnv):
        possible_agents = ["a0", "a1"]

        def __init__(self):
            obs_sp = gym.spaces.Box(0.0, 1.0, (4,), np.float32)
            self.observation_spaces = {a: obs_sp
                                       for a in self.possible_agents}
            self.action_spaces = {a: gym.spaces.Discrete(2)
                                  for a in self.possible_agents}
            self._rng = np.random.default_rng(0)
            self._t = 0
            self._state = {}

        def _obs(self):
            out = {}
            for a in self.possible_agents:
                s = int(self._rng.integers(0, 4))
                self._state[a] = s
                out[a] = np.eye(4, dtype=np.float32)[s]
            return out

        def reset(self, *, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            return self._obs(), {}

        def step(self, actions):
            rewards = {a: float(int(actions[a]) == self._state[a] % 2)
                       for a in self.possible_agents}
            self._t += 1
            done = self._t >= 8
            terms = {a: done for a in self.possible_agents}
            terms["__all__"] = done
            truncs = {a: False for a in [*self.possible_agents, "__all__"]}
            return self._obs(), rewards, terms, truncs, {}

    return MatchingEnv


def test_multi_agent_runner_routes_as_jax():
    mapping = {"a0": "m0", "a1": "m1"}.__getitem__
    jspec = jrm.RLModuleSpec(observation_dim=4, action_dim=2, hidden=(8,))
    tspec = trl.RLModuleSpec(observation_dim=4, action_dim=2, hidden=(8,))
    params = {m: jrm.ActorCriticModule(jspec).init_params(
        jax.random.PRNGKey(i)) for i, m in enumerate(("m0", "m1"))}
    jr = jrl.MultiAgentEnvRunner(_matching_env(jrl), {"m0": jspec,
                                                      "m1": jspec},
                                 mapping, seed=2)
    jr.set_weights(params)
    tr = trl.MultiAgentEnvRunner(_matching_env(trl), {"m0": tspec,
                                                      "m1": tspec},
                                 mapping, seed=2)
    tr.set_weights({m: rl_module_params_from_jax(jrm.params_to_numpy(p),
                                                 tspec)
                    for m, p in params.items()})
    want, got = jr.sample(40, explore=False), tr.sample(40, explore=False)
    assert set(want) == set(got) == {"m0", "m1"}
    for m in want:
        _same_eps = list(zip(want[m], got[m]))
        assert len(want[m]) == len(got[m]) >= 2
        for x, y in _same_eps:
            np.testing.assert_array_equal(np.stack(x.obs), np.stack(y.obs))
            assert x.actions == y.actions and x.rewards == y.rewards
            np.testing.assert_allclose(x.vf_preds, y.vf_preds, atol=TOL)
            assert (x.terminated, x.truncated) == (y.terminated,
                                                   y.truncated)
    assert jr.get_metrics() == tr.get_metrics()
    # exploring, each agent's fragments go to its module; shared policy
    shared = trl.MultiAgentEnvRunner(_matching_env(trl), {"p": tspec},
                                     lambda a: "p", seed=2)
    shared.set_weights({"p": tr.modules["m0"].get_weights()})
    out = shared.sample(32)
    assert set(out) == {"p"} and sum(ep.length for ep in out["p"]) == 32
    assert all(np.isfinite(ep.logps).all() for ep in out["p"])


def test_multi_agent_ppo_trains_and_checkpoints(tmp_path):
    def config(seed):
        return (trl.MultiAgentPPOConfig().environment(_matching_env(trl))
                .multi_agent(policies={"m0": None, "m1": None},
                             policy_mapping_fn={"a0": "m0",
                                                "a1": "m1"}.__getitem__)
                .training(train_batch_size=128, minibatch_size=64,
                          num_epochs=2, lr=1e-2)
                .rl_module(hidden=(16,))
                .learners(learner_device="cpu").debugging(seed=seed))

    algo = trl.MultiAgentPPO(config=config(0))
    other = trl.MultiAgentPPO(config=config(9))
    try:
        res = algo.train()
        assert {"m0/total_loss", "m1/total_loss"} <= set(res)
        assert res["num_env_steps_sampled"] >= 128
        algo.save_checkpoint(str(tmp_path))
        other.load_checkpoint(str(tmp_path))
        for m in ("m0", "m1"):
            assert _max_diff(algo.learner_groups[m].get_weights(),
                             other.learner_groups[m].get_weights()) == 0.0
    finally:
        algo.stop()
        other.stop()


# -- the smoke's envs -----------------------------------------------------------


@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_smoke_envs_step_as_gymnasium(name):
    import chip_smoke

    ours = {"CartPole-v1": chip_smoke.SmokeCartPole,
            "Pendulum-v1": chip_smoke.SmokePendulum}[name]()
    theirs = gym.make(name)
    assert ours.observation_space.shape == theirs.observation_space.shape
    np.testing.assert_array_equal(ours.observation_space.high,
                                  theirs.observation_space.high)
    rng = np.random.default_rng(1)
    o1, _ = ours.reset(seed=7)
    o2, _ = theirs.reset(seed=7)
    ends = 0
    for _ in range(700):
        np.testing.assert_array_equal(o1, o2)
        if name == "CartPole-v1":
            a = int(rng.integers(0, 2))
        else:
            a = rng.uniform(-2.5, 2.5, size=1).astype(np.float32)
        o1, r1, t1, u1, _ = ours.step(a)
        o2, r2, t2, u2, _ = theirs.step(a)
        assert (float(r1), t1, u1) == (float(r2), t2, u2)
        if t1 or u1:
            ends += 1
            np.testing.assert_array_equal(o1, o2)
            o1, _ = ours.reset()
            o2, _ = theirs.reset()
    assert ends >= 3
    theirs.close()
