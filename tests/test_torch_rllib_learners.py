"""The port's RLlib Learners against the JAX Learners (optax), on the CPU.

Each case builds the JAX learner (`PRNGKey(seed)` weights), carries its
weights (and target network) into the port's learner
(`convert.rl_module_params_from_jax`, `Learner.set_state`), gives both the
same numpy batch and compares two updates: the loss, every stat, and every
updated weight (optax's `chain(clip_by_global_norm, adam)` against the
port's in-place step), and DQN's target network and TD errors. PPO's
``num_devices=4`` case gives 66 rows, which both trim to 64. SAC and CQL
are in `test_torch_rllib_sac.py`.

Tolerances: values and stats 1e-5; weights after an Adam step 1e-5 (Adam
moves a weight by ~lr whatever its gradient's size, so this is 1 % of the
movement at lr 1e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: spare the other workers' cores

from _torch_rllib_helpers import (ACT, B, OBS, TOL, check_stats,  # noqa: E402
                                  check_weights, rows, sequences)
from ray_tpu.rllib.algorithms import appo as jappo  # noqa: E402
from ray_tpu.rllib.algorithms import bc as jbc  # noqa: E402
from ray_tpu.rllib.core import learner as jl  # noqa: E402
from ray_tpu.rllib.core import rl_module as jrm  # noqa: E402
from ray_tpu_torch.models.convert import rl_module_params_from_jax  # noqa: E402
from ray_tpu_torch.rllib.algorithms import appo as tappo  # noqa: E402
from ray_tpu_torch.rllib.algorithms import bc as tbc  # noqa: E402
from ray_tpu_torch.rllib.core import learner as tl  # noqa: E402
from ray_tpu_torch.rllib.core import rl_module as trm  # noqa: E402


# name: (JAX learner, port learner, JAX module class, port module class,
#        config, batch)
CASES = {
    "ppo": (jl.PPOLearner, tl.PPOLearner, None, None,
            {"lr": 1e-3, "entropy_coeff": 0.01}, lambda: rows(B, 1)),
    "dqn": (jl.DQNLearner, tl.DQNLearner, jrm.QModule, trm.QModule,
            {"lr": 1e-3, "target_update_freq": 1}, lambda: rows(B, 2)),
    "dqn_prioritized": (
        jl.DQNLearner, tl.DQNLearner, jrm.QModule, trm.QModule,
        {"lr": 1e-3}, lambda: {**rows(B, 3), "weights": np.random.default_rng(
            3).uniform(0.2, 1.0, B).astype(np.float32)}),
    "impala": (jl.IMPALALearner, tl.IMPALALearner, None, None,
               {"lr": 1e-3}, lambda: sequences(4)),
    "appo": (jappo.APPOLearner, tappo.APPOLearner, None, None,
             {"lr": 1e-3, "clip_param": 0.1}, lambda: sequences(5)),
    "marwil": (jbc.MARWILLearner, tbc.MARWILLearner, None, None,
               {"lr": 1e-3, "beta": 1.0, "vf_loss_coeff": 1.0},
               lambda: rows(B, 6)),
    "bc": (jbc.MARWILLearner, tbc.MARWILLearner, None, None,
           {"lr": 1e-3, "beta": 0.0, "entropy_coeff": 0.01},
           lambda: rows(B, 7)),
}


def _learners(name, num_devices=1):
    jcls, tcls, jmod, tmod, config, _ = CASES[name]
    jspec = jrm.RLModuleSpec(observation_dim=OBS, action_dim=ACT,
                             hidden=(16, 16), module_class=jmod)
    tspec = trm.RLModuleSpec(observation_dim=OBS, action_dim=ACT,
                             hidden=(16, 16), module_class=tmod)
    jlr = jcls(jspec, config, seed=0, num_devices=num_devices)
    tlr = tcls(tspec, config, seed=0, num_devices=num_devices, device="cpu")
    weights = rl_module_params_from_jax(jlr.get_weights(), tspec)
    state = {"weights": weights}
    if hasattr(jlr, "target_params"):
        state["target_params"] = weights
    tlr.set_state(state)
    return jlr, tlr, tspec


@pytest.mark.parametrize("name", sorted(CASES))
def test_update_matches_jax(name):
    jlr, tlr, tspec = _learners(name)
    batch = CASES[name][5]()
    for _ in range(2):  # the second update also tests Adam's bias terms
        check_stats(jlr.update_from_batch(batch),
                     tlr.update_from_batch(batch))
        check_weights(jlr.params, tspec, tlr.get_weights())
    if name.startswith("dqn"):
        # target_update_freq 1 syncs after every update, 100 never here
        check_weights(jlr.target_params, tspec,
                       trm.params_to_numpy(tlr.target))
        np.testing.assert_allclose(jlr.td_errors(batch),
                                   tlr.td_errors(batch), rtol=0, atol=TOL)


def test_ppo_num_devices_4_trims_66_rows_as_jax():
    """JAX shards the batch over a 4-device dp mesh (66 rows -> 64); the
    port keeps those batch semantics on its one device."""
    jlr, tlr, tspec = _learners("ppo", num_devices=4)
    batch = rows(66, 8)
    check_stats(jlr.update_from_batch(batch), tlr.update_from_batch(batch))
    check_weights(jlr.params, tspec, tlr.get_weights())
    # the trimmed update is the port's own 64-row update
    _, one, _ = _learners("ppo")
    _, four, _ = _learners("ppo", num_devices=4)
    assert one.update_from_batch({k: v[:64] for k, v in batch.items()}) \
        == four.update_from_batch(batch)
    # fewer rows than devices tile up to one row per device
    small = {k: v[:3] for k, v in batch.items()}
    check_stats(jlr.update_from_batch(small), tlr.update_from_batch(small))


def test_gradients_then_apply_equal_one_update():
    """The LearnerGroup path (compute_gradients, host average,
    apply_gradients) takes the same step as update_from_batch; the
    gradients equal the JAX learner's."""
    jlr, tlr, tspec = _learners("ppo")
    _, other, _ = _learners("ppo")
    batch = rows(B, 9)
    jgrads, jstats = jlr.compute_gradients(batch)
    grads, stats = tlr.compute_gradients(batch)
    check_stats(jstats, stats)
    check_weights(jgrads, tspec, grads)
    tlr.apply_gradients(grads)
    other.update_from_batch(batch)
    for k, w in other.get_weights().items():
        np.testing.assert_array_equal(w, tlr.get_weights()[k])
    st = tlr.get_state()["opt_state"]
    assert st["count"] == 1
    for part in ("mu", "nu"):
        for k, v in other.get_state()["opt_state"][part].items():
            np.testing.assert_array_equal(v, st[part][k])


def test_state_round_trip_continues_the_same_trajectory():
    _, a, spec = _learners("dqn")
    for seed in (10, 11):
        a.update_from_batch(rows(B, seed))
    b = tl.DQNLearner(spec, CASES["dqn"][4], seed=7, device="cpu")
    b.set_state(a.get_state())
    batch = rows(B, 12)
    check_stats(a.update_from_batch(batch), b.update_from_batch(batch),
                 {k: 0.0 for k in ("total_loss", "grad_norm")})
    for k, w in a.get_weights().items():
        np.testing.assert_array_equal(w, b.get_weights()[k])


def test_learner_defaults_to_the_card():
    spec = trm.RLModuleSpec(observation_dim=OBS, action_dim=ACT)
    if torch.cuda.is_available():
        assert tl.PPOLearner(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.PPOLearner(spec)
