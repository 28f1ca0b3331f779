"""ray_tpu_torch.rllib — reinforcement learning on the new API stack.

Port of `ray_tpu/rllib/` to PyTorch. Reference: `rllib/` (new stack only:
RLModule / Learner / EnvRunner / ConnectorV2). RLModules are nn.Modules;
a learner's update is one compiled step (a CUDA graph per batch shape on
the card); env runners sample on the host's CPU, locally or as actors of
the port's runtime; learners scale as learner actors, one per card.
Importing the package imports no gymnasium: only an env given by its
gymnasium id does (`AlgorithmConfig.env_creator`).
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig, MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import (
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.core.learner import (
    DQNLearner,
    IMPALALearner,
    Learner,
    PPOLearner,
)
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (
    ActorCriticModule,
    Columns,
    QModule,
    RLModule,
    RLModuleSpec,
)
from ray_tpu_torch.rllib.env.multi_agent import (
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentEnvRunnerGroup,
)
from ray_tpu_torch.rllib.env.env_runner import (
    EnvRunnerGroup,
    Episode,
    SingleAgentEnvRunner,
)

__all__ = [
    "Algorithm", "AlgorithmConfig", "APPO", "APPOConfig",
    "CQL", "CQLConfig", "PPO", "PPOConfig", "DQN",
    "DQNConfig", "IMPALA", "IMPALAConfig", "BC", "BCConfig", "MARWIL",
    "MARWILConfig", "SAC", "SACConfig", "Learner", "PPOLearner",
    "DQNLearner", "IMPALALearner", "LearnerGroup",
    "RLModule", "RLModuleSpec", "ActorCriticModule", "QModule",
    "Columns", "EnvRunnerGroup", "SingleAgentEnvRunner", "Episode",
    "MultiAgentPPO", "MultiAgentPPOConfig", "MultiAgentEnv",
    "MultiAgentEnvRunner", "MultiAgentEnvRunnerGroup",
]
