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

__all__ = ["Algorithm", "AlgorithmConfig", "APPO", "APPOConfig",
           "CQL", "CQLConfig", "PPO", "PPOConfig", "DQN",
           "DQNConfig", "IMPALA", "IMPALAConfig",
           "MultiAgentPPO", "MultiAgentPPOConfig", "BC", "BCConfig",
           "MARWIL", "MARWILConfig", "SAC", "SACConfig"]
