"""ray_tpu_torch.rllib — the RL library of the port (port of ray_tpu/rllib/,
single-device).

Rollout workers step natively vectorized numpy envs with a torch policy
(categorical, diagonal-Gaussian, squashed-Gaussian, deterministic with
noise, or an LSTM with its state threaded); learners train the
reference's models (`models.py`) with optax's Adam written out:
`TorchLearner` for PPO (categorical, continuous and recurrent) and A2C,
`_VTraceLearner` for IMPALA and APPO (feed-forward or recurrent), and
the off-policy `_QLearner` (DQN), `_SACLearner` and `_TD3Learner` over a
replay buffer.  Offline: JSON and Parquet experience IO, `BC`, `MARWIL`
and `CQL` over logged batches, and the off-policy estimators (IS, WIS,
DM, DR, `fit_fqe`).  Multi-agent: `MultiAgentRolloutWorker` with one
policy per policy id, PPO's per-policy learners, `QMix` / VDN, and the
`PolicyServer` that external envs drive over HTTP.  Weights and batches cross the object plane as the
reference's (flax variables trees, the recurrent model's plain dict,
SampleBatches of numpy), so either package's workers and learners
interoperate.  The runtime reaches the port only as a handle that the
caller passes (`AlgorithmConfig.resources(runtime=ray_tpu)`), and so
do Tune's `report` (`Algorithm.as_trainable`) and the Data layer
(`DatasetReader.from_path`, `JsonReader.to_dataset`).

Waiting for later slices: ES / ARS, bandits and the data-parallel
learners of the multi-device slice (`learner_mesh`).
"""

from ray_tpu_torch.rllib.a2c import A2C, A2CConfig, a2c_loss  # noqa: F401
from ray_tpu_torch.rllib.algorithm import (  # noqa: F401
    Algorithm, AlgorithmConfig)
from ray_tpu_torch.rllib.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rllib.env import (  # noqa: F401
    CartPoleVector, Env, PendulumVector, RepeatPrevVector,
    SyntheticPixelVector, VectorEnv, make_vector_env, register_env)
from ray_tpu_torch.rllib.estimators import (  # noqa: F401
    ESTIMATORS, DirectMethod, DoublyRobust, ImportanceSampling,
    WeightedImportanceSampling, fit_fqe, split_episodes)
from ray_tpu_torch.rllib.impala import (  # noqa: F401
    IMPALA, IMPALAConfig, LearnerThread)
from ray_tpu_torch.rllib.learner import (  # noqa: F401
    ClipAdam, TorchLearner, ppo_loss, ppo_loss_continuous,
    ppo_loss_recurrent)
from ray_tpu_torch.rllib.marwil import (  # noqa: F401
    MARWIL, MARWILConfig, compute_mc_returns)
from ray_tpu_torch.rllib.models import (  # noqa: F401
    ActorCritic, ConvActorCritic, DeterministicActor, GaussianActorCritic,
    QNetwork, RecurrentActorCritic, SquashedGaussianActor, gaussian_logp,
    make_continuous_model, make_model, make_offpolicy_model,
    make_recurrent_model)
from ray_tpu_torch.rllib.multi_agent import (  # noqa: F401
    CooperativeMatchEnv, MultiAgentBatch, MultiAgentRolloutWorker,
    MultiAgentVectorEnv, make_multi_agent_env, register_multi_agent_env)
from ray_tpu_torch.rllib.offline import (  # noqa: F401
    BC, BCConfig, DatasetReader, JsonReader, JsonWriter, ParquetWriter)
from ray_tpu_torch.rllib.policy import (  # noqa: F401
    DeterministicNoiseRolloutPolicy, RecurrentTorchPolicy,
    SquashedGaussianRolloutPolicy, TorchPolicy)
from ray_tpu_torch.rllib.policy_server import (  # noqa: F401
    PolicyClient, PolicyServer)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.qmix import (  # noqa: F401
    QMix, QMixConfig, TwoStepGameEnv, VDNConfig)
from ray_tpu_torch.rllib.replay_buffer import (  # noqa: F401
    PrioritizedReplayBuffer, ReplayBuffer)
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker  # noqa: F401
from ray_tpu_torch.rllib.sac import SAC, SACConfig  # noqa: F401
from ray_tpu_torch.rllib.sample_batch import (  # noqa: F401
    SampleBatch, compute_gae)
from ray_tpu_torch.rllib.td3 import TD3, TD3Config  # noqa: F401
from ray_tpu_torch.rllib.vtrace import vtrace  # noqa: F401
from ray_tpu_torch.rllib.worker_set import WorkerSet  # noqa: F401
