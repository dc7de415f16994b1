"""ray_tpu_torch.rllib — the RL library of the port (port of ray_tpu/rllib/,
single-device, feed-forward, discrete actions).

Rollout workers step natively vectorized numpy envs with a torch policy;
learners (`TorchLearner` for PPO, `_VTraceLearner` for IMPALA) train the
reference's actor-critics (`models.py`: the tanh MLP and the Nature-CNN)
with optax's clipped Adam written out.  Weights and batches cross the
object plane as the reference's (flax variables trees and SampleBatches
of numpy), so either package's workers and learners interoperate.  The
runtime reaches the port only as a handle that the caller passes
(`AlgorithmConfig.resources(runtime=ray_tpu)`).

Waiting (ROADMAP A9): continuous actions, recurrent models,
multi-agent, the other algorithms, offline and estimators, and the Tune
binding; data-parallel learners wait for the multi-device slice.
"""

from ray_tpu_torch.rllib.algorithm import (  # noqa: F401
    Algorithm, AlgorithmConfig)
from ray_tpu_torch.rllib.env import (  # noqa: F401
    CartPoleVector, Env, SyntheticPixelVector, VectorEnv, make_vector_env,
    register_env)
from ray_tpu_torch.rllib.impala import (  # noqa: F401
    IMPALA, IMPALAConfig, LearnerThread)
from ray_tpu_torch.rllib.learner import (  # noqa: F401
    ClipAdam, TorchLearner, ppo_loss)
from ray_tpu_torch.rllib.models import (  # noqa: F401
    ActorCritic, ConvActorCritic, make_model)
from ray_tpu_torch.rllib.policy import TorchPolicy  # noqa: F401
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker  # noqa: F401
from ray_tpu_torch.rllib.sample_batch import (  # noqa: F401
    SampleBatch, compute_gae)
from ray_tpu_torch.rllib.vtrace import vtrace  # noqa: F401
from ray_tpu_torch.rllib.worker_set import WorkerSet  # noqa: F401
