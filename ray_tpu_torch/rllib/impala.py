"""IMPALA: async actor-learner RL (port of ray_tpu/rllib/impala.py).

`_VTraceLearner` is one V-trace SGD step over a time-major fragment
(`vtrace.py`): one forward over the fragment's T*B observations and the
B bootstrap observations together (the MLP or the Nature-CNN, by the
observation's shape), the loss, a backward and `ClipAdam`'s step.  With
`use_lstm` the model is the recurrent actor-critic: `apply_seq` over the
time-major fragment from its `state_in` with the carry zeroed at its
`resets`, and `step` from `bootstrap_state` for the bootstrap value.
With `clip_param` set the policy loss is APPO's clipped surrogate on
the V-trace advantages.

The reference's learner has no donation, so the driver may read the
weights while `LearnerThread` steps.  Here the optimizer updates the
params in place, so its step and every read of the weights hold the
learner's lock: a read never sees half an update.

Data-parallel (`mesh` with `data` = k > 1, on each rank of a process
group): each rank takes its B / k columns of the time-major [T, B]
fragment (and its rows of `bootstrap_obs`), and the gradients and
metrics are averaged over `data`; V-trace is per sequence, so the slice
is exact.

`IMPALA` needs the caller's runtime handle (`.resources(runtime=...)`):
its rollout workers are remote by construction.  With
`.resources(learner_mesh=...)` its learner is a learner group
(`learner_group.py`) of data-parallel ranks.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import (ClipAdam, DataParallel,
                                         batch_tensors, learner_state,
                                         set_learner_state)
from ray_tpu_torch.rllib.learner_group import learner_for, picklable_config
from ray_tpu_torch.rllib.models import make_model, make_recurrent_model
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.vtrace import vtrace
from ray_tpu_torch.rllib.worker_set import WorkerSet


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.lr = 6e-4
        self.grad_clip = 40.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho_threshold = 1.0
        self.clip_c_threshold = 1.0
        self.broadcast_interval = 1       # updates between weight broadcasts
        self.learner_queue_size = 16
        self.min_updates_per_step = 1


class _VTraceLearner:
    """One V-trace SGD step per time-major fragment; `device=None` means
    CUDA."""

    def __init__(self, obs_dim, num_actions: int, cfg: IMPALAConfig,
                 hidden, seed: int, mesh=None, device: DeviceLike = None):
        self.dp = DataParallel(mesh, "_VTraceLearner")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.recurrent = bool(getattr(cfg, "use_lstm", False))
        if self.recurrent:
            self.model = make_recurrent_model(
                obs_dim, num_actions, hidden, getattr(cfg, "lstm_size", 64),
                seed=seed, device=self.device)
        else:
            self.model = make_model(obs_dim, num_actions, hidden, seed=seed,
                                    device=self.device)
        self.opt = ClipAdam(self.model.parameters(), cfg.lr, cfg.grad_clip)
        self.num_updates = 0
        self._lock = threading.Lock()

    def loss(self, batch: Dict[str, torch.Tensor]):
        """(total, metrics) of one time-major fragment of tensors."""
        cfg = self.cfg
        obs = batch[SampleBatch.OBS]      # [T, B, D] or [T, B, H, W, C]
        T, B = obs.shape[:2]
        if self.recurrent:
            logits, values = self.model.apply_seq(obs, batch["state_in"],
                                                  batch["resets"])
            _, bootstrap_value, _ = self.model.step(
                batch["bootstrap_obs"], batch["bootstrap_state"])
        else:
            flat = torch.cat([obs.reshape((T * B,) + obs.shape[2:]),
                              batch["bootstrap_obs"].to(obs.dtype)])
            logits, values = self.model(flat)
            bootstrap_value = values[T * B:]
            logits = logits[:T * B].reshape(T, B, -1)
            values = values[:T * B].reshape(T, B)

        logp_all = F.log_softmax(logits, dim=-1)
        actions = batch[SampleBatch.ACTIONS].long()
        target_logp = logp_all.gather(-1, actions[..., None])[..., 0]

        done = (batch[SampleBatch.TERMINATEDS]
                | batch[SampleBatch.TRUNCATEDS]).float()
        discounts = cfg.gamma * (1.0 - done)
        behavior_logp = batch[SampleBatch.ACTION_LOGP]
        vt = vtrace(behavior_logp, target_logp, batch[SampleBatch.REWARDS],
                    discounts, values, bootstrap_value,
                    cfg.clip_rho_threshold, cfg.clip_c_threshold)

        clip_param = getattr(cfg, "clip_param", None)
        if clip_param is not None:
            ratio = torch.exp(target_logp - behavior_logp)
            adv = vt.pg_advantages
            surr = torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
            pg_loss = -surr.mean()
        else:
            pg_loss = -(vt.pg_advantages * target_logp).mean()
        vf_loss = 0.5 * ((vt.vs - values) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pg_loss + cfg.vf_loss_coeff * vf_loss \
            - cfg.entropy_coeff * entropy
        return total, {"total_loss": total, "policy_loss": pg_loss,
                       "vf_loss": vf_loss, "entropy": entropy}

    def _columns(self, tb: Dict[str, torch.Tensor]) -> Dict[str,
                                                           torch.Tensor]:
        """This replica's B / k columns of a time-major fragment (rows of
        `bootstrap_obs`)."""
        k, i = self.dp.k, self.dp.index
        if k == 1:
            return tb
        out = {}
        for key, v in tb.items():
            axis = 0 if key == "bootstrap_obs" else 1
            n = v.shape[axis] // k
            out[key] = v.narrow(axis, i * n, n)
        return out

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        total, metrics = self.loss(self._columns(batch_tensors(
            batch, self.device)))
        grads = list(torch.autograd.grad(total, self.opt.params))
        keys = list(metrics)
        means = collectives.all_reduce_mean(
            grads + [metrics[k].detach() for k in keys], self.dp.group)
        with self._lock:
            self.opt.step(means[:len(grads)])
            self.num_updates += 1
        values = torch.stack(means[len(grads):]).tolist()
        return dict(zip(keys, values))

    def get_weights(self):
        with self._lock:
            return convert.actor_critic_variables(self.model)

    def get_state(self):
        return learner_state(self)

    def set_state(self, state):
        set_learner_state(self, state)


class LearnerThread(threading.Thread):
    """Consumes fragments from a queue, runs SGD continuously.

    Reference: rllib/execution/learner_thread.py:17.
    """

    def __init__(self, learner: _VTraceLearner, queue_size: int):
        super().__init__(daemon=True, name="impala-learner")
        self.learner = learner
        self.inqueue: queue.Queue = queue.Queue(maxsize=queue_size)
        self.last_metrics: Dict[str, float] = {}
        self.stopped = False
        self._error: Optional[BaseException] = None

    def run(self) -> None:
        while not self.stopped:
            batch = self.inqueue.get()
            if batch is None:
                return
            try:
                self.last_metrics = self.learner.update(batch)
            except Exception as e:  # surfaced in training_step
                self._error = e
                return

    def stop(self) -> None:
        self.stopped = True
        try:
            self.inqueue.put_nowait(None)
        except queue.Full:
            pass

    def check_error(self) -> None:
        if self._error is not None:
            raise self._error


class IMPALA(Algorithm):
    def setup(self) -> None:
        cfg = self.config
        if cfg.runtime is None:
            raise ValueError("IMPALA's rollout workers are remote: pass "
                             "config.resources(runtime=ray_tpu)")
        recurrent = ({"policy_kind": "recurrent", "lstm_size": cfg.lstm_size}
                     if cfg.use_lstm else {})
        self.workers = WorkerSet(
            num_workers=max(cfg.num_rollout_workers, 1), runtime=cfg.runtime,
            num_cpus_per_worker=cfg.num_cpus_per_worker,
            worker_kwargs=self.worker_kwargs(postprocess=False, **recurrent))
        self.learner = learner_for(
            _VTraceLearner, self.obs_dim, self.num_actions,
            picklable_config(cfg), cfg.model_hidden, cfg.seed,
            device=cfg.device,
            mesh=cfg.learner_mesh)
        self.workers.sync_weights(self.learner.get_weights())
        self.learner_thread = LearnerThread(
            self.learner, cfg.learner_queue_size)
        self.learner_thread.start()
        self._inflight: Dict[Any, Any] = {}   # ref -> worker
        self._updates_at_broadcast = 0

    def _launch(self, worker) -> None:
        self._inflight[worker.sample.remote()] = worker

    def training_step(self) -> Dict[str, Any]:
        """Reference: impala.py training_step — async sample -> learner
        queue -> periodic broadcast."""
        cfg = self.config
        rt = cfg.runtime
        self.learner_thread.check_error()
        for w in self.workers.remote_workers:
            if w not in self._inflight.values():
                self._launch(w)

        updates_before = self.learner.num_updates
        fragments = 0
        episodes = 0
        # Drain until the learner has made progress this step.
        while (self.learner.num_updates - updates_before
               < cfg.min_updates_per_step):
            self.learner_thread.check_error()
            ready, _ = rt.wait(list(self._inflight), num_returns=1,
                               timeout=10.0)
            for ref in ready:
                worker = self._inflight.pop(ref)
                try:
                    batch, metrics = rt.get(ref)
                except Exception:
                    worker = self.workers.replace_worker(worker)
                    self._launch(worker)
                    continue
                episodes += self._record_metrics([metrics])
                fragments += 1
                # Bounded put with error polling: if the learner thread
                # died with the queue full, a bare put() would deadlock
                # the driver instead of surfacing the learner exception.
                while True:
                    self.learner_thread.check_error()
                    if self.learner_thread.stopped:
                        return {"fragments_this_iter": fragments,
                                "episodes_this_iter": episodes,
                                "learner_updates_total":
                                    self.learner.num_updates}
                    try:
                        self.learner_thread.inqueue.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue
                # Broadcast the newest weights to the worker that just
                # delivered, then relaunch it.
                if (self.learner.num_updates - self._updates_at_broadcast
                        >= cfg.broadcast_interval):
                    ref_w = rt.put(self.learner.get_weights())
                    worker.set_weights.remote(ref_w)
                    self._updates_at_broadcast = self.learner.num_updates
                self._launch(worker)

        self.workers.local_worker.set_weights(self.learner.get_weights())
        return {"fragments_this_iter": fragments,
                "episodes_this_iter": episodes,
                "learner_updates_total": self.learner.num_updates,
                **{f"learner/{k}": v
                   for k, v in self.learner_thread.last_metrics.items()}}

    def stop(self) -> None:
        self.learner_thread.stop()
        super().stop()

    def save_to_dict(self) -> Dict[str, Any]:
        return {"learner_state": self.learner.get_state(),
                "config": self.config.to_dict()}

    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        self.learner.set_state(state["learner_state"])
        self.workers.sync_weights(self.learner.get_weights())
