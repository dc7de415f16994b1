"""Podracer: the async actor/learner control loop (port of
ray_tpu/rl/controller.py, with the runtime and the Observer injected).

A gang of versioned rollout actors (`EnvRolloutActor`) runs ahead
asynchronously; delivered fragments enter the bounded `TrajectoryQueue`
(stale-by->k batches are dropped at the door, a full queue backpressures
the producer); the stale-tolerant V-trace learner drains whatever is
admissible; and every `publish_interval` updates the new weights cross
the object plane ONCE and the gang adopts by reference.

Fault tolerance is part of the loop: a dead rollout worker is detected
at delivery, replaced, and re-adopts the CURRENT published weights
(`rl/worker_replaced`, `rl_workers_replaced`); a dead learner is rebuilt
from the newest COMMITTED checkpoint (`recover_learner()`) and the
queue, which the controller owns, is re-screened against the restored
version.

The gang is remote by construction, so `Podracer` needs the caller's
runtime handle: `PodracerConfig().resources(runtime=ray_tpu, ...)`.

The config's Observer records the driver's side: the learner's `rl/learn`
spans, the `rl/publish` spans, the queue's counters and the worker
replacements.  It does not cross into the gang's processes, so a remote
`EnvRolloutActor` records no `rl/rollout` or `rl/adopt` span; those
spans come only from actors built in the caller's process with an
observer (`EngineRolloutActor(..., observer=obs)`, or the components
called in one process, as `chip_smoke.py`'s rl_podracer phase does).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ray_tpu_torch.rl.learner import StaleTolerantLearner
from ray_tpu_torch.rl.rollout import EnvRolloutActor
from ray_tpu_torch.rl.trajectory import TrajectoryQueue
from ray_tpu_torch.rl.weights import WeightPublisher
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.worker_set import WorkerSet
from ray_tpu_torch.util.observe import NOOP


class PodracerConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=Podracer)
        self.lr = 6e-4
        self.grad_clip = 40.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho_threshold = 1.0
        self.clip_c_threshold = 1.0
        # Async-loop knobs: k=0 forces on-policy (every batch must be at
        # the learner's version — the PPO-parity configuration).
        self.staleness_bound = 1
        self.queue_capacity = 8
        self.publish_interval = 1     # learner updates between publishes
        self.min_updates_per_step = 1
        # Durability: ckpt_dir=None disables checkpointing.
        self.ckpt_dir = None
        self.ckpt_interval = 20


class Podracer(Algorithm):
    def setup(self) -> None:
        cfg = self.config
        if cfg.runtime is None:
            raise ValueError("Podracer's rollout gang is remote: pass "
                             "config.resources(runtime=ray_tpu)")
        self._obs = cfg.observer or NOOP
        self.workers = WorkerSet(
            num_workers=max(cfg.num_rollout_workers, 1), runtime=cfg.runtime,
            num_cpus_per_worker=cfg.num_cpus_per_worker,
            worker_cls=EnvRolloutActor, worker_kwargs=self.worker_kwargs())
        self.learner = self._make_learner()
        self.queue = TrajectoryQueue(cfg.queue_capacity,
                                     cfg.staleness_bound, cfg.observer)
        self.publisher = WeightPublisher(cfg.runtime, cfg.observer)
        self.publisher.publish(self.learner.get_weights(),
                               self.workers.remote_workers,
                               version=self.learner.version)
        self._inflight: Dict[Any, Any] = {}   # sample ref -> worker
        self._idle: List[Any] = []            # backpressured workers
        self._last_learner_metrics: Dict[str, float] = {}

    def _make_learner(self) -> StaleTolerantLearner:
        cfg = self.config
        return StaleTolerantLearner(
            self.obs_dim, self.num_actions, hidden=cfg.model_hidden,
            gamma=cfg.gamma, lr=cfg.lr, grad_clip=cfg.grad_clip,
            vf_loss_coeff=cfg.vf_loss_coeff,
            entropy_coeff=cfg.entropy_coeff,
            clip_rho_threshold=cfg.clip_rho_threshold,
            clip_c_threshold=cfg.clip_c_threshold, seed=cfg.seed,
            ckpt_dir=cfg.ckpt_dir, ckpt_interval=cfg.ckpt_interval,
            device=cfg.device, observer=cfg.observer)

    # -- gang management ---------------------------------------------------
    def _launch(self, worker) -> None:
        self._inflight[worker.sample_versioned.remote()] = worker

    def _launch_all_idle(self) -> None:
        # Backpressured workers restart only once the queue has room.
        while self._idle and not self.queue.full:
            self._launch(self._idle.pop())
        busy = set(map(id, self._inflight.values()))
        busy |= set(map(id, self._idle))
        for w in self.workers.remote_workers:
            if id(w) not in busy:
                self._launch(w)

    def _replace(self, worker) -> None:
        replacement = self.workers.replace_worker(worker)
        self._obs.inc("rl_workers_replaced")
        self._obs.record("rl", "worker_replaced",
                         version=self.publisher.version)
        try:
            # The re-formed worker re-adopts the CURRENT published
            # weights: no new put, the reference is still live.
            self.publisher.re_adopt(replacement)
        except Exception as e:  # surfaces at its next delivery if gone
            self._obs.record("rl", "re_adopt_failed", error=repr(e))
        self._launch(replacement)

    def _publish_boundary(self) -> None:
        version, weights = self.learner.publish_boundary()
        # wait=False: adoption lands per-actor behind whatever fragment
        # is in flight (the version boundary IS the fragment boundary).
        self.publisher.publish(weights, self.workers.remote_workers,
                               version=version, wait=False)

    def _drain_learner(self) -> int:
        cfg = self.config
        updates = 0
        while True:
            item = self.queue.get(self.learner.version, timeout=0.0)
            if item is None:
                return updates
            batch, bversion = item
            self._last_learner_metrics = self.learner.update(batch,
                                                             bversion)
            updates += 1
            if self.learner.num_updates % cfg.publish_interval == 0:
                self._publish_boundary()

    def _process_deliveries(self, block: bool) -> tuple:
        """Harvest completed sample refs: queue the batches (or hold the
        worker under backpressure) and replace workers whose refs
        surface a death.  block=False sweeps everything already done
        without waiting."""
        if not self._inflight:
            return 0, 0
        rt = self.config.runtime
        refs = list(self._inflight)
        ready, _ = rt.wait(refs, num_returns=1 if block else len(refs),
                           timeout=10.0 if block else 0.0)
        fragments = 0
        episodes = 0
        for ref in ready:
            worker = self._inflight.pop(ref)
            try:
                batch, bversion, metrics = rt.get(ref)
            except Exception:
                self._replace(worker)
                continue
            episodes += self._record_metrics([metrics])
            fragments += 1
            accepted = self.queue.put(batch, bversion,
                                      self.learner.version)
            if accepted or bversion < self.learner.version:
                # Delivered (or too stale to queue — either way the
                # worker should go sample under fresher weights).
                self._launch(worker)
            else:
                self._idle.append(worker)   # backpressure
        return fragments, episodes

    # -- training ----------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        updates_before = self.learner.num_updates
        fragments = 0
        episodes = 0
        while (self.learner.num_updates - updates_before
               < cfg.min_updates_per_step):
            self._drain_learner()
            self._launch_all_idle()
            if (self.learner.num_updates - updates_before
                    >= cfg.min_updates_per_step):
                break
            if not self._inflight:
                continue   # everything backpressured: drain again
            f, e = self._process_deliveries(block=True)
            fragments += f
            episodes += e
        f, e = self._process_deliveries(block=False)
        fragments += f
        episodes += e
        self._launch_all_idle()
        self.workers.local_worker.set_weights(self.learner.get_weights())
        return {"fragments_this_iter": fragments,
                "episodes_this_iter": episodes,
                "learner_updates_total": self.learner.num_updates,
                "policy_version": self.learner.version,
                "queue": self.queue.stats(),
                **{f"learner/{k}": v
                   for k, v in self._last_learner_metrics.items()}}

    # -- fault tolerance ---------------------------------------------------
    def recover_learner(self):
        """The killed-learner path: rebuild from the newest COMMITTED
        checkpoint (fresh optimizer + step 0 when none exists), re-screen
        the surviving queue against the restored version, and republish.
        Returns the restored update count (None for a from-scratch
        rebuild)."""
        self.learner = self._make_learner()
        restored = self.learner.restore_latest()
        self.queue.evict_stale(self.learner.version)
        self.publisher.publish(self.learner.get_weights(),
                               self.workers.remote_workers,
                               version=self.learner.version, wait=False)
        return restored

    # -- persistence -------------------------------------------------------
    def save_to_dict(self) -> Dict[str, Any]:
        return {"learner_state": self.learner.state_tree(),
                "config": self.config.to_dict()}

    def restore_from_dict(self, state: Dict[str, Any]) -> None:
        self.learner.set_state_tree(state["learner_state"])
        self.publisher.publish(self.learner.get_weights(),
                               self.workers.remote_workers,
                               version=self.learner.version)
