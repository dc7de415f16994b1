"""Policy server + client: RL for environments that live outside the
cluster (games, simulators, real systems); port of
ray_tpu/rllib/policy_server.py.

The server hosts the current policy (a `TorchPolicy` on `device`, None
-> CUDA) for inference, accumulates the episodes the clients drive
(start_episode / get_action / log_returns / end_episode), and hands
completed experience to the algorithm as SampleBatches — external envs
replace rollout workers as the sample source.

Transport is plain HTTP/JSON over the standard library (urllib client,
http.server on a thread) so external processes need zero dependencies.
GAE postprocessing happens server-side at episode end, matching the
rollout worker's math.
"""

from __future__ import annotations

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae


class _Episode:
    def __init__(self):
        self.obs: List[np.ndarray] = []
        self.actions: List[int] = []
        self.logp: List[float] = []
        self.vf: List[float] = []
        self.rewards: List[float] = []
        self.total_reward = 0.0


class PolicyServer:
    """Serves actions to external envs; collects their episodes.

    Endpoints (JSON bodies):
      POST /start_episode              -> {episode_id}
      POST /get_action {episode_id, obs}        -> {action}
      POST /log_returns {episode_id, reward}    -> {}
      POST /end_episode {episode_id, obs}       -> {}
    """

    def __init__(self, obs_dim: int, num_actions: int, *,
                 hidden=(64, 64), seed: int = 0, gamma: float = 0.99,
                 lam: float = 0.95, host: str = "127.0.0.1", port: int = 0,
                 device: DeviceLike = None):
        self.policy = TorchPolicy(obs_dim, num_actions, hidden, seed=seed,
                                  device=device)
        self.gamma, self.lam = gamma, lam
        self._episodes: Dict[str, _Episode] = {}
        self._completed: List[SampleBatch] = []
        self._returns: List[float] = []
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                try:
                    out = outer._dispatch(self.path, body)
                    data = json.dumps(out).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001
                    data = json.dumps({"error": str(e)}).encode()
                    self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self.address = f"http://{host}:{self.port}"
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="policy-server").start()

    # -- protocol ----------------------------------------------------------

    def _dispatch(self, path: str, body: dict) -> dict:
        if path == "/start_episode":
            eid = uuid.uuid4().hex[:12]
            with self._lock:
                self._episodes[eid] = _Episode()
            return {"episode_id": eid}
        eid = body["episode_id"]
        with self._lock:
            ep = self._episodes.get(eid)
        if ep is None:
            raise ValueError(f"unknown episode {eid}")
        if path == "/get_action":
            obs = np.asarray(body["obs"], np.float32)
            a, logp, vf, _ = self.policy.compute_actions(obs[None])
            with self._lock:
                ep.obs.append(obs)
                ep.actions.append(int(a[0]))
                ep.logp.append(float(logp[0]))
                ep.vf.append(float(vf[0]))
            return {"action": int(a[0])}
        if path == "/log_returns":
            with self._lock:
                ep.rewards.append(float(body["reward"]))
                ep.total_reward += float(body["reward"])
            return {}
        if path == "/end_episode":
            with self._lock:
                self._episodes.pop(eid, None)
            self._finish_episode(ep)
            return {}
        raise ValueError(f"unknown endpoint {path}")

    def _finish_episode(self, ep: _Episode) -> None:
        steps = min(len(ep.obs), len(ep.rewards))
        if steps == 0:
            return
        rewards = np.asarray(ep.rewards[:steps], np.float32)[:, None]
        values = np.asarray(ep.vf[:steps], np.float32)[:, None]
        dones = np.zeros((steps, 1), np.float32)
        dones[-1, 0] = 1.0   # episode ended -> no bootstrap past the end
        adv, targets = compute_gae(rewards, values, dones,
                                   np.zeros(1, np.float32),
                                   self.gamma, self.lam)
        batch = SampleBatch({
            SampleBatch.OBS: np.stack(ep.obs[:steps]),
            SampleBatch.ACTIONS: np.asarray(ep.actions[:steps], np.int32),
            SampleBatch.ACTION_LOGP: np.asarray(ep.logp[:steps],
                                                np.float32),
            SampleBatch.VF_PREDS: values[:, 0],
            SampleBatch.ADVANTAGES: adv[:, 0],
            SampleBatch.VALUE_TARGETS: targets[:, 0],
        })
        with self._lock:
            self._completed.append(batch)
            self._returns.append(ep.total_reward)

    # -- training-side API -------------------------------------------------

    def to_sample_batch(self, min_rows: int = 1
                        ) -> Optional[Tuple[SampleBatch, List[float]]]:
        """Drain completed episodes; None until min_rows accumulated."""
        with self._lock:
            rows = sum(b.count for b in self._completed)
            if rows < min_rows:
                return None
            batches, self._completed = self._completed, []
            returns, self._returns = self._returns, []
        return SampleBatch.concat_samples(batches), returns

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def get_weights(self):
        return self.policy.get_weights()

    def stop(self) -> None:
        self._httpd.shutdown()


class PolicyClient:
    """External-env side — stdlib only, so any process can drive
    training without installing this framework."""

    def __init__(self, address: str, timeout: float = 30.0):
        self.address = address.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, body: dict) -> dict:
        import urllib.request
        req = urllib.request.Request(
            self.address + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def start_episode(self) -> str:
        return self._post("/start_episode", {})["episode_id"]

    def get_action(self, episode_id: str, obs) -> int:
        return self._post("/get_action", {
            "episode_id": episode_id,
            "obs": np.asarray(obs, np.float32).tolist()})["action"]

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._post("/log_returns", {"episode_id": episode_id,
                                    "reward": float(reward)})

    def end_episode(self, episode_id: str, obs) -> None:
        self._post("/end_episode", {
            "episode_id": episode_id,
            "obs": np.asarray(obs, np.float32).tolist()})
