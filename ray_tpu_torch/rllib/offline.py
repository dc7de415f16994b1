"""Offline RL: experience IO and behaviour cloning (port of
ray_tpu/rllib/offline.py).

- `JsonWriter` / `JsonReader`: SampleBatches as JSON lines, each column
  base64 bytes with its dtype and shape; the files are the reference's
  byte for byte, so either package reads what the other wrote.
- `ParquetWriter` (pyarrow, imported when a batch is written) and
  `DatasetReader` over any dataset with `iter_batches`.  The Data layer
  reaches the port as a runtime handle (`runtime.data.read_parquet`,
  `runtime.data.from_items`), never an import.
- `BC`: supervised max-likelihood of the logged actions on the
  reference's `ActorCritic`, with plain Adam (optax.adam: eps 1e-8, no
  clip) on `device` (None -> CUDA).  Its weights are drawn from a CPU
  `torch.Generator` (the caller's, or one seeded with the config's
  seed); minibatch orders come from numpy's default_rng(seed), as the
  reference draws them, so the two packages visit the same rows.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.models import make_model
from ray_tpu_torch.rllib.sac import plain_adam
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _encode_array(arr: np.ndarray) -> dict:
    return {"__npy__": base64.b64encode(
        np.ascontiguousarray(arr).tobytes()).decode(),
        "dtype": str(arr.dtype), "shape": list(arr.shape)}


def _decode_array(obj: dict) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(obj["__npy__"]),
        dtype=np.dtype(obj["dtype"])).reshape(obj["shape"]).copy()


class JsonWriter:
    """Append SampleBatches as JSON lines, a new file past
    `max_file_size` bytes."""

    def __init__(self, path: str, max_file_size: int = 64 << 20):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._max = max_file_size
        self._index = 0
        self._file = None

    def _rotate(self):
        if self._file is not None:
            self._file.close()
        name = os.path.join(self.path, f"output-{self._index:05d}.json")
        self._index += 1
        self._file = open(name, "a")

    def write(self, batch: SampleBatch) -> None:
        if self._file is None or self._file.tell() > self._max:
            self._rotate()
        record = {k: _encode_array(np.asarray(v)) for k, v in batch.items()}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class JsonReader:
    """Iterate SampleBatches back from a JsonWriter directory."""

    def __init__(self, path: str):
        self.path = path
        self._files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".json"))
        if not self._files:
            raise ValueError(f"no .json experience files under {path!r}")

    def __iter__(self) -> Iterator[SampleBatch]:
        for fname in self._files:
            with open(fname) as f:
                for line in f:
                    if not line.strip():
                        continue
                    record = json.loads(line)
                    yield SampleBatch({k: _decode_array(v)
                                       for k, v in record.items()})

    def read_all(self) -> SampleBatch:
        return SampleBatch.concat_samples(list(self))

    def to_dataset(self, runtime: Any):
        """The experiences as a dataset of rows, built by the runtime
        handle's Data layer (`runtime.data.from_items`)."""
        rows: List[Dict[str, Any]] = []
        for batch in self:
            for i in range(batch.count):
                rows.append({k: np.asarray(v[i]).tolist()
                             for k, v in batch.items()})
        return runtime.data.from_items(rows)


class ParquetWriter:
    """Append SampleBatches as Parquet files.  Multi-dimensional columns
    (observations) are stored as nested lists; shapes reconstruct on
    read."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._index = 0

    def write(self, batch: SampleBatch) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq
        cols = {}
        for k, v in batch.items():
            arr = np.asarray(v)
            cols[k] = (arr.tolist() if arr.ndim > 1 else arr)
        table = pa.table(cols)
        pq.write_table(table, os.path.join(
            self.path, f"part-{self._index:05d}.parquet"))
        self._index += 1

    def close(self) -> None:
        pass


def _numpy_batch_to_sample(batch: Dict[str, Any]) -> SampleBatch:
    out = {}
    for k, v in batch.items():
        arr = np.asarray(v)
        if arr.dtype == object:          # nested-list column -> ndarray
            arr = np.asarray([np.asarray(x) for x in v])
        out[k] = arr
    return SampleBatch(out)


class DatasetReader:
    """Stream SampleBatches out of a dataset (any object with
    `iter_batches(batch_size=, batch_format="numpy")`): the learner never
    materializes the whole log."""

    def __init__(self, dataset, batch_size: int = 1024):
        self._ds = dataset
        self._batch_size = batch_size

    @classmethod
    def from_path(cls, path: str, batch_size: int = 1024, *,
                  runtime: Any) -> "DatasetReader":
        """Parquet files under `path`, read by the runtime handle's Data
        layer (`runtime.data.read_parquet`)."""
        return cls(runtime.data.read_parquet(path), batch_size)

    def __iter__(self) -> Iterator[SampleBatch]:
        for b in self._ds.iter_batches(batch_size=self._batch_size,
                                       batch_format="numpy"):
            yield _numpy_batch_to_sample(b)

    def read_all(self) -> SampleBatch:
        return SampleBatch.concat_samples(list(self))


class OfflineLearner:
    """The shell BC, MARWIL and CQL share: an `ActorCritic` on `device`
    (None -> CUDA) whose logits head is the policy (or Q), plain Adam,
    and numpy's default_rng(seed) for minibatch orders."""

    def __init__(self, obs_dim: int, num_actions: int, config, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = resolve_device(device)
        self.model = make_model(obs_dim, num_actions, config.model_hidden,
                                seed=config.seed, device=self.device,
                                generator=generator)
        self.opt = plain_adam(self.model.parameters(), config.lr)
        self._rng = np.random.default_rng(config.seed)

    def _tensor(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=dtype, device=self.device)

    def _minibatches(self, n: int) -> Iterator[torch.Tensor]:
        """num_epochs of shuffled row indices on the device, in minibatches
        of train_batch_size, each epoch's order one draw of the numpy
        generator."""
        size = self.config.train_batch_size
        for _ in range(self.config.num_epochs):
            perm = self._tensor(self._rng.permutation(n))
            for lo in range(0, n, size):
                yield perm[lo:lo + size]

    def _apply(self, loss: torch.Tensor) -> None:
        """One Adam step on the loss's gradients; parameters the loss does
        not reach (BC's and CQL's value trunk) get zeros, as jax.grad
        gives them."""
        self.opt.step(torch.autograd.grad(loss, self.opt.params,
                                          materialize_grads=True))

    @torch.no_grad()
    def _logits(self, obs: np.ndarray) -> torch.Tensor:
        return self.model(self._tensor(np.asarray(obs, np.float32)))[0]

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        return self._logits(obs).argmax(-1).cpu().numpy()

    def get_weights(self):
        return convert.actor_critic_variables(self.model)


def nll(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[action], per row."""
    return -F.log_softmax(logits, -1).gather(1, actions[:, None])[:, 0]


class BCConfig:
    """Behavior cloning config."""

    def __init__(self):
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_epochs = 1
        self.model_hidden = (64, 64)
        self.seed = 0


class BC(OfflineLearner):
    """Behavior cloning: supervised max-likelihood on logged actions
    (MARWIL with beta 0)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 config: Optional[BCConfig] = None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(obs_dim, num_actions, config or BCConfig(),
                         device=device, generator=generator)

    def loss(self, obs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        logits, _ = self.model(obs)
        return nll(logits, actions).mean()

    def train_on(self, batch: SampleBatch) -> Dict[str, float]:
        """num_epochs of minibatch SGD over the logged experiences."""
        obs = np.asarray(batch[SampleBatch.OBS], np.float32)
        actions = np.asarray(batch[SampleBatch.ACTIONS])
        if obs.ndim > 2:  # time-major fragments flatten to rows
            obs = obs.reshape(-1, obs.shape[-1])
            actions = actions.reshape(-1)
        obs_t = self._tensor(obs)
        act_t = self._tensor(actions, torch.long)
        last = torch.zeros(())
        for idx in self._minibatches(len(obs)):
            last = self.loss(obs_t[idx], act_t[idx])
            self._apply(last)
        return {"bc_loss": float(last.detach()), "samples": len(obs)}
