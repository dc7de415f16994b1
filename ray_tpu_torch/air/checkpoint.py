"""Checkpoint: training state as a dict (the port's copy of the dict
form of ray_tpu/air/checkpoint.py).

`Algorithm.save` returns one and `Algorithm.restore` reads any object
with `to_dict()`, so a checkpoint of either package restores in the
other: both hold the same dict of numpy trees.  The reference's
directory, sharded and temporary-directory forms are not copied; the
port's sharded format is `ray_tpu_torch.checkpoint`.
"""

from __future__ import annotations


class Checkpoint:
    def __init__(self, data: dict):
        self._data = data

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        return cls(dict(data))

    def to_dict(self) -> dict:
        return dict(self._data)

    def __repr__(self):
        return "Checkpoint(dict)"
