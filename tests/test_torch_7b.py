"""The 7B configs (llama2-7b, llama3-8b, gpt 7b) of the port against the
JAX package's, with nothing allocated at 7B: the port's `init_params`
runs under `FakeTensorMode` (shapes only), the reference's under
`jax.eval_shape`.

- every field of each config equals the reference's (the reference's
  `scan_unroll`, a `lax.scan` knob, has no counterpart);
- every leaf the port's init draws has the reference's shape, in the
  tree `param_shapes` gives, and `num_params` is the reference's;
- on fsdp = 4 every leaf's shard, at each of the 4 positions, has the
  shape of the reference's `NamedSharding.shard_shape` on 4 of the 8
  virtual CPU devices (the slice `MeshPlan.init_leaf` keeps, taken by
  `sharding.local_index` on the family's `param_specs`).
"""

import types

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import (MeshConfig as JMeshConfig,
                              create_mesh as jcreate_mesh)
from ray_tpu.parallel.sharding import tree_shardings as jtree_shardings
from ray_tpu_torch.models import gpt, llama
from ray_tpu_torch.parallel.mesh import AXES
from ray_tpu_torch.parallel.sharding import local_index, tree_shardings

CONFIGS = [("llama2-7b", jllama, llama), ("llama3-8b", jllama, llama),
           ("7b", jgpt, gpt)]
FSDP = 4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _drawn_shapes(tmod, config) -> dict:
    """{path: shape} of every leaf the port's init draws, in draw
    order, under FakeTensorMode (nothing allocated)."""
    shapes = {}
    with FakeTensorMode():
        tmod.init_params(config, torch.Generator().manual_seed(0),
                         keep=lambda path, t: shapes.setdefault(
                             path, tuple(t.shape)))
    return shapes


def _reference_shapes(jmod, config) -> dict:
    tree = jax.eval_shape(lambda key: jmod.init_params(config, key),
                          jax.random.key(0))
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("name,jmod,tmod", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_config_fields_equal_the_reference(name, jmod, tmod):
    want, got = jmod.CONFIGS[name], tmod.CONFIGS[name]
    fields = {f.name for f in got.__dataclass_fields__.values()}
    assert {f for f in want.__dataclass_fields__} - fields == \
        {"scan_unroll"}
    for field in fields:
        value, ref = getattr(got, field), getattr(want, field)
        if field == "dtype":
            assert str(value).removeprefix("torch.") == np.dtype(ref).name
        else:
            assert value == ref, field
    assert got.remat and got.head_dim == want.head_dim


@pytest.mark.parametrize("name,jmod,tmod", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_leaf_shapes_and_count_equal_the_reference(name, jmod, tmod):
    config = tmod.CONFIGS[name]
    want = _reference_shapes(jmod, jmod.CONFIGS[name])
    drawn = _drawn_shapes(tmod, config)
    assert drawn == want
    assert _flat(tmod.param_shapes(config)) == want
    assert tmod.num_params(config) == jmod.num_params(jmod.CONFIGS[name]) \
        == sum(int(np.prod(s)) for s in want.values())


@pytest.mark.parametrize("name,jmod,tmod", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_fsdp4_shard_shapes_equal_the_reference(name, jmod, tmod):
    config, jconfig = tmod.CONFIGS[name], jmod.CONFIGS[name]
    jmesh = jcreate_mesh(JMeshConfig(data=1, fsdp=FSDP),
                         devices=jax.devices()[:FSDP])
    jshard = _flat(jtree_shardings(jmesh, jmod.param_specs(jconfig)))
    sizes = [FSDP if a == "fsdp" else 1 for a in AXES]
    mesh = types.SimpleNamespace(mesh_dim_names=AXES,
                                 mesh=np.empty(sizes))
    specs = _flat(tree_shardings(mesh, tmod.param_specs(config)))
    for path, shape in _drawn_shapes(tmod, config).items():
        want = tuple(jshard[path].shard_shape(shape))
        for i in range(FSDP):
            coordinate = [i if a == "fsdp" else 0 for a in AXES]
            index = local_index(shape, specs[path].spec, mesh, coordinate)
            assert tuple(s.stop - s.start for s in index) == want, \
                (path, i)
