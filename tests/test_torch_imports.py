"""The port's import rule, held in tier-1: every module of
`ray_tpu_torch/` and `chip_smoke.py` import nothing of JAX and nothing
of the JAX package (`ray_tpu`), in a fresh interpreter."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import ray_tpu_torch
names = ["ray_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                          "ray_tpu_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
roots = {m.split(".")[0] for m in sys.modules}
print(json.dumps({"modules": names,
                  "forbidden": sorted(roots & {"jax", "jaxlib", "ray_tpu"})}))
"""


def test_port_and_chip_smoke_import_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    for name in ("ray_tpu_torch.parallel.mesh",
                 "ray_tpu_torch.parallel.pipeline",
                 "ray_tpu_torch.train.pipeline_stage",
                 "ray_tpu_torch.train.pipeline_trainer"):
        assert name in got["modules"]
    assert got["forbidden"] == [], got["forbidden"]
