"""Registers, shared memory and spills of each kernel in one csrc file.

    python3 scripts/ptxas_report.py [name]      # default: flash_attention

Runs nvcc on `ray_tpu_torch/ops/csrc/<name>.cu` with the flags the port
builds it with (`ops/_build.py`) plus `-Xptxas -v`, into a scratch file
that is thrown away, and prints ptxas's lines for each kernel (mangled
names).  Dynamic shared memory is set at launch and is not in them.
Needs nvcc (the CUDA toolkit); no card.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ray_tpu_torch.ops import _build  # noqa: E402

name = sys.argv[1] if len(sys.argv) > 1 else "flash_attention"
with tempfile.TemporaryDirectory() as tmp:
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         f"{tmp}/{name}.so", str(_build.CSRC / f"{name}.cu")],
        capture_output=True, text=True)
for line in (proc.stdout + proc.stderr).splitlines():
    if any(w in line for w in ("Compiling entry", "registers", "spill")):
        print(line)
sys.exit(proc.returncode)
