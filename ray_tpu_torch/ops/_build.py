"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

into `ray_tpu_torch/_build/` (git-ignored).  The library's name carries
a hash of its source and the flags, so an edited kernel rebuilds and an
unchanged one is reused.  A failed build raises with nvcc's output;
nothing falls back.  No PyTorch header is compiled, so a build takes
seconds.  `build_all` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of ray_tpu_torch "
                           "build only where the CUDA toolkit is installed")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on `csrc/<name>.cu` unless it is built already; returns
    (target, tmp, process) with process None when there is nothing to do."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".so.tmp.{os.getpid()}")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp, proc) -> Path:
    if proc is None:
        return target
    output, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{output}")
    os.replace(tmp, target)
    return target


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless it is built already; returns the
    .so path."""
    return _finish(name, *_start(name))


def build_all() -> List[Path]:
    """Compile every `csrc/*.cu`, one nvcc each, all started together."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = [(name, _start(name)) for name in names]
    built, failed = [], []
    for name, job in started:          # wait for every nvcc, then raise
        try:
            built.append(_finish(name, *job))
        except RuntimeError as exc:
            failed.append(str(exc))
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
