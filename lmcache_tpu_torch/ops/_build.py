"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``build/lmcache_tpu_torch/``
beside the package (ignored by git). The library name carries a digest of
the sources and flags, so an edited kernel is rebuilt and an unchanged one
is reused. :func:`build` starts one ``nvcc`` per source, all at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lmcache_tpu_torch"
# -fno-gnu-unique: g++ otherwise makes a template's static locals (each
# launcher's record of the shared memory it raised its kernel to) one
# object across every library of the process, so that a second library
# instantiating the same launcher would skip raising its own copy of the
# kernel and have its launches refused
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC,-fno-gnu-unique", "-Xptxas",
              "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's report (registers, shared memory, spills) of each library built
# by this process, keyed by kernel name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` process per source, all started together.
    Returns {name: library path}; raises if any compile fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    targets = {n: _target(n) for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic publish
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
