"""Build and load the hand-written CUDA kernels of ``pysco_tpu_torch/csrc``.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per source, all started together, then one link. The build
runs at first use, from the sources in the package only, into
``csrc/build/`` (a git-ignored directory); the library's file name
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("deposit.cu", "gather.cu", "half_sweep.cu", "scalaron_sweep.cu",
           "residual.cu", "prolongation.cu", "mond_source.cu")
HEADERS = ("tiled_pm.cuh", "stencil.cuh")
# --fmad=false: every product and sum rounds as its own float32 operation,
# as in the plain PyTorch twins the kernels are checked against
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

# what the last build printed (ptxas register and shared-memory counts)
# and how long it took, for the smoke run's report
BUILD_INFO = {"seconds": None, "log": ""}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def _check(r: subprocess.CompletedProcess, cmd) -> None:
    if r.returncode:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stderr[-4000:]}")


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build the kernel library if needed and load it."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update((CSRC / name).read_bytes())
    tag = h.hexdigest()[:16]
    lib = BUILD_DIR / f"libpysco_kernels-{tag}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for s in SOURCES:
            obj = BUILD_DIR / f"{Path(s).stem}-{tag}.{os.getpid()}.o"
            cmd = [nvcc, *FLAGS, "-c", "-o", str(obj), str(CSRC / s)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        # wait for every compile before raising on any, so that no nvcc
        # outlives a failed build
        done = []
        for cmd, p in procs:
            out, err = p.communicate()
            done.append(subprocess.CompletedProcess(cmd, p.returncode, out,
                                                    err))
        for r in done:
            _check(r, r.args)
        log = [r.stdout + r.stderr for r in done]
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS[:2], "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        _check(r, cmd)
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["log"] = "".join(log) + r.stdout + r.stderr
        os.replace(tmp, lib)
        for o in objs:
            o.unlink()
    return ctypes.CDLL(str(lib))
