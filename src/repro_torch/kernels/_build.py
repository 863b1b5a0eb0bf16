"""Compile the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions.  It is compiled for
``sm_90a`` into ``build/repro_torch/lib<name>-<hash>.so`` under the
checkout at first use; the hash covers the source text and the flags, so a
changed source is rebuilt.  Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# -fmad=false keeps nvcc from contracting a*b+c into one FMA, and no
# --use_fast_math keeps '/' and sqrt IEEE: the labels must match the
# float32 reference bit for bit at the μ ± ασ boundary.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"  # when nvcc is not on PATH


def nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def target(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile each named source (all of ``csrc/`` by default) that has no
    up-to-date library, one nvcc process per source, all started together.

    Returns each compiled source's compiler output (``-Xptxas -v`` lists
    registers, shared memory and spills per kernel), which is also kept
    beside its library (:func:`build_log`).  Raises if any fails.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in names:
            out = target(name)
            if out.exists() and out.with_suffix(".log").exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs[name] = (proc, tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{logs[name]}")
            else:
                out.with_suffix(".log").write_text(logs[name])
                os.replace(tmp, out)
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """The compiler output of the current library of ``csrc/<name>.cu``,
    building it if needed."""
    build_all([name])
    return target(name).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    out = target(name)
    if not out.exists():
        build_all([name])
    return ctypes.CDLL(str(out))
