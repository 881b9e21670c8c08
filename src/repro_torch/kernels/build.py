"""Builds the port's CUDA C++ sources at first use.

Each ``src/repro_torch/csrc/<name>.cu`` has a plain C interface and becomes
``build/lib<name>-<hash>.so`` at the repo root, compiled by ``nvcc`` for
``sm_90a`` and loaded with ``ctypes``. The file name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so a changed
source or header is rebuilt and an unchanged one is loaded as it is.
``build()`` compiles every missing library in parallel (one ``nvcc`` per
source, all started together) and is what ``chip_smoke.py`` times;
``library()`` builds one on demand.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention", "rmsnorm", "adamw",
           "selective_scan")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every shared header ``csrc/*.cuh`` (name and text) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library of ``names`` that is missing; returns seconds.

    Raises with the compiler's output when a source does not compile. The
    ptxas report (registers, shared memory, spills) goes beside the library
    as ``.log``."""
    t0 = time.perf_counter()
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


@functools.cache
def library(name: str) -> ctypes.CDLL:
    build([name])
    return ctypes.CDLL(str(target(name)))
