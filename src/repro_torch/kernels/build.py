"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/kernels/lib<name>-<hash>.so`` at the repository root
(a directory git ignores). The hash covers the source, every
``csrc`` header that it includes and the flags, so an edited source or
header builds anew and an unchanged one is reused. Nothing is
built when a module is imported: :func:`library` builds on first use,
and :func:`build` compiles every missing library at once, one ``nvcc``
process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("hier_agg", "kmeans_dist", "flash_attention", "conv_pool")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = (str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME
            else shutil.which("nvcc"))
    if not nvcc or not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _inputs(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers that it includes,
    directly or through another header, in the order first reached."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())
                 if (CSRC / inc.decode()).is_file()]
    return seen


def library_path(name: str) -> Path:
    tag = hashlib.sha256()
    for path in _inputs(name):
        tag.update(path.name.encode() + path.read_bytes())
    tag.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{tag.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the libraries of ``names`` that are missing, in parallel.

    Returns ``{name: nvcc output}`` for the ones compiled (the
    ``-Xptxas=-v`` register and shared-memory report); raises with the
    compiler's output if any compile fails, after every process ended.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)         # atomic: readers never see half
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """Load the library of kernel ``name``, building it first if missing
    (callers keep the handle)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
