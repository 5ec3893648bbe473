"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
for ``sm_90a`` into ``build/repro_torch/lib<name>-<hash>.so`` at the root
of the checkout, at first use. The hash covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source or header is
rebuilt and an unchanged one is reused. Every missing
library is compiled at once, one ``nvcc`` process per source. Nothing here
runs at import: the CPU tests import every module and have no ``nvcc``.

``torch.utils.cpp_extension.load`` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C one seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("quant_matmul", "paged_attention", "fake_quant",
           "flash_attention")
# --split-compile=0: nvcc optimizes a source's kernels in parallel on every
# core (quant_matmul.cu: 136 s to 36 s with nvcc 12.9 on an 8-core host)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

# Loaded libraries, one per source, for the life of the process.
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    of every shared header ``csrc/*.cuh`` (a source may include any of
    them) and of the flags."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library of ``names`` that is missing, all at once.

    Returns ``{name: {"seconds": wall time of its nvcc, "ptxas": the
    entry-function, register, shared-memory and spill lines of -Xptxas
    -v}}`` for the libraries compiled by this call. Raises with nvcc's
    output if any compile fails, after every started nvcc has exited.
    """
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    report, failed = {}, {}
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed[name] = log
            continue
        # rename is atomic: a concurrent build sees the whole file or none
        os.replace(tmp, lib)
        report[name] = {
            "seconds": seconds,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "Compiling entry function" in ln
                      or "registers" in ln or "spill" in ln
                      or "bytes smem" in ln],
        }
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{log}" for n, log in failed.items()))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
