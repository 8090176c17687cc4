"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the
checkout, where ``<hash>`` is the SHA-256 of the source, the shared headers
(``csrc/*.cuh``) and the flags: a changed source or header builds anew, an
unchanged one loads from the cache. ``nvcc``
also writes its ``-Xptxas -v`` report (registers, shared memory, spills)
beside the library, as ``<name>-<hash>.log``.

Nothing here runs at import. A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = (
    "streamsvm_scan", "streamsvm_single", "predict", "gram", "kernel_bank", "multiball",
    "baselines",
)

_libs: dict[str, ctypes.CDLL] = {}  # loaded shared libraries, by source name
build_seconds: dict[str, float] = {}  # wall time of the builds this process ran


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels cannot be built on this machine"
    )


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(FLAGS).encode()).hexdigest()[:16]
    stem = BUILD_DIR / f"{name}-{digest}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that is not cached yet, all at once (one
    ``nvcc`` per source, started together). Returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, jobs = {}, []
    for name in names:
        src, so, log = _paths(name)
        out[name] = so
        if so.is_file():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, so, log, time.perf_counter()))
    failed = []
    for name, proc, tmp, so, log, t0 in jobs:
        report, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        log.write_text(report)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the cached build of ``name``."""
    _, _, log = _paths(name)
    return "\n".join(l for l in log.read_text().splitlines() if "ptxas" in l)


def static_smem(name: str, kernel: str) -> set[int]:
    """Static shared bytes per CTA that ptxas reports for every instantiation
    of the ``__global__`` function ``kernel`` in the cached build of
    ``name`` (matched by its length-prefixed mangled name)."""
    out, entry = set(), None
    for line in ptxas_report(name).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry is not None:
            if f"{len(kernel)}{kernel}" in entry:
                words = line.replace(",", "").split()
                out.add(int(words[words.index("smem") - 2]) if "smem" in words else 0)
            entry = None
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if needed)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
