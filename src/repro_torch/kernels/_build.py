"""Build and load the port's CUDA kernels (route (b): nvcc -> shared library
with a plain C interface -> ctypes).

``load(name, passes)`` compiles every library of ``LIBS`` at first use into
``<repo>/build/kernels/<hash>/lib<name>_p<passes>.so``, one library per
entry of ``LIBS`` and pass count the entry names, one ``nvcc`` each, all
started together; the directory is keyed by a hash of the sources and
flags.  It then loads the library asked for.  Nothing is built or started
when the module is imported.  Each library's compiler output (``-Xptxas -v``:
registers, shared memory, spills) is kept beside it as ``<lib>.log``, and
the compile seconds of the last build in ``build_seconds.json``.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises with the CUDA error string when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: Pass counts the TCEC kernels are built for (bf16x1, bf16x3, bf16x6); each
#: is its own library so the builds run in parallel.
PASSES = (1, 3, 6)
#: library -> (source in ``csrc``, extra nvcc flags, the pass counts it is
#: built for).  K7-K9 (``structured``) run one bf16 pass.
LIBS = {
    "tcec_matmul": ("tcec_matmul_k2.cu", (), PASSES),
    "tcec_matmul_k2b": ("tcec_matmul.cu", (), PASSES),
    "tcec_staged": ("tcec_staged.cu", (), PASSES),
    "flash_attention": ("flash_attention.cu", (), PASSES),
    "paged_attention": ("paged_attention.cu", (), PASSES),
    "structured": ("structured.cu", (), (1,)),
}
#: The tile menu of K2b, K5 and K6, (bm, bn, bk) — the list of
#: ``csrc/tcec_tile.cuh::dispatch``.  Every warp owns a 32 x 32 output tile.
TILES = ((32, 32, 32), (64, 64, 32), (128, 64, 32), (128, 128, 32))
#: K2b's/K5's/K6's tile when no tile is asked for.
DEFAULT_TILE = (64, 64, 32)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[Tuple[str, int], ctypes.CDLL] = {}


def tile_threads(bm: int, bn: int) -> int:
    """Threads of a block at tile (bm, bn): one warp per 32 x 32 outputs."""
    return (bm // 32) * (bn // 32) * 32


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of repro_torch "
            "are built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(LIBS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where this source tree's libraries live (built or not)."""
    return BUILD_ROOT / _digest()


def build_all() -> Path:
    """Compile every missing library in parallel; returns the build dir."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    t0 = time.perf_counter()
    try:
        for name, (source, defines, pass_counts) in LIBS.items():
            for passes in pass_counts:
                lib = f"lib{name}_p{passes}"
                so = out / f"{lib}.so"
                if so.exists():
                    continue
                nvcc = nvcc or _nvcc()
                tmp = out / f"{lib}.so.{os.getpid()}.tmp"
                log = open(out / f"{lib}.log", "w")
                cmd = [nvcc, *NVCC_FLAGS, *defines, f"-DREPRO_PASSES={passes}",
                       f"-I{CSRC}", "-o", str(tmp), str(CSRC / source)]
                jobs[lib] = (subprocess.Popen(cmd, stdout=log,
                                              stderr=subprocess.STDOUT),
                             log, tmp, so)
    finally:
        seconds, failed = {}, []
        while len(seconds) < len(jobs):
            for lib, (proc, log, tmp, so) in jobs.items():
                if lib in seconds or proc.poll() is None:
                    continue
                seconds[lib] = round(time.perf_counter() - t0, 1)
                log.close()
                if proc.returncode == 0:
                    os.replace(tmp, so)
                else:
                    failed.append(lib)
            time.sleep(0.05)
    if jobs:
        (out / "build_seconds.json").write_text(json.dumps(seconds))
    if failed:
        logs = "\n".join(
            f"--- {n} ---\n{(out / f'{n}.log').read_text()[-4000:]}"
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def load(name: str, passes: int) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``LIBS``) built for ``passes``
    (building all on first use)."""
    with _LOCK:
        lib = _LIBS.get((name, passes))
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}_p{passes}.so"))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[(name, passes)] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as a pointer for ctypes."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


class LaunchCounter:
    """Counts a kernel's launches: its wrapper adds one where it launches
    the kernel, and nowhere else (plain-version calls do not count)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def hit(self) -> None:
        self.n += 1

    def reset(self) -> None:
        self.n = 0


#: kernel name -> its launch counter (one per wrapper module).
COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    c = LaunchCounter(name)
    COUNTERS[name] = c
    return c
