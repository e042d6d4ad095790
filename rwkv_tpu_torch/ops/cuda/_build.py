"""Build the port's CUDA sources (rwkv_tpu_torch/csrc/*.cu) at first use.

Each `<name>.cu` compiles on its own, with nvcc, into a shared library with a
plain C interface that the wrappers load with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<digest>.so csrc/<name>.cu

The libraries go to rwkv_tpu_torch/_build/ (listed in .gitignore), named by a
digest of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. `build()` starts one nvcc per source, all at
once. nvcc's register and shared-memory report (-Xptxas -v) is kept beside
each library as lib<name>-<digest>.log.

Nothing here runs when a module is imported: the CPU tests import every
module, and the CPU has no nvcc. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNELS = ("mm8", "mm4", "mm8_a8", "decode_stack", "tp_halves", "decode_stack_tp")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then $PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every library in `names` that is not built yet, one nvcc per
    source, all started together. Returns seconds spent per library (0.0 for
    one that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    secs = {n: 0.0 for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        out = lib_path(n)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """nvcc's -Xptxas -v report for the current build of `name`."""
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.rwkv_error_string.argtypes = [ctypes.c_int]
        lib.rwkv_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


SPLIT_FLOATS = 1 << 22   # 16 MB of split-K partials (qmv.cuh)
SPLIT_TILES = 4096       # column tiles with a split-K counter
_SCRATCH: dict = {}


def split_scratch(device: torch.device, owner: str):
    """(partial f32 buffer, zeroed int32 counters, target block count) for the
    split-K matvecs of qmv.cuh on `device`, one set per calling module. The
    kernels leave the counters at zero, so the set is reused by every launch
    on the stream; launches on two streams at once would need two sets."""
    key = (owner, device)
    s = _SCRATCH.get(key)
    if s is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        s = (torch.empty(SPLIT_FLOATS, dtype=torch.float32, device=device),
             torch.zeros(SPLIT_TILES, dtype=torch.int32, device=device),
             2 * sms)
        _SCRATCH[key] = s
    return s


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.rwkv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
