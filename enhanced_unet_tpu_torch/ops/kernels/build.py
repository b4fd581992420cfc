"""Build and load the hand-written CUDA kernels.

Each source `enhanced_unet_tpu_torch/csrc/<name>.cu` has a plain C interface
and is compiled by `nvcc` for Hopper (`sm_90a`) into its own shared library
under `build/kernels/` at the repository root, at first use, then loaded with
`ctypes`.  The library's file name carries a hash of its source and of the
local headers it includes (`#include "..."` under `csrc/`), so an edited
source or header is rebuilt.  A missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")   # the CUDA toolkit's default

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: Dict[Path, bytes]) -> None:
    """`path` and every local header it includes, transitively, by content."""
    if path in seen:
        return
    seen[path] = text = path.read_bytes()
    for name in _LOCAL_INCLUDE.findall(text):
        _sources(path.parent / name.decode(), seen)


def library_path(name: str) -> Path:
    seen: Dict[Path, bytes] = {}
    _sources(CSRC / f"{name}.cu", seen)
    digest = hashlib.sha256()
    for path, text in seen.items():
        digest.update(path.name.encode() + b"\0" + text)
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Compile every library not yet built, one `nvcc` per source, all
    started together.  Returns seconds per built library (0 if cached)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_nvcc_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


MAX_GRID_Z = 65535          # CUDA's limit on gridDim.z, where K1 puts the batch


def check_grid(n: int, h: int, w: int, what: str) -> None:
    """Raise for a batch the kernels cannot index: K1 launches the batch as
    gridDim.z and K2 counts tiles, the batch's pixels at most, in `int`
    (element offsets are 64-bit)."""
    if n > MAX_GRID_Z or n * h * w >= 2 ** 31:
        raise ValueError(f"{what}: a batch of {n} x {h} x {w} is beyond the kernels' "
                         f"grid (at most {MAX_GRID_Z} images and 2^31 - 1 pixels)")


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (or NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
