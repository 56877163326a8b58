"""Build the CUDA sources in ``csrc/`` with nvcc and load them via ctypes.

Route: nvcc into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), loaded with ``ctypes``. The library
is built at first use from the package's own sources into
``csrc/build/<hash of the sources and flags>/``, which git ignores. A
failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load_library(name: str) -> Tuple[ctypes.CDLL, dict]:
    """Build (once per source hash) and load ``csrc/<name>.cu``.

    Returns the library and its build info: ``seconds`` spent compiling in
    this process (0.0 when the library was already built), ``path`` and
    ``ptxas`` (nvcc's resource report)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        h = hashlib.sha256(src.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        out_dir = BUILD_ROOT / h.hexdigest()[:16]
        so = out_dir / f"lib{name}.so"
        log = out_dir / f"{name}.log"
        seconds = 0.0
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.time()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            seconds = time.time() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {src}:\n"
                    f"{proc.stdout}\n{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr, encoding="utf-8")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        info = {"seconds": seconds, "path": str(so),
                "ptxas": log.read_text(encoding="utf-8")
                if log.exists() else ""}
        _LIBS[name] = (lib, info)
        return _LIBS[name]
