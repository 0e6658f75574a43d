"""Build the port's CUDA kernels from the sources in the checkout.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
:mod:`ctypes`.  Builds happen at first use, into ``build/`` at the root of
the checkout, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the tests import every module on hosts
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parents[1] / "build"

# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {"lindley_scan": "lindley_scan.cu",
                           "chained_lindley": "chained_lindley.cu",
                           "rmsnorm": "rmsnorm.cu",
                           "flash_attention": "flash_attention.cu",
                           "decode_attention": "decode_attention.cu"}

# the model kernels' flags: floating-point contraction allowed (their
# contract is allclose, and their products are multiply-adds)
MODEL_NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler=-fPIC",
)

# the Lindley kernels' flags: --fmad=false keeps them bit-equal to their
# plain versions
NVCC_FLAGS = MODEL_NVCC_FLAGS[:3] + ("--fmad=false",) + MODEL_NVCC_FLAGS[3:]

FLAGS: Dict[str, Tuple[str, ...]] = {
    name: NVCC_FLAGS if name in ("lindley_scan", "chained_lindley")
    else MODEL_NVCC_FLAGS for name in SOURCES}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels cannot be built on this host")
    return found


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library goes, keyed by source and flags."""
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + "\0".join(FLAGS[name]).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> "subprocess.Popen | None":
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *FLAGS[name], "-o", str(tmp),
           str(CSRC_DIR / SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: "subprocess.Popen | None") -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    out = library_path(name)
    out.with_suffix(".log").write_text(log)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Build every named kernel, one ``nvcc`` per source, all started
    together; returns each library's path.  Raises on any failed build."""
    procs = {name: _start(name) for name in names}
    errors = []
    for name, proc in procs.items():
        try:
            _finish(name, proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
