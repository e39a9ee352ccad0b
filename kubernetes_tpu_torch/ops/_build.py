"""Build the hand-written CUDA sources in ops/csrc at first use.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a plain
C interface, `kubernetes_tpu_torch/_build/<name>-<hash>.so`, where the hash
covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  The libraries are loaded with ctypes: the sources
include no PyTorch header, which keeps a build to seconds (ninja and
torch.utils.cpp_extension are not needed).  Nothing here runs at import.
`COUNTS` tallies the nvcc compiles started and the libraries loaded in this
process (testing.sanitizers.BuildCounter reads it: after warmup, steady
waves build and load nothing).
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
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # exact f32: no FMA contraction, IEEE division and sqrt
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# process-local: name -> ctypes.CDLL, one load per process (each
# scheduler child of scheduler/procrun.py loads its own)
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc compiles started and libraries loaded, by source name
COUNTS: dict[str, dict[str, int]] = {"builds": {}, "loads": {}}


def nvcc_path() -> str | None:
    """nvcc on PATH, else the toolkit's default location, else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.access(default, os.X_OK) else None


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile every source in `names` (default: all of csrc) that has no
    current library yet, one nvcc process per source, all started
    together.  Returns {name: {"path", "seconds", "cached", "log"}} where
    log is nvcc's stderr (the -Xptxas -v register/spill report).  Raises
    RuntimeError when nvcc is missing or a compile fails."""
    names = sources() if names is None else list(names)
    out: dict[str, dict] = {}
    procs = {}
    t0 = time.monotonic()
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "cached": True,
                         "log": ""}
            continue
        nvcc = nvcc_path()
        if nvcc is None:
            raise RuntimeError("nvcc not found: cannot build the CUDA "
                               "kernels (need the CUDA toolkit)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        COUNTS["builds"][name] = COUNTS["builds"].get(name, 0) + 1
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, path)
    for name, (proc, tmp, path) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{stdout}{stderr}")
        os.replace(tmp, path)
        out[name] = {"path": str(path), "seconds": time.monotonic() - t0,
                     "cached": False, "log": stderr}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        info = build([name])[name]
        lib = _loaded[name] = ctypes.CDLL(info["path"])
        COUNTS["loads"][name] = COUNTS["loads"].get(name, 0) + 1
    return lib
