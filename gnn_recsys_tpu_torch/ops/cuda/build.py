"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
into ``gnn_recsys_tpu_torch/_build/lib<name>-<hash>.so`` (the hash of the
source, so an edited kernel is never served from a stale library), with the
compiler's register and spill summary beside it (``.so.ptxas``).  Nothing
here runs at import time: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from gnn_recsys_tpu_torch.utils import profiling

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time, "ptxas": compiler's resource summary}
build_info: Dict[str, Dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA host only")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(names: List[str]) -> Dict[str, str]:
    """Compile the named sources in parallel (one ``nvcc`` each); returns
    name -> library path.  Raises with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            if name not in build_info and os.path.exists(out + ".ptxas"):
                with open(out + ".ptxas") as f:  # the summary of an earlier build
                    build_info[name] = {"seconds": 0.0, "ptxas": f.read().splitlines()}
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
        with open(out + ".ptxas", "w") as f:
            f.write("\n".join(ptxas))
        os.replace(tmp, out)
        build_info[name] = {"seconds": time.perf_counter() - t0, "ptxas": ptxas}
    return {name: _lib_path(name) for name in names}


def ptxas_summary(lines: List[str]) -> Dict[str, Dict[str, int]]:
    """Per compiled entry function (its mangled name): registers and spill
    bytes (stores + loads), from the ``ptxas -v`` lines ``build`` keeps."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for ln in lines:
        if "entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {"registers": 0, "spill_bytes": 0}
        elif name is not None and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[name]["spill_bytes"] = nums[1] + nums[2]  # stack frame, stores, loads
        elif name is not None and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def load(name: str, bind: Optional[Callable[[ctypes.CDLL], None]] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built and bound (``bind(lib)``:
    its exports' types, the host's plans checked) on first use.  Every source
    exports ``const char* cuda_error_string(int)``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            if bind is not None:
                bind(lib)
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (a wrapper then takes its
    plain version); raises unless they all lie on one CUDA device otherwise."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors must all be on one CUDA device, got {devices}")
    return False


def stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, for a C entry point."""
    return torch.cuda.current_stream(device).cuda_stream


def launch_counters() -> Dict[str, object]:
    """Every kernel wrapper of this package, by name: the owners of the
    ``launches`` counters declared in ``utils/profiling.py``."""
    from gnn_recsys_tpu_torch.ops.cuda import (  # noqa: F401 (their wrappers declare them)
        gather_mean, leaf_agg, lstm_cell, pool_mask, topk_mips)

    return {owner.__name__: owner for owner, attr in profiling.DECLARED.values()
            if attr == "launches" and owner.__module__.startswith(__package__ + ".")}
