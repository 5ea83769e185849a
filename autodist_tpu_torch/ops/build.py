"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, under the checkout's
git-ignored ``build/`` directory; the file name carries a hash of the
source, of every ``csrc/*.cuh`` header it includes and of the flags, so an
edited kernel or header rebuilds. The library loads with
``ctypes``. :func:`load_all` starts one ``nvcc`` per source at once.
Nothing here runs at import: this module imports on hosts with no CUDA.
"""
import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from autodist_tpu_torch.utils import logging

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")  # registers and spills of every kernel
KERNELS = ("flash_fwd", "flash_bwd")  # every csrc/<name>.cu the port builds
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_locks = {name: threading.Lock() for name in KERNELS}
_libs = {}
build_seconds = {}  # name -> seconds the nvcc build took in this process
build_logs = {}  # name -> nvcc's output (ptxas -v) of a build in this process


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels are built from "
                           "autodist_tpu_torch/csrc at first use")
    return path


def _sources(src):
    """``src`` and every header it includes from ``csrc/``, transitively,
    in the order first included."""
    out, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(os.path.dirname(path), inc.decode())
                if os.path.exists(dep):
                    todo.append(dep)
    return out


def library_path(name):
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def load_library(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use."""
    if name not in _locks:
        raise ValueError(f"unknown kernel {name!r}; the port builds {KERNELS}")
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src, out = library_path(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            build_seconds[name] = time.perf_counter() - t0
            build_logs[name] = proc.stdout + proc.stderr
            logging.info("built %s in %.1fs", out, build_seconds[name])
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib


def load_all():
    """Build (one ``nvcc`` per source, all started together) and load
    every kernel of the port; returns {name: CDLL}."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = {name: pool.submit(load_library, name) for name in KERNELS}
        return {name: f.result() for name, f in futures.items()}


def register_report(log):
    """[(kernel, registers, spill store bytes)] from a ``ptxas -v`` log."""
    out, kernel, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m.group(1)), spill))
            kernel = None
    return out
