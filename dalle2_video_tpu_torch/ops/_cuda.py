"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; a
source whose tiling its wrapper plans is built with the plan's constants
as ``-D`` macros (``CudaKernel(defines=...)``), so only the wrapper states
them. Builds
happen at first use, into ``csrc/_build/`` (git-ignored), named by a hash of
the sources and flags so a stale library is never reused; several sources
build in parallel (one ``nvcc`` each). Nothing here runs at import time: the
CPU tests import every module on a machine with no ``nvcc``.

A ``CudaKernel`` counts its launches in ``launches``: the wrapper adds one
each time it launches the kernel for a CUDA tensor, and nowhere else. A
kernel with more than one route (the flash backward) also counts each
launch under its route in ``routes``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
DEFINES: Dict[str, Dict[str, int]] = {}  # source -> the -D macros it is built with
BUILD_LOG: Dict[str, str] = {}  # source -> nvcc output (ptxas register report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _flags(source: str) -> List[str]:
    return [*NVCC_FLAGS, *(f"-D{k}={v}" for k, v in sorted(DEFINES.get(source, {}).items()))]


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str]) -> Dict[str, float]:
    """Compile every source that has no up-to-date library, all nvcc
    processes started together, behind a file lock on the build directory
    (ranks of one machine starting at once build each library once; the
    others wait, then load it). Returns seconds spent per source built."""
    sources = list(sources)
    if all(_lib_path(s).exists() for s in sources):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "nvcc.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_unlocked([s for s in sources if not _lib_path(s).exists()])
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_unlocked(todo: List[str]) -> Dict[str, float]:
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = []
    t0 = time.time()
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(src), "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    times = {}
    errors = []
    for src, out, tmp, p in procs:
        try:
            log, _ = p.communicate(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        BUILD_LOG[src] = log
        times[src] = time.time() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for {src}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def _load(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_lib_path(source)))
            lib.d2v_error_string.argtypes = [ctypes.c_int]
            lib.d2v_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


class CudaKernel:
    """One exported C entry point of one csrc source.

    ``argtypes`` are ctypes types; pass pointers and the stream as Python
    ints (``tensor.data_ptr()``, ``stream.cuda_stream``). ``defines`` are
    the ``-D`` macros its source is built with."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str,
                 defines: Optional[Dict[str, int]] = None):
        if DEFINES.setdefault(source, dict(defines or {})) != dict(defines or {}):
            raise ValueError(f"{source}: its kernels disagree on its -D macros")
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self.routes: Dict[str, int] = {}
        self._fn = None

    def reset(self) -> None:
        """Set the launch counts to 0."""
        self.launches = 0
        self.routes = {}

    def _bind(self):
        if self._fn is None:
            lib = _load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        return self._fn

    def query(self, symbol: str, *args: int) -> int:
        """Call an int-valued C helper of the kernel's library (a plan the C
        side owns). It launches nothing and counts nothing."""
        lib, _ = self._bind()
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_int
        return fn(*args)

    def launch(self, *args, route: Optional[str] = None) -> None:
        lib, fn = self._bind()
        err = fn(*args)
        if err != 0:
            msg = lib.d2v_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed ({err}): {msg}")
        self.launches += 1
        if route is not None:
            self.routes[route] = self.routes.get(route, 0) + 1


def require_cuda(name: str, tensors: List, dtypes=None) -> None:
    """Validate the tensors a kernel takes: same CUDA device, contiguous,
    16-byte aligned, and (optionally) one of ``dtypes``."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
        if dtypes is not None and t.dtype not in dtypes:
            raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")


def forbid_grad(name: str, tensors: List, hint: str) -> None:
    """Raise where autograd would need a gradient through a raw kernel
    launch: its output would silently carry none."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel call is not differentiable; {hint}")


def dtype_code(dtype) -> int:
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise ValueError(f"kernel dtype {dtype} unsupported (float32 or bfloat16)")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def all_kernels() -> List["CudaKernel"]:
    """Every kernel of the port, one entry per TPU kernel it replaces: the
    serving path's forwards, the training path's backwards, the opt-in
    conv paths' kernels and the flash probes' variants (imports the op
    modules)."""
    from dalle2_video_tpu_torch.ops import (
        cross_attention,
        flash_mqa,
        flash_variants,
        fused_block,
        groupnorm_film,
        spatial_conv,
    )

    return [flash_mqa.KERNEL, flash_mqa.BWD_KERNEL, groupnorm_film.KERNEL,
            groupnorm_film.BWD_KERNEL, cross_attention.KERNEL, spatial_conv.KERNEL,
            spatial_conv.WGRAD_KERNEL, fused_block.KERNEL, fused_block.GN_BWD_KERNEL,
            flash_variants.R2_KERNEL, flash_variants.INNER_KERNEL]


def build_all(kernels: Optional[Sequence[CudaKernel]] = None) -> Dict[str, float]:
    kernels = all_kernels() if kernels is None else kernels
    times = build(sorted({k.source for k in kernels}))
    for k in kernels:
        k._bind()
    return times
