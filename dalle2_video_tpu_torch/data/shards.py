"""The ``.vshard`` fixed-record video store (port of
dalle2_video_tpu/data/shards.py): ``ShardWriter``, ``ShardReader`` and
``h5_to_vshard``.

A ``.vshard`` file is a 64-byte header (magic ``VSHARD01``, record count,
record bytes, ndim, dtype code, eight dims, two reserved words; little
endian) followed by fixed-size records, written once by preprocessing. The
reader is the repository's C++ mmap + threaded-gather library,
``native/shard_reader.cpp``, compiled as it stands with ``g++ -O3 -shared
-fPIC -std=c++17 -pthread`` into ``csrc/_build/`` (git-ignored; never into
``native/``) and bound with ctypes. The build is named by a hash of the
source and flags, serialised by an fcntl lock and published with an atomic
``os.replace``, so loader worker processes and test workers that start at
once build it once and never load half a file. A failed build or open
raises: there is no fallback to Python reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

MAGIC = b"VSHARD01"
DTYPES = {0: np.dtype(np.float32), 1: np.dtype(np.uint8), 2: np.dtype(np.int32)}
DTYPE_CODES = {v: k for k, v in DTYPES.items()}

SOURCE = Path(__file__).resolve().parents[2] / "native" / "shard_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    """Where the reader's library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libshard_reader-{h.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile ``native/shard_reader.cpp`` unless its library exists; safe
    when several processes call it at once. Raises if g++ fails."""
    out = lib_path()
    if out.exists():
        return out
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libshard_reader.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while this one waited
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native()))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            idx = ctypes.POINTER(ctypes.c_int64)
            for name, res, args in (
                    ("sr_open", p, [ctypes.c_char_p]),
                    ("sr_num_records", i64, [p]),
                    ("sr_record_bytes", i64, [p]),
                    ("sr_dtype", ctypes.c_int, [p]),
                    ("sr_ndim", ctypes.c_int, [p]),
                    ("sr_dims", None, [p, ctypes.POINTER(ctypes.c_uint32)]),
                    ("sr_gather", ctypes.c_int, [p, idx, i64, p, ctypes.c_int]),
                    ("sr_prefetch", None, [p, idx, i64]),
                    ("sr_close", None, [p])):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


class ShardWriter:
    """Append fixed-shape records to a .vshard file; the header's count is
    patched on close."""

    def __init__(self, path, record_shape: Tuple[int, ...], dtype=np.float32):
        if len(record_shape) > 8:
            raise ValueError(f"a record has at most 8 dims, not {len(record_shape)}")
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.record_shape = tuple(int(d) for d in record_shape)
        self.dtype = np.dtype(dtype)
        if self.dtype not in DTYPE_CODES:
            raise ValueError(f"dtype {self.dtype} has no .vshard code")
        self.record_bytes = int(np.prod(self.record_shape)) * self.dtype.itemsize
        self.count = 0
        self._f = open(self.path, "wb")
        self._write_header()

    def _write_header(self) -> None:
        dims = list(self.record_shape) + [0] * (8 - len(self.record_shape))
        hdr = struct.pack("<8sIIII8I2I", MAGIC, self.count, self.record_bytes,
                          len(self.record_shape), DTYPE_CODES[self.dtype], *dims, 0, 0)
        self._f.seek(0)
        self._f.write(hdr)
        self._f.seek(0, 2)

    def append(self, record: np.ndarray) -> None:
        record = np.ascontiguousarray(record, dtype=self.dtype)
        if record.shape != self.record_shape:
            raise ValueError(f"record {record.shape}, store {self.record_shape}")
        self._f.write(record.tobytes())
        self.count += 1

    def close(self) -> None:
        if not self._f.closed:
            self._write_header()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardReader:
    """mmap-backed random access with a threaded gather (``num_threads``
    copies in parallel) and madvise prefetch."""

    def __init__(self, path, num_threads: int = 8):
        self._lib = _load_lib()
        self._h = self._lib.sr_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open shard {path}")
        self.num_threads = num_threads
        self.num_records = int(self._lib.sr_num_records(self._h))
        self.record_bytes = int(self._lib.sr_record_bytes(self._h))
        self.dtype = DTYPES[self._lib.sr_dtype(self._h)]
        ndim = self._lib.sr_ndim(self._h)
        dims = (ctypes.c_uint32 * ndim)()
        self._lib.sr_dims(self._h, dims)
        self.record_shape = tuple(int(d) for d in dims)

    def _indices(self, indices: Sequence[int]) -> np.ndarray:
        return np.ascontiguousarray(indices, dtype=np.int64)

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        """Records ``indices`` (any order, repeats allowed) as one array;
        IndexError on an index out of range."""
        idx = self._indices(indices)
        out = np.empty((len(idx), *self.record_shape), dtype=self.dtype)
        rc = self._lib.sr_gather(self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                 len(idx), out.ctypes.data, self.num_threads)
        if rc != 0:
            raise IndexError(f"shard gather failed (index out of range?) rc={rc}")
        return out

    def prefetch(self, indices: Sequence[int]) -> None:
        idx = self._indices(indices)
        self._lib.sr_prefetch(self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                              len(idx))

    def close(self) -> None:
        if self._h:
            self._lib.sr_close(self._h)
            self._h = None

    def __len__(self) -> int:
        return self.num_records

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass


def h5_to_vshard(h5_path, out_path, dataset: str = "videos") -> int:
    """Copy an h5 store's ``dataset`` record by record into a .vshard file;
    returns the record count."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("h5_to_vshard reads h5 stores and needs h5py") from exc
    with h5py.File(h5_path, "r") as f:
        ds = f[dataset]
        with ShardWriter(out_path, ds.shape[1:], ds.dtype) as w:
            for i in range(ds.shape[0]):
                w.append(ds[i])
            return w.count
