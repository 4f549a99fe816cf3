"""Threaded gathers from a packed uint8 ``images.npy`` on disk (port of
``fedmlp_tpu/data/native_loader.py``): the host side of ``data.host_stream``,
for a training set that stays off the device.

The gathers run in ``native/packloader.cpp`` (io_uring with O_DIRECT, a
pread repair path, an mmap fallback; one prefetch job at a time through
``pl_submit``/``pl_wait``), bound with ctypes. The source is compiled at
first use with ``native/Makefile``'s flags into ``fedmlp_tpu_torch/_build/``
(a file name hashed from the source and the flags, written under a temporary
name and renamed), never into ``native/``. A library that does not build or
load raises; ``gather_plain`` is the numpy gather the tests hold the library
against, and no path falls back to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "packloader.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return Path(build_dir) / f"libpackloader-{digest[:12]}.so"


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``native/packloader.cpp`` with ``$CXX`` (default g++) into
    ``build_dir`` unless it is there already; raises RuntimeError with the
    compiler's output when the compiler is missing or fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CXX") or "g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"packloader build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"packloader build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded packloader library, built on first use, with the argument
    and result types of every function set."""
    with _LOCK:
        path = str(build_library())
        lib = _LIBS.get(path)
        if lib is None:
            lib = ctypes.CDLL(path)
            u8p, i64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)
            lib.pl_open.restype = ctypes.c_void_p
            lib.pl_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int64,
                                    ctypes.c_uint64]
            lib.pl_close.restype = None
            lib.pl_close.argtypes = [ctypes.c_void_p]
            lib.pl_gather.restype = ctypes.c_int
            lib.pl_gather.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64, u8p,
                                      ctypes.c_int]
            lib.pl_submit.restype = ctypes.c_int
            lib.pl_submit.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64, ctypes.c_int]
            lib.pl_wait.restype = ctypes.c_int64
            lib.pl_wait.argtypes = [ctypes.c_void_p, u8p]
            _LIBS[path] = lib
        return lib


def npy_layout(path: str) -> tuple[int, tuple, np.dtype]:
    """(header bytes, shape, dtype) of a C-ordered ``.npy`` file."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        if fortran:
            raise ValueError(f"{path}: a Fortran-ordered array is not a packed shard")
        return f.tell(), shape, dtype


def gather_plain(mm: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """The rows ``mm[indices]``, shaped ``indices.shape + row shape``: the
    numpy gather that the library's results are held against."""
    idx = np.asarray(indices, np.int64)
    return np.asarray(mm[idx.reshape(-1)]).reshape(idx.shape + mm.shape[1:])


class PackLoader:
    """Threaded row gathers from a packed uint8 ``.npy``: synchronous
    (``gather``) or one job in flight (``submit``, then ``wait``).

    ``reuse_buffers`` keeps one output buffer per kind of call and row
    count, written again by the next such call: a returned array holds until
    then. With a card present the buffers are pinned host memory, and
    ``to_device`` copies them with ``non_blocking=True``; a buffer is
    written again only after the CUDA event of its last copy has completed.
    Off, every call returns a fresh array."""

    def __init__(self, npy_path: str, n_threads: int = 8, reuse_buffers: bool = False):
        self._handle = None
        self.path = npy_path
        self.n_threads = n_threads
        self.reuse = reuse_buffers
        header, shape, dtype = npy_layout(npy_path)
        if dtype != np.uint8:
            raise ValueError(f"{npy_path}: packed image shards are uint8, not {dtype}")
        self.shape = tuple(shape)
        self.row_shape = self.shape[1:]
        self.row_bytes = int(np.prod(self.row_shape))
        self.n = self.shape[0]
        self._pinned = reuse_buffers and torch.cuda.is_available()
        self._bufs: dict = {}
        self._fences: dict = {}  # buffer address → CUDA event of its last copy
        self._pending = None
        self._lib = load_library()
        self._handle = self._lib.pl_open(npy_path.encode(), self.row_bytes, self.n, header)
        if not self._handle:
            raise OSError(f"pl_open failed for {npy_path} ({self.n} rows of "
                          f"{self.row_bytes} bytes after a {header}-byte header)")

    @property
    def native(self) -> bool:
        return self._handle is not None

    def _out(self, tag: str, nrows: int) -> np.ndarray:
        shape = (nrows,) + self.row_shape
        if not self.reuse:
            return np.empty(shape, np.uint8)
        buf = self._bufs.get((tag, nrows))
        if buf is None:
            buf = torch.empty(shape, dtype=torch.uint8, pin_memory=self._pinned).numpy()
            self._bufs[(tag, nrows)] = buf
        fence = self._fences.pop(buf.ctypes.data, None)
        if fence is not None:
            fence.synchronize()
        return buf

    def _flat(self, indices: np.ndarray) -> np.ndarray:
        if self._handle is None:
            raise RuntimeError("the loader is closed")
        return np.ascontiguousarray(np.asarray(indices).reshape(-1), np.int64)

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Rows ``indices`` (any shape) → uint8 ``indices.shape + row_shape``."""
        idx = self._flat(indices)
        out = self._out("gather", len(idx))
        rc = self._lib.pl_gather(self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                 len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 self.n_threads)
        if rc != 0:
            raise IndexError(f"pl_gather: an index outside [0, {self.n})")
        return out.reshape(np.shape(indices) + self.row_shape)

    def submit(self, indices: np.ndarray) -> None:
        """Start gathering rows ``indices`` on the loader's thread; one job
        at a time, collected by ``wait``."""
        if self._pending is not None:
            raise RuntimeError("a gather is in flight: wait() for it first")
        idx = self._flat(indices)
        rc = self._lib.pl_submit(self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                 len(idx), self.n_threads)
        if rc == -1:
            raise IndexError(f"pl_submit: an index outside [0, {self.n})")
        if rc != 0:
            raise RuntimeError(f"pl_submit failed rc={rc}")
        self._pending = (np.shape(indices), len(idx))

    def wait(self) -> np.ndarray:
        """The rows of the job ``submit`` started, once gathered."""
        if self._pending is None:
            raise RuntimeError("wait() without a submitted gather")
        shape, n = self._pending
        out = self._out("wait", n)
        got = self._lib.pl_wait(self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        self._pending = None
        if got != out.nbytes:
            raise RuntimeError(f"pl_wait returned {got} bytes, expected {out.nbytes}")
        return out.reshape(shape + self.row_shape)

    def to_device(self, rows: np.ndarray, device) -> torch.Tensor:
        """``rows`` (a result of ``gather`` or ``wait``) as a uint8 tensor on
        ``device``. On the CPU a reused buffer is copied (``from_numpy``
        would alias memory that the next call writes) and a fresh one is
        wrapped; on the card the copy runs on the current stream, and a
        reused buffer is fenced until it has completed."""
        src = torch.from_numpy(rows)
        device = torch.device(device)
        if device.type != "cuda":
            return src.clone() if self.reuse else src
        out = src.to(device, non_blocking=self._pinned)
        if self.reuse:
            fence = torch.cuda.Event()
            fence.record()
            self._fences[rows.ctypes.data] = fence
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.pl_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
