"""ctypes bindings for the native host runtime (``csrc/husky_native.cpp``).

Counterpart of ``husky_rover_mppi_isaacsim_tpu/native``, with its names,
signatures and C ABI. The compute path of this package is PyTorch and the
CUDA kernels of ``csrc/``; this module is the *host* runtime around it,
replacing the reference's native dependencies:

========================  ==================================================
reference                 here
========================  ==================================================
cv2.distanceTransform     :func:`edt_l2` (exact Felzenszwalb) /
(MPPI_isaac.py:374)       :func:`chamfer5` (bit-comparable 5x5 chamfer)
PIL bicubic worker        :func:`bicubic_upsample`
(high_resolution_DEM_
workers.py:107-196)
zfpy block compression    :func:`compress` / :func:`decompress`
(utils.py:33-81)          (fixed-accuracy delta+varint codec)
multiprocessing worker    :class:`TilePool` (C++ threads, shortest-queue
pools (:199-766)          dispatch, poison-pill shutdown)
========================  ==================================================

The shared library is built from the source in the checkout at first use
with ``g++`` (:func:`..ops.cuda_build.build_host`: cached under a hash of
the source and the flags, renamed into place), on the host of whatever
device the caller uses. Nothing degrades: where the build fails, every
entry point raises ``RuntimeError`` with the compiler's output
(:func:`available` and :func:`build_error` report it without raising).
Inputs are numpy arrays or CPU tensors; outputs are numpy arrays. The
foreign calls release the interpreter lock, so a :class:`TilePool`'s jobs
and a thread waiting in :meth:`TilePool.collect` leave other Python threads
running.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional

import numpy as np
import torch

SOURCE = "husky_native.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
build_seconds = 0.0  # g++ seconds of this process's build (0.0 when cached)
library_path = None  # the loaded shared library

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _bind(lib: ctypes.CDLL) -> None:
    lib.hn_edt_l2.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _f32p]
    lib.hn_edt_l2.restype = None
    lib.hn_edt_l2_sq.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _f32p]
    lib.hn_edt_l2_sq.restype = None
    lib.hn_chamfer5.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _f32p]
    lib.hn_chamfer5.restype = None
    lib.hn_bicubic_upsample.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p]
    lib.hn_bicubic_upsample.restype = None
    lib.hn_compress_f32.argtypes = [_f32p, ctypes.c_long, ctypes.c_float, _u8p, ctypes.c_long]
    lib.hn_compress_f32.restype = ctypes.c_long
    lib.hn_decompress_f32.argtypes = [_u8p, ctypes.c_long, ctypes.c_float, _f32p,
                                      ctypes.c_long]
    lib.hn_decompress_f32.restype = ctypes.c_long
    lib.hn_pool_create.argtypes = [ctypes.c_int]
    lib.hn_pool_create.restype = ctypes.c_void_p
    lib.hn_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.hn_pool_destroy.restype = None
    lib.hn_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_int, _f32p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
    lib.hn_pool_submit.restype = ctypes.c_long
    lib.hn_pool_pending.argtypes = [ctypes.c_void_p]
    lib.hn_pool_pending.restype = ctypes.c_long
    lib.hn_pool_peek.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long), ctypes.c_int]
    lib.hn_pool_peek.restype = ctypes.c_int
    lib.hn_pool_fetch.argtypes = [ctypes.c_void_p, _f32p, ctypes.c_long]
    lib.hn_pool_fetch.restype = ctypes.c_long


def _load() -> Optional[ctypes.CDLL]:
    """Build (once per process) and bind the library; a failure is kept."""
    global _lib, _build_error, build_seconds, library_path
    with _lock:
        if _lib is None and _build_error is None:
            from ..ops.cuda_build import build_host

            try:
                built = build_host(SOURCE)
            except (RuntimeError, OSError) as exc:  # no compiler, a compile error
                _build_error = str(exc)
            else:
                _bind(built.lib)
                _lib, build_seconds, library_path = built.lib, built.seconds, built.path
        return _lib


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native host runtime did not build:\n{_build_error}")
    return lib


def available() -> bool:
    """True when the native library is built (or was built now)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """The compiler's output of a failed build, else None."""
    _load()
    return _build_error


def _host_array(arr, dtype) -> np.ndarray:
    """A C-contiguous numpy array of ``dtype``; a tensor must lie on the CPU."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError(f"the native runtime reads host memory; got a tensor on "
                             f"{arr.device}")
        arr = arr.numpy()
    return np.ascontiguousarray(arr, dtype=dtype)


# --- distance transforms -----------------------------------------------------

def edt_l2(occupied, squared: bool = False) -> np.ndarray:
    """Exact L2 EDT (pixels) of a boolean occupancy grid (True = obstacle)."""
    lib = _library()
    occ = _host_array(occupied, np.uint8)
    h, w = occ.shape
    out = np.empty((h, w), np.float32)
    fn = lib.hn_edt_l2_sq if squared else lib.hn_edt_l2
    fn(occ.ctypes.data_as(_u8p), h, w, out.ctypes.data_as(_f32p))
    return out


def chamfer5(binary_free) -> np.ndarray:
    """cv2-compatible 5x5 chamfer DT (0 = obstacle, nonzero = free)."""
    lib = _library()
    img = _host_array(binary_free, np.uint8)
    h, w = img.shape
    out = np.empty((h, w), np.float32)
    lib.hn_chamfer5(img.ctypes.data_as(_u8p), h, w, out.ctypes.data_as(_f32p))
    return out


# --- bicubic upsample --------------------------------------------------------

def bicubic_upsample(src, factor: int) -> np.ndarray:
    """Catmull-Rom (a=-0.5) integer-factor upsample, PIL convention: the
    native twin of ``terrain.upsample.upsample_bicubic``."""
    lib = _library()
    src = _host_array(src, np.float32)
    h, w = src.shape
    out = np.empty((h * factor, w * factor), np.float32)
    lib.hn_bicubic_upsample(src.ctypes.data_as(_f32p), h, w, factor,
                            out.ctypes.data_as(_f32p))
    return out


# --- fixed-accuracy codec ----------------------------------------------------

def compress(arr, tolerance: float = 1e-3) -> bytes:
    """Compress a float array with bounded error <= tolerance/2 per element
    (the zfpy fixed-accuracy mode the reference uses for rock blocks)."""
    lib = _library()
    flat = _host_array(arr, np.float32).ravel()
    cap = max(64, flat.size * 10)
    buf = np.empty(cap, np.uint8)
    n = lib.hn_compress_f32(flat.ctypes.data_as(_f32p), flat.size, ctypes.c_float(tolerance),
                            buf.ctypes.data_as(_u8p), cap)
    if n < 0:
        raise ValueError("compression failed (tolerance <= 0 or overflow)")
    return bytes(buf[:n])


def decompress(data: bytes, shape, tolerance: float = 1e-3) -> np.ndarray:
    lib = _library()
    src = np.frombuffer(data, np.uint8)
    cap = int(np.prod(shape)) if len(shape) else 1
    out = np.empty(cap, np.float32)
    n = lib.hn_decompress_f32(src.ctypes.data_as(_u8p), src.size, ctypes.c_float(tolerance),
                              out.ctypes.data_as(_f32p), cap)
    if n != cap:
        raise ValueError(f"decompressed {n} elements, expected {cap}")
    return out.reshape(shape)


# --- thread-pool tile runner --------------------------------------------------

BICUBIC = 0
EDT = 1
CHAMFER = 2


class TilePool:
    """C++ thread-pool tile runner with shortest-queue dispatch: the native
    re-design of ``BaseWorkerManager`` + its load-balancing dispatcher
    (high_resolution_DEM_workers.py:199-766). Submit returns a job id;
    results arrive on a completion queue drained by :meth:`collect` /
    :meth:`collect_all` (the ``collect_terrain_data`` pattern,
    high_resolution_DEM_generator.py:786-826). The pool copies a job's
    input at submission.
    """

    def __init__(self, n_workers: int = 8):
        self._lib = _library()
        self._pool = self._lib.hn_pool_create(n_workers)
        self.n_workers = n_workers
        self.jobs = 0            # submitted over the pool's life
        self.collect_s = 0.0     # seconds spent in collect_all

    def _handle(self):
        if self._pool is None:
            raise RuntimeError("TilePool is closed")  # not a NULL-deref
        return self._pool

    def submit(self, kind: int, src, p0: int = 1) -> int:
        """Enqueue a job (BICUBIC: p0 = upscale factor; EDT/CHAMFER:
        src > 0.5 is the binary input)."""
        handle = self._handle()
        src = _host_array(src, np.float32)
        h, w = src.shape
        self.jobs += 1
        return self._lib.hn_pool_submit(handle, kind, src.ctypes.data_as(_f32p), h, w, p0)

    def pending(self) -> int:
        return self._lib.hn_pool_pending(self._handle())

    def collect(self, wait_ms: int = 1000):
        """Pop one finished (job_id, array), or None on timeout."""
        handle = self._handle()
        jid, h, w, size = ctypes.c_long(), ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
        ok = self._lib.hn_pool_peek(handle, ctypes.byref(jid), ctypes.byref(h),
                                    ctypes.byref(w), ctypes.byref(size), wait_ms)
        if not ok:
            return None
        out = np.empty(size.value, np.float32)
        n = self._lib.hn_pool_fetch(handle, out.ctypes.data_as(_f32p), size.value)
        if n != size.value:
            raise RuntimeError(f"TilePool job {jid.value}: fetched {n} of {size.value} values")
        factor = int(round((size.value / (h.value * w.value)) ** 0.5))
        if factor < 1 or factor * factor * h.value * w.value != size.value:
            raise RuntimeError(
                f"TilePool job {jid.value}: output size {size.value} is not "
                f"a square multiple of the {h.value}x{w.value} input")
        return jid.value, out.reshape(h.value * factor, w.value * factor)

    def collect_all(self, timeout_s: float = 60.0) -> dict:
        """Drain until no jobs are pending; {job_id: array}."""
        t0 = time.perf_counter()
        results = {}
        deadline = time.monotonic() + timeout_s
        while self.pending() > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{self.pending()} tile jobs still pending")
            got = self.collect(wait_ms=200)
            if got is not None:
                results[got[0]] = got[1]
        self.collect_s += time.perf_counter() - t0
        return results

    def close(self) -> None:
        """Stop the workers (each runs the jobs queued before the stop) and
        free the pool, results not yet collected included. Idempotent."""
        if self._pool is not None:
            self._lib.hn_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self.close()
