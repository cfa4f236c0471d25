"""ctypes bindings to the native runtime (libgorio_native).

The compute path is JAX/XLA; the runtime around it — dataset decode with
background prefetch, a threaded stage pipeline, a kd-tree for host-side
validation — is C++ (native/), mirroring where the reference uses C++
(nodelet manager, nanoflann, rosbag IO). The library is built on demand by
one C++ compiler command over native/src/*.cc and cached under native/build.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_NATIVE = _ROOT / "native"
_BUILD = _NATIVE / "build"
_LIB = None


class NativeUnavailable(RuntimeError):
    pass


def build_native(force: bool = False) -> Path:
    """Build libgorio_native.so under native/build with one C++ compiler
    command (`$CXX`, else `c++`/`g++`) over native/src/*.cc."""
    lib = _BUILD / "libgorio_native.so"
    if lib.exists() and not force:
        return lib
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("no C++ compiler found (set CXX)")
    _BUILD.mkdir(parents=True, exist_ok=True)
    sources = sorted(str(p) for p in (_NATIVE / "src").glob("*.cc"))
    out = subprocess.run(
        [cxx, "-std=c++17", "-O3", "-shared", "-fPIC", *sources, "-o", str(lib), "-lpthread"],
        capture_output=True,
        text=True,
    )
    if out.returncode != 0:
        raise NativeUnavailable(f"{cxx} failed ({out.returncode}): {out.stderr[-2000:]}")
    return lib


def load(auto_build: bool = True):
    global _LIB
    if _LIB is not None:
        return _LIB
    lib_path = _BUILD / "libgorio_native.so"
    if not lib_path.exists():
        if not auto_build:
            raise NativeUnavailable("libgorio_native.so not built")
        try:
            build_native()
        except Exception as e:
            raise NativeUnavailable(f"native build failed: {e}") from e
    lib = ctypes.CDLL(str(lib_path))
    lib.gorio_kdtree_create.restype = ctypes.c_void_p
    lib.gorio_kdtree_create.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
    lib.gorio_kdtree_destroy.argtypes = [ctypes.c_void_p]
    lib.gorio_kdtree_knn.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.gorio_write_frame.restype = ctypes.c_int
    lib.gorio_write_frame.argtypes = [
        ctypes.c_char_p,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.gorio_dataset_open.restype = ctypes.c_void_p
    lib.gorio_dataset_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.gorio_dataset_close.argtypes = [ctypes.c_void_p]
    lib.gorio_dataset_next.restype = ctypes.c_int
    lib.gorio_dataset_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.gorio_pipeline_dataset_open.restype = ctypes.c_void_p
    lib.gorio_pipeline_dataset_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.gorio_pipeline_dataset_next.restype = ctypes.c_int
    lib.gorio_pipeline_dataset_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.gorio_pipeline_dataset_backlog.restype = ctypes.c_int
    lib.gorio_pipeline_dataset_backlog.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gorio_pipeline_dataset_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


FIELDS = 5  # x y z intensity doppler


class NativeKDTree:
    """Exact kd-tree NN (validation oracle for the brute-force NN search)."""

    def __init__(self, points: np.ndarray, leaf_size: int = 16):
        lib = load()
        pts = np.ascontiguousarray(points, dtype=np.float32)
        self._lib = lib
        self._handle = lib.gorio_kdtree_create(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0], leaf_size
        )

    def knn(self, queries: np.ndarray, k: int):
        q = np.ascontiguousarray(queries, dtype=np.float32)
        n = q.shape[0]
        idx = np.empty((n, k), np.int32)
        d2 = np.empty((n, k), np.float32)
        self._lib.gorio_kdtree_knn(
            self._handle,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            k,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            d2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return idx, d2

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.gorio_kdtree_destroy(self._handle)
            self._handle = None


def write_frame(path, stamp: float, xyz, intensity=None, doppler=None):
    """Write one .grf radar frame."""
    lib = load()
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    cols = [xyz]
    cols.append(np.asarray(intensity if intensity is not None else np.zeros(n), np.float32)[:, None])
    cols.append(np.asarray(doppler if doppler is not None else np.zeros(n), np.float32)[:, None])
    data = np.ascontiguousarray(np.concatenate(cols, axis=1), np.float32)
    rc = lib.gorio_write_frame(
        str(path).encode(),
        float(stamp),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        FIELDS,
    )
    if rc != 0:
        raise IOError(f"failed to write {path}")


class NativeDataset:
    """Prefetching .grf sequence reader (the bag-replay counterpart)."""

    def __init__(self, paths, capacity: int = 4096, queue_depth: int = 4):
        lib = load()
        self._lib = lib
        self.capacity = capacity
        enc = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        self._handle = lib.gorio_dataset_open(arr, len(enc), queue_depth)
        self._buf = np.empty((capacity, FIELDS), np.float32)

    def __iter__(self):
        return self

    def __next__(self):
        stamp = ctypes.c_double()
        while True:
            n = self._lib.gorio_dataset_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.capacity,
                FIELDS,
                ctypes.byref(stamp),
            )
            if n == 0:
                raise StopIteration
            if n == -2:  # valid frame, zero returns (sensor dropout) — skip
                continue
            if n < 0:
                raise IOError("corrupt frame")
            data = self._buf[:n].copy()
            return stamp.value, data[:, :3], data[:, 3], data[:, 4]

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.gorio_dataset_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativePipelineDataset:
    """Two-stage native pipeline (decode thread -> pack thread) yielding
    zero-padded (capacity, FIELDS) host buffers ready for device upload.

    This is the L3 runtime counterpart of the reference's 3-nodelet
    shared-manager dataflow (SURVEY.md §1 L3): each stage is its own native
    thread connected by bounded queues (native/src/pipeline.h), and the pack
    stage does the padding the fused frontend previously paid per frame in
    Python. Iteration yields (stamp, n_valid, padded) where `padded` is a
    reused (capacity, FIELDS) float32 array — copy it if you keep it."""

    def __init__(self, paths, capacity: int = 4096, queue_depth: int = 4):
        lib = load()
        self._lib = lib
        self.capacity = capacity
        enc = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        self._handle = lib.gorio_pipeline_dataset_open(
            arr, len(enc), queue_depth, capacity, FIELDS
        )
        self._buf = np.empty((capacity, FIELDS), np.float32)

    def __iter__(self):
        return self

    def __next__(self):
        stamp = ctypes.c_double()
        while True:
            n = self._lib.gorio_pipeline_dataset_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(stamp),
            )
            if n == 0:
                raise StopIteration
            if n == -2:  # valid frame, zero returns (sensor dropout) — skip
                continue
            if n < 0:
                raise IOError("corrupt frame")
            return stamp.value, n, self._buf

    def backlog(self, stage: int = 0) -> int:
        return int(self._lib.gorio_pipeline_dataset_backlog(self._handle, stage))

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.gorio_pipeline_dataset_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
