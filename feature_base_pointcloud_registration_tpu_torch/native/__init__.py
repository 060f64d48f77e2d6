"""ctypes bindings for the native host runtime (libfbpr_native).

The port's copy of the JAX package's `native/` (which imports no JAX; the
port imports none of the JAX package).  The library builds at first use
with `make` into `build/libfbpr_native-<hash>.so` beside the package (the
hash covers the source and the Makefile, so an edited source rebuilds; a
temporary name then `os.replace`, so concurrent first uses do not read a
half-written file).  Every entry point has a NumPy fallback, so the package
works without a compiler; `available()` says which one runs.  See
src/fbpr_native.cpp for what is native and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build"
_lib = None
_tried = False


def _lib_path() -> Path:
    h = hashlib.sha256()
    for name in ("src/fbpr_native.cpp", "Makefile"):
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"libfbpr_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["make", "-B", "-C", str(_DIR), f"OUT={tmp}"],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, so)
    return True


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _lib_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pr = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    lib.voxel_downsample.restype = i64
    lib.voxel_downsample.argtypes = [pf, i64, f32, pf, i64]
    lib.crop_box.restype = i64
    lib.crop_box.argtypes = [pf, i64, pf, pf, pi, i64]
    lib.pcd_read_header.restype = i64
    lib.pcd_read_header.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(i32),
                                    ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.pcd_read_xyzi.restype = i64
    lib.pcd_read_xyzi.argtypes = [ctypes.c_char_p, pf, pf, i64]
    lib.scan_loader_create.restype = ctypes.c_void_p
    lib.scan_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i64, i64, i32, i32, i32, f32, f32,
        f32]
    lib.scan_loader_next.restype = i64
    lib.scan_loader_next.argtypes = [ctypes.c_void_p, pf, pf, pr, pf]
    lib.scan_loader_destroy.restype = None
    lib.scan_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.kitti_read_bin.restype = i64
    lib.kitti_read_bin.argtypes = [ctypes.c_char_p, pf, pf, pr, pf, i64,
                                   i32, f32, f32, f32]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def voxel_downsample(xyz: np.ndarray, leaf: float) -> np.ndarray:
    """Hash-grid centroid voxel filter (host).  xyz: [N,3] f32."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    lib = _load()
    if lib is None:  # NumPy fallback
        keys = np.floor(xyz / leaf).astype(np.int64)
        _, first, inv = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
        cent = np.zeros((first.size, 3), np.float64)
        cnt = np.zeros(first.size)
        np.add.at(cent, inv, xyz)
        np.add.at(cnt, inv, 1)
        return (cent / cnt[:, None]).astype(np.float32)
    out = np.empty_like(xyz)
    n = lib.voxel_downsample(xyz, xyz.shape[0], np.float32(leaf), out,
                             out.shape[0])
    return out[:n].copy()


def crop_box(xyz: np.ndarray, center, half) -> np.ndarray:
    """Indices of points inside the axis-aligned box (host)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    lib = _load()
    if lib is None:
        inside = (np.abs(xyz - np.asarray(center, np.float32))
                  <= np.asarray(half, np.float32)).all(1)
        return np.where(inside)[0].astype(np.int64)
    idx = np.empty(xyz.shape[0], np.int64)
    n = lib.crop_box(xyz, xyz.shape[0],
                     np.ascontiguousarray(center, np.float32),
                     np.ascontiguousarray(half, np.float32), idx,
                     idx.shape[0])
    return idx[:n].copy()


def pcd_read_xyzi(path: str, cap: int = 1 << 24):
    """Fast PCD reader -> (xyz [N,3], intensity [N]).  Falls back to the
    NumPy parser in io.pcd."""
    lib = _load()
    if lib is None:
        from ..io.pcd import read_pcd
        d = read_pcd(path)
        xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
        inten = d.get("intensity", np.zeros(len(xyz), np.float32))
        return xyz, np.asarray(inten, np.float32)
    xyz = np.empty((cap, 3), np.float32)
    inten = np.empty(cap, np.float32)
    n = lib.pcd_read_xyzi(path.encode(), xyz, inten, cap)
    if n < 0:
        raise IOError(f"failed to parse PCD: {path}")
    return xyz[:n].copy(), inten[:n].copy()


def kitti_read_bin(path: str, n_rings: int = 64, elev_min: float = -24.9,
                   elev_max: float = 2.0, scan_period: float = 0.1,
                   cap: int = 1 << 21):
    """KITTI velodyne .bin -> dict(xyz, intensity, ring, time)."""
    lib = _load()
    if lib is None:
        raw = np.fromfile(path, np.float32).reshape(-1, 4)
        xyz = raw[:, :3]
        inten = raw[:, 3]
        r_xy = np.linalg.norm(xyz[:, :2], axis=1)
        elev = np.arctan2(xyz[:, 2], r_xy)
        lo, hi = np.deg2rad(elev_min), np.deg2rad(elev_max)
        ring = np.round((elev - lo) / (hi - lo) * (n_rings - 1)).astype(np.int32)
        ring[(ring < 0) | (ring >= n_rings)] = -1
        az = np.arctan2(xyz[:, 1], xyz[:, 0])
        az[az < 0] += 2 * np.pi
        time = (az / (2 * np.pi) * scan_period).astype(np.float32)
    else:
        xyz = np.empty((cap, 3), np.float32)
        inten = np.empty(cap, np.float32)
        ring = np.empty(cap, np.int32)
        time = np.empty(cap, np.float32)
        n = lib.kitti_read_bin(path.encode(), xyz, inten, ring, time, cap,
                               np.int32(n_rings), np.float32(elev_min),
                               np.float32(elev_max), np.float32(scan_period))
        if n < 0:
            raise IOError(f"failed to read {path}")
        xyz, inten, ring, time = (a[:n].copy() for a in
                                  (xyz, inten, ring, time))
    return dict(xyz=xyz, intensity=inten, ring=ring, time=time,
                valid=np.ones(len(xyz), bool))


class ScanLoader:
    """Threaded scan prefetcher over a KITTI .bin sequence.

    Worker threads decode files ahead of the consumer into a bounded ring
    delivered strictly in order — the native data-plane analog of the
    reference's bag playback + subscriber queue (scans arrive while the
    previous one is processed, ref: src/imageProjection.cpp:182-226); here
    file IO/decode overlap the device solve.  Synchronous NumPy fallback
    when the shared library is unavailable.

        with ScanLoader(paths) as it:
            for scan in it:   # dict(xyz, intensity, ring, time, valid)
                ...
    """

    def __init__(self, paths, cap: int = 1 << 21, queue_depth: int = 4,
                 n_threads: int = 2, n_rings: int = 64,
                 elev_min: float = -24.9, elev_max: float = 2.0,
                 scan_period: float = 0.1):
        self.paths = [str(p) for p in paths]
        self.cap = cap
        self.kw = dict(n_rings=n_rings, elev_min=elev_min,
                       elev_max=elev_max, scan_period=scan_period)
        self._lib = _load()
        self._handle = None
        self._served = 0
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.scan_loader_create(
                arr, len(self.paths), cap, queue_depth, n_threads,
                np.int32(n_rings), np.float32(elev_min),
                np.float32(elev_max), np.float32(scan_period))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._served >= len(self.paths):
            raise StopIteration
        i = self._served
        self._served += 1
        if self._handle is None:
            return kitti_read_bin(self.paths[i], cap=self.cap, **self.kw)
        xyz = np.empty((self.cap, 3), np.float32)
        inten = np.empty(self.cap, np.float32)
        ring = np.empty(self.cap, np.int32)
        time = np.empty(self.cap, np.float32)
        n = self._lib.scan_loader_next(self._handle, xyz, inten, ring, time)
        if n == -2:
            raise StopIteration
        if n < 0:
            raise IOError(f"failed to read {self.paths[i]}")
        xyz, inten, ring, time = (a[:n].copy() for a in
                                  (xyz, inten, ring, time))
        return dict(xyz=xyz, intensity=inten, ring=ring, time=time,
                    valid=np.ones(n, bool))

    def close(self):
        if self._handle is not None:
            self._lib.scan_loader_destroy(self._handle)
            self._handle = None
