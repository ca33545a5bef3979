"""ctypes bindings for the native scene-preparation runtime (native/).

Builds native/libmpt_native.so from the committed sources on first use, and
again whenever a source is newer (g++, ~1 s), and exposes
`build_bvh_native`. Falls back to the numpy builder (bvh.py) when no
toolchain is available — call sites use `try_build_bvh`.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO = os.path.join(_NATIVE_DIR, "libmpt_native.so")
_SOURCES = ("bvh_builder.cpp", "exr_piz.cpp", "Makefile")
_lib = None
_lib_failed = False

LEAF_SIZE = 4


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
            os.path.getmtime(os.path.join(_NATIVE_DIR, src))
            for src in _SOURCES
        ):
            subprocess.run(
                ["make", "-s", "-C", _NATIVE_DIR], check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_SO)
        lib.build_bvh.restype = ctypes.c_int32
        lib.build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float)] * 3 + [ctypes.c_int32] + [
            ctypes.POINTER(ctypes.c_float)] * 2 + [
            ctypes.POINTER(ctypes.c_int32)] * 3 + [ctypes.c_int32] + [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    except Exception:
        _lib_failed = True
    return _lib


def build_bvh_native(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray):
    """SAH BVH via the C++ builder. Returns the same tuple layout as the
    numpy builder or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nf = len(p0)
    cap = max(4 * (nf // LEAF_SIZE + 1) + 4, 16)
    prim_cap = cap * LEAF_SIZE

    p0 = np.ascontiguousarray(p0, np.float32)
    p1 = np.ascontiguousarray(p1, np.float32)
    p2 = np.ascontiguousarray(p2, np.float32)
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_first = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    node_miss = np.empty(cap, np.int32)
    prim_idx = np.empty(prim_cap, np.int32)
    prim_pad = ctypes.c_int32(0)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    nn = lib.build_bvh(
        p0.ctypes.data_as(fp), p1.ctypes.data_as(fp), p2.ctypes.data_as(fp),
        nf,
        node_lo.ctypes.data_as(fp), node_hi.ctypes.data_as(fp),
        node_first.ctypes.data_as(ip), node_count.ctypes.data_as(ip),
        node_miss.ctypes.data_as(ip), cap,
        prim_idx.ctypes.data_as(ip), prim_cap, ctypes.byref(prim_pad),
    )
    if nn < 0:
        return None
    pp = prim_pad.value
    return (
        node_lo[:nn].copy(), node_hi[:nn].copy(), node_first[:nn].copy(),
        node_count[:nn].copy(), node_miss[:nn].copy(), prim_idx[:pp].copy(),
    )
