"""ctypes binding to the native scene-ingestion runtime (runtime/loader.cpp).

Compiles the shared library on first use (g++ -O3, cached by source hash
under the checkout's ``build/native/``)
and exposes drop-in replacements for :func:`models.obj.parse_obj` and
:func:`models.bvh.build_bvh` producing byte-identical results. Used
automatically by :func:`models.scene.load_scene` when available; set
``WRT_NO_NATIVE=1`` to force the pure-Python path."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_RUNTIME_DIR = os.path.join(os.path.dirname(__file__), "..", "runtime")
_SRC = os.path.abspath(os.path.join(_RUNTIME_DIR, "loader.cpp"))
_lock = threading.Lock()
_lib = None
_load_failed = False


def _build_lib() -> Optional[str]:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    from ..utils.paths import BUILD_DIR

    cache_dir = os.path.join(BUILD_DIR, "native")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"libwrtloader_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    # Per-process tmp name: concurrent builders (e.g. pytest + bench in
    # separate processes) must not share a .tmp or the loser's os.replace
    # races the winner's (observed: FileNotFoundError on the rename).
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o",
        tmp_path,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp_path, so_path)
    except Exception:
        return so_path if os.path.exists(so_path) else None
    finally:
        # A failed/timed-out build can leave a partial pid-suffixed tmp
        # behind (os.replace never ran) — don't accumulate them.
        if os.path.exists(tmp_path):
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
    return so_path


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get("WRT_NO_NATIVE"):
            _load_failed = True
            return None
        so = _build_lib()
        if so is None:
            _load_failed = True
            return None
        lib = ctypes.CDLL(so)
        c = ctypes
        lib.wrt_obj_parse.restype = c.c_void_p
        lib.wrt_obj_parse.argtypes = [c.c_char_p]
        lib.wrt_obj_free.argtypes = [c.c_void_p]
        for fn in (
            "wrt_obj_num_vertices", "wrt_obj_num_normals",
            "wrt_obj_num_texcoords", "wrt_obj_num_models",
            "wrt_obj_num_materials",
        ):
            getattr(lib, fn).restype = c.c_int64
            getattr(lib, fn).argtypes = [c.c_void_p]
        fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        for fn in (
            "wrt_obj_copy_vertices", "wrt_obj_copy_normals",
            "wrt_obj_copy_texcoords",
        ):
            getattr(lib, fn).argtypes = [c.c_void_p, fp]
        lib.wrt_obj_model_name.restype = c.c_char_p
        lib.wrt_obj_model_name.argtypes = [c.c_void_p, c.c_int64]
        lib.wrt_obj_material_name.restype = c.c_char_p
        lib.wrt_obj_material_name.argtypes = [c.c_void_p, c.c_int64]
        lib.wrt_obj_model_num_faces.restype = c.c_int64
        lib.wrt_obj_model_num_faces.argtypes = [c.c_void_p, c.c_int64]
        lib.wrt_obj_model_copy.argtypes = [c.c_void_p, c.c_int64, ip, ip, ip, ip]
        lib.wrt_bvh_build.restype = c.c_void_p
        lib.wrt_bvh_build.argtypes = [fp, fp, fp, c.c_int64]
        lib.wrt_bvh_free.argtypes = [c.c_void_p]
        lib.wrt_bvh_num_nodes.restype = c.c_int64
        lib.wrt_bvh_num_nodes.argtypes = [c.c_void_p]
        lib.wrt_bvh_copy.argtypes = [c.c_void_p, fp, fp, ip, ip, ip, ip]
        _lib = lib
        return _lib


def parse_obj_native(path: str):
    """Native OBJ parse → models.obj.ObjFile (or None if unavailable)."""
    from .obj import ObjFile, ObjModel

    lib = get_lib()
    if lib is None:
        return None
    h = lib.wrt_obj_parse(path.encode())
    if not h:
        return None
    try:
        nv = lib.wrt_obj_num_vertices(h)
        nn = lib.wrt_obj_num_normals(h)
        nt = lib.wrt_obj_num_texcoords(h)
        vertices = np.empty((nv, 3), np.float32)
        normals = np.empty((nn, 3), np.float32)
        texcoords = np.empty((nt, 3), np.float32)
        if nv:
            lib.wrt_obj_copy_vertices(h, vertices.reshape(-1))
        if nn:
            lib.wrt_obj_copy_normals(h, normals.reshape(-1))
        if nt:
            lib.wrt_obj_copy_texcoords(h, texcoords.reshape(-1))
        n_mat = lib.wrt_obj_num_materials(h)
        mat_names: List[str] = [
            lib.wrt_obj_material_name(h, i).decode() for i in range(n_mat)
        ]
        models = []
        for m in range(lib.wrt_obj_num_models(h)):
            f = lib.wrt_obj_model_num_faces(h, m)
            v_idx = np.empty((f * 3,), np.int32)
            n_idx = np.empty((f * 3,), np.int32)
            t_idx = np.empty((f * 3,), np.int32)
            mat_id = np.empty((f,), np.int32)
            if f:
                lib.wrt_obj_model_copy(h, m, v_idx, n_idx, t_idx, mat_id)
            material = [
                mat_names[i] if i >= 0 else "" for i in mat_id.tolist()
            ]
            models.append(
                ObjModel(
                    name=lib.wrt_obj_model_name(h, m).decode(),
                    vertex_idx=v_idx.reshape(-1, 3),
                    normal_idx=n_idx.reshape(-1, 3),
                    texcoord_idx=t_idx.reshape(-1, 3),
                    material=material,
                )
            )
        return ObjFile(
            vertices=vertices, normals=normals, texcoords=texcoords,
            models=models,
        )
    finally:
        lib.wrt_obj_free(h)


def build_bvh_native(faces):
    """Native BVH build → models.bvh.BVH (or None if unavailable)."""
    from .bvh import BVH

    lib = get_lib()
    if lib is None:
        return None
    p0 = np.ascontiguousarray(faces.p0, np.float32)
    e1 = np.ascontiguousarray(faces.e1, np.float32)
    e2 = np.ascontiguousarray(faces.e2, np.float32)
    f = len(faces)
    h = lib.wrt_bvh_build(
        p0.reshape(-1), e1.reshape(-1), e2.reshape(-1), f
    )
    if not h:
        return None
    try:
        n = lib.wrt_bvh_num_nodes(h)
        node_min = np.empty((n, 3), np.float32)
        node_max = np.empty((n, 3), np.float32)
        right = np.empty((n,), np.int32)
        face0 = np.empty((n,), np.int32)
        face1 = np.empty((n,), np.int32)
        skip = np.empty((n,), np.int32)
        if n:
            lib.wrt_bvh_copy(
                h, node_min.reshape(-1), node_max.reshape(-1), right, face0,
                face1, skip,
            )
        return BVH(
            node_min=node_min, node_max=node_max, right_idx=right,
            face0=face0, face1=face1, skip=skip,
        )
    finally:
        lib.wrt_bvh_free(h)
