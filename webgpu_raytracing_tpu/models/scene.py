"""Scene assembly: models + materials → flat device tables.

The reference serializes faces/BVH/models/materials into four storage
buffers with a bump allocator (scene.ts:39-60, 179-334). Here the same
logical content becomes SoA ``jnp`` arrays, with one structural change: the
per-model preorder BVHs are concatenated and their skip links rebased so
that the whole scene is ONE threaded tree walk — the outer per-model loop
of the reference traversal (render.ts:456-462) becomes falling off one
model's subtree straight into the next root.

Load-bearing contract preserved: **model 0 is the light source** — NEE
samples ``models[0]`` (render.ts:849-852); the reference guarantees this by
hand-ordering its 8-model subset with Light first (render.ts:91-100).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import numpy as np

from .bvh import BVH, build_bvh
from .face import FaceSet
from .mtl import parse_mtl
from .obj import parse_obj
from .test_models import triangle_model, unit_cube_model

# The reference renders this hand-picked, reordered subset of the 13 loaded
# models (render.ts:91-100). Load order is [unitCube, triangle, Light,
# back_wall, ceiling, Dodecahedron, Floor, Ladder, left_wall, right_wall,
# Suzanne, TallBox, Teapot], so the rendered set is Light, Suzanne, Floor,
# TallBox, left_wall, Dodecahedron, back_wall, ceiling — Light first.
REFERENCE_SUBSET = (2, 10, 6, 11, 8, 5, 3, 4)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Device-resident scene data (all jnp arrays; a jit-able pytree)."""

    # traversal tables, all models concatenated & threaded
    node_box: jax.Array  # (N, 8) f32: min.xyz, max.xyz, 0, 0
    node_meta: jax.Array  # (N, 4) i32: skip, face0, face1, 0 (global face ids)
    # face tables (global face indices)
    tri: jax.Array  # (F, 9) f32: p0, e1, e2
    shade_normal: jax.Array  # (F, 12) f32: faceNormal, n0, n1, n2
    face_material: jax.Array  # (F,) i32
    # model table (scene.ts:211-221): faces offset/count, bvh offset/count
    model_face_offset: jax.Array  # (M,) i32
    model_face_count: jax.Array  # (M,) i32
    # materials (scene.ts:241-269)
    mat_color: jax.Array  # (K, 3) f32
    mat_emission: jax.Array  # (K, 3) f32
    # clustered acceleration tables (ops/cluster_trace.py)
    clusters: object  # ClusterTables pytree

    @property
    def n_nodes(self) -> int:
        return self.node_box.shape[0]

    @property
    def n_faces(self) -> int:
        return self.tri.shape[0]


@dataclasses.dataclass
class Model:
    name: str
    faces: FaceSet
    bvh: BVH


@dataclasses.dataclass
class Scene:
    models: List[Model]
    mat_color: np.ndarray  # (K, 3) f32
    mat_emission: np.ndarray  # (K, 3) f32
    mat_names: List[str]

    def select(self, indices: Sequence[int]) -> "Scene":
        return Scene(
            models=[self.models[i] for i in indices],
            mat_color=self.mat_color,
            mat_emission=self.mat_emission,
            mat_names=self.mat_names,
        )

    def tables(
        self, cluster_size: int = 128, group_size: int | None = None
    ) -> SceneTables:
        """Flatten all models into threaded traversal + shading tables."""
        import jax.numpy as jnp

        n_total = sum(len(m.bvh) for m in self.models)
        node_box_l, node_meta_l = [], []
        face_off, face_cnt = [], []
        node_off = 0
        foff = 0
        for m in self.models:
            b = m.bvh
            n = len(b)
            box = np.zeros((n, 8), dtype=np.float32)
            box[:, 0:3] = b.node_min
            box[:, 3:6] = b.node_max
            meta = np.zeros((n, 4), dtype=np.int32)
            meta[:, 0] = b.skip + node_off  # model-local end == next root
            meta[:, 1] = np.where(b.face0 >= 0, b.face0 + foff, -1)
            meta[:, 2] = np.where(b.face1 >= 0, b.face1 + foff, -1)
            node_box_l.append(box)
            node_meta_l.append(meta)
            face_off.append(foff)
            face_cnt.append(len(m.faces))
            node_off += n
            foff += len(m.faces)
        assert node_off == n_total

        fs = FaceSet.concat([m.faces for m in self.models])
        tri = np.concatenate([fs.p0, fs.e1, fs.e2], axis=1).astype(np.float32)
        shade = np.concatenate(
            [fs.normal, fs.n0, fs.n1, fs.n2], axis=1
        ).astype(np.float32)

        from ..ops.cluster_trace import pack_cluster_tables
        from .cluster import build_clusters

        if group_size is None:
            # two-level clustering for large scenes (BASELINE config #5):
            # the super boxes key the ray sort at C/G boxes per ray
            total_faces = sum(len(m.faces) for m in self.models)
            group_size = 64 if total_faces > 1024 * cluster_size else 0
        clusters = pack_cluster_tables(
            build_clusters(
                self.models,
                cluster_size=cluster_size,
                group_size=group_size,
            )
        )

        return SceneTables(
            clusters=clusters,
            node_box=jnp.asarray(np.concatenate(node_box_l, axis=0)),
            node_meta=jnp.asarray(np.concatenate(node_meta_l, axis=0)),
            tri=jnp.asarray(tri),
            shade_normal=jnp.asarray(shade),
            face_material=jnp.asarray(fs.material_idx),
            model_face_offset=jnp.asarray(np.array(face_off, np.int32)),
            model_face_count=jnp.asarray(np.array(face_cnt, np.int32)),
            mat_color=jnp.asarray(self.mat_color),
            mat_emission=jnp.asarray(self.mat_emission),
        )


def materials_from_mtl(mtls) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """scene.ts:92-108 — Kd → color, Ke → emission; the material named
    'Light' is forced to color 0, emission (1,1,1)."""
    colors, emissions, names = [], [], []
    for m in mtls:
        if m.name == "Light":
            colors.append((0.0, 0.0, 0.0))
            emissions.append((1.0, 1.0, 1.0))
        else:
            colors.append(m.Kd)
            emissions.append(m.Ke)
        names.append(m.name)
    return (
        np.array(colors, dtype=np.float32),
        np.array(emissions, dtype=np.float32),
        names,
    )


def scene_from_facesets(
    named_facesets: Sequence[Tuple[str, FaceSet]],
    mat_color: np.ndarray,
    mat_emission: np.ndarray,
    mat_names: Optional[List[str]] = None,
) -> Scene:
    models = [
        Model(name=n, faces=f, bvh=build_bvh(f)) for n, f in named_facesets
    ]
    return Scene(
        models=models,
        mat_color=np.asarray(mat_color, np.float32).reshape(-1, 3),
        mat_emission=np.asarray(mat_emission, np.float32).reshape(-1, 3),
        mat_names=mat_names or [f"m{i}" for i in range(len(mat_color))],
    )


def load_scene(
    obj_path: str,
    mtl_path: str,
    selection: Optional[Sequence[int]] = REFERENCE_SUBSET,
    include_fixtures: bool = True,
) -> Scene:
    """loadModels() (scene.ts:83-177): parse OBJ+MTL, prepend the two
    analytic fixtures, build two-sided faces + per-model BVHs; then apply
    the reference's 8-model subset selection (render.ts:91-100)."""
    from .face import build_faces

    with open(mtl_path) as fh:
        mtls = parse_mtl(fh.read())
    mat_color, mat_emission, mat_names = materials_from_mtl(mtls)
    name_to_idx = {n: i for i, n in enumerate(mat_names)}

    import os as _os

    obj = None
    if not _os.environ.get("WRT_NO_NATIVE"):
        from .native import parse_obj_native

        obj = parse_obj_native(obj_path)
    if obj is None:
        with open(obj_path) as fh:
            obj = parse_obj(fh.read())

    models: List[Model] = []
    if include_fixtures:
        for name, fs in (
            ("unitCube", unit_cube_model()),
            ("triangle", triangle_model()),
        ):
            models.append(Model(name=name, faces=fs, bvh=build_bvh(fs)))

    for om in obj.models:
        tris = obj.vertices[om.vertex_idx]  # (F, 3, 3)
        has_n = om.normal_idx.size and (om.normal_idx >= 0).all()
        nrms = obj.normals[om.normal_idx] if has_n else None
        mats = np.array(
            [name_to_idx.get(m, -1) for m in om.material], dtype=np.int32
        )
        fs = build_faces(tris, nrms, mats, two_sided=True)
        models.append(Model(name=om.name, faces=fs, bvh=build_bvh(fs)))

    scene = Scene(
        models=models,
        mat_color=mat_color,
        mat_emission=mat_emission,
        mat_names=mat_names,
    )
    if selection is not None:
        scene = scene.select(selection)
    return scene
