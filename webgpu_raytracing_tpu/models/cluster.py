"""Triangle clusters — the clustered traversal's acceleration structure.

Instead of a WGSL-style per-ray BVH descent (render.ts:433-640), the
clustered tracers (ops/cluster_trace.py, ops/cluster_triton.py) test a
tile of rays against whole clusters of up to ``CLUSTER_SIZE`` triangles,
stored as dense padded blocks:

* cluster membership comes from the preorder BVH leaf sequence (leaves in
  preorder are spatially coherent), so consecutive runs of faces form
  tight boxes — the build is a single pass over the already-built tree;
* each cluster's triangles are precomputed into the bilinear-form vectors
  that let the XLA path select Möller–Trumbore candidates with one
  ray-block × tri-block product (ops/cluster_trace.py derives the algebra);
* padding triangles are degenerate (n = 0 ⇒ det = 0 ⇒ culled by the
  backface test), so no masking is needed in the hot loop.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .bvh import BVH
from .face import FaceSet

CLUSTER_SIZE = 64

# inverted-empty AABB for pad clusters: min > max makes every slab test
# miss (near > far), so pad rows are unreachable by construction
_PAD_BOX_LO = np.float32(3.0e38)
_PAD_BOX_HI = np.float32(-3.0e38)


@dataclasses.dataclass
class ClusterSet:
    """Dense per-cluster tables (numpy, host). Face references are into
    the *global* face order of the owning scene."""

    # (C, 6): AABB min/max
    box: np.ndarray
    # (C, CLUSTER_SIZE, 3) each: Möller–Trumbore bilinear-form vectors
    n: np.ndarray  # cross(e1, e2) — unnormalized geometric normal
    e1: np.ndarray
    e2: np.ndarray
    q1: np.ndarray  # cross(p0, e1)
    q2: np.ndarray  # cross(p0, e2)
    k0: np.ndarray  # (C, CLUSTER_SIZE): dot(p0, n)
    face_id: np.ndarray  # (C, CLUSTER_SIZE) int32 global face id (-1 pad)
    # two-level grouping (large scenes): super s owns cluster rows
    # [s*group, (s+1)*group); pad rows have empty boxes (min > max) and
    # zero matrices. None/0 = single-level.
    super_box: np.ndarray | None = None  # (C2, 6)
    group: int = 0

    @property
    def n_clusters(self) -> int:
        return self.box.shape[0]


def leaf_face_order(bvh: BVH) -> np.ndarray:
    """Model-local face indices in preorder-leaf order (spatially
    coherent traversal order of the median-split tree)."""
    order = []
    for i in range(len(bvh)):
        if bvh.right_idx[i] < 0:
            if bvh.face0[i] >= 0:
                order.append(bvh.face0[i])
            if bvh.face1[i] >= 0:
                order.append(bvh.face1[i])
    return np.array(order, dtype=np.int64)


def treelet_cut(bvh: BVH, max_faces: int) -> list:
    """Cut the tree into maximal subtrees holding ≤ max_faces faces each;
    returns a list of face-index arrays (model-local). Treelets are real
    BVH nodes, so their boxes partition space far better than arbitrary
    leaf-order runs — less box overlap ⇒ fewer clusters per ray."""
    n = len(bvh)
    # subtree face counts, computed leaf-up (children follow parents in
    # preorder, so a reverse sweep sees children first)
    counts = np.zeros(n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        r = bvh.right_idx[i]
        if r < 0:
            counts[i] = int(bvh.face0[i] >= 0) + int(bvh.face1[i] >= 0)
        else:
            counts[i] = counts[i + 1] + counts[r]

    def subtree_faces(root: int) -> np.ndarray:
        out = []
        stack = [root]
        while stack:
            i = stack.pop()
            r = bvh.right_idx[i]
            if r < 0:
                if bvh.face0[i] >= 0:
                    out.append(bvh.face0[i])
                if bvh.face1[i] >= 0:
                    out.append(bvh.face1[i])
            else:
                stack.append(r)
                stack.append(i + 1)
        return np.array(out, dtype=np.int64)

    cuts = []
    stack = [0] if n else []
    while stack:
        i = stack.pop()
        if counts[i] <= max_faces or bvh.right_idx[i] < 0:
            cuts.append(subtree_faces(i))
        else:
            stack.append(bvh.right_idx[i])
            stack.append(i + 1)
    return cuts


def build_clusters(
    models: List,  # List[Model] (scene.py); avoids a circular import
    cluster_size: int = CLUSTER_SIZE,
    group_size: int = 0,
) -> ClusterSet:
    """Chunk every model's preorder-leaf face sequence into clusters.

    Clusters never span models, so the model→face-range mapping (the
    light-sampling contract) stays intact.

    With ``group_size`` G > 0, consecutive clusters (which are sibling
    treelets in DFS order, hence spatially coherent) are additionally
    grouped into *superclusters* of exactly G children; the global list is
    padded to a multiple of G with empty clusters (box min > max ⇒ every
    slab test misses; zero matrices ⇒ det = 0 ⇒ culled). Supers MAY span
    model boundaries — clusters reference global face ids, so the only
    cost is one looser super box per seam, far cheaper than per-model
    padding on many-model scenes. The super boxes key the ray sort
    (``ClusterTables.sort_box``) at C/G boxes per ray (BASELINE config
    #5); the tracers still test every child box per tile.
    """
    boxes, ns, e1s, e2s, q1s, q2s, k0s, fids = [], [], [], [], [], [], [], []

    def emit_pad():
        boxes.append(
            np.array([_PAD_BOX_LO] * 3 + [_PAD_BOX_HI] * 3, np.float32)
        )
        zero3 = np.zeros((cluster_size, 3), np.float32)
        ns.append(zero3)
        e1s.append(zero3)
        e2s.append(zero3)
        q1s.append(zero3)
        q2s.append(zero3)
        k0s.append(np.zeros((cluster_size,), np.float32))
        fids.append(np.full((cluster_size,), -1, np.int32))

    face_offset = 0
    for m in models:
        faces: FaceSet = m.faces
        for sel in treelet_cut(m.bvh, cluster_size):
            cnt = sel.shape[0]
            p0 = faces.p0[sel]
            e1 = faces.e1[sel]
            e2 = faces.e2[sel]

            v0, v1, v2 = p0, p0 + e1, p0 + e2
            lo = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
            hi = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
            # pad degenerate axes, same policy as the BVH (bv.ts:54-61) —
            # a zero-thickness box fails the strict slab test
            thin = (hi - lo) < 0.01
            hi = hi + thin.astype(np.float32) * 0.01

            def pad(a, fill=0.0):
                out = np.full(
                    (cluster_size,) + a.shape[1:], fill, dtype=np.float32
                )
                out[:cnt] = a
                return out

            n = np.cross(e1, e2).astype(np.float32)
            q1 = np.cross(p0, e1).astype(np.float32)
            q2 = np.cross(p0, e2).astype(np.float32)
            k0 = np.einsum("ij,ij->i", p0, n).astype(np.float32)

            fid = np.full((cluster_size,), -1, dtype=np.int32)
            fid[:cnt] = sel + face_offset

            boxes.append(np.concatenate([lo, hi]).astype(np.float32))
            ns.append(pad(n))
            e1s.append(pad(e1.astype(np.float32)))
            e2s.append(pad(e2.astype(np.float32)))
            q1s.append(pad(q1))
            q2s.append(pad(q2))
            k0s.append(pad(k0))
            fids.append(fid)
        face_offset += len(faces)
    if group_size:
        # pad the GLOBAL cluster list to a whole number of supers
        while len(boxes) % group_size:
            emit_pad()

    super_box = None
    if group_size:
        box_arr = np.stack(boxes)
        c2 = box_arr.shape[0] // group_size
        grp = box_arr.reshape(c2, group_size, 6)
        # union over real children only (pads are inverted-empty)
        super_box = np.concatenate(
            [grp[:, :, 0:3].min(axis=1), grp[:, :, 3:6].max(axis=1)],
            axis=-1,
        ).astype(np.float32)

    return ClusterSet(
        box=np.stack(boxes),
        n=np.stack(ns),
        e1=np.stack(e1s),
        e2=np.stack(e2s),
        q1=np.stack(q1s),
        q2=np.stack(q2s),
        k0=np.stack(k0s),
        face_id=np.stack(fids),
        super_box=super_box,
        group=group_size,
    )
