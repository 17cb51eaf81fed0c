"""Exact CPU simulation of the kernel's near-ordered round loop with the
tile-wide t-prune bound — true round counts per tile size, bounce rays.

Per-ray best dynamics are exact: a ray's best drops to its final t the
moment the cluster containing its winning face is processed (before
that no processed cluster can beat it, since rounds run in near order
and the winner is the global min)."""
import os, sys
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import jax.numpy as jnp
import numpy as np

from webgpu_raytracing_tpu.config import RenderSettings, F32_MAX, MIN_DIST
from webgpu_raytracing_tpu.models.scene import load_scene
from webgpu_raytracing_tpu.utils.paths import ASSETS_DIR, enable_compile_cache
from webgpu_raytracing_tpu.ops.raygen import camera_rays
from webgpu_raytracing_tpu.ops import rng
from webgpu_raytracing_tpu.ops.cluster_trace import trace_closest_clustered
from webgpu_raytracing_tpu.ops.intersect import safe_inv_dir
from webgpu_raytracing_tpu.ops.ray_sort import nearest_cluster_key

W, H = 512, 384
R = W * H
settings = RenderSettings(width=W, height=H)
enable_compile_cache()
scene = load_scene(
    os.path.join(ASSETS_DIR, "raytraced-scene.obj"),
    os.path.join(ASSETS_DIR, "raytraced-scene.mtl"),
)
tables = scene.tables()
boxes = np.asarray(tables.clusters.box)
C = boxes.shape[0]
# face -> cluster map
fid = np.asarray(tables.clusters.face_id)  # (C, S)
n_faces = int(fid.max()) + 1
face2cl = np.full(n_faces, -1, np.int32)
for c in range(C):
    sel = fid[c] >= 0
    face2cl[fid[c][sel]] = c

ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.int32), jnp.arange(W, dtype=jnp.int32), indexing="ij")
idx = (xs + ys * W).reshape(R)
base_pos = jnp.stack([xs, ys], axis=-1).reshape(R, 2).astype(jnp.float32)
view = jnp.eye(4, dtype=jnp.float32)

state = rng.seed_state(jnp.broadcast_to(jnp.uint32(1), (R,)), idx)
o, d, state = camera_rays(base_pos, view, state, settings)
tmax = jnp.full((R,), F32_MAX, jnp.float32)
hit = trace_closest_clustered(o, d, tmax, tables, None, tile=256)

t2, state = rng.random_2(state)
nd = np.asarray(rng.sample_cosine_weighted_hemisphere(t2, -d))
found = np.asarray(hit.face) >= 0
no = np.asarray(o) + np.asarray(d) * np.where(found, np.asarray(hit.t), 1.0)[:, None]
btm = np.where(found, F32_MAX, 0.0).astype(np.float32)
bh = trace_closest_clustered(jnp.asarray(no), jnp.asarray(nd), jnp.asarray(btm), tables, None, tile=256)
bface = np.asarray(bh.face)
bt = np.where(bface >= 0, np.asarray(bh.t), btm)  # miss live rays keep t_max
bwc = np.where(bface >= 0, face2cl[np.maximum(bface, 0)], -1)
inv = np.asarray(safe_inv_dir(jnp.asarray(nd)))

key = np.asarray(nearest_cluster_key(
    jnp.asarray(no), jnp.asarray(nd), jnp.asarray(btm),
    jnp.asarray(tables.clusters.sort_box)))
order = np.argsort(key, kind="stable")

def ray_nears(o_, inv_, tm_):
    near = np.full((o_.shape[0], C), -np.float32(np.inf), np.float32)
    far = np.full((o_.shape[0], C), np.float32(np.inf), np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for ax in range(3):
            t0 = (boxes[None, :, ax] - o_[:, ax:ax+1]) * inv_[:, ax:ax+1]
            t1 = (boxes[None, :, 3+ax] - o_[:, ax:ax+1]) * inv_[:, ax:ax+1]
            near = np.maximum(near, np.minimum(t0, t1))
            far = np.minimum(far, np.maximum(t0, t1))
    h = (near < far) & (near < tm_[:, None]) & (far > MIN_DIST)
    return np.where(h, np.maximum(near, 0.0), np.float32(np.inf))

for tile in (128, 256, 512):
    rounds_all = []
    for i in range(0, R, tile):
        sel = order[i:i+tile]
        nr = ray_nears(no[sel], inv[sel], btm[sel])
        tile_near = nr.min(axis=0)  # (C,)
        cl_order = np.argsort(tile_near, kind="stable")
        best = btm[sel].copy()  # init best = t_max (0 for dead lanes)
        bound = best.max()
        rounds = 0
        for c in cl_order:
            nc = tile_near[c]
            if not (nc < bound):
                break
            rounds += 1
            wins = bwc[sel] == c
            best = np.where(wins, bt[sel], best)
            bound = best.max()
        rounds_all.append(rounds)
    r_ = np.array(rounds_all)
    per_ray_work = r_.sum() * tile / R  # epilogue elems per ray (x4S)
    print(f"tile={tile:3d}: rounds mean {r_.mean():6.1f} p95 {np.percentile(r_,95):5.0f} "
          f"p99 {np.percentile(r_,99):5.0f} | serial rounds/ray {r_.sum()/R:.3f} "
          f"| epilogue work/ray {per_ray_work:.1f}", flush=True)
