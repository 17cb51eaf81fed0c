"""CPU study: per-tile cluster-union sizes (kernel-round proxy) for
sort-key variants and tile sizes, on real bounce rays at 512x384."""
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

W, H = 512, 384
R = W * H
settings = RenderSettings(width=W, height=H)
enable_compile_cache()
scene = load_scene(
    os.path.join(ASSETS_DIR, "raytraced-scene.obj"),
    os.path.join(ASSETS_DIR, "raytraced-scene.mtl"),
)
tables = scene.tables()
boxes = np.asarray(tables.clusters.box)  # (C, 6)
C = boxes.shape[0]
print(f"C={C} S={tables.clusters.face_id.shape[1]}")

ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.int32), jnp.arange(W, dtype=jnp.int32), indexing="ij")
idx = (xs + ys * W).reshape(R)
base_pos = jnp.stack([xs, ys], axis=-1).reshape(R, 2).astype(jnp.float32)
view = jnp.eye(4, dtype=jnp.float32)

state = rng.seed_state(jnp.broadcast_to(jnp.uint32(1), (R,)), idx)
o, d, state = camera_rays(base_pos, view, state, settings)
tmax = jnp.full((R,), F32_MAX, jnp.float32)
hit = trace_closest_clustered(o, d, tmax, tables, None, tile=256)

# bounce rays
t2, state = rng.random_2(state)
nd = rng.sample_cosine_weighted_hemisphere(t2, -d)
found = np.asarray(hit.face) >= 0
no = np.asarray(o) + np.asarray(d) * np.where(found, np.asarray(hit.t), 1.0)[:, None]
nd = np.asarray(nd)
btmax = np.where(found, F32_MAX, 0.0).astype(np.float32)

# closest hit of bounce rays (for NEED definition: near < t_hit)
bhit = trace_closest_clustered(jnp.asarray(no), jnp.asarray(nd), jnp.asarray(btmax), tables, None, tile=256)
bt = np.asarray(bhit.t)
bt = np.where(np.asarray(bhit.face) >= 0, bt, np.where(found, F32_MAX, 0.0))

# dense per-ray nears (numpy, chunked)
inv = np.asarray(safe_inv_dir(jnp.asarray(nd)))
def ray_nears(o_, inv_, tm_):
    near = np.full((o_.shape[0], C), -np.inf, np.float32)
    far = np.full((o_.shape[0], C), np.inf, np.float32)
    for ax in range(3):
        t0 = (boxes[None, :, ax] - o_[:, ax:ax+1]) * inv_[:, ax:ax+1]
        t1 = (boxes[None, :, 3+ax] - o_[:, ax:ax+1]) * inv_[:, ax:ax+1]
        near = np.maximum(near, np.minimum(t0, t1))
        far = np.minimum(far, np.maximum(t0, t1))
    hitb = (near < far) & (near < tm_[:, None]) & (far > MIN_DIST)
    return np.where(hitb, np.maximum(near, 0.0), np.inf)

def stats(order, tile):
    """Union sizes of NEEDED clusters (near < ray's closest-hit t) per tile."""
    unions = []
    needs = []
    for i in range(0, R, tile):
        sel = order[i:i+tile]
        nr = ray_nears(no[sel], inv[sel], btmax[sel])
        needed = nr <= bt[sel][:, None]   # clusters that must be processed
        needs.append(needed.sum(axis=1))
        unions.append(int(needed.any(axis=0).sum()))
    u = np.array(unions); nd_ = np.concatenate(needs)
    return u.mean(), np.percentile(u, 95), nd_.mean()

def key_n(n_ids):
    nr = np.empty((R, C), np.float32)
    for i in range(0, R, 65536):
        nr[i:i+65536] = ray_nears(no[i:i+65536], inv[i:i+65536], btmax[i:i+65536])
    key = np.zeros(R, np.int64)
    for _ in range(n_ids):
        m = nr.min(axis=1)
        cid = np.where(np.isfinite(m), nr.argmin(axis=1), C)
        key = key * (C + 1) + cid
        nr[np.arange(R), np.minimum(cid, C - 1)] = np.inf
    return key

for n_ids in (1, 2, 3):
    order = np.argsort(key_n(n_ids), kind="stable")
    for tile in (128, 256):
        mu, p95, need = stats(order, tile)
        print(f"key{n_ids} tile={tile}: union mean {mu:.1f} p95 {p95:.0f} (per-ray need {need:.2f})", flush=True)
