"""NEGATIVE RESULT (kept as reproduction): obstacle POSE is not reliably
fittable by pathwise gradients.

Source position and ior fit well (examples/locate_source.py,
tests/test_diff.py::test_fit_recovers_ior) because their dominant signal
is smooth — hit delays move continuously with the parameter. Moving an
OCCLUDER is different: its dominant effect on the IR is *visibility*
(which rays get blocked), a boundary term that pathwise autodiff misses
entirely without edge sampling (the standard differentiable-path-tracing
bias noted in diff.py's module docstring).

Measured here (4x4 shoebox, 0.8x0.4 slab, 3 microphones, 1024 rays,
16-grid multi-start, annealed blurred loss): the x coordinate recovers
(0.21 vs true 0.20) but y converges to a spurious -0.53 minimum at loss
3e-3 in every start, while the true pose — whose loss is exactly 0 by
common-random-numbers construction — attracts none of them. Fixing this
needs reparametrized/edge-sampled visibility gradients, not more starts.

Run:  python examples/obstacle_pose_negative.py   (~35 s on CPU)
"""

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import optax, time
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from realisticaudioraytracing2d_tpu.models.materials import AudioMaterial
from realisticaudioraytracing2d_tpu.models.rooms import shoebox_room
from realisticaudioraytracing2d_tpu.models.scene import Transform2D
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams
from realisticaudioraytracing2d_tpu import diff

SR, IR_LEN, N_RAYS, B = 16000, 1024, 1024, 4

def setup(center):
    wall = AudioMaterial(absorption=0.3, scattering=0.3)
    obst = AudioMaterial(absorption=0.6, scattering=0.1)
    return shoebox_room(4.0, 4.0, wall_material=wall,
                        obstacles=[(Transform2D(center, 0.0, (0.8, 0.4)), obst)])

params = TraceParams.make(source=(-1.4, 0.2),
                          listeners=[(1.4, -0.3), (1.2, 1.2), (-0.3, -1.4)],
                          listener_radius=0.4)
key = jax.random.PRNGKey(0)
true_c = (0.2, 0.3)
target = diff.simulate_ir(setup(true_c), params, key, n_rays=N_RAYS,
                          max_bounces=B, sample_rate=SR, ir_length=IR_LEN, soft=True)
scene0 = setup((0.0, 0.0))
groups, ng = diff.infer_material_groups(scene0)
g_obst = int(groups[16])
is_g = (jnp.asarray(groups) == g_obst) & scene0.mask

def loss_fn(delta, sigma):
    d = jnp.where(is_g[:, None], delta[None, :], 0.0)
    sc = scene0._replace(a=scene0.a + d, b=scene0.b + d)
    pred = diff.simulate_ir(sc, params, key, n_rays=N_RAYS, max_bounces=B,
                            sample_rate=SR, ir_length=IR_LEN, soft=True)
    return diff._blur_rel_l2(pred, target, sigma)

STEPS = 200
sigmas = jnp.asarray(32.0 * 0.5 ** (np.arange(STEPS) / 30) + 1.0, jnp.float32)

def fit_one(d0):
    adam = optax.adam(0.04)
    def step(carry, sigma):
        d, st = carry
        v, g = jax.value_and_grad(loss_fn)(d, sigma)
        up, st = adam.update(g, st)
        return (optax.apply_updates(d, up), st), v
    (d, _), _ = jax.lax.scan(step, (d0, adam.init(d0)), sigmas)
    return d, loss_fn(d, sigmas[-1])

gx, gy = jnp.meshgrid(jnp.linspace(-0.9, 0.9, 4), jnp.linspace(-0.9, 0.9, 4))
starts = jnp.stack([gx.ravel(), gy.ravel()], -1)  # 16-grid starts
t0 = time.time()
ds, ls = jax.jit(jax.vmap(fit_one))(starts)
ds, ls = np.asarray(ds), np.asarray(ls)
best = int(np.argmin(ls))
print("best", ds[best], "loss", ls[best], "true", true_c,
      f"err {np.linalg.norm(ds[best] - np.asarray(true_c)):.3f} m, {time.time()-t0:.0f}s")
print("top3:", sorted(zip(ls, map(tuple, np.round(ds,2)))) [:3])
