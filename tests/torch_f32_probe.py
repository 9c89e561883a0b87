"""Where the port's float32 engine parts from the JAX engine's on the cp
course, op by op, with the same RANSAC draws.

    PYTHONPATH=.:tests python tests/torch_f32_probe.py [preset|VGICP] [frames]

Both engines preprocess the first frames in float32 (JAX with x64 off, as
chip_smoke.py's reference runs): the clouds, ego velocity, floor and the
prepared covariances are compared, then the last frame's RBF covariance
piece by piece: the squared norms (against the plain sum and XLA's fused
multiply-add contraction of it), the distances, the weights, the moment
sums, and the covariances the port's tail makes from JAX's own sums. Prints
one line per quantity: the largest difference and how many entries differ.
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_shared_cache  # noqa: E402,F401  (one torch thread)

import chip_smoke as cs  # noqa: E402
from rivslam_tpu import pipeline as ref_pipeline, presets as ref_presets  # noqa: E402
from rivslam_tpu.core.pointcloud import SENTINEL, RadarCloud as RefCloud  # noqa: E402
from rivslam_tpu.eval.validation import build_course_cfg  # noqa: E402
from rivslam_tpu.frontend import apdgicp_fast as ref_fast  # noqa: E402
from rivslam_tpu_torch import pipeline, presets  # noqa: E402
from rivslam_tpu_torch.core import prng  # noqa: E402
from rivslam_tpu_torch.core.pointcloud import RadarCloud  # noqa: E402
from rivslam_tpu_torch.frontend import apdgicp_fast  # noqa: E402
from rivslam_tpu_torch.io import datasets, synthetic  # noqa: E402
from rivslam_tpu_torch.ops import eig3  # noqa: E402


def say(name, a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    print(f"  {name}: largest difference {d.max():.3e}, {(d > 0).sum()} of {d.size} differ", flush=True)


def covariance_tail(acc):
    """The port's moments -> covariance -> PLANE regularization, from sums."""
    cnt = torch.clamp_min(acc[:, 0], 1e-6)
    m = [acc[:, i] / cnt for i in (1, 2, 3)]
    c = [acc[:, k] / cnt - m[i] * m[j] for k, i, j in ((4, 0, 0), (5, 0, 1), (6, 0, 2), (7, 1, 1), (8, 1, 2),
                                                       (9, 2, 2))]
    return np.stack([r.numpy() for r in eig3.plane_regularize_soa(*c, 1e-3)], 1)


def main(which="preset", n_frames=1):
    if which == "preset":
        ref_cfg, cfg = cs.preset_cfg(ref_presets), cs.preset_cfg(presets)
    else:
        ref_cfg, cfg = build_course_cfg("cp", which), cs.voxel_cfg(which)
    st = datasets.stack_sequence(synthetic.simulate_sequence(**cs.COURSE)[0], cs.ENGINE_CAPACITY,
                                 cs.ENGINE_IMU_CAPACITY)
    ref_eng = ref_pipeline.Engine(ref_cfg, dtype=jnp.float32, seed=0)
    eng = pipeline.Engine(cfg, dtype=torch.float32, seed=0, device="cpu")
    ref_key, key = jax.random.key(0), prng.key(0)
    ext = np.asarray(cfg.imu.ext_rot, np.float64).reshape(3, 3)
    ref_floor, floor = jnp.array([0.0, 0.0, 1.0, 0.0], jnp.float32), torch.tensor([0.0, 0.0, 1.0, 0.0])
    for f in range(n_frames):
        ref_key, ref_k1 = jax.random.split(ref_key)
        key, k1 = prng.split(key)
        gyr = st["imu_gyr"][f] @ ext.T if cfg.imu.apply_extrinsics else st["imu_gyr"][f]
        ang_vel = gyr[np.argmax(st["imu_mask"][f])] if st["imu_mask"][f].any() else np.zeros(3)
        arrays = {k: np.asarray(st[k][f], np.float32) for k in ("xyz", "doppler", "intensity")}
        ref_out = ref_eng._prog.preprocess(
            RefCloud(**{k: jnp.asarray(v) for k, v in arrays.items()}, mask=jnp.asarray(st["mask"][f])),
            jnp.asarray(ang_vel, jnp.float32), ref_k1, ref_floor)
        reve_u, floor_u = eng._draw_sequence([k1], cs.ENGINE_CAPACITY, None)
        out = eng._preprocess(
            RadarCloud(**{k: torch.as_tensor(v) for k, v in arrays.items()}, mask=torch.as_tensor(st["mask"][f])),
            torch.as_tensor(ang_vel, dtype=torch.float32), floor, (reve_u[0], floor_u[0]))
        (ref_cl, ref_ego, ref_prep, ref_fl, _, ref_floor), (cl, ego, prep, fl, _, floor) = ref_out, out
        valid = np.asarray(ref_prep.mask)
        print(f"frame {f}: {valid.sum()} valid points", flush=True)
        say("cloud xyz", ref_cl.xyz, cl.xyz)
        say("ego velocity", ref_ego.v, ego.v)
        say("floor", ref_fl.coeffs, fl.coeffs)
        off = np.abs(np.asarray(ref_prep.cov) - prep.cov.numpy()).reshape(-1, 9).max(1)[valid]
        print(f"  covariances off by over 1e-2: {(off > 1e-2).sum()} of {valid.sum()}", flush=True)

    # the last frame's RBF covariance, piece by piece
    xyz, mask, rc = np.asarray(ref_prep.xyz), valid, ref_cfg.registration
    prec = ref_fast._bulk_precision(rc)

    @jax.jit
    def ref_pieces(xyz, mask):
        sent = jnp.where(mask[:, None], xyz, SENTINEL)
        n2 = jnp.sum(sent * sent, axis=1)
        d2 = jnp.maximum(n2[:, None] + n2[None, :] - 2.0 * jnp.matmul(sent, sent.T, precision=prec), 0.0)
        W = jnp.where((d2 <= rc.rbf_max_dist**2) & mask[None, :], jnp.exp(-rc.rbf_kernel_width * d2), 0.0)
        x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        feats = jnp.stack([jnp.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z], axis=1)
        return n2, d2, W, jnp.matmul(W, feats, precision=prec)

    ref_n2, ref_d2, ref_W, ref_acc = (np.asarray(a) for a in ref_pieces(jnp.asarray(xyz), jnp.asarray(mask)))
    t_xyz, t_mask = torch.as_tensor(xyz)[None], torch.as_tensor(mask)[None]
    d2 = torch.clamp_min(apdgicp_fast._self_sqdist(t_xyz, t_mask), 0.0)[0]
    W = torch.where((d2 <= rc.rbf_max_dist**2) & t_mask[0][None, :], torch.exp(-rc.rbf_kernel_width * d2), 0.0)
    x, y, z = t_xyz[0].unbind(-1)
    feats = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z], dim=-1)
    a, b, c = (xyz[mask, i].astype(np.float64) for i in range(3))
    plain = ((a * a).astype(np.float32) + (b * b).astype(np.float32)) + (c * c).astype(np.float32)
    fused = (c * c + (b * b + (a * a).astype(np.float32)).astype(np.float32)).astype(np.float32)
    print(f"the last frame's RBF covariance ({mask.sum()} valid points): squared norms equal to JAX's on "
          f"{(plain == ref_n2[mask]).sum()} points summed plainly, {(fused == ref_n2[mask]).sum()} as "
          f"fma(z, z, fma(y, y, x*x))", flush=True)
    say("distances (valid pairs)", ref_d2[np.ix_(mask, mask)], d2.numpy()[np.ix_(mask, mask)])
    say("weights", ref_W, W.numpy())
    say("moment sums (valid rows)", ref_acc[mask], (W @ feats).numpy()[mask])
    say("moment sums from JAX's weights (valid rows)", ref_acc[mask], (torch.as_tensor(ref_W) @ feats).numpy()[mask])
    ref_cov = np.asarray(ref_prep.cov)[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    for name, acc in (("the port's sums", W @ feats), ("JAX's sums", torch.as_tensor(ref_acc))):
        off = np.abs(covariance_tail(acc) - ref_cov).max(1)[mask]
        print(f"  covariances from {name}: {(off > 1e-2).sum()} of {mask.sum()} off JAX's by over 1e-2", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "preset", int(sys.argv[2]) if len(sys.argv) > 2 else 1)
