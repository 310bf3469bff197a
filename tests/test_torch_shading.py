"""The port's device math against its jnp twins in the JAX megakernel.

Camera ray (megakernel.py:498-509), the BxDF samplers ``_sample_diffuse``
/ ``_reflect`` / ``_dielectric`` (:237-311), the sphere/disc test
(:2133-2160) and the watertight dense row test (:898-956), on the same
seeded inputs. The camera, sphere/disc and dense-test twins are the
kernel's expressions written out here in jnp (the kernel holds them
inline). The twins run op by op (no jit): a fused XLA CPU loop contracts
products into FMAs, which the kernel under test (built with -fmad=false)
and its plain torch version never do. Tolerance rtol = atol = 1e-6: XLA
has its own rsqrt/log/cos/sin, so results may differ in the last ulp;
boolean outcomes must agree exactly.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ipu_ray_lib_tpu.ops.pallas import megakernel as jmk
from ipu_ray_lib_tpu_torch.ops import bxdf, camera, intersect
from ipu_ray_lib_tpu_torch.ops.vec3 import normalize3

N = 2048
TOL = dict(rtol=1e-6, atol=1e-6)


def _unit(r, n):
    v = r.standard_normal((3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0, keepdims=True).astype(np.float32)


def _t(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)


def _j(a):
    return tuple(jnp.asarray(x) for x in a)


def _approx_recip(x):
    # pl.reciprocal has a lowering but no eager rule; one jitted op:
    return jax.jit(lambda v: pl.reciprocal(v, approx=True))(x)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


class _Params:
    fov_radians = float(np.pi / 4)
    image_width = 96
    image_height = 64
    anti_alias_scale = 0.25


def test_camera_ray_matches_kernel():
    r = np.random.default_rng(0)
    pr = r.integers(0, 64, N).astype(np.float32)
    pc = r.integers(0, 96, N).astype(np.float32)
    g1, g2 = r.standard_normal((2, N)).astype(np.float32)
    p = _Params
    tan_theta = float(np.tan(p.fov_radians / 2.0))
    aspect = p.image_width / p.image_height

    def jcam(pr, pc, g1, g2):
        pu = pr + np.float32(p.anti_alias_scale) * g1
        pv = pc + np.float32(p.anti_alias_scale) * g2
        xn = pv * np.float32(1.0 / p.image_width) - 0.5
        yn = pu * np.float32(1.0 / p.image_height) - 0.5
        dx = np.float32(2.0 * aspect * tan_theta) * xn
        dy = np.float32(-2.0 * tan_theta) * yn
        return jmk._normalize3((dx, dy, jnp.full_like(dx, -1.0)))

    want = jcam(pr, pc, g1, g2)
    o, d = camera.camera_ray(*_t((pr, pc, g1, g2)), camera.camera_consts(p))
    _close(d, want)
    np.testing.assert_array_equal(o[2].numpy(), -jmk.RAY_EPSILON)
    np.testing.assert_array_equal(o[0].numpy(), 0.0)


def test_sample_diffuse_matches_kernel():
    r = np.random.default_rng(1)
    n = _unit(r, N)
    u1, u2 = r.random((2, N)).astype(np.float32)
    u1[:4] = 0.5  # the concentric map's centre (ux == uy == 0)
    u2[:4] = 0.5
    want = jmk._sample_diffuse(_j(n), jnp.asarray(u1), jnp.asarray(u2))
    got = bxdf.sample_diffuse(_t(n), *_t((u1, u2)))
    _close(got, want)


def test_reflect_matches_kernel():
    r = np.random.default_rng(2)
    d, n = _unit(r, N), _unit(r, N)
    want = jmk._reflect(_j(d), _j(n))
    _close(bxdf.reflect(_t(d), _t(n)), want)


def test_dielectric_matches_kernel():
    r = np.random.default_rng(3)
    d, n = _unit(r, N), _unit(r, N)
    ior = r.choice([1.0, 1.33, 1.52, 2.4], N).astype(np.float32)
    u = r.random(N).astype(np.float32)
    wd, wm = jmk._dielectric(_j(d), _j(n), jnp.asarray(ior),
                                      jnp.asarray(u))
    gd, gm = bxdf.dielectric(_t(d), _t(n), *_t((ior, u)))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert 0 < int(gm.sum()) < N  # both branches exercised
    _close(gd, wd)


def _rays(r, n):
    """Rays from inside the Cornell box in random directions."""
    o = np.stack([r.uniform(-270, 270, n), r.uniform(-270, 270, n),
                  r.uniform(-1350, -800, n)]).astype(np.float32)
    return o, _unit(r, n)


@pytest.fixture(scope="module")
def bench_tables():
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

    ts, _ = build_scene(make_cornell_box_scene(
        "assets/monkey_bust.glb", box_only=False), device="cpu", image_width=32,
        image_height=32)
    return ts


def test_analytic_hit_matches_kernel(bench_tables):
    r = np.random.default_rng(4)
    o, d = _rays(r, N)
    # aim a third of the rays at the spheres and the disc:
    ap = bench_tables.ap.numpy()
    tgt = ap[r.integers(0, 3, N // 3), 1:4].T
    d[:, :N // 3] = (tgt - o[:, :N // 3]) / np.linalg.norm(
        tgt - o[:, :N // 3], axis=0)
    best_t = np.where(r.random(N) < 0.3, np.float32(np.inf),
                      r.uniform(100, 2000, N)).astype(np.float32)
    best_t[:16] = -1.0  # inactive lanes

    def jtest(ap, o, d, bt_a):
        kind = ap[:, 0:1]
        cx, cy, cz = ap[:, 1:2], ap[:, 2:3], ap[:, 3:4]
        nx, ny, nz = ap[:, 4:5], ap[:, 5:6], ap[:, 6:7]
        r2, doff = ap[:, 7:8], ap[:, 8:9]
        ocx, ocy, ocz = cx - o[0], cy - o[1], cz - o[2]
        tca = ocx * d[0] + ocy * d[1] + ocz * d[2]
        l2 = ocx * ocx + ocy * ocy + ocz * ocz - tca * tca
        td = jnp.sqrt(jnp.maximum(r2 - l2, 0.0))
        t0, t1 = tca - td, tca + td
        t_sph = jnp.where(t0 < 0.0, t1, t0)
        ok_sph = (kind == 1.0) & (tca >= 0.0) & (l2 <= r2) & (t_sph > 0.0)
        dn_ = nx * d[0] + ny * d[1] + nz * d[2]
        on_ = nx * o[0] + ny * o[1] + nz * o[2]
        t_dsc = -(on_ + doff) / jnp.where(dn_ == 0.0, 1.0, dn_)
        hx = o[0] + d[0] * t_dsc - cx
        hy = o[1] + d[1] * t_dsc - cy
        hz = o[2] + d[2] * t_dsc - cz
        d2 = hx * hx + hy * hy + hz * hz
        ok_dsc = (kind == 2.0) & (dn_ != 0.0) & (t_dsc > 0.0) & (d2 < r2)
        t_ap = jnp.where(ok_sph | ok_dsc,
                         jnp.where(kind == 1.0, t_sph, t_dsc), jnp.inf)
        t_ap = jnp.where(t_ap < bt_a, t_ap, jnp.inf)
        bt = jnp.min(t_ap, axis=0)
        lane = jax.lax.broadcasted_iota(jnp.int32, t_ap.shape, 0)
        bi = jnp.min(jnp.where(t_ap <= bt, lane, 2**31 - 1), axis=0)
        return bt, bi

    wt, wi = jtest(jnp.asarray(ap), _j(o), _j(d), jnp.asarray(best_t))
    gt, gi = intersect.analytic_hit(bench_tables.ap, _t(o), _t(d),
                                    torch.from_numpy(best_t))
    wt, wi = np.asarray(wt), np.asarray(wi)
    hit = np.isfinite(wt)
    assert hit.sum() > N // 10
    np.testing.assert_array_equal(np.isfinite(gt.numpy()), hit)
    np.testing.assert_allclose(gt.numpy()[hit], wt[hit], **TOL)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_dense_rows_match_kernel(bench_tables):
    r = np.random.default_rng(5)
    o, d = _rays(r, 512)
    o_mag = np.max(np.abs(o), axis=0)
    pb = bench_tables.p.numpy()  # every row of the bench scene

    def jtest(pb, o, d, omq):
        def col(c):
            return pb[:, c:c + 1]

        def tdot(c0, rr):
            return col(c0) * rr[0] + col(c0 + 1) * rr[1] + col(c0 + 2) * rr[2]

        on, dn = tdot(3, o), tdot(3, d)
        og1, dg1 = tdot(6, o), tdot(6, d)
        og2, dg2 = tdot(9, o), tdot(9, d)
        rr = _approx_recip(dn)
        rr = rr * (2.0 - dn * rr)
        t = (col(0) - on) * rr
        b1 = og1 + t * dg1 - col(1)
        b2 = og2 + t * dg2 - col(2)
        et = (col(14) + jnp.abs(on)) * jnp.abs(rr)
        eps = jnp.minimum(col(12) + col(13) * (omq + et), np.float32(1e-3))
        ok = (jnp.minimum(b1, b2) >= -eps) & (b1 + b2 <= 1.0 + eps) & (t > 0.0)
        return t, ok

    wt, wok = jtest(jnp.asarray(pb), _j(o), _j(d), jnp.asarray(o_mag))
    gt, gok = intersect.dense_rows(torch.from_numpy(pb), _t(o), _t(d),
                                   torch.from_numpy(o_mag))
    wok = np.asarray(wok)
    assert wok.sum() > 100
    np.testing.assert_array_equal(gok.numpy(), wok)
    np.testing.assert_allclose(gt.numpy()[wok], np.asarray(wt)[wok], **TOL)


def test_normalize_uses_exact_reciprocal_sqrt():
    v = _t(np.random.default_rng(6).standard_normal((3, N)).astype(np.float32))
    n = normalize3(v)
    x = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    il = 1.0 / torch.sqrt(x)
    np.testing.assert_array_equal(n[0].numpy(), (v[0] * il).numpy())
