"""The port's shadow trace (kernel K4's plain version, ``render`` in
shadow-trace mode, the AOV images) against the JAX package on the CPU.

The JAX side runs its own functions on scenes built with
``intersector="pallas"``, so its fused shadow kernel runs in interpret
mode, as tests/test_render_e2e.py runs it. Ids, masks and occlusion match
exactly and floats bit for bit (``==`` on every element):

* ``generate_camera_rays`` equals the JAX function under ``jit`` with a
  static image size and fov (as the shadow chunk runs it), at two fovs,
  on a square and on a non-aligned crop window;
* ``bundle_cull`` equals the JAX ``bundle_cull`` under ``jit`` on Cornell +
  monkey rays, with a padded chunk;
* ``shadow_trace_ref`` equals the JAX ``fused_shadow_trace_arrays`` on the
  Cornell box, a vertex-normal mesh and random rays from spread origins;
* ``render`` equals the JAX ``render`` on every ``RenderOutput`` field at
  two chunk sizes, on a crop window and with ``aovs=("normal",)``, and the
  golden ``tests/golden/shadow_box48x32.npz``; the AOV images equal the
  JAX ones; the render meets the oracle bounds of test_render_e2e.py.

Bit for bit needs the JAX package's arithmetic as XLA compiles it on the
CPU: a product feeding a sum is one fused multiply-add there, inside the
interpret-mode kernel as in the camera and the epilogue, so the port
writes those as ``fma`` (ops/vec3.py); the tests below show the plain
forms differ. The golden was made with::

    from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.render.renderer import render
    a, p, _ = build_scene(make_cornell_box_scene(None, box_only=False),
                          image_width=48, image_height=32,
                          intersector='pallas')
    out = render(a, p, mode='shadow-trace', chunk_size=512)
    np.savez_compressed('tests/golden/shadow_box48x32.npz', **out._asdict())
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ipu_ray_lib_tpu.scene.types as JT
from ipu_ray_lib_tpu.cpu.reference import oracle_shadow_trace
from ipu_ray_lib_tpu.ops.camera import generate_camera_rays as jax_camera_rays
from ipu_ray_lib_tpu.ops.pallas.intersect_kernel import (
    bundle_cull as jax_bundle_cull)
from ipu_ray_lib_tpu.ops.pallas.shadow_kernel import (
    fused_shadow_trace_arrays as jax_shadow_arrays)
from ipu_ray_lib_tpu.render.aov import VisualiseMode as JaxVisualiseMode
from ipu_ray_lib_tpu.render.aov import make_aov_image as jax_aov_image
from ipu_ray_lib_tpu.render.renderer import render as jax_render
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu.utils.image import mse
import ipu_ray_lib_tpu_torch.scene.build as TB
import ipu_ray_lib_tpu_torch.scene.types as TT
from ipu_ray_lib_tpu_torch.ops import camera as TC
from ipu_ray_lib_tpu_torch.ops import shadow as sh
from ipu_ray_lib_tpu_torch.ops.cull import bundle_cull
from ipu_ray_lib_tpu_torch.ops.vec3 import fma, sqrt
from ipu_ray_lib_tpu_torch.render.aov import VisualiseMode, make_aov_image
from ipu_ray_lib_tpu_torch.render.renderer import render
from ipu_ray_lib_tpu_torch.render.shadow import DEFAULT_LIGHT_POS, shadow_trace
from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

from test_torch_hbm import _jax_leaves, _smooth_scene

ROOT = os.path.join(os.path.dirname(__file__), "..")
MONKEY = os.path.join(ROOT, "assets", "monkey_bust.glb")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "shadow_box48x32.npz")
W, H = 48, 32
LIGHT = tuple(float(v) for v in DEFAULT_LIGHT_POS)
FIELDS = ("rgb", "t", "geom_id", "prim_id", "normal", "hit_p")


def _equal(a, b) -> int:
    """Elements where a != b (inf == inf; no NaN is expected)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return int((a != b).sum())


@pytest.fixture(scope="module")
def box():
    """The 48x32 Cornell box (box + 2 spheres + disc) in both packages."""
    arrays, jparams, _ = jax_build_scene(
        jax_cornell(None, box_only=False), image_width=W, image_height=H,
        intersector="pallas")
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=W, image_height=H,
                                intersector="pallas")
    return arrays, jparams, ts, params


@pytest.fixture(scope="module")
def jax_renders(box):
    """The JAX render at chunk 512 (the golden's) and 48*32, a crop window
    and normals only (chunk 512: one compile for all three)."""
    arrays, jparams, _, _ = box
    crop = dataclasses.replace(jparams, window_w=17, window_h=13,
                               window_c=5, window_r=9)
    return {
        "512": jax_render(arrays, jparams, chunk_size=512),
        "1536": jax_render(arrays, jparams, chunk_size=W * H),
        "crop": jax_render(arrays, crop, chunk_size=512),
        "normal": jax_render(arrays, jparams, chunk_size=512,
                             aovs=("normal",)),
    }


@pytest.fixture(scope="module")
def port_renders(box):
    _, _, ts, params = box
    crop = dataclasses.replace(params, window_w=17, window_h=13,
                               window_c=5, window_r=9)
    sh.reset_launches()
    out = {
        "512": render(ts, params, chunk_size=512),
        "1536": render(ts, params, chunk_size=W * H),
        "crop": render(ts, crop, chunk_size=512),
        "normal": render(ts, params, chunk_size=512, aovs=("normal",)),
    }
    assert sh.launches == 0  # CPU tensors take the plain version
    return out


# ---- 1. camera rays ----

@pytest.mark.parametrize("fov", [np.pi / 4, np.pi / 3])
@pytest.mark.parametrize("size,window", [((48, 48), (48, 48, 0, 0)),
                                         ((48, 32), (17, 13, 5, 9)),
                                         ((1440, 1440), (64, 40, 700, 300))])
def test_camera_rays_match_jax(fov, size, window):
    w, h = size
    rows, cols = TC.pixel_grid(*window, device="cpu")
    jit = jax.jit(lambda r, c: jax_camera_rays(r, c, w, h, fov, 0.0, None))
    jo, jd = jit(rows.numpy(), cols.numpy())
    to, td = TC.generate_camera_rays(rows, cols, w, h, fov)
    assert _equal(to.numpy(), np.asarray(jo)) == 0
    assert _equal(td.numpy(), np.asarray(jd)) == 0


def test_camera_plain_division_is_not_jaxs():
    """The cause of the camera's multiply-add form: XLA divides by the
    image width as a product with its f32 reciprocal, fused with the
    ``- 0.5``; a true division (the JAX source's op-by-op meaning) lands on
    other f32 values for some columns."""
    cols = torch.arange(48, dtype=torch.float32)
    xla = fma(cols, float(np.float32(1.0) / np.float32(48.0)), -0.5)
    plain = cols / torch.tensor(48.0) - 0.5
    jit = jax.jit(lambda c: (c / jnp.float32(48.0)) - 0.5)
    assert _equal(xla.numpy(), np.asarray(jit(cols.numpy()))) == 0
    assert _equal(plain.numpy(), np.asarray(jit(cols.numpy()))) > 0


@pytest.mark.parametrize("fov", [np.pi / 4, np.pi / 3])
def test_tan_is_the_constant_xla_folds(fov):
    """With the fov static, XLA folds tan at compile time to the correctly
    rounded f32 value at both fovs, which the port computes."""
    folded = jax.jit(lambda: jnp.tan(jnp.float32(fov) / 2.0))()
    assert TC.tan_half_fov(fov) == float(folded)


def test_sqrt_is_correctly_rounded():
    """torch.sqrt of an f32 CPU tensor above 512 elements is not correctly
    rounded; the port's sqrt (ops/vec3.py) is, as the kernels' sqrtf and
    XLA's are."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 4.0, 8192).astype(np.float32))
    exact = np.sqrt(x.numpy())  # numpy's f32 sqrt is IEEE
    assert _equal(sqrt(x).numpy(), exact) == 0
    assert _equal(torch.sqrt(x).numpy(), exact) > 0


# ---- 2. bundle cull ----

@pytest.fixture(scope="module")
def monkey():
    ts, params = TB.build_scene(make_cornell_box_scene(MONKEY, box_only=False),
                                device="cpu", image_width=64, image_height=64,
                                intersector="pallas")
    rows, cols = TC.pixel_grid(64, 64, 0, 0, device="cpu")
    return ts, TC.generate_camera_rays(rows, cols, 64, 64,
                                       params.fov_radians)[1]


@pytest.mark.parametrize("n_rays", [4096, 3000])
def test_bundle_cull_matches_jax(monkey, n_rays):
    ts, dirs = monkey
    nrb = -(-n_rays // 1024)
    Rp = nrb * 1024
    d = torch.nn.functional.pad(dirs[:n_rays], (0, 0, 0, Rp - n_rays),
                                value=1.0)
    o = torch.zeros_like(d)
    tmin = torch.zeros(Rp)
    tmax = torch.full((Rp,), float("inf"))
    tmax[n_rays:] = -1.0
    want = jax.jit(jax_bundle_cull, static_argnums=(5,))(
        ts.baabb.numpy(), o.numpy(), d.numpy(), tmin.numpy(), tmax.numpy(),
        nrb)
    got = bundle_cull(ts.baabb, o, d, tmin, tmax, nrb)
    assert int(got[0].sum()) > nrb  # several blocks per bundle
    for g, w in zip(got, want):
        assert _equal(g.numpy(), np.asarray(w)) == 0


# ---- 3. the kernel's plain version against the JAX kernel ----

def _arrays_case(arrays, ts, origins, dirs, light):
    jf, ji = jax_shadow_arrays(arrays, jnp.asarray(origins), jnp.asarray(dirs),
                               light=light, ambient=0.05, interpret=True)
    jf, ji = np.asarray(jf), np.asarray(ji)
    assert not jf[4:].any() and not ji[4:].any()  # rows the port drops
    tf, ti = sh.fused_shadow_trace_arrays(
        ts, torch.from_numpy(origins), torch.from_numpy(dirs), light=light)
    return jf[:4], ji[:4], tf.numpy(), ti.numpy()


@pytest.fixture(scope="module")
def arrays_cases(box):
    arrays, _, ts, params = box
    rows, cols = TC.pixel_grid(W, H, 0, 0, device="cpu")
    dirs = TC.generate_camera_rays(rows, cols, W, H, params.fov_radians)[1]
    cases = {"cornell": _arrays_case(arrays, ts, np.zeros((W * H, 3), np.float32),
                                     dirs.numpy(), LIGHT)}
    # Random rays from origins spread over the box, a third aimed at the
    # spheres and the disc; 3,000 rays, so the last bundle is padded:
    rng = np.random.default_rng(5)
    b = ts.baabb.numpy()
    lo, hi = b[:, 0:3].min(0), b[:, 3:6].max(0)
    o = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo),
                    (3000, 3)).astype(np.float32)
    d = rng.normal(size=(3000, 3)).astype(np.float32)
    tg = ts.ap.numpy()[:, 1:4]
    d[:1000] = (tg[rng.integers(0, len(tg), 1000)]
                + rng.normal(0, 20, (1000, 3)).astype(np.float32) - o[:1000])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cases["random"] = _arrays_case(arrays, ts, o, d, LIGHT)
    # A mesh with vertex normals: the shading normal follows the
    # barycentrics.
    sa, _, _ = jax_build_scene(_smooth_scene(JT), image_width=16,
                               image_height=16, intersector="pallas")
    ss, _ = TB.build_scene(_smooth_scene(TT), device="cpu", image_width=16,
                           image_height=16, intersector="pallas")
    o = rng.uniform(-3, 3, (2048, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(0, 2, 2048)
    d = (np.array([0, -0.4, -3.2], np.float32)
         + rng.normal(0, 0.7, (2048, 3)).astype(np.float32) - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cases["smooth"] = _arrays_case(sa, ss, o, d, (0.5, 2.0, -2.5))
    return cases


@pytest.mark.parametrize("case", ["cornell", "random", "smooth"])
def test_shadow_arrays_match_jax_kernel(arrays_cases, case):
    jf, ji, tf, ti = arrays_cases[case]
    assert _equal(ti, ji) == 0
    assert _equal(tf, jf) == 0
    assert (ji[0] >= 0).sum() > 0 and 0 < ji[3].sum() < ji.shape[1]
    if case == "random":
        assert (ji[1] >= 0).sum() > 50 and (ji[2] >= 0).sum() > 20
    if case == "smooth":  # the sphere's normals vary within triangles
        assert len(np.unique(tf[0][ji[0] >= 0])) > 1000


def test_plain_row_test_is_not_jaxs(box):
    """The cause of the kernel's multiply-add form: the same walk with
    every product rounded before its sum (K1's dense row test) gives other
    hit distances than the JAX kernel in interpret mode."""
    arrays, _, ts, params = box
    rows, cols = TC.pixel_grid(W, H, 0, 0, device="cpu")
    dirs = TC.generate_camera_rays(rows, cols, W, H, params.fov_radians)[1]
    jf, ji = jax_shadow_arrays(arrays, jnp.zeros((W * H, 3)),
                               jnp.asarray(dirs.numpy()), light=LIGHT,
                               ambient=0.05, interpret=True)
    hit = np.asarray(ji)[0] >= 0
    pc = ts.p[torch.from_numpy(np.asarray(ji)[0][hit]).long()]
    dh = dirs[torch.from_numpy(hit)]
    dn = pc[:, 3] * dh[:, 0] + pc[:, 4] * dh[:, 1] + pc[:, 5] * dh[:, 2]
    r = torch.reciprocal(dn.to(torch.bfloat16).float())
    t_plain = pc[:, 0] * (r * (2.0 - dn * r))
    assert _equal(t_plain.numpy(), np.asarray(jf)[3][hit]) > 0


# ---- 4. render ----

@pytest.mark.parametrize("case", ["512", "1536", "crop", "normal"])
def test_render_matches_jax(jax_renders, port_renders, case):
    want, got = jax_renders[case], port_renders[case]
    assert got.hit_count == want.hit_count > 0
    for f in FIELDS:
        assert _equal(getattr(got, f), getattr(want, f)) == 0, f
    if case == "normal":  # not read back: filled
        assert not got.rgb.any() and not got.hit_p.any()
        assert np.isinf(got.t).all() and (got.prim_id == -1).all()


def test_render_holds_shadow_golden(jax_renders, port_renders):
    golden = np.load(GOLDEN)
    for f in FIELDS:
        assert _equal(getattr(jax_renders["512"], f), golden[f]) == 0, f
        assert _equal(getattr(port_renders["512"], f), golden[f]) == 0, f


def test_render_progress_callback(box):
    """The callback fires per chunk with the chunk's rgb, also when rgb is
    not read back (the JAX package raises a KeyError there)."""
    _, _, ts, params = box
    seen = []
    out = render(ts, params, chunk_size=512, aovs=("t",),
                 progress_callback=lambda ci, rgb: seen.append((ci, rgb)))
    assert [ci for ci, _ in seen] == [0, 1, 2]
    assert all(rgb.shape == (512, 3) for _, rgb in seen)
    assert sum(float(rgb.sum()) for _, rgb in seen) > 0
    assert not out.rgb.any() and np.isfinite(out.t).any()


def test_render_path_trace_is_render_streaming():
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=16, image_height=16,
                                samples_per_pixel=1)
    out = render(ts, params, mode="path-trace")
    rgb, done = render_streaming(ts, params, chunk_slots=1 << 16)
    assert done == 256 and _equal(out.rgb, rgb) == 0
    assert (out.geom_id == -1).all() and np.isinf(out.t).all()
    # progressive: spp 1 is one batch seeded rng_seed, the same image
    seen = []
    prog = render(ts, params, mode="path-trace",
                  progress_callback=lambda bi, rgb: seen.append((bi, rgb)))
    assert [bi for bi, _ in seen] == [0]
    assert _equal(seen[0][1], rgb) == 0 and _equal(prog.rgb, rgb) == 0


# ---- 5. AOV images ----

@pytest.mark.parametrize("mode", [m.value for m in VisualiseMode])
def test_aov_images_match_jax(box, jax_renders, port_renders, mode):
    arrays = box[0]
    mat_id, mat_albedo = np.asarray(arrays.mat_id), np.asarray(arrays.mat_albedo)
    want = jax_aov_image(jax_renders["512"], JaxVisualiseMode(mode), mat_id,
                         mat_albedo)
    got = make_aov_image(port_renders["512"], VisualiseMode(mode),
                         box[2].mat_id.numpy(), box[2].mat_albedo.numpy())
    assert _equal(got, want) == 0


# ---- 6. the oracle (tests/test_render_e2e.py bounds) ----

def test_render_meets_oracle_bounds(box, port_renders):
    _, _, _, params = box
    rows, cols = TC.pixel_grid(W, H, 0, 0, device="cpu")
    o, d = TC.generate_camera_rays(rows, cols, W, H, params.fov_radians)
    ref = oracle_shadow_trace(jax_cornell(None, box_only=False), o.numpy(),
                              d.numpy())
    ref = {k: v.reshape((H, W) + v.shape[1:]) for k, v in ref.items()}
    out = port_renders["1536"]
    ours, theirs = out.geom_id >= 0, ref["geom"] >= 0
    assert (ours == theirs).mean() > 0.995
    assert mse(out.rgb, ref["rgb"]) < 2e-3
    both = ours & theirs
    dots = np.abs(np.sum(out.normal * ref["normal"], axis=-1))[both]
    assert np.quantile(dots, 0.02) > 0.999
    err = np.linalg.norm(out.hit_p - ref["hit_p"], axis=-1)[both]
    assert np.quantile(err, 0.99) < 0.5


# ---- 7. the scene leaves the shadow epilogue reads ----

def test_from_jax_arrays_carries_shadow_leaves(box):
    arrays, _, ts, _ = box
    carried = TB.from_jax_arrays(_jax_leaves(arrays), "cpu")
    for f in ("tri_geom", "tri_prim", "sphere_geom", "disc_geom", "mat_id",
              "mat_albedo"):
        got, own = getattr(carried, f), getattr(ts, f)
        assert got.dtype == own.dtype and torch.equal(got, own), f
    assert carried.n_spheres == 2 and carried.n_discs == 1
    assert int((ts.tri_geom >= 0).sum()) == int(
        (np.asarray(arrays.blocked.tri_geom) >= 0).sum())


# ---- 8. HBM-mode scenes ----

def _hbm_box():
    return TB.build_scene(make_cornell_box_scene(None, box_only=False),
                          device="cpu", image_width=W, image_height=H,
                          intersector="pallas-hbm")


def test_shadow_trace_in_hbm_mode_holds_golden():
    """An HBM-mode scene takes the glue route through the closest-hit
    kernel K6 and renders the golden."""
    ts, params = _hbm_box()
    out = render(ts, params, chunk_size=512)
    golden = np.load(GOLDEN)
    for f in FIELDS:
        assert _equal(getattr(out, f), golden[f]) == 0, f


def test_shadow_trace_raises_in_hbm_mode():
    """Once refused (hence the name): the shadow trace of a scene whose
    tables are in HBM mode runs through "bvh" (K7's plain version) and
    equals the JAX package's render with that intersector, every AOV."""
    ts, _ = _hbm_box()
    with pytest.raises(ValueError, match="no threaded BVH"):
        shadow_trace(ts, None, torch.ones(4, 3), intersector="bvh")
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=W, image_height=H,
                                intersector="bvh")
    assert ts.pbox is None  # HBM-mode tables
    arrays, jparams, _ = jax_build_scene(
        jax_cornell(None, box_only=False), image_width=W, image_height=H,
        intersector="bvh")
    want = jax_render(arrays, jparams, mode="shadow-trace", chunk_size=512)
    out = render(ts, params, chunk_size=512)
    for f in FIELDS:
        assert _equal(getattr(out, f), getattr(want, f)) == 0, f


# ---- 9. the kernel on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_shadow_kernel_matches_plain(cuda_device):
    ts, params = TB.build_scene(make_cornell_box_scene(MONKEY, box_only=False),
                                device=cuda_device, image_width=64,
                                image_height=64, intersector="pallas")
    rows, cols = TC.pixel_grid(64, 64, 0, 0, device=cuda_device)
    dirs = TC.generate_camera_rays(rows, cols, 64, 64, params.fov_radians)[1]
    args = sh.shadow_inputs(ts, None, dirs)
    sh.reset_launches()
    kf, ki = sh.shadow_trace_cuda(ts, *args, light=LIGHT)
    torch.cuda.synchronize()
    assert sh.launches == 1
    pf, pi = sh.shadow_trace_ref(ts, *args, light=LIGHT)
    assert torch.equal(kf, pf) and torch.equal(ki, pi)
