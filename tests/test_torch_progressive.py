"""The port's progressive path trace and f16 readback on the CPU.

* ``render(mode="path-trace", progress_callback=...)`` renders batches of
  at most 16 samples, batch bi seeded ``rng_seed + 0x9E3779B9*bi``, and
  passes the running average after each: against the JAX package's
  ``render`` on the Cornell box at 32x32 spp 17 (batches 16 + 1), the
  callback count, every frame and the final image bit for bit.
* ``render_streaming(spp=, seed=)`` is the render with those
  ``SceneParams`` fields replaced; ``readback_f16`` is the f32 image
  rounded to f16 and widened back.
* The shadow trace with ``readback_f16`` against the JAX package under
  ``RAY_READBACK_F16=1``, every AOV and every callback chunk bit for bit,
  on a Cornell box scaled 60x so that hit distances and points pass the
  f16 range (65504) and are clamped, and misses keep t = inf.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import numpy as np
import pytest

from ipu_ray_lib_tpu.render.renderer import render as jax_render
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu_torch.render.renderer import render
from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

FIELDS = ("rgb", "t", "geom_id", "prim_id", "normal", "hit_p")
F16_MAX = float(np.finfo(np.float16).max)
SCALE = np.float32(60.0)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def progressive():
    """(JAX frames, JAX image, port frames, port image) of the Cornell box
    at 32x32 spp 17 with a progress callback."""
    arrays, jp, _ = jax_build_scene(jax_cornell(None, box_only=True),
                                    image_width=32, image_height=32,
                                    samples_per_pixel=17,
                                    intersector="pallas")
    ts, tp = build_scene(make_cornell_box_scene(None, box_only=True),
                         device="cpu", image_width=32, image_height=32,
                         samples_per_pixel=17)
    jf, pf = [], []
    want = jax_render(arrays, jp, mode="path-trace",
                      progress_callback=lambda bi, im: jf.append((bi, im)))
    got = render(ts, tp, mode="path-trace",
                 progress_callback=lambda bi, im: pf.append((bi, im)))
    return jf, np.asarray(want.rgb), pf, got.rgb


def test_progressive_frames_match_jax(progressive):
    jf, _, pf, _ = progressive
    assert [bi for bi, _ in pf] == [bi for bi, _ in jf] == [0, 1]
    for (_, a), (_, b) in zip(pf, jf):
        assert _same(a, b)


def test_progressive_image_matches_jax(progressive):
    _, want, pf, got = progressive
    assert _same(got, want)
    assert got.shape == (32, 32, 3) and np.isfinite(got).all()
    # the last running average is the image (spp / spp)
    assert _same(pf[-1][1], got)


@pytest.fixture(scope="module")
def box16():
    return build_scene(make_cornell_box_scene(None, box_only=True),
                       device="cpu", image_width=16, image_height=16,
                       samples_per_pixel=2)


@pytest.mark.parametrize("spp, seed", [(1, 5), (3, 1442), (4, 0xFFFFFFFF)])
def test_spp_and_seed_overrides(box16, spp, seed):
    ts, params = box16
    got, done = render_streaming(ts, params, spp=spp, seed=seed)
    want, want_done = render_streaming(
        ts, dataclasses.replace(params, samples_per_pixel=spp,
                                rng_seed=seed))
    assert done == want_done == 16 * 16 * spp
    assert _same(got, want)


def test_streaming_f16_readback_is_the_rounded_image(box16):
    ts, params = box16
    f32, d32 = render_streaming(ts, params)
    f16, d16 = render_streaming(ts, params, readback_f16=True)
    assert d32 == d16
    assert f16.dtype == np.float32
    assert _same(f16, f32.astype(np.float16).astype(np.float32))
    assert not _same(f16, f32)


def test_progressive_f16_batches_are_rounded(box16):
    """Each batch is read back rounded; the running average is f32."""
    ts, params = box16
    p = dataclasses.replace(params, samples_per_pixel=17)
    frames = []
    out = render(ts, p, mode="path-trace", readback_f16=True,
                 progress_callback=lambda bi, im: frames.append(im))
    acc = np.zeros_like(out.rgb)
    for bi, b in enumerate((16, 1)):
        img, _ = render_streaming(ts, p, spp=b,
                                  seed=(p.rng_seed + 0x9E3779B9 * bi)
                                  & 0xFFFFFFFF)
        acc += img.astype(np.float16).astype(np.float32) * b
        assert _same(frames[bi], acc / (16 + bi))
    assert _same(out.rgb, acc / 17)


def _scaled(desc):
    """The scene ``desc`` scaled by SCALE about the origin, in place."""
    for m in desc.meshes:
        m.vertices = m.vertices * SCALE
    desc.spheres = desc.spheres * SCALE
    desc.discs = np.concatenate([desc.discs[:, :3], desc.discs[:, 3:] * SCALE],
                                axis=1)
    return desc


@pytest.fixture(scope="module")
def shadow_f16():
    """The shadow trace of the scaled Cornell box (box + spheres + disc)
    at 48x32, chunk 512, with f16 readback: (JAX render and chunks under
    RAY_READBACK_F16=1, port render and chunks, the port's f32 render)."""
    arrays, jp, _ = jax_build_scene(_scaled(jax_cornell(None, box_only=False)),
                                    image_width=48, image_height=32,
                                    intersector="pallas")
    ts, tp = build_scene(_scaled(make_cornell_box_scene(None, box_only=False)),
                         device="cpu", image_width=48, image_height=32)
    jc, pc = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_READBACK_F16", "1")
        want = jax_render(arrays, jp, chunk_size=512,
                          progress_callback=lambda ci, c: jc.append((ci, c)))
    got = render(ts, tp, chunk_size=512, readback_f16=True,
                 progress_callback=lambda ci, c: pc.append((ci, c)))
    return want, jc, got, pc, render(ts, tp, chunk_size=512)


@pytest.mark.parametrize("field", FIELDS)
def test_shadow_f16_aovs_match_jax(shadow_f16, field):
    want, _, got, _, _ = shadow_f16
    assert _same(getattr(got, field), np.asarray(getattr(want, field)))


def test_shadow_f16_chunks_match_jax(shadow_f16):
    _, jc, _, pc, _ = shadow_f16
    assert [ci for ci, _ in pc] == [ci for ci, _ in jc] == [0, 1, 2]
    for (_, a), (_, b) in zip(pc, jc):
        assert _same(a, b)


def test_shadow_f16_clamps_and_keeps_misses(shadow_f16):
    """The scaled scene's hits lie past 65504: finite values are clamped
    to the f16 range, misses keep t = inf, and every float AOV is the f32
    one rounded so (the port's ``_prep_f``)."""
    _, _, got, _, f32 = shadow_f16
    miss = f32.geom_id < 0
    assert miss.any() and np.isinf(got.t[miss]).all()
    far = ~miss & (f32.t > F16_MAX)
    assert far.any() and (got.t[far] == F16_MAX).all()
    assert (f32.t[~miss] < F16_MAX).any()
    assert (np.abs(f32.hit_p) > F16_MAX).any()
    assert np.isfinite(got.hit_p).all()
    for f in ("rgb", "t", "normal", "hit_p"):
        a = getattr(f32, f)
        want = np.where(np.isfinite(a), np.clip(a, -F16_MAX, F16_MAX), a)
        assert _same(getattr(got, f), want.astype(np.float16)
                     .astype(np.float32)), f
    for f in ("geom_id", "prim_id"):
        assert _same(getattr(got, f), getattr(f32, f))
