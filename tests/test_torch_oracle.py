"""The port's f64 oracle, EXR codec, image helpers and serial container
against the JAX package's, on the same inputs.

* ``oracle_intersect``, ``oracle_intersect_bvh``, ``oracle_occluded`` and
  ``oracle_shadow_trace`` equal the JAX package's bit for bit on the
  Cornell box with the monkey (48x32 camera rays) and on seeded random
  rays; ``camera_rays`` equals the JAX package's ``generate_camera_rays``
  called op by op, as ``trace.py`` calls it for the oracle.
* ``write_exr`` writes the JAX writer's bytes for the same image, and
  each package reads the other's file; ``write_image``/``read_image``/
  ``mse`` agree.
* The serial container: the JAX package's ``tests/test_serial.py`` cases
  against the port's copy, and its bytes (node records, sections, whole
  bundles) equal the JAX package's.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import os

import numpy as np
import pytest

from ipu_ray_lib_tpu.bvh.builder import build_bvh_python as jax_bvh_python
from ipu_ray_lib_tpu.cpu import reference as jref
from ipu_ray_lib_tpu.ops.camera import generate_camera_rays, pixel_grid
from ipu_ray_lib_tpu.scene import serial as jser
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu.utils import exr as jexr
from ipu_ray_lib_tpu.utils import image as jimage
from ipu_ray_lib_tpu_torch.bvh.builder import build_bvh_python
from ipu_ray_lib_tpu_torch.cpu import reference as tref
from ipu_ray_lib_tpu_torch.scene import serial as tser
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene
from ipu_ray_lib_tpu_torch.utils import exr as texr
from ipu_ray_lib_tpu_torch.utils import image as timage

MONKEY = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "monkey_bust.glb")
W, H = 48, 32


def assert_bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def scenes():
    return (make_cornell_box_scene(MONKEY, box_only=False),
            jax_cornell(MONKEY, box_only=False))


def _rays(kind):
    if kind == "camera":
        return tref.camera_rays(W, H, 0, 0, W, H, float(np.pi / 4))
    rng = np.random.default_rng(7)
    o = rng.uniform([50, 50, 50], [500, 500, 500], (600, 3)).astype(
        np.float32) - np.array([278, 273, -800], np.float32)
    o *= np.array([-1, 1, -1], np.float32)
    d = rng.normal(size=(600, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("window", [(48, 32, 0, 0, 48, 32),
                                    (768, 432, 0, 0, 768, 432),
                                    (8, 8, 12, 12, 32, 32),
                                    (100, 50, 3, 7, 640, 480)])
def test_camera_rays_match_trace_py(window):
    w, h, c, r, iw, ih = window
    rows, cols = pixel_grid(w, h, c, r)
    jo, jd = generate_camera_rays(rows, cols, iw, ih, float(np.pi / 4), 0.0,
                                  None)
    to, td = tref.camera_rays(w, h, c, r, iw, ih, float(np.pi / 4))
    assert_bits(td, np.asarray(jd))
    assert_bits(to, np.asarray(jo))


@pytest.mark.parametrize("kind", ["camera", "random"])
@pytest.mark.parametrize("fn", ["oracle_intersect", "oracle_intersect_bvh"])
def test_oracle_intersect_matches_jax(scenes, kind, fn):
    ts, js = scenes
    o, d = _rays(kind)
    got = getattr(tref, fn)(ts, o, d)
    want = getattr(jref, fn)(js, o, d)
    for name, a, b in zip(("t", "geom", "prim", "normal"), got, want):
        assert_bits(a, b, name)
    assert (got[1] >= 0).sum() > len(o) // 3


@pytest.mark.parametrize("use_bvh", [False, True])
def test_oracle_occluded_matches_jax(scenes, use_bvh):
    ts, js = scenes
    o, d = _rays("random")
    t_max = np.full(len(o), 400.0)
    assert_bits(tref.oracle_occluded(ts, o, d, t_max, use_bvh),
                jref.oracle_occluded(js, o, d, t_max, use_bvh))


@pytest.mark.parametrize("kind", ["camera", "random"])
@pytest.mark.parametrize("use_bvh", [None, True])
def test_oracle_shadow_trace_matches_jax(scenes, kind, use_bvh):
    ts, js = scenes
    o, d = _rays(kind)
    got = tref.oracle_shadow_trace(ts, o, d, use_bvh=use_bvh)
    want = jref.oracle_shadow_trace(js, o, d, use_bvh=use_bvh)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_bits(got[k], want[k], k)


def _image(seed=0, shape=(17, 23, 3)):
    img = np.random.default_rng(seed).normal(0, 10, shape).astype(np.float32)
    img[0, 0] = [np.inf, -np.inf, np.nan]
    return img


def test_exr_bytes_match_jax(tmp_path):
    img = _image()
    tp, jp = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    texr.write_exr(tp, img)
    jexr.write_exr(jp, img)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    assert_bits(texr.read_exr(jp), jexr.read_exr(jp))
    assert_bits(jexr.read_exr(tp), img)
    assert_bits(texr.read_exr(tp), img)


def test_exr_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError):
        texr.write_exr(str(tmp_path / "x.exr"), np.zeros((4, 4)))


def test_image_helpers_match_jax(tmp_path):
    a, b = _image(1, (8, 9, 3)), _image(2, (8, 9, 3))
    a[0, 0] = b[0, 0] = 0.0
    assert timage.mse(a, b) == jimage.mse(a, b)
    p = str(tmp_path / "x.exr")
    timage.write_image(p, a)
    assert_bits(jimage.read_image(p), timage.read_image(p))
    assert_bits(timage.read_image(p), a)


def _bvh(build, rng, n=64):
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, (n, 3)).astype(np.float32)
    return build(lo, hi, np.zeros(n, np.int64), np.arange(n))


def test_node_record_is_24_bytes():
    assert tser.NODE_DTYPE.itemsize == 24
    assert tser.NODE_DTYPE == jser.NODE_DTYPE


def test_node_pack_round_trip_and_bytes():
    bvh = _bvh(build_bvh_python, np.random.default_rng(1442))
    jbvh = _bvh(jax_bvh_python, np.random.default_rng(1442))
    packed = tser.pack_nodes(bvh)
    assert packed.nbytes == bvh.num_nodes * 24
    assert packed.tobytes() == jser.pack_nodes(jbvh).tobytes()
    back = tser.unpack_nodes(packed, bvh.miss, bvh.max_depth)
    for f in ("mins", "exts", "meta", "geom", "miss"):
        assert_bits(getattr(back, f), getattr(bvh, f), f)


def _sections(rng):
    return {
        "a_f32": rng.normal(size=(7, 3)).astype(np.float32),
        "b_u8": rng.integers(0, 255, 13).astype(np.uint8),
        "c_f16": rng.normal(size=5).astype(np.float16),
        "d_i32": rng.integers(-5, 5, (3, 2)).astype(np.int32),
    }


def test_serialiser_alignment_round_trip_and_bytes():
    arrays = _sections(np.random.default_rng(3))
    t, j = tser.Serialiser(), jser.Serialiser()
    for k, v in arrays.items():
        t.add(k, v)
        j.add(k, v)
    blob = t.tobytes({"answer": 42})
    assert blob == j.tobytes({"answer": 42})
    d = tser.Deserialiser(blob)
    assert d.meta["answer"] == 42
    for k, v in arrays.items():
        assert_bits(d.get(k), v, k)
        assert (d._body_base + d._toc[k]["offset"]) % 64 == 0


def test_scene_bundle_file_round_trip_and_bytes(tmp_path):
    bvh = _bvh(build_bvh_python, np.random.default_rng(5), 33)
    arrays = {"verts": np.random.default_rng(6).normal(size=(10, 3)).astype(
        np.float32), "tri_v": np.arange(15, dtype=np.int32).reshape(5, 3)}
    tp, jp = str(tmp_path / "t.tprs"), str(tmp_path / "j.tprs")
    tser.save_scene_bundle(tp, bvh=bvh, arrays_host=arrays, meta={"name": "t"})
    jser.save_scene_bundle(jp, bvh=bvh, arrays_host=arrays, meta={"name": "t"})
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    bvh2, arrays2, meta = tser.load_scene_bundle(jp)
    assert meta["name"] == "t" and meta["bvh_max_depth"] == bvh.max_depth
    for f in ("mins", "exts", "meta", "geom", "miss"):
        assert_bits(getattr(bvh2, f), getattr(bvh, f), f)
    for k, v in arrays.items():
        assert_bits(arrays2[k], v, k)


def test_deserialiser_refuses_bad_magic():
    with pytest.raises(ValueError, match="magic"):
        tser.Deserialiser(b"NOTASCENE" + b"\x00" * 64)
