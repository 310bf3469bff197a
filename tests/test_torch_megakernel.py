"""The port's megakernel against the JAX megakernel on the same inputs.

CPU: the port's ``megakernel_path_trace`` (its plain torch version on CPU
tensors) against the JAX ``megakernel_path_trace(..., interpret=True)``
on the same pixel stream and seed, for the golden scene here and the
bench scene (Cornell + monkey) in tests/test_torch_megakernel_monkey.py,
which runs these tests on its own ``case``, at 32x32 spp 2. ``flat`` is
held at rtol = atol = 1e-5 (the golden tolerance) and ``done`` exactly.

CUDA (marker ``cuda``, skipped without a card): the hand-written kernel
against the plain version on the same card.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipu_ray_lib_tpu.ops.pallas.megakernel import (
    megakernel_path_trace as jax_megakernel)
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu_torch.ops import megakernel as mk
from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
from ipu_ray_lib_tpu_torch.render.streaming import slot_pool
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

W = H = 32
SPP = 2
SEED = 1442
MESHES = {"golden": None, "monkey": "assets/monkey_bust.glb"}


def _stream(params):
    n_pix = W * H
    R, J = slot_pool(n_pix, 1 << 17)
    rows, cols = pixel_stream(params).coords(torch.device("cpu"), R * J)
    return rows.numpy(), cols.numpy(), R, J, n_pix


def make_case(name):
    """(port scene, params, stream, JAX flat, JAX done) for one scene."""
    mesh = MESHES[name]
    arrays, jparams, _ = jax_build_scene(
        jax_cornell(mesh, box_only=False), image_width=W, image_height=H,
        samples_per_pixel=SPP, intersector="pallas")
    ts, tparams = build_scene(make_cornell_box_scene(mesh, box_only=False),
                              device="cpu", image_width=W, image_height=H,
                              samples_per_pixel=SPP)
    rows, cols, R, J, n_pix = _stream(tparams)
    max_iters = J * SPP * tparams.max_path_length + 16
    jflat, jdone = jax_megakernel(
        arrays, jnp.asarray(rows), jnp.asarray(cols), jnp.uint32(SEED),
        jnp.int32(n_pix), params=jparams, slots=R, j_per_slot=J, spp=SPP,
        max_iters=max_iters, br=256, interpret=True)
    kw = dict(params=tparams, slots=R, j_per_slot=J, spp=SPP,
              max_iters=max_iters)
    return (ts, kw, torch.from_numpy(rows), torch.from_numpy(cols), n_pix,
            np.asarray(jflat), int(jdone))


@pytest.fixture(scope="module", params=["golden"])
def case(request):
    return make_case(request.param)


def test_plain_matches_jax_interpret(case):
    ts, kw, rows, cols, n_pix, jflat, jdone = case
    flat, done = mk.megakernel_path_trace(ts, rows, cols, SEED, n_pix, **kw)
    assert int(done) == jdone == n_pix * SPP
    assert flat.shape == jflat.shape and flat.dtype == torch.float32
    np.testing.assert_allclose(flat.numpy(), jflat, rtol=1e-5, atol=1e-5)
    assert float(flat.sum()) > 0.0


def test_ref_entry_point_matches_dispatch(case):
    ts, kw, rows, cols, n_pix, jflat, _ = case
    a, da = mk.megakernel_path_trace(ts, rows, cols, SEED, n_pix, **kw)
    b, db = mk.megakernel_path_trace_ref(ts, rows, cols, SEED, n_pix, **kw)
    assert torch.equal(a, b) and int(da) == int(db)


def test_cpu_tensors_launch_no_kernel(case):
    ts, kw, rows, cols, n_pix, _, _ = case
    mk.reset_launches()
    mk.megakernel_path_trace(ts, rows, cols, SEED, n_pix, **kw)
    assert mk.launches == 0


def test_pixel_group_offset_matches_full_dispatch(case):
    """A dispatch over stream rows [j0, j0+1) of a k_total schedule equals
    the same rows of the full dispatch (the reference's j0/k_total
    contract) — here with the bench stream cut to J = 2."""
    ts, kw, rows, cols, n_pix, _, _ = case
    R = kw["slots"] // 2
    kw2 = dict(kw, slots=R, j_per_slot=2)
    full, dfull = mk.megakernel_path_trace(ts, rows, cols, SEED, n_pix, **kw2)
    parts = []
    for j0 in (0, 1):
        f, _ = mk.megakernel_path_trace(
            ts, rows[j0 * R:(j0 + 1) * R], cols[j0 * R:(j0 + 1) * R], SEED,
            n_pix, **dict(kw2, j_per_slot=1, j0=j0, k_total=2 * SPP))
        parts.append(f)
    assert int(dfull) == n_pix * SPP
    assert torch.equal(torch.cat(parts), full)


def test_rejects_mismatched_stream(case):
    ts, kw, rows, cols, n_pix, _, _ = case
    with pytest.raises(ValueError, match="rows/cols"):
        mk.megakernel_path_trace(ts, rows[:-1], cols[:-1], SEED, n_pix, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(case, cuda_device):
    ts, kw, rows, cols, n_pix, jflat, jdone = case
    gs = ts.to(cuda_device)
    r, c = rows.to(cuda_device), cols.to(cuda_device)
    mk.reset_launches()
    flat, done = mk.megakernel_path_trace(gs, r, c, SEED, n_pix, **kw)
    torch.cuda.synchronize()
    assert mk.launches == 1
    ref, dref = mk.megakernel_path_trace_ref(gs, r, c, SEED, n_pix, **kw)
    assert int(done) == int(dref) == jdone
    np.testing.assert_allclose(flat.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(flat.cpu().numpy(), jflat, rtol=1e-5,
                               atol=1e-5)
