"""The frame drivers' spans (``utils/profiling.py:span``) under a CPU-only
``torch.profiler``:

* with no profiler ``span`` hands back one shared no-op context and calls
  nothing in torch; under a profiler it records a host range, in the
  profile and in ``recorded_spans()`` on the profile's clock, and no
  user annotation (of which kineto would put a copy on the card's
  timeline);
* ``render_streaming`` records ``streaming.upload``, ``.batch``,
  ``.readback`` and ``.scatter`` once a frame, in that order, and under a
  NIF ``streaming.env`` inside ``streaming.batch``;
* the shadow trace records each ``renderer.*`` phase once a chunk and its
  readback once a frame;
* ``render_streaming_sharded`` on two CPU shards records its ``mesh.*``
  spans;
* ``profiling.trace`` turns the spans on and writes them to its Chrome
  trace;
* each image is the same bit for bit with and without a profiler.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ipu_ray_lib_tpu_torch.nif.model import load_nif_env
from ipu_ray_lib_tpu_torch.parallel.mesh import (make_ray_mesh,
                                                 render_streaming_sharded)
from ipu_ray_lib_tpu_torch.render.renderer import render
from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                 make_primitive_scene)
from ipu_ray_lib_tpu_torch.utils import profiling

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LAYERS = ("streaming.", "renderer.", "mesh.")
SHADOW_CHUNK = 512


@pytest.fixture(scope="module")
def box():
    return build_scene(make_cornell_box_scene(None), device="cpu",
                       image_width=16, image_height=16, samples_per_pixel=2)


@pytest.fixture(scope="module")
def shadow_box():
    return build_scene(make_cornell_box_scene(None, box_only=False),
                       device="cpu", image_width=48, image_height=32)


def _profiled(fn):
    """fn()'s result and the program's spans it recorded, [(start, end,
    name)] in order of their start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(LAYERS))
    return out, spans


def _names(spans):
    return [n for _, _, n in spans]


def test_span_without_a_profiler_calls_nothing_in_torch(monkeypatch, box):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    before = profiling.recorded_spans()
    a, b = profiling.span("streaming.batch"), profiling.span("mesh.gather")
    assert a is b
    with a:
        with b:  # the shared context nests
            pass
    # a whole frame of each driver runs without reaching a record function
    render_streaming(*box)
    scene, params = box
    render(scene, params, mode="shadow-trace", chunk_size=SHADOW_CHUNK)
    assert profiling.recorded_spans() == before


def test_span_records_while_a_profiler_runs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("renderer.cull"):
            torch.ones(4).sum()
    assert not torch.autograd.profiler._is_profiler_enabled
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "renderer.cull"]
    assert len(ev) == 1 and ev[0].end_ns() > ev[0].start_ns()
    # a host operation, not a user annotation: no copy on a card's row
    assert not ev[0].is_user_annotation()
    assert profiling.span("renderer.cull") is profiling.span("x")


def test_recorded_spans_are_the_profiles_on_its_clock(box):
    n0 = len(profiling.recorded_spans())
    _, spans = _profiled(lambda: render_streaming(*box, seed=3))
    mine = sorted(profiling.recorded_spans()[n0:])
    assert _names(mine) == _names(spans)
    # each recorded range lies inside the profile's range of the same span
    # (the profile's opens before and closes after the recorder's clock
    # reads), on one clock: epoch ns, to within the profile's conversion
    slack = 1e6
    for (s, e, _), (ks, ke, _) in zip(mine, spans):
        assert ks - slack <= s <= e <= ke + slack
        assert s - ks < 50e6 and ke - e < 50e6


def test_streaming_spans_once_a_frame_in_order(box):
    def two_frames():
        return [render_streaming(*box, seed=s) for s in (1, 2)]

    _, spans = _profiled(two_frames)
    frame = ["streaming.upload", "streaming.batch", "streaming.readback",
             "streaming.scatter"]
    assert _names(spans) == frame * 2
    # in sequence: each span ends before the next starts
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_streaming_env_nests_in_the_batch_under_a_nif():
    env = load_nif_env(os.path.join(ROOT, "assets", "nif",
                                    "synthetic_urban_4k"), device="cpu")
    scene, params = build_scene(make_primitive_scene(), device="cpu",
                                image_width=16, image_height=16,
                                samples_per_pixel=1)
    (_, done), spans = _profiled(
        lambda: render_streaming(scene, params, env=env))
    assert done == 256
    assert _names(spans) == ["streaming.upload", "streaming.batch",
                             "streaming.env", "streaming.readback",
                             "streaming.scatter"]
    batch, env_span = spans[1], spans[2]
    assert batch[0] <= env_span[0] and env_span[1] <= batch[1]


def test_shadow_spans_once_a_chunk(shadow_box):
    scene, params = shadow_box
    out, spans = _profiled(lambda: render(
        scene, params, mode="shadow-trace", chunk_size=SHADOW_CHUNK))
    n_chunks = 48 * 32 // SHADOW_CHUNK
    chunk = ["renderer.rays", "renderer.cull", "renderer.kernel",
             "renderer.epilogue", "renderer.store"]
    assert _names(spans) == chunk * n_chunks + ["renderer.readback"]
    assert out.hit_count > 0


def test_mesh_spans(box):
    scene, params = box
    mesh = make_ray_mesh(["cpu"] * 2)
    (_, done), spans = _profiled(lambda: render_streaming_sharded(
        scene, params, mesh, chunk_slots=256))
    assert done == 16 * 16 * 2
    # one batch: the plan, the dispatch over both shards, one readback
    assert _names(spans) == ["mesh.setup", "mesh.dispatch", "mesh.gather",
                             "mesh.assemble"]


def test_no_span_is_a_user_annotation(shadow_box):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(*shadow_box, mode="shadow-trace", chunk_size=SHADOW_CHUNK)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name().startswith(LAYERS)]
    assert len(ev) == 5 * (48 * 32 // SHADOW_CHUNK) + 1
    assert not any(e.is_user_annotation() for e in ev)


def test_profiling_trace_writes_the_spans(tmp_path, box):
    path = str(tmp_path / "frame.json")
    with profiling.trace(path, cuda=False):
        render_streaming(*box)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"streaming.upload", "streaming.batch", "streaming.readback",
            "streaming.scatter"} <= names


@pytest.mark.parametrize("driver", ["streaming", "shadow", "mesh"])
def test_images_equal_with_and_without_a_profiler(driver, box, shadow_box):
    if driver == "streaming":
        def frame():
            return render_streaming(*box, seed=7)
    elif driver == "shadow":
        def frame():
            return tuple(render(*shadow_box, mode="shadow-trace",
                                chunk_size=SHADOW_CHUNK))
    else:
        mesh = make_ray_mesh(["cpu"] * 2)

        def frame():
            return render_streaming_sharded(*box, mesh, chunk_slots=256)
    plain = frame()
    traced, spans = _profiled(frame)
    assert spans
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        else:
            assert a == b
