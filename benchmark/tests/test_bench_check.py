"""The comparison that decides ``correct``, at a size a CPU run holds:
the reference's scenes are the system's, the system equals the reference
on every cell, the control (the reference one precision step down in the
system's place) fails at the cell's own size, and a run with its timed path broken underneath
comes out not correct, once for each fault the cell can have.

On the CPU the system runs its plain versions, which hold its kernels on
the card; the card's own comparison is the run's."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import scene as RS

ROOT = harness.ROOT
CPU = torch.device("cpu")
# Every pixel of a 16 x 16 frame at spp 8 (most of a Cornell frame is
# black at fewer samples); chunks of 256 rays or slots, so a frame has
# several.
SMALL = {"config": {"image_width": 16, "image_height": 16,
                    "samples_per_pixel": 8},
         "traffic": {"check_pixels": 256, "trace_frames": 1, "chunk": 256}}
CELLS = ["cornell-monkey.path-1440-spp64", "cornell-monkey.shadow-1440",
         "spheres-nif.path-768x432-spp64",
         "cornell-monkey.path-1440-spp64-x4"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# The sharded cell: in BENCHMARK.json once proven on four cards, and
# tested here either way (its mode, traffic and limit are in place).
X4 = {"name": CELLS[3], "config": "cornell-monkey",
      "traffic": "path-1440-spp64-x4", "chips": 4, "why": "test"}


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    if X4["name"] not in [w["name"] for w in m["workloads"]]:
        m["workloads"].append(X4)
    return m


def _cell(name, **traffic):
    ov = {"config": dict(SMALL["config"]),
          "traffic": dict(SMALL["traffic"], **traffic)}
    return harness.Cell(name, manifest=_manifest(), overrides=ov)


def _devices(cell):
    return [CPU] * cell.chips


def _run(cell, seed=2147483659, seconds=0.01):
    return harness.run(cell, seed, seconds, False, _devices(cell), 0.0)


@pytest.mark.parametrize("config", ["cornell-monkey", "spheres-nif"])
def test_reference_scene_is_the_systems(config):
    from ipu_ray_lib_tpu_torch.scene import builtin

    with open(os.path.join(ROOT, "benchmark", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    mod, fn = cfg["program"]["scene"].split(":")
    args = [os.path.join(ROOT, a) for a in cfg["program"]["args"]]
    desc = getattr(builtin, fn)(*args)
    sc = RS.load(cfg["scene"], ROOT)
    tv = [m.vertices[m.triangles.astype(np.int64)] for m in desc.meshes]
    tv = np.concatenate(tv) if tv else np.zeros((0, 3, 3), np.float32)
    assert np.array_equal(sc.tri_v, tv)
    assert np.array_equal(sc.spheres, desc.spheres)
    assert np.array_equal(sc.discs, desc.discs)
    assert list(sc.mat_ids[:desc.num_geoms]) == list(desc.mat_ids)
    assert sc.fov == desc.camera.horizontal_fov
    assert np.array_equal(sc.mat_albedo,
                          np.stack([m.albedo for m in desc.materials]))
    assert np.array_equal(sc.mat_emission,
                          np.stack([m.emission for m in desc.materials]))


@pytest.mark.parametrize("name", CELLS)
def test_system_equals_reference(name):
    cell = _cell(name)
    spans = {}
    prog = cell.mode.Program(cell, 11, _devices(cell), spans)
    frames = [prog.frame(i) for i in range(2)]
    got = [f.sample for f in frames]
    want = cell.mode.reference(cell, 11, 2, CPU)
    sound = cell.mode.compare(got, want)
    assert all(v == 0.0 for v in sound.values()), sound
    lit = [np.asarray(w["rgb"] if isinstance(w, dict) else w) for w in want]
    assert np.mean(np.concatenate(lit).max(axis=1) > 0) > 0.05
    assert set(spans) == {"scene.build_s", "kernels.load_s"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_own_size(name):
    """The control against the reference on a few pixels of two frames
    of the cell's own configuration (the card reads it over a run's
    worth of frames: PERF.md)."""
    cell = harness.Cell(name, manifest=_manifest(),
                        overrides={"traffic": {"check_pixels": 12}})
    want = cell.mode.reference(cell, 11, 2, CPU)
    control = cell.mode.compare(
        cell.mode.reference(cell, 11, 2, CPU, control=True), want)
    assert all(v > cell.limits[k] for k, v in control.items()), control


def test_a_sound_run_is_correct():
    r = _run(_cell(CELLS[0]))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"paths_per_s", "setup_s"}


# ---- faults planted underneath the timed path ----

def _state_unchanged_path(mp):
    import ipu_ray_lib_tpu_torch.render.streaming as st
    orig = st.trace_batch

    def fault(*a, **k):
        flat, done = orig(*a, **k)
        return torch.zeros_like(flat), done
    mp.setattr(st, "trace_batch", fault)


def _half_batch_path(mp):
    import ipu_ray_lib_tpu_torch.render.streaming as st
    orig = st.trace_batch

    def fault(*a, spp, **k):
        flat, done = orig(*a, spp=max(1, spp // 2), **k)
        return flat, done * (spp // max(1, spp // 2))
    mp.setattr(st, "trace_batch", fault)


def _answer_altered_path(mp):
    import ipu_ray_lib_tpu_torch.render.streaming as st
    orig = st.trace_batch

    def fault(*a, **k):
        flat, done = orig(*a, **k)
        flat = flat.clone()
        flat[::7] *= 1.5
        return flat, done
    mp.setattr(st, "trace_batch", fault)


def _exchange_left_out(mp):
    import ipu_ray_lib_tpu_torch.parallel.mesh as me
    orig = me._gather

    def fault(mesh, local):
        vals = orig(mesh, local)
        return [v if i == 0 or np.ndim(v) == 0 else np.zeros_like(v)
                for i, v in enumerate(vals)]
    mp.setattr(me, "_gather", fault)


def _sharded(fault):
    def plant(mp):
        import ipu_ray_lib_tpu_torch.parallel.mesh as me
        import ipu_ray_lib_tpu_torch.render.streaming as st
        fault(mp)
        mp.setattr(me, "trace_batch", st.trace_batch)
    return plant


def _shadow(change):
    def plant(mp):
        import ipu_ray_lib_tpu_torch.render.renderer as rr
        orig = rr.shadow_trace

        def fault(scene, origins, dirs, **k):
            return change(orig, scene, origins, dirs, **k)
        mp.setattr(rr, "shadow_trace", fault)
    return plant


def _shadow_unchanged(orig, scene, o, d, **k):
    res = orig(scene, o, d, **k)
    return type(res)(*[torch.zeros_like(x) for x in res])


def _shadow_half(orig, scene, o, d, **k):
    h = d.shape[0] // 2
    res = orig(scene, o, d[:h], **k)
    return type(res)(*[torch.cat([x, torch.zeros((d.shape[0] - h,)
                                                 + x.shape[1:], dtype=x.dtype)])
                       for x in res])


def _shadow_altered(orig, scene, o, d, **k):
    res = orig(scene, o, d, **k)
    g = res.geom_id.clone()
    g[::7] += 1
    return res._replace(geom_id=g)


FAULTS = [
    (CELLS[0], "state_unchanged", _state_unchanged_path),
    (CELLS[0], "half_batch", _half_batch_path),
    (CELLS[0], "answer_altered", _answer_altered_path),
    (CELLS[2], "state_unchanged", _state_unchanged_path),
    (CELLS[2], "half_batch", _half_batch_path),
    (CELLS[2], "answer_altered", _answer_altered_path),
    (CELLS[1], "state_unchanged", _shadow(_shadow_unchanged)),
    (CELLS[1], "half_batch", _shadow(_shadow_half)),
    (CELLS[1], "answer_altered", _shadow(_shadow_altered)),
    (CELLS[3], "state_unchanged", _sharded(_state_unchanged_path)),
    (CELLS[3], "half_batch", _sharded(_half_batch_path)),
    (CELLS[3], "answer_altered", _sharded(_answer_altered_path)),
    (CELLS[3], "exchange_left_out", _exchange_left_out),
]


@pytest.mark.parametrize("name,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault, plant):
    plant(monkeypatch)
    r = _run(_cell(name))
    assert r["failed"] == 0, "the fault hides from the frame's own count"
    assert not r["correct"], r["checks"]
