"""Times the port's K1, K6 and K5 alone in one source tree, on a CUDA card.

To compare two versions in one call, unpack the older one into a
directory git ignores and run, in turns (older, newer, newer, older):

    python3 experiments/torch_k1_k6_ab.py <tree> [--count] [--k1-only]

It builds the tree's kernels, then times with CUDA events:
- K1: `megakernel_path_trace` on Cornell + monkey at 1440^2 spp 64, three
  times (the first includes the first launch's warm-up);
- K6: every launch of one path-A frame (`render` of the stress grid 512
  at 1440^2 in HBM mode, normals only: 64 launches of 65,536 rays), each
  launch three times; per launch its best time and the blocks its 64
  bundles tested (`pairs`: max, mean, the heaviest bundle over the mean);
- K3: `megakernel_path_trace` on that scene at 1440^2 spp 64, three
  times;
- K5: every launch of one path-B frame (Cornell + monkey 1440^2 spp 4
  under a sky env), summed, three times.
With `--count` (a tree whose K1 has a counting launch) it also makes K1's
counting launch at the 1440^2 frame and at the frame's slot pool with
spp 1, where it holds the counts against the plain walk's. `--k1-only`
skips the rest. `name=value` arguments set a module constant of the
tree's ops/cuda/build.py before any launch (for example `k1_spread=16`
sets K1_SPREAD, `wave_chunks=32` WAVE_CHUNKS).

Prints one JSON line: per case the times, an md5 of the outputs (equal
md5s: equal outputs), and the counts.
"""

import contextlib
import hashlib
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
flags = sys.argv[2:]
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih  # noqa: E402
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik  # noqa: E402
from ipu_ray_lib_tpu_torch.ops import megakernel as mk  # noqa: E402
from ipu_ray_lib_tpu_torch.ops.cuda import build as cb  # noqa: E402
from ipu_ray_lib_tpu_torch.render.renderer import render  # noqa: E402
from ipu_ray_lib_tpu_torch.render.streaming import (  # noqa: E402
    render_streaming, slot_pool)
from ipu_ray_lib_tpu_torch.scene.build import build_scene  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.builtin import (  # noqa: E402
    make_cornell_box_scene, make_stress_scene)

assert mk.__file__.startswith(tree), mk.__file__
dev = torch.device("cuda", 0)
knobs = {k: int(v) for k, v in (f.split("=") for f in flags if "=" in f)}
for k, v in knobs.items():
    setattr(cb, k.upper(), v)


def md5(*ts):
    h = hashlib.md5()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def ev(fn):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def stream(params, chunk=1 << 17):
    n_pix = params.window_w * params.window_h
    R, J = slot_pool(n_pix, chunk)
    try:
        from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
    except ImportError:  # a tree from before render/pixels.py
        from ipu_ray_lib_tpu_torch.render.streaming import _pixel_stream
        rows_np, cols_np, _ = _pixel_stream(params)
        pad = (0, R * J - n_pix)
        return (torch.from_numpy(np.pad(rows_np, pad)).to(dev),
                torch.from_numpy(np.pad(cols_np, pad)).to(dev), R, J, n_pix)
    return (*pixel_stream(params).coords(dev, R * J), R, J, n_pix)


@contextlib.contextmanager
def recording(mod, name, calls):
    fn = getattr(mod, name)

    def rec(scene, *a):
        out = fn(scene, *a)
        calls.append(a)
        return out

    setattr(mod, name, rec)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def counted(scene, rows, cols, n, kw):
    c = torch.zeros(len(cb.COUNTERS), dtype=torch.int64, device=dev)
    acc, done = mk._trace(mk._accumulate_cuda, scene, rows, cols,
                          kw["params"].rng_seed, n, counters=c, **kw)
    return dict(zip(cb.COUNTERS, c.tolist())), acc, done


out = {"tree": tree, "knobs": knobs}
monkey = os.path.join(tree, "assets", "monkey_bust.glb")
s, p = build_scene(make_cornell_box_scene(monkey, box_only=False),
                   device=dev, image_width=1440, image_height=1440,
                   samples_per_pixel=64)
rows, cols, R, J, n = stream(p)
kw = dict(params=p, slots=R, j_per_slot=J, spp=64,
          max_iters=J * 64 * p.max_path_length + 16, k_total=J * 64)
ms, img = [], None
for _ in range(3):
    t, (img, done) = ev(lambda: mk.megakernel_path_trace(
        s, rows, cols, p.rng_seed, n, **kw))
    ms.append(t)
out["k1"] = dict(ms=ms, md5=md5(img), done=int(done))
if "--count" in flags:
    cnt, acc, cdone = counted(s, rows, cols, n, kw)
    out["k1"]["counters"] = cnt
    out["k1"]["count_same"] = bool(torch.equal(mk.image(acc, cdone, 64),
                                               img))
    kw1 = dict(params=p, slots=R, j_per_slot=J, spp=1,
               max_iters=J * p.max_path_length + 16)
    walk = {}
    mk._trace(mk._accumulate_plain, s, rows, cols, 1442, n, stats=walk,
              **kw1)
    c = torch.zeros(len(cb.COUNTERS), dtype=torch.int64, device=dev)
    mk._trace(mk._accumulate_cuda, s, rows, cols, 1442, n, counters=c, **kw1)
    cnt1 = dict(zip(cb.COUNTERS, c.tolist()))
    out["k1_pool"] = dict(counters=cnt1, plain=walk,
                          equal=cnt1["lane_blocks"] == walk["block_tests"]
                          and cnt1["segments"] == walk["segments"])

if "--k1-only" not in flags:
    del s
    bs, bp = build_scene(make_stress_scene(512), device=dev,
                         image_width=1440, image_height=1440,
                         samples_per_pixel=64)
    rows3, cols3, R3, J3, n3 = stream(bp)
    calls = []
    with recording(ih, "super_walk_cuda", calls):
        render(bs, bp, aovs=("normal",))
    per = []
    h = hashlib.md5()
    for a in calls:
        ts = []
        for _ in range(3):
            t, o = ev(lambda: ik.walk_cuda(bs, *a, hbm=True))
            ts.append(t)
        for x in o[:5]:
            h.update(x.cpu().numpy().tobytes())
        pairs = o[4].double()
        per.append(dict(ms=min(ts), max=int(pairs.max()),
                        mean=float(pairs.mean()),
                        listed=int(a[0].sum()) * 8,
                        spec=int(o[5].sum()) if len(o) > 5 else None))
    kw3 = dict(params=bp, slots=R3, j_per_slot=J3, spp=64,
               max_iters=J3 * 64 * bp.max_path_length + 16, k_total=J3 * 64)
    ms3 = []
    for _ in range(3):
        t, (img3, _) = ev(lambda: mk.megakernel_path_trace(
            bs, rows3, cols3, bp.rng_seed, n3, **kw3))
        ms3.append(t)
    out["k3"] = dict(ms=ms3, md5=md5(img3))
    heavy = max(per, key=lambda r: r["ms"])
    out["k6"] = dict(
        ms=sum(r["ms"] for r in per), launches=len(per), md5=h.hexdigest(),
        pairs=sum(r["mean"] * 64 for r in per),
        spec=(sum(r["spec"] for r in per) if per[0]["spec"] is not None
              else None),
        heaviest=dict(heavy, ratio=heavy["max"] / max(heavy["mean"], 1e-9)),
        per_launch=per)
    del bs
    s, p = build_scene(make_cornell_box_scene(monkey, box_only=False),
                       device=dev, image_width=1440, image_height=1440,
                       samples_per_pixel=4)
    from ipu_ray_lib_tpu_torch.ops.vec3 import fma

    def sky(d):
        t = 0.5 * (d[:, 1] + 1.0)
        return torch.stack([fma(-0.5, t, 1.0), fma(-0.3, t, 1.0),
                            torch.ones_like(t)], -1) * 0.7

    calls = []
    with recording(ik, "dense_walk_cuda", calls):
        render_streaming(s, p, env=sky)
    ms = []
    for _ in range(3):
        t, outs = ev(lambda: [ik.walk_cuda(s, *a, hbm=False) for a in calls])
        ms.append(t)
    out["k5"] = dict(ms=ms, launches=len(calls),
                     md5=md5(*[x for o in outs for x in o[:5]]))
from ipu_ray_lib_tpu_torch.runtime.device import gpu_identity  # noqa: E402

out["gpu"] = gpu_identity()
out["ptxas"] = [ln.strip() for ln in cb.build_info.get("log", "").splitlines()
                if "registers" in ln or "spill" in ln or "Function" in ln]
print(json.dumps(out), flush=True)
