"""Times the port's K4 and K5 alone in one source tree, on a CUDA card.

To compare two versions in one call, unpack the older one into a
directory git ignores and run, in turns (older, newer, newer, older):

    python3 experiments/torch_k4_k5_ab.py <tree> [--count] [name=value ...]

It builds the tree's kernels, then times with CUDA events, each timed
stretch behind a spin kernel that holds the card until the host has
queued it (so the times are the card's, not the host's launch rate):
- K4: every launch of one Cornell + monkey 1440^2 shadow frame (`render`
  in shadow-trace mode, normals only: 32 launches of 65,536 rays), all
  of them back to back, three times, and each launch alone (best of
  three);
- K5: every launch of one path-B frame (Cornell + monkey 1440^2 spp 4
  under a sky env: one launch of 131,072 rays per iteration), back to
  back, three times, and each launch alone (best of two).
Per launch it records the blocks the bundles walked (max and mean over
the launch's bundles, where the tree reports them), the (lane, block)
pairs the lanes tested (where the tree reports them) and the pairs the
hits need (`ops/intersect_kernel.py:needed_pairs`, the primary walk's for
K4), and fits each launch's time to its heaviest bundle's blocks.
With `--count` (a tree whose K4/K5 have counting launches) it also makes
a counting launch of every launch and sums its counters (cycle split,
blocks, pairs), and counts K4's occlusion pairs needed with the plain
version. `name=value` arguments set a module constant of the tree's
ops/cuda/build.py before any launch (for example `k5_spread=16`).

Prints one JSON line: per kernel the times, an md5 of the outputs (equal
md5s: equal outputs), the counts and the fits.
"""

import contextlib
import hashlib
import inspect
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
flags = sys.argv[2:]
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik  # noqa: E402
from ipu_ray_lib_tpu_torch.ops import shadow as sh  # noqa: E402
from ipu_ray_lib_tpu_torch.ops.cuda import build as cb  # noqa: E402
from ipu_ray_lib_tpu_torch.ops.vec3 import fma  # noqa: E402
from ipu_ray_lib_tpu_torch.render.renderer import render  # noqa: E402
from ipu_ray_lib_tpu_torch.render.streaming import render_streaming  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.build import build_scene  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene  # noqa: E402

assert ik.__file__.startswith(tree), ik.__file__
dev = torch.device("cuda", 0)
knobs = {k: int(v) for k, v in (f.split("=") for f in flags if "=" in f)}
for k, v in knobs.items():
    setattr(cb, k.upper(), v)
counting = "--count" in flags
names = getattr(cb, "K45_COUNTERS", None)
k4_pairs_out = "pairs" in inspect.signature(sh.shadow_trace_cuda).parameters


def md5(ts):
    h = hashlib.md5()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def ev(fn, hold_ms=0.0):
    """CUDA-event time of fn's launches. With ``hold_ms`` a spin kernel of
    about that long runs first, so that the host has queued every launch
    before the card reaches them: the time is then the card's alone, not
    the host's launch rate."""
    if hold_ms:
        torch.cuda._sleep(int(hold_ms * 2e6))  # ~2e6 cycles per ms
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


@contextlib.contextmanager
def recording(mod, name, calls):
    fn = getattr(mod, name)

    def rec(scene, *a, **kw):
        out = fn(scene, *a, **kw)
        calls.append((a, kw))
        return out

    setattr(mod, name, rec)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def fit(per, key):
    """Least-squares ms = a * per[key] + b over the launches, and the
    correlation (with the launches' mean blocks beside it)."""
    x = np.array([r[key] for r in per], float)
    y = np.array([r["ms"] for r in per], float)
    if len(x) < 2 or x.std() == 0:
        return None
    a, b = np.polyfit(x, y, 1)
    xm = np.array([r["mean"] for r in per], float)
    return dict(ms_per_block=a, ms_at_zero=b,
                corr=float(np.corrcoef(x, y)[0, 1]),
                corr_mean=(float(np.corrcoef(xm, y)[0, 1])
                           if xm.std() > 0 else None))


def counters_of(launch):
    c = torch.zeros(len(names), dtype=torch.int64, device=dev)
    launch(c)
    torch.cuda.synchronize()
    return c


out = {"tree": tree, "knobs": knobs}
monkey = os.path.join(tree, "assets", "monkey_bust.glb")

# ---- K4: the Cornell + monkey 1440^2 shadow frame's launches ----
s, p = build_scene(make_cornell_box_scene(monkey, box_only=False),
                   device=dev, image_width=1440, image_height=1440)
calls = []
with recording(sh, "shadow_trace_cuda", calls):
    render(s, p, mode="shadow-trace", aovs=("normal",))


def k4(a, kw, **extra):
    return sh.shadow_trace_cuda(s, *a, **kw, **extra)


ms = []
for _ in range(3):
    t, outs = ev(lambda: [k4(a, kw) for a, kw in calls], 40.0)
    ms.append(t)
per = []
tot = {"need": 0, "tested": 0, "dense": 0}
for (a, kw), (of, oi) in zip(calls, outs):
    r = dict(ms=min(ev(lambda: k4(a, kw), 1.0)[0] for _ in range(3)))
    need = ik.needed_pairs(s, a[1], a[3], of[3].contiguous(), a[0],
                           members=1)
    r["need"] = need
    tot["need"] += need
    if k4_pairs_out:
        pr = torch.zeros((4, a[0].shape[0]), dtype=torch.int32, device=dev)
        k4(a, kw, pairs=pr)
        blocks = pr[0].double()
        r.update(max=int(blocks.max()), mean=float(blocks.mean()),
                 tested=int(pr[2].sum()), occ_blocks=int(pr[1].sum()),
                 occ_tested=int(pr[3].sum()))
        tot["tested"] += r["tested"]
        tot["dense"] += int(pr[0].sum()) * 1024
    per.append(r)
res = dict(ms=ms, launches=len(calls),
           md5=md5([x for o in outs for x in o]), pairs=tot)
if counting and names:
    summed = None
    for (a, kw), r in zip(calls, per):
        c = counters_of(lambda c: k4(a, kw, counters=c))
        cd = dict(zip(names, c.tolist()))
        r.setdefault("max", cd["max_bundle_blocks"])
        r.setdefault("mean", cd["bundle_blocks"] / a[0].shape[0])
        summed = c if summed is None else summed + c
    res["counters"] = dict(zip(names, summed.tolist()))
    occ = {}
    for a, kw in calls:
        sh.shadow_trace_ref(s, *a, **kw, stats=occ)
    res["plain_walk"] = occ
if per and "max" in per[0]:
    res["fit"] = fit(per, "max")
res["per_launch"] = per
out["k4"] = res
del s, calls, outs

# ---- K5: the path-B frame's launches (one per iteration) ----
s, p = build_scene(make_cornell_box_scene(monkey, box_only=False),
                   device=dev, image_width=1440, image_height=1440,
                   samples_per_pixel=4)


def sky(d):
    t = 0.5 * (d[:, 1] + 1.0)
    return torch.stack([fma(-0.5, t, 1.0), fma(-0.3, t, 1.0),
                        torch.ones_like(t)], -1) * 0.7


calls = []
with recording(ik, "dense_walk_cuda", calls):
    render_streaming(s, p, env=sky)
ms = []
for _ in range(3):
    t, outs = ev(lambda: [ik.walk_cuda(s, *a, hbm=False) for a, _ in calls],
                 300.0)
    ms.append(t)
per = []
tot = {"need": 0, "tested": 0, "dense": 0}
for (a, _), o in zip(calls, outs):
    blocks = o[4].double()
    r = dict(ms=min(ev(lambda: ik.walk_cuda(s, *a, hbm=False), 1.0)[0]
                    for _ in range(2)),
             max=int(blocks.max()), mean=float(blocks.mean()),
             need=ik.needed_pairs(s, a[1], a[3], o[0], o[4], members=1))
    tot["need"] += r["need"]
    tot["dense"] += int(o[4].sum()) * 1024
    if len(o) > 6:
        r["tested"] = int(o[6].sum())
        tot["tested"] += r["tested"]
    per.append(r)
res = dict(ms=ms, launches=len(calls),
           md5=md5([x for o in outs for x in o[:5]]), pairs=tot,
           fit=fit(per, "max"))
if counting and names:
    summed = None
    for a, _ in calls:
        c = counters_of(lambda c: ik.walk_cuda(s, *a, hbm=False, counters=c))
        summed = c if summed is None else summed + c
    res["counters"] = dict(zip(names, summed.tolist()))
res["per_launch"] = per
out["k5"] = res

from ipu_ray_lib_tpu_torch.runtime.device import gpu_identity  # noqa: E402

out["gpu"] = gpu_identity()
out["ptxas"] = [ln.strip() for ln in cb.build_info.get("log", "").splitlines()
                if "registers" in ln or "spill" in ln or "Function" in ln]
print(json.dumps(out), flush=True)
