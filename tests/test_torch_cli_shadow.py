"""``trace_torch.py`` against ``trace.py`` on the CPU: the shadow trace,
an imported scene and the NIF light.

Both CLIs run with the same flags (the JAX package's with ``--intersector
pallas``, the port's with ``--device cpu``); their EXR files are equal
byte for byte:

* ``--scene box-simple -w 24 -H 24 --render-mode shadow-trace --visualise
  normal`` with the oracle and the CPU twin: the card's (here the CPU's)
  image, the CPU twin's and the oracle's;
* a ``--crop`` window of the Cornell + monkey shadow trace (hit points);
* ``--mesh-file assets/hdri_test.dae --visualise id`` (Collada).

``--scene spheres --nif-hdri assets/nif/synthetic_urban_4k`` holds the
split tolerance of tests/test_torch_env.py (the NIF-lit render is not bit
for bit: queue 3 of ROADMAP.md) at the size that tolerance was measured
at, 48x32 spp 2 (the golden's render). At 16x16 spp 2 its share within
1e-2 is 0.979 (16 of 768 elements outside), below the tolerance's 0.98:
the share is a measured one, and 768 elements are too few to hold it.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import pytest

from ipu_ray_lib_tpu_torch.utils.exr import read_exr
from test_torch_env import hold_high_frequency, split
from torch_cli_pairs import run_pair, same_bytes

CASES = {
    "shadow-oracle": (["--scene", "box-simple", "-w", "24", "-H", "24",
                       "--render-mode", "shadow-trace", "--visualise",
                       "normal", "--devices", "1"], "normal",
                      ["oracle", "cpu", "gpu"]),
    "crop": (["--scene", "box", "-w", "32", "-H", "32", "--crop",
              "8x8+12+12", "--render-mode", "shadow-trace", "--visualise",
              "hitpoint", "--tpu-only", "--devices", "1"], "hitpoint",
             ["gpu"]),
    "collada-id": (["--mesh-file", "assets/hdri_test.dae", "-w", "16", "-H",
                    "16", "--render-mode", "shadow-trace", "--visualise",
                    "id", "--tpu-only", "--devices", "1"], "id", ["gpu"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_shadow_exr_equals_trace_py(tmp_path, case):
    argv, vis, kinds = CASES[case]
    pairs = run_pair(tmp_path, argv, vis)
    assert sorted(pairs) == sorted(kinds)
    for kind in kinds:
        assert same_bytes(*pairs[kind]), kind
    assert read_exr(pairs["gpu"][0]).max() > 0


def test_nif_render_holds_the_split_tolerance(tmp_path):
    pairs = run_pair(tmp_path, [
        "--scene", "spheres", "--nif-hdri", "assets/nif/synthetic_urban_4k",
        "-w", "48", "-H", "32", "--samples", "2", "--tpu-only",
        "--devices", "1"])
    got, want = (read_exr(p) for p in pairs["gpu"])
    assert got.shape == want.shape == (32, 48, 3)
    assert got.mean() > 0.05
    hold_high_frequency(split(got, want))
