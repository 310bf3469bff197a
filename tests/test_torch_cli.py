"""``trace_torch.py`` against ``trace.py`` on the CPU: the path trace.

Both CLIs run with the same flags, the JAX package's with ``--intersector
pallas`` (the megakernel in interpret mode), the port's with ``--device
cpu`` (its plain versions); their EXR files are equal byte for byte:

* ``--scene box -w 16 -H 16 --samples 2 --tpu-only`` (one device; the
  port takes ``--tpu-only`` as its alias of ``--gpu-only``);
* a ``--crop 8x8+12+12`` window of a 32x32 path trace;
* ``--devices 2``: the JAX package on two of the conftest's virtual CPU
  devices (``render_streaming_sharded``), the port on two CPU shards.

The shadow trace with the oracle, the Collada scene and the NIF light are
in tests/test_torch_cli_shadow.py; the port's own CLI checks in
tests/test_torch_cli_port.py.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import pytest

from torch_cli_pairs import run_pair, same_bytes

CASES = {
    "box": ["--scene", "box", "-w", "16", "-H", "16", "--samples", "2",
            "--tpu-only", "--devices", "1"],
    "crop": ["--scene", "box-simple", "-w", "32", "-H", "32", "--crop",
             "8x8+12+12", "--samples", "2", "--tpu-only", "--devices", "1"],
    "devices-2": ["--scene", "box", "-w", "16", "-H", "16", "--samples", "2",
                  "--tpu-only", "--devices", "2"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_path_trace_exr_equals_trace_py(tmp_path, case):
    pairs = run_pair(tmp_path, CASES[case])
    assert list(pairs) == ["gpu"]
    assert same_bytes(*pairs["gpu"])
