"""Record -> bank with the env term left out equals K1's direct banking
bit for bit (the golden box scene, and with the monkey plinth): the bank
adds a slot's paths in the reference's order. A file of its own beside
tests/test_torch_env.py, whose stream helper it shares, so that the test
workers run the two side by side."""

import torch_threads  # noqa: F401  (first: one torch thread)
import pytest
import torch

from ipu_ray_lib_tpu_torch.ops import megakernel as mk
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene
from test_torch_env import _stream


@pytest.mark.parametrize("mesh", [None, "assets/monkey_bust.glb"])
def test_record_then_bank_equals_direct_banking(mesh):
    """Records banked with every env contribution left out give K1's
    direct accumulator bit for bit (golden box scene, and with the
    monkey plinth)."""
    ts, params = build_scene(make_cornell_box_scene(mesh, box_only=False),
                             device="cpu", image_width=24, image_height=16,
                             samples_per_pixel=2)
    rows, cols, n_pix, kw = _stream(params)
    direct, d0 = mk._trace(mk._accumulate_plain, ts, rows, cols, 1442, n_pix,
                           **kw)
    rec, d1 = mk.trace_records(ts, rows, cols, 1442, n_pix, **kw)
    assert torch.equal(d0, d1) and int(d1.sum()) == n_pix * 2
    esc = mk.escaped_records(rec, d1)
    assert 0 < int(esc.sum()) < int(d1.sum())
    rec[6] = 0.0  # leave every escaped path's env term out
    banked = mk.bank(rec, d1, 2)
    assert float(direct.sum()) > 0.0
    assert torch.equal(banked, direct)
