"""The host half of the tensor-core env MLP and the gate it is held to.

* ``pack_mma`` lays the urban_4k NIF's bf16 weights out in the order and
  the ``mma.m16n8k16`` B-fragment layout the kernel (ops/cuda/env_mlp.cu)
  reads them: read back through its stage table as the kernel reads it,
  every weight comes back in its place, once, and the padding is zero.
* The kernel sums in the tensor cores' order, so on the card it is held
  to a tolerance, not to the bit: ``deviation`` gives the measures of
  tests/test_torch_env.py ``split``, and ``within_yardstick`` the gate
  that chip_smoke.py applies against a torch.matmul chain's deviation.
  Both are tested here on synthetic perturbations of a plain output.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

import numpy as np
import pytest
import torch

from ipu_ray_lib_tpu_torch.nif.model import NifConfig, NifEnv, load_nif_env
from ipu_ray_lib_tpu_torch.ops import env as envk
from test_torch_env import hold_high_frequency, split

ROOT = os.path.join(os.path.dirname(__file__), "..")
URBAN = os.path.join(ROOT, "assets", "nif", "synthetic_urban_4k")


@pytest.fixture(scope="module")
def urban():
    return load_nif_env(URBAN, device="cpu")


@pytest.fixture(scope="module")
def plain(urban):
    """The plain env MLP on 2,048 seeded directions."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return envk.env_mlp_ref(torch.from_numpy(d), urban).numpy()


def _unpack(packed, env):
    """The layers' weight bits as the kernel reads them: stage by stage,
    k-tile by n-tile, lane g*4 + t holding rows (2t, 2t+1) and (2t+8,
    2t+9) of column g. Also checks that the stages run through the
    packed words in order, each pass and layer ending where flagged."""
    wq = packed["wq"].numpy().view(np.uint32)
    got = {l: np.full((cin, -(-cout // 16) * 16), -1, np.int64)
           for l, (cin, cout, _, _) in enumerate(env.layers)}
    off = 0
    for off16, n16, l, n0, k0, nk, nch, flags in packed["stages"].tolist():
        assert off16 == off and 0 < nk <= envk.MMA_KG
        assert 0 < nch <= envk.MMA_NCH and n16 == nk * nch * 16
        off += n16
        w = got[l]
        kt, nt = w.shape[0] // 16, w.shape[1] // 8
        assert flags & 1 == (k0 + nk == kt)
        assert flags >> 1 == (k0 + nk == kt and n0 + nch == nt)
        words = wq[off16 * 4:(off16 + n16) * 4].reshape(nk, nch, 32, 2)
        for kk in range(nk):
            for j in range(nch):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for h in range(2):
                        k = (k0 + kk) * 16 + 8 * h + 2 * t
                        v = int(words[kk, j, lane, h])
                        for dk, bits in ((0, v & 0xFFFF), (1, v >> 16)):
                            assert w[k + dk, (n0 + j) * 8 + g] == -1
                            w[k + dk, (n0 + j) * 8 + g] = bits
    assert off * 4 == wq.size
    return got


def test_pack_mma_holds_every_weight_once(urban):
    packed = envk.pack_mma(urban)
    got = _unpack(packed, urban)
    F = 4 * urban.config.embedding_dimension
    for l, (cin, cout, relu, concat) in enumerate(urban.layers):
        w, _ = urban.layer(l)
        want = w.view(torch.int16).numpy().astype(np.uint16)
        np.testing.assert_array_equal(got[l][:, :cout], want)
        assert not got[l][:, cout:].any()  # the padded outputs are zero
        row = packed["layers"][l].tolist()
        at = 0 if l == 0 else cin - F if concat else cin
        assert row[:6] == [cin, cout, int(relu), at, urban.offsets[l][1],
                           int(l == urban.num_layers - 1)]
    assert packed["ldx"] == 320 + 8  # the widest hidden output, + 8
    # the host copy of the stage table, which the launcher checks:
    np.testing.assert_array_equal(packed["stages_host"],
                                  packed["stages"].numpy())
    assert envk._packed(urban) is envk._packed(urban)


def test_pack_mma_refuses_widths_off_the_instruction():
    """An E = 2 NIF has 8 features, not a multiple of the 16-deep
    instruction: the CPU route still runs it, the kernel's packing
    refuses it."""
    env = NifEnv(NifConfig(2, ("relu", "none"), (False, False), True),
                 [np.ones((8, 16), np.float32), np.ones((16, 3), np.float32)],
                 [None, None], 1.0, np.zeros(3, np.float32))
    out = envk.env_mlp(torch.tensor([[0.0, 1.0, 0.0]]), env)
    assert out.shape == (1, 3) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="multiples of 16"):
        envk.pack_mma(env)


def _perturb(x, rel, share, seed):
    """x with a ``share`` of its elements moved by up to ``rel``
    relative."""
    rng = np.random.default_rng(seed)
    hit = rng.random(x.shape) < share
    return (x * (1 + np.where(hit, rng.uniform(-rel, rel, x.shape), 0.0))
            ).astype(np.float32)


@pytest.mark.parametrize("rel,share", [(3e-6, 1.0), (4e-3, 0.2),
                                       (2e-2, 0.01)])
def test_deviation_is_split(plain, rel, share):
    got = _perturb(plain, rel, share, 1)
    assert envk.deviation(got, plain) == split(got, plain)


def test_yardstick_gate(plain):
    """The gate passes a kernel nearer the plain version than the chain
    and refuses one further off on any measure, within and beyond the
    stated slack; and it holds the high-frequency tolerance on its own."""
    near = envk.deviation(_perturb(plain, 2e-3, 0.3, 2), plain)
    far = envk.deviation(_perturb(plain, 2e-2, 0.3, 3), plain)
    assert envk.within_yardstick(near, far) == []
    assert envk.within_yardstick(near, near) == []
    bad = envk.within_yardstick(far, near)
    assert any(b.startswith("within_1e2") for b in bad)
    assert any(b.startswith("max_rel") for b in bad)
    # just past the slack, one measure at a time:
    for key, step in (("within_1e5", -2 * envk.YARDSTICK_SHARE_SLACK),
                      ("within_1e2", -2 * envk.YARDSTICK_SHARE_SLACK),
                      ("mean_rel", 2 * envk.YARDSTICK_MEAN_REL_SLACK)):
        k = dict(near, **{key: near[key] + step})
        assert [b.split()[0] for b in envk.within_yardstick(k, near)] == [key]
    k = dict(near, max_rel=near["max_rel"] * envk.YARDSTICK_MAX_REL_SLACK
             * 1.01)
    assert [b.split()[0] for b in envk.within_yardstick(k, near)] == [
        "max_rel"]
    # the high-frequency tolerance binds even where the chain is worse:
    worse = envk.deviation(_perturb(plain, 1e-1, 0.05, 4), plain)
    assert envk.within_high_frequency(worse) != []
    assert envk.within_yardstick(worse, worse) == envk.within_high_frequency(
        worse)
    with pytest.raises(AssertionError):
        hold_high_frequency(worse)
    hold_high_frequency(near)
    assert envk.within_high_frequency(near) == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["MMA_KG", "MMA_NCH"])
def test_cuda_launch_refuses_stages_past_the_ring(urban, cuda_device,
                                                  monkeypatch, knob):
    """A pack whose stages hold more k-tiles or n-tiles than the kernel's
    weight ring is refused at launch, not run past its slots."""
    from ipu_ray_lib_tpu_torch.ops.cuda.build import launch_env_mlp

    env = urban.to(cuda_device)
    monkeypatch.setattr(envk, knob, getattr(envk, knob) * 2)
    packed = envk.pack_mma(env)
    dirs = torch.tensor([[0.0, 1.0, 0.0]], device=cuda_device)
    with pytest.raises(RuntimeError, match="env_mlp launch failed"):
        launch_env_mlp(dirs, torch.empty_like(dirs), env, packed)
