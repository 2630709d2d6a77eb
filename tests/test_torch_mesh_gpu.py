"""The device mesh of ``aom_av1_psy_tpu_torch`` on the card: a mesh that
names ``cuda:0`` twice plans the 2-tile frame as the batched path does
(same stream, same plans), the analysis step sharded over it equals the
batched step, and every kernel call refuses tensors of another card than
the current one (the guard of ``kernels/build.CudaKernel``). With two
cards: ``make_mesh(2)`` plans each tile on its own card, and a KP launch
on ``cuda:1`` tensors with ``cuda:0`` current raises. Tolerance: exact
equality.

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false (the two-card tests also where
fewer than two cards exist). The file imports nothing of jax or of the
reference package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_mesh_gpu.py
"""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from aom_av1_psy_tpu_torch.kernels.build import WrongDevice
from aom_av1_psy_tpu_torch.normative import tables
from aom_av1_psy_tpu_torch.ops import analyze as A
from aom_av1_psy_tpu_torch.ops.analyze import KP
from aom_av1_psy_tpu_torch.ops.intra_pred import KA
from aom_av1_psy_tpu_torch.ops.txfm import SQUARE_TX
from aom_av1_psy_tpu_torch.parallel import mesh as M
from aom_av1_psy_tpu_torch.utils import testframes

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return M.make_mesh(2)


CFG = EncoderConfig(base_q_idx=90, tile_cols_log2=1)


def _encode(frame, device, mesh=None):
    enc = GpuFrameEncoder(frame, CFG, device=device)
    enc.mesh = mesh
    return enc.encode(), enc


def _same_plans(a, b):
    for pa, pb in zip(a, b, strict=True):
        assert set(pa) == set(pb)
        for k, v in pa.items():
            if k == "recon_dev":
                for ra, rb in zip(v, pb[k], strict=True):
                    assert torch.equal(ra.cpu(), rb.cpu())
            elif k != "part":
                np.testing.assert_array_equal(v, pb[k], err_msg=k)


def test_repeated_card_mesh_equals_batched(dev):
    frame = testframes.make_frame(256, 128, seed=2)
    want, batched = _encode(frame, dev)
    got, enc = _encode(frame, dev, M.Mesh([dev, dev]))
    assert got == want == _encode(frame, "cpu")[0]
    _same_plans(batched.tile_plans, enc.tile_plans)
    for p in enc.tile_plans:
        assert all(r.device == dev for r in p["recon_dev"])


def test_two_card_mesh_plans_each_tile_on_its_card(two_cards):
    frame = testframes.make_frame(256, 128, seed=2)
    want, batched = _encode(frame, "cuda:0")
    got, enc = _encode(frame, "cuda:0", two_cards)
    assert got == want
    _same_plans(batched.tile_plans, enc.tile_plans)
    for t, p in enumerate(enc.tile_plans):
        assert all(r.device == torch.device("cuda", t)
                   for r in p["recon_dev"])
    assert all(r.device == torch.device("cuda", 0)
               for r in enc.ref_planes_dev)


def _blocks(n, B, device):
    rng = np.random.default_rng(n)
    return [torch.as_tensor(a, device=device) for a in (
        rng.integers(0, 256, (B, n, n)).astype(np.uint8),
        rng.integers(0, 256, (B, n)).astype(np.uint8),
        rng.integers(0, 256, (B, n)).astype(np.uint8),
        rng.integers(0, 256, B).astype(np.uint8))]


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_step_on_one_card_equals_batched(dev, shards):
    args = _blocks(16, 8160, dev)
    want = M.batched_analyze_step(16, 100, device=dev)(*args)
    got = M.sharded_analyze_step(M.Mesh([dev] * shards), 16, 100)(*args)
    for g, w in zip(got, want, strict=True):
        assert g.device == dev and torch.equal(g, w)


def test_sharded_step_on_two_cards_equals_batched(two_cards):
    args = _blocks(16, 8160, "cuda:0")
    want = M.batched_analyze_step(16, 100, device="cuda:0")(*args)
    got = M.sharded_analyze_step(two_cards, 16, 100)(*args)
    for g, w in zip(got, want, strict=True):
        assert g.device == torch.device("cuda", 0) and torch.equal(g, w)


def test_guard_refuses_a_device_that_is_not_current(dev):
    KA.lib()
    KP.lib()
    with torch.cuda.device(dev):
        KA.stream_on(0)
        for k in (KA, KP):
            with pytest.raises(WrongDevice, match="cuda:1"):
                k.stream_on(1)


def test_launch_on_the_second_card_needs_it_current(two_cards):
    args = _blocks(8, 64, "cuda:1")
    q = (tables.dc_quant(100), tables.ac_quant(100), SQUARE_TX[8])
    before = KP.launches
    with torch.cuda.device(0):
        with pytest.raises(WrongDevice):
            A.analyze_blocks(*args, *q)
    assert KP.launches == before
    with torch.cuda.device(1):
        got = A.analyze_blocks(*args, *q)
    want = A.analyze_blocks(*(a.cpu() for a in args), *q)
    for g, w in zip(got, want, strict=True):
        assert g.device == torch.device("cuda", 1)
        assert torch.equal(g.cpu(), w)


def test_mesh_of_another_device_type_raises(dev):
    enc = GpuFrameEncoder(testframes.make_frame(256, 128, seed=2), CFG,
                          device=dev)
    enc.mesh = M.Mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="cpu devices"):
        enc.encode()
