"""Port parity of the device mesh (``parallel/mesh.py``) on the CPU, held
against the JAX reference on the virtual CPU devices of
``tests/conftest.py``:

- with ``GpuFrameEncoder.mesh`` a mesh of k CPU entries, the frame of
  ``tests/test_multichip.py`` at 64k x 128 (k tile columns) gives the
  byte-identical stream of the reference's sharded encode
  (``TpuFrameEncoder.mesh = make_mesh(k)``) and of the port's batched
  encode, and the port's ``tile_plans_sharded`` on the slabs the
  reference's ``tile_plans_sharded`` was given returns its plans (k = 2
  and 8 here; k = 4 and a last tile narrower than its slab in
  ``test_torch_mesh_cells.py``);
- a class-level mesh reaches the KEY frame of ``encode_video``;
- ``sharded_analyze_step`` equals the reference's at mesh sizes 1, 2 and
  8, the int32 wrap of the totals included;
- the error paths raise, and the kernels' device guard refuses a call on
  another card than the current one (a stand-in for the card's getter).

Tolerance: exact equality."""
import functools

import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder
from aom_av1_psy_tpu.parallel import mesh as RM
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.encoder import tpu_interframe as TIF
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from aom_av1_psy_tpu_torch.kernels.build import CudaKernel, WrongDevice
from aom_av1_psy_tpu_torch.parallel import mesh as M
from aom_av1_psy_tpu_torch.utils.testframes import make_frame
from test_multichip import _frame
from test_torch_analyze import _ref_step
from test_torch_tiles import assert_same_tile_plans
from test_tpu_inter import panning
from torch_threads import one_torch_thread  # noqa: F401


def cpu_mesh(k):
    return M.Mesh(["cpu"] * k)


def check_sharded(monkeypatch, f, cfg, k):
    """The reference's sharded encode (its ``tile_plans_sharded`` call
    recorded), the port's mesh encode and the port's batched encode of one
    frame: the same bytes, and the port's sharded plans on the recorded
    slabs equal the reference's."""
    seen = []
    ref_sharded = RM.tile_plans_sharded

    def record(mesh, slabs, q, mi_rows):
        plans = ref_sharded(mesh, slabs, q, mi_rows)
        seen.append((slabs, q, mi_rows, plans))
        return plans

    monkeypatch.setattr(RM, "tile_plans_sharded", record)
    ref = TpuFrameEncoder(f, cfg)
    ref.mesh = RM.make_mesh(k)
    want = ref.encode()
    assert ref.tile_T == k and len(seen) == 1

    pf, pcfg = convert.from_jax(f), convert.from_jax(cfg)
    enc = GpuFrameEncoder(pf, pcfg, device="cpu")
    enc.mesh = convert.from_jax(ref.mesh, "cpu")
    assert len(enc.mesh) == k and enc.mesh.axis == "tiles"
    got = enc.encode()
    batched = GpuFrameEncoder(pf, pcfg, device="cpu").encode()
    assert got == want
    assert batched == want
    assert_same_tile_plans(seen[0][3], enc.tile_plans)

    slabs, q, mi_rows, plans = seen[0]
    sharded = M.tile_plans_sharded(cpu_mesh(k), slabs, q, mi_rows)
    assert_same_tile_plans(plans, sharded)
    for p in sharded:
        assert all(r.device.type == "cpu" for r in p["recon_dev"])
    return enc


@pytest.mark.parametrize("k", [2, 8])
def test_sharded_tiles_match_jax(monkeypatch, k):
    check_sharded(monkeypatch, _frame(64 * k, 128),
                  EncoderConfig(base_q_idx=90,
                                tile_cols_log2=k.bit_length() - 1), k)


def test_class_mesh_reaches_the_gop_key_frame(monkeypatch):
    """``GpuFrameEncoder.mesh`` set on the class: the 2-tile KEY frame of
    ``encode_video`` is planned through ``tile_plans_sharded``, and the
    GOP's packets are those of the unsharded GOP."""
    frames = [convert.from_jax(f) for f in panning(128, 64, 3, seed=12)]
    cfg = convert.from_jax(EncoderConfig(base_q_idx=90, tile_cols_log2=1))
    want, _ = TIF.encode_video(frames, cfg, device="cpu")
    calls = []
    sharded = M.tile_plans_sharded
    monkeypatch.setattr(M, "tile_plans_sharded",
                        lambda *a: calls.append(a[0]) or sharded(*a))
    monkeypatch.setattr(GpuFrameEncoder, "mesh", cpu_mesh(2))
    got, encs = TIF.encode_video(frames, cfg, device="cpu")
    assert got == want
    assert len(calls) == 1 and len(calls[0]) == 2
    assert encs[0].tile_T == 2


def _blocks(rng, B, n):
    blocks = rng.integers(0, 256, (B, n, n)).astype(np.uint8)
    above, left = (rng.integers(0, 256, (B, n)).astype(np.uint8)
                   for _ in range(2))
    return blocks, above, left, rng.integers(0, 256, B).astype(np.uint8)


def _wrap_blocks():
    """1024 checkerboard 32x32 blocks: the SSE total passes 2**31."""
    B, n = 1024, 32
    r, c = np.mgrid[0:n, 0:n]
    blocks = np.broadcast_to(((r + c + 1) % 2 * 255).astype(np.uint8),
                             (B, n, n)).copy()
    return (blocks, np.full((B, n), 127, np.uint8),
            np.full((B, n), 129, np.uint8), np.full(B, 128, np.uint8))


@pytest.mark.parametrize("case", ["n8", "n32", "wrap"])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_sharded_step_matches_jax(k, case):
    rng = np.random.default_rng(k * 10 + len(case))
    args = {"n8": lambda: _blocks(rng, 64, 8),
            "n32": lambda: _blocks(rng, 16, 32),
            "wrap": _wrap_blocks}[case]()
    n = args[0].shape[-1]
    want = _ref_step(k, n)(*args)
    step = M.sharded_analyze_step(convert.from_jax(RM.make_mesh(k), "cpu"),
                                  n, 100)
    got = step(*args)
    tensors = step(*map(torch.as_tensor, args))
    for g, t, w, name in zip(got, tensors, want,
                             ("modes", "levels", "eob", "tot_sse",
                              "tot_coeff")):
        assert g.dtype == t.dtype == torch.int32, name
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(t.numpy(), np.asarray(w), err_msg=name)
    if case == "wrap":
        assert int(got[3]) == -133693440


@functools.cache
def _tiled_encoder():
    return GpuFrameEncoder(make_frame(128, 64, seed=3),
                           convert.from_jax(EncoderConfig(
                               base_q_idx=90, tile_cols_log2=1)),
                           device="cpu")


@pytest.mark.parametrize("case", [
    "mesh_size_not_tile_count", "encoder_mesh_size", "batch_not_divisible",
    "make_mesh_without_cuda", "mixed_mesh", "one_tile", "uniform_grid",
    "from_jax_without_device"])
def test_error_paths_raise(case):
    if case == "mesh_size_not_tile_count":
        with pytest.raises(ValueError, match="2 tile slabs"):
            M.tile_plans_sharded(cpu_mesh(3), _tiled_encoder()._tile_slabs(),
                                 90, _tiled_encoder().mi_rows)
    elif case == "encoder_mesh_size":
        enc = GpuFrameEncoder(make_frame(128, 64, seed=3),
                              _tiled_encoder().cfg, device="cpu")
        enc.mesh = cpu_mesh(4)
        with pytest.raises(ValueError, match="4 devices for 2"):
            enc.encode()
    elif case == "batch_not_divisible":
        args = _blocks(np.random.default_rng(0), 6, 8)
        with pytest.raises(ValueError, match="divide"):
            M.sharded_analyze_step(cpu_mesh(4), 8, 100)(*args)
    elif case == "make_mesh_without_cuda":
        if torch.cuda.device_count() >= 2:
            pytest.skip("this machine has two cards")
        with pytest.raises(RuntimeError, match="CUDA devices"):
            M.make_mesh(2)
    elif case == "mixed_mesh":
        with pytest.raises(ValueError, match="mixes"):
            M.Mesh(["cpu", "cuda:0"])
    elif case in ("one_tile", "uniform_grid"):
        # 128x64 untiled; 640x360 (mi rows = 2 mod 8) takes the uniform grid
        w, h = (128, 64) if case == "one_tile" else (640, 360)
        enc = GpuFrameEncoder(make_frame(w, h, seed=3),
                              convert.from_jax(EncoderConfig(base_q_idx=90)),
                              device="cpu")
        enc.mesh = cpu_mesh(2)
        with pytest.raises(ValueError, match=case.replace("_", " ")):
            enc.encode()
    else:
        with pytest.raises(ValueError, match="device"):
            convert.from_jax(RM.make_mesh(2))


def test_make_mesh_on_the_cpu():
    m = M.make_mesh(3, device="cpu")
    assert m.devices == (torch.device("cpu"),) * 3 and m.axis == "tiles"
    assert len(M.make_mesh(device="cpu")) == 1


def _fake_kernel(current):
    """A kernel whose library is a stand-in: the current device is
    ``current`` and its entry records the stream it was handed."""
    k = CudaKernel("fake", {"entry": ()})
    calls = []
    k._lib = object()
    k._fns = {"entry": lambda *a: calls.append(a) or 0}
    k._current = lambda: current
    k._raw = lambda d: 1000 + d
    return k, calls


@pytest.mark.parametrize("how", ["launch", "call"])
def test_guard_refuses_another_cards_tensors(how):
    k, calls = _fake_kernel(current=0)
    getattr(k, how)("entry", 7, device=0)
    assert calls == [(7, 1000)]
    with pytest.raises(WrongDevice, match="cuda:1"):
        getattr(k, how)("entry", 7, device=1)
    assert calls == [(7, 1000)]
    assert k.launches == (1 if how == "launch" else 0)
    with pytest.raises(TypeError):
        getattr(k, how)("entry", 7)
