"""Port parity of the dense full-pel search: ``full_pel_grid_search`` and
``full_pel_hierarchical`` of ``aom_av1_psy_tpu_torch.ops.mvsearch`` (on CPU
tensors: the plain version of kernel KJ) against the reference's jnp branch
(the device program KJ replaces) and its numpy branch, on blocks of
32x32, 24x32 and 16x16 with planted matches, noise and flat blocks on
which every offset ties, at radius 6 and 16, with ``sad_per_bit`` 0 and 4.
Tolerance: exact equality (MVs and SADs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.ops import mvsearch as RMV
from aom_av1_psy_tpu_torch.ops import mvsearch as MV
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(32, 32), (24, 32), (16, 16)]


def blocks(h, w, radius, seed):
    """(src, windows) numpy int32: blocks 0-2 planted at random offsets
    (block 1 with noise), 3 pure noise, 4-5 flat in flat windows (every
    offset ties), 6 a planted match on the window's border."""
    rng = np.random.default_rng(seed)
    B = 7
    wh, ww = h + 2 * radius, w + 2 * radius
    win = rng.integers(0, 256, (B, wh, ww)).astype(np.int32)
    src = rng.integers(0, 256, (B, h, w)).astype(np.int32)
    for b, (dy, dx) in enumerate(rng.integers(-radius, radius + 1, (3, 2))):
        src[b] = win[b, radius + dy : radius + dy + h,
                     radius + dx : radius + dx + w]
    src[1] = np.clip(src[1] + rng.integers(-3, 4, (h, w)), 0, 255)
    win[4:6] = 128
    src[4] = 128
    src[5] = 77
    src[6] = win[6, 2 * radius :, :w]            # dy = +radius, dx = -radius
    return src, win


def _port(fn, src, win, *a, **kw):
    mvs, sad = fn(torch.as_tensor(src), torch.as_tensor(win), *a, **kw)
    assert mvs.dtype == torch.int32 and sad.dtype == torch.int32
    return mvs.numpy(), sad.numpy()


@pytest.mark.parametrize("xp", ["jnp", "numpy"])
@pytest.mark.parametrize("sad_per_bit", [0, 4])
@pytest.mark.parametrize("radius", [6, 16])
@pytest.mark.parametrize("h,w", SHAPES)
def test_grid_search_matches_reference(h, w, radius, sad_per_bit, xp):
    src, win = blocks(h, w, radius, seed=h * 100 + w + radius)
    wrap = jnp.asarray if xp == "jnp" else np.asarray
    want = RMV.full_pel_grid_search(wrap(src), wrap(win), radius,
                                    sad_per_bit)
    got = _port(MV.full_pel_grid_search, src, win, radius, sad_per_bit)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w_))
    if not sad_per_bit:
        # flat blocks: the first offset (-radius, -radius) wins every tie
        np.testing.assert_array_equal(got[0][4:6], -radius)
        assert got[0][6].tolist() == [radius, -radius]


@pytest.mark.parametrize("xp", ["jnp", "numpy"])
@pytest.mark.parametrize("sad_per_bit", [0, 4])
@pytest.mark.parametrize("h,w", SHAPES)
def test_hierarchical_matches_reference(h, w, sad_per_bit, xp):
    src, win = blocks(h, w, 16, seed=h + w)
    wrap = jnp.asarray if xp == "jnp" else np.asarray
    want = RMV.full_pel_hierarchical(wrap(src), wrap(win), 16, step=4,
                                     sad_per_bit=sad_per_bit)
    got = _port(MV.full_pel_hierarchical, src, win, 16, step=4,
                sad_per_bit=sad_per_bit)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w_))


def test_wrapper_and_plain_agree_on_cpu_tensors():
    src, win = blocks(32, 32, 16, seed=5)
    a = _port(MV.full_pel_grid_search, src, win, 16)
    b = _port(MV.full_pel_grid_search_plain, src, win, 16)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_plain_scan_is_chunked_over_blocks(monkeypatch):
    """More blocks than one chunk: the chunks join in block order."""
    monkeypatch.setattr(MV, "_CHUNK", 3)
    src, win = blocks(16, 16, 6, seed=9)
    want = RMV.full_pel_grid_search(src, win, 6)
    got = _port(MV.full_pel_grid_search, src, win, 6)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("radius", [3, 6, 16, 32])
def test_cost_grid_equals_both_reference_branches(radius):
    """The host cost grid (numpy float32 log2) equals the reference's jnp
    branch's at weights 1-13: no difference between the two branches."""
    dr = np.arange(2 * radius + 1) - radius
    jr = jnp.arange(2 * radius + 1) - radius
    for weight in (1, 4, 7, 13):
        got = MV._cost_grid(radius, weight)
        want_np = RMV.mv_cost_bits(dr[:, None].astype(np.float32),
                                   dr[None, :].astype(np.float32), weight)
        want_j = RMV.mv_cost_bits(jr[:, None].astype(jnp.float32),
                                  jr[None, :].astype(jnp.float32), weight)
        np.testing.assert_array_equal(got, want_np)
        np.testing.assert_array_equal(got, np.asarray(want_j))


def test_subpel_helpers_take_tensors():
    """Tensors take the tensor branch (the plain versions on CPU tensors),
    numpy arrays the host branch; both give the same refinement, and
    anything else raises."""
    rng = np.random.default_rng(2)
    src = rng.integers(0, 256, (2, 8, 8)).astype(np.int32)
    win = rng.integers(0, 256, (2, 17, 17)).astype(np.int32)
    mvs = np.array([[1, -2], [0, 3]], np.int32)
    got = MV.batched_subpel_refine(torch.as_tensor(src),
                                   torch.as_tensor(win),
                                   torch.as_tensor(mvs))
    assert all(torch.is_tensor(g) and g.dtype == torch.int32 for g in got)
    for g, w_ in zip(got, MV.batched_subpel_refine(src, win, mvs)):
        np.testing.assert_array_equal(g.numpy(), w_)
    assert MV.subpel_refine(torch.as_tensor(src[0]), torch.as_tensor(win[0]),
                            (1, -2)) == MV.subpel_refine(src[0], win[0],
                                                         (1, -2))
    with pytest.raises(TypeError):
        MV.batched_subpel_refine(src.tolist(), win, mvs)
