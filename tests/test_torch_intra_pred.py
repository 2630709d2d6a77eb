"""Port parity: intra prediction of ``aom_av1_psy_tpu_torch`` — the plain
modes, the directional edge buffer + gathers, the carried-over candidate
tables and masks, and the plain version of kernel KA — against the JAX
reference on the same seeded inputs. Tolerance: exact equality."""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aom_av1_psy_tpu.encoder import tpu_intra as JTI
from aom_av1_psy_tpu.encoder import tpu_intra_dir as JDIR
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TTI
from aom_av1_psy_tpu_torch.encoder import tpu_intra_dir as TDIR
from aom_av1_psy_tpu_torch.ops import intra_pred as IP
from torch_threads import one_torch_thread  # noqa: F401

# every (have_a, have_l, trreal, blreal) combination, one block each
COMBOS = np.array(list(itertools.product((0, 1), repeat=4)), bool)


def _edges(rng, bs, n):
    return (rng.integers(0, 256, (n, bs)).astype(np.int32),
            rng.integers(0, 256, (n, bs)).astype(np.int32),
            rng.integers(0, 256, n).astype(np.int32))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_predict_all_modes_matches_jax(bs):
    rng = np.random.default_rng(bs)
    above, left, tl = _edges(rng, bs, 16)
    ha, hl = COMBOS[:, 0], COMBOS[:, 1]
    want = JTI._predict_all_modes(jnp.asarray(above), jnp.asarray(left),
                                  jnp.asarray(tl), jnp.asarray(ha),
                                  jnp.asarray(hl), bs)
    got = TTI._predict_all_modes(_t(above), _t(left), _t(tl), _t(ha),
                                 _t(hl), bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bs", [16, 32])
def test_tables_and_candidates_carried_over(bs):
    assert TDIR.candidates() == JDIR.candidates()
    want, got = JDIR.tables(bs), TDIR.tables(bs)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("mi_rows,mi_cols,R,C", [(16, 24, 2, 3),
                                                 (36, 44, 5, 6),
                                                 (32, 32, 4, 4)])
def test_position_masks_carried_over(mi_rows, mi_cols, R, C):
    want = JDIR.position_masks(mi_rows, mi_cols, mi_cols, R, C)
    got = TDIR.position_masks(mi_rows, mi_cols, mi_cols, R, C)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("bs,ef", [(16, 0), (16, 1), (32, 0), (32, 1)])
def test_edge_buffer_and_dir_predict_match_jax(bs, ef):
    rng = np.random.default_rng(10 * bs + ef)
    above, left, tl = _edges(rng, bs, 16)
    abext = rng.integers(0, 256, (16, bs)).astype(np.int32)
    lfext = rng.integers(0, 256, (16, bs)).astype(np.int32)
    ha, hl, tr, bl = (COMBOS[:, i] for i in range(4))
    eft = np.full(16, bool(ef))
    E_j = JDIR.build_edge_buffer(*(jnp.asarray(a) for a in (
        above, left, tl, ha, hl, tr, bl, abext, lfext)), bs)
    E_t = TDIR.build_edge_buffer(*(_t(a) for a in (
        above, left, tl, ha, hl, tr, bl, abext, lfext)), bs)
    np.testing.assert_array_equal(E_t.numpy(), np.asarray(E_j))
    want = JDIR.dir_predict(E_j, jnp.asarray(eft), bs)
    got = TDIR.dir_predict(E_t, _t(eft), bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bs", [16, 32])
def test_allowed_mask_matches_jax(bs):
    rng = np.random.default_rng(bs)
    ok = [rng.random(9) < .5 for _ in range(3)]
    want = JDIR.allowed_mask(*(jnp.asarray(o) for o in ok), bs)
    got = TDIR.allowed_mask(*(_t(o) for o in ok), bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_preds(above, left, tl, ha, hl, tr, bl, abext, lfext, eft, bs, K):
    """The reference's candidate stack, as its wavefronts build it."""
    j = [jnp.asarray(a) for a in (above, left, tl, ha, hl)]
    p = JTI._predict_all_modes(*j, bs)
    if K == 7:
        return np.asarray(p)
    E = JDIR.build_edge_buffer(*j, *(jnp.asarray(a) for a in (
        tr, bl, abext, lfext)), bs)
    return np.asarray(jnp.concatenate(
        [p, JDIR.dir_predict(E, jnp.asarray(eft), bs)], axis=0))


@pytest.mark.parametrize("bs,K", [(32, 61), (16, 61), (16, 7), (8, 7),
                                  (4, 7)])
def test_intra_pred_sse_plain_matches_jax(bs, K):
    rng = np.random.default_rng(bs + K)
    n = 16
    above, left, tl = _edges(rng, bs, n)
    abext = rng.integers(0, 256, (n, bs)).astype(np.int32)
    lfext = rng.integers(0, 256, (n, bs)).astype(np.int32)
    ha, hl, tr, bl = (COMBOS[:, i] for i in range(4))
    if K == 7:
        tr = bl = np.zeros(n, bool)
    eft = rng.random(n) < .5
    src = rng.integers(0, 256, (n, bs, bs)).astype(np.int32)
    preds = _jax_preds(above, left, tl, ha, hl, tr, bl, abext, lfext, eft,
                       bs, K)
    want_sse = ((preds - src[None]) ** 2).sum((-1, -2))
    ext = {}
    if K == 61:
        ext = dict(trreal=_t(tr), blreal=_t(bl), abext=_t(abext),
                   lfext=_t(lfext), ef=_t(eft))
    args = [_t(a) for a in (above, left, tl, ha, hl)]
    # the wrapper takes the plain version for CPU tensors
    sse = IP.intra_pred_sse(*args, _t(src), K, **ext)
    assert sse.dtype == torch.int32 and sse.shape == (K, n)
    np.testing.assert_array_equal(sse.numpy(), want_sse)
    cand = rng.integers(0, K, n)
    one = IP.intra_pred_one(*args, _t(cand), K, **ext)
    np.testing.assert_array_equal(one.numpy(), preds[cand, np.arange(n)])

