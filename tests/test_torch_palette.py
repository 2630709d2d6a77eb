"""Port parity of palette ``calc_indices`` and ``k_means``
(``aom_av1_psy_tpu_torch.ops.palette``): the numpy branch and the tensor
branch on CPU tensors (the plain version of kernel KQ) against the libaom
golden cases of ``tests/golden/golden_kmeans.npz`` (dims 1 and 2, as
``tests/test_palette.py`` reads them), against the reference's jnp branch
(the device program KQ replaces) on seeded data at N = 4096, K = 2..8
(dim 1) and N = 1024 pairs (dim 2), with duplicate centroids (the first
index wins), and ``k_means`` against the reference's.

JAX runs without x64, so the jnp branch sums in int32; at 8-bit samples
and N <= 4096 that cannot wrap. Tolerance: exact equality (indices, their
uint8 dtype and the integer totals)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.ops import palette as RP
from aom_av1_psy_tpu_torch.ops import palette as P
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_kmeans.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _check(got, want):
    gi, gt = got
    wi, wt = want
    if torch.is_tensor(gi):
        assert gi.dtype == torch.uint8
        gi = gi.numpy()
    assert gi.dtype == np.uint8 and np.asarray(wi).dtype == np.uint8
    np.testing.assert_array_equal(gi, np.asarray(wi))
    assert isinstance(gt, int) and gt == int(wt)


@pytest.mark.parametrize("case", range(6))
def test_golden(golden, case):
    g = golden
    n, k = (int(v) for v in g[f"km{case}_meta"])
    data = g[f"km{case}_data"][: n * 2]
    cents = g[f"km{case}_cents"][: k * 2]
    for dim, d, c in ((1, data[:n], cents[:k]), (2, data, cents)):
        want = (g[f"km{case}_idx{dim}"][:n].astype(np.uint8),
                int(g[f"km{case}_dist"][dim - 1]))
        _check(P.calc_indices(d, c, dim), want)
        _check(P.calc_indices(torch.as_tensor(d), torch.as_tensor(c), dim),
               want)


def _data(seed, n, dim):
    return np.random.default_rng(seed).integers(0, 256, n * dim) \
        .astype(np.int32)


@pytest.mark.parametrize("k", range(2, 9))
@pytest.mark.parametrize("dim,n", [(1, 4096), (2, 1024)])
def test_tensor_branch_matches_jnp(dim, n, k):
    data = _data(dim * 100 + k, n, dim)
    # evenly spaced centroids make many dim-1 ties (first index wins)
    cents = (np.arange(k * dim) * 255 // max(k * dim - 1, 1)).astype(np.int32)
    np.random.default_rng(k).shuffle(cents)
    want = RP.calc_indices(jnp.asarray(data), jnp.asarray(cents), dim)
    _check(P.calc_indices(torch.as_tensor(data), torch.as_tensor(cents), dim),
           want)
    _check(P.calc_indices(data, cents, dim), want)
    _check(P.calc_indices(torch.as_tensor(data), cents, dim), want)


@pytest.mark.parametrize("dim", [1, 2])
def test_duplicate_centroids_first_index_wins(dim):
    data = _data(dim, 512, dim)
    cents = np.array([[40, 40], [200, 90], [40, 40], [120, 250],
                      [200, 90]])[:, :dim].reshape(-1)
    idx, total = P.calc_indices(torch.as_tensor(data), torch.as_tensor(cents),
                                dim)
    assert set(idx.tolist()) <= {0, 1, 3}
    want = RP.calc_indices(jnp.asarray(data), jnp.asarray(cents), dim)
    _check((idx, total), want)


@pytest.mark.parametrize("k", [2, 5, 8])
@pytest.mark.parametrize("dim", [1, 2])
def test_k_means_matches_reference(dim, k):
    rng = np.random.default_rng(dim * 10 + k)
    centres = rng.integers(20, 236, (k, dim))
    data = np.clip(centres[rng.integers(0, k, 600)]
                   + rng.normal(0, 6, (600, dim)), 0, 255).astype(np.int64)
    got = P.k_means(data.reshape(-1), k, dim)
    want = RP.k_means(data.reshape(-1), k, dim)
    np.testing.assert_array_equal(got[0], want[0])
    _check(got[1:], want[1:])


def test_tensor_branch_takes_256_centroids_and_raises_above():
    data = _data(3, 2048, 1)
    cents = np.arange(256)
    _check(P.calc_indices(torch.as_tensor(data), torch.as_tensor(cents), 1),
           RP.calc_indices(data, cents, 1))
    with pytest.raises(ValueError, match="uint8"):
        P.calc_indices(torch.as_tensor(data), torch.arange(257), 1)
    with pytest.raises(TypeError):
        P.calc_indices(data.tolist(), cents, 1)
