"""The committed MV-rate proxy table (``aom_av1_psy_tpu_torch/encoder/
mv_rate_proxy.py``) against the jitted reference ``tpu_inter.
_mv_rate_proxy`` on the CPU: equal bit for bit at every (row, col) split,
both signs, of every s = |row| + |col| in 0..S_MAX. A regenerated table
(for instance from numpy's or torch's log2) fails here."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from aom_av1_psy_tpu.encoder import tpu_inter as JI
from aom_av1_psy_tpu_torch.encoder import tpu_inter as TI
from aom_av1_psy_tpu_torch.encoder.mv_rate_proxy import MV_RATE_PROXY, S_MAX
from torch_threads import one_torch_thread  # noqa: F401


def _splits():
    s = np.concatenate([np.full(k + 1, k) for k in range(S_MAX + 1)])
    r = np.concatenate([np.arange(k + 1) for k in range(S_MAX + 1)])
    return s, r, s - r


def test_table_equals_jitted_reference_at_every_split():
    assert MV_RATE_PROXY.dtype == np.float32
    assert MV_RATE_PROXY.shape == (S_MAX + 1,)
    s, r, c = _splits()
    sign = np.where(np.arange(len(s)) % 2 == 0, 1, -1)
    ref = jax.jit(JI._mv_rate_proxy)
    want = np.asarray(ref(jnp.asarray(r * sign, jnp.int32),
                          jnp.asarray(-c, jnp.int32)))
    np.testing.assert_array_equal(MV_RATE_PROXY[s].view(np.uint32),
                                  want.view(np.uint32))


def test_port_proxy_indexes_the_table_and_flags_overflow():
    s, r, c = _splits()
    proxy = TI._RateProxy("cpu")
    got = proxy(torch.as_tensor(-r, dtype=torch.int32),
                torch.as_tensor(c, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), MV_RATE_PROXY[s])
    assert not bool(proxy.over)
    proxy(torch.tensor([S_MAX], dtype=torch.int32),
          torch.tensor([1], dtype=torch.int32))
    assert bool(proxy.over)
    # the reachable bound: coarse +/-16 at half resolution, fine +/-16,
    # subpel +/-6, in 1/8 pel, on both components
    assert 2 * (8 * (2 * 16 + 16) + 6) <= S_MAX
