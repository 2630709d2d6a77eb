"""State carried between the JAX reference and the port.

The encoder has no weights: its "parameters" are the tables derived from
the ``FrameContext`` and the normative data, plus the reference chain. Both
packages build the tables on the host as numpy; these functions move them
(and planes made by the JAX encoder) onto the port's tensors, so a test can
run both packages on identical inputs and a later slice can start the port
from a JAX-made reference.
"""
from __future__ import annotations

import numpy as np
import torch


def plane(arr, device) -> torch.Tensor:
    """A 2-D integer plane (numpy or array-like) as an int32 tensor."""
    return torch.tensor(np.asarray(arr, np.int32), device=device)


def _tensor(v, device):
    a = np.asarray(v)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32), device=device)
    if a.dtype == np.float32:
        return torch.as_tensor(a, device=device)
    raise TypeError(f"unexpected table dtype {a.dtype}")


def inputs_from_numpy(d: dict, device) -> dict:
    """Plan inputs (``encoder.tpu_intra.part_inputs``: cost tables, rate
    tables, position masks, lambda grids, forced/no_split masks) as
    tensors on ``device``; Python scalars pass through unchanged."""
    out = {}
    for k, v in d.items():
        if isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, dict):
            out[k] = inputs_from_numpy(v, device)
        elif isinstance(v, tuple):
            out[k] = tuple(_tensor(x, device) for x in v)
        else:
            out[k] = _tensor(v, device)
    return out


def planes_from_jax(arrs: dict, device) -> dict:
    """The JAX encoder's plan dict, with ``recon_dev`` and
    ``ref_planes_dev`` given as numpy (``np.asarray`` of the jax arrays),
    turned into the port's: host arrays stay numpy, planes become int32
    tensors on ``device``."""
    out = dict(arrs)
    for k in ("recon_dev", "ref_planes_dev"):
        if k in out:
            out[k] = [plane(p, device) for p in out[k]]
    return out


def chain_from_jax(enc, device) -> dict:
    """The GOP state a JAX encoder (``TpuFrameEncoder`` or
    ``TpuInterFrameEncoder``) leaves behind, as the inputs of the port's
    ``GpuInterFrameEncoder``: ``seq``, ``prev_fc`` (its counter-reset
    ``saved_fc``) and ``ref_planes`` (``ref_planes_out`` of an inter frame,
    else ``ref_planes_dev``; jax arrays are read with ``np.asarray``) as
    int32 tensors on ``device``. Use as
    ``GpuInterFrameEncoder(frame, cfg, crop_w=..., crop_h=...,
    **chain_from_jax(enc, device), device=device)``."""
    planes = getattr(enc, "ref_planes_out", None)
    if planes is None:
        planes = enc.ref_planes_dev
    return {"seq": enc.seq, "prev_fc": enc.saved_fc,
            "ref_planes": [plane(np.asarray(p), device) for p in planes]}
