"""State carried between the JAX reference and the port.

The encoder has no weights: its "parameters" are the tables derived from
the ``FrameContext`` and the normative data, plus the reference chain. Both
packages build the tables on the host as numpy, each from its own copy of
the host layers; these functions carry the reference's objects (configs,
frames, headers, entropy contexts) into the port's own classes and move
planes made by the JAX encoder onto the port's tensors, so a test can run
both packages on identical inputs and hand the port only the port's own
objects, and a later slice can start the port from a JAX-made reference.
"""
from __future__ import annotations

import enum
import functools
import importlib

import numpy as np
import torch

_REF = "aom_av1_psy_tpu."


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


def _port_class(cls):
    """The port's class of the same module path and name as the reference
    class ``cls``: ``aom_av1_psy_tpu.X.C`` -> ``aom_av1_psy_tpu_torch.X.C``."""
    mod = importlib.import_module("aom_av1_psy_tpu_torch."
                                  + cls.__module__[len(_REF):])
    return functools.reduce(getattr, cls.__qualname__.split("."), mod)


def _state(obj) -> dict:
    out = dict(getattr(obj, "__dict__", {}))
    for c in type(obj).__mro__:
        for k in getattr(c, "__slots__", ()):
            if hasattr(obj, k):
                out[k] = getattr(obj, k)
    return out


def _is_jax_mesh(obj) -> bool:
    cls = type(obj)
    return cls.__name__ == "Mesh" and cls.__module__.split(".")[0] == "jax"


def from_jax(obj, device=None):
    """A deep copy of a reference object (a header, a ``FrameContext``, an
    ``EncoderConfig``, a ``Frame``, ...) as the port's object of the same
    class: instances of reference classes become instances of the port's
    copies, attribute for attribute; numpy arrays are copied; lists, tuples
    and dicts are walked; anything else is kept. A reference device mesh
    (``jax.sharding.Mesh``) becomes the port's ``parallel.mesh.Mesh`` of as
    many entries of ``device`` (which the caller must name) along its first
    axis. Neither the reference package nor jax is imported: classes are
    matched by module path and name."""
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_jax(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: from_jax(v, device) for k, v in obj.items()}
    if _is_jax_mesh(obj):
        from .parallel.mesh import Mesh
        if device is None:
            raise ValueError("from_jax of a device mesh needs the device its "
                             "entries stand for")
        return Mesh([device] * obj.devices.size, axis=obj.axis_names[0])
    cls = type(obj)
    if not cls.__module__.startswith(_REF):
        return obj
    port = _port_class(cls)
    if isinstance(obj, enum.Enum):
        return port(obj.value)
    out = port.__new__(port)
    for k, v in _state(obj).items():
        setattr(out, k, from_jax(v, device))
    return out


def chain_from_jax(enc, device) -> dict:
    """The GOP state a JAX encoder (``TpuFrameEncoder`` or
    ``TpuInterFrameEncoder``) leaves behind, as the inputs of the port's
    ``GpuInterFrameEncoder``: ``seq`` and ``prev_fc`` (its counter-reset
    ``saved_fc``) as the port's objects (:func:`from_jax`), and
    ``ref_planes_dev`` (``ref_planes_out`` of an inter frame, else
    ``ref_planes_dev``; jax arrays are read with ``np.asarray``) as int32
    tensors on ``device``. Use as
    ``GpuInterFrameEncoder(frame, cfg, crop_w=..., crop_h=...,
    **chain_from_jax(enc, device), device=device)``."""
    planes = getattr(enc, "ref_planes_out", None)
    if planes is None:
        planes = enc.ref_planes_dev
    return {"seq": from_jax(enc.seq), "prev_fc": from_jax(enc.saved_fc),
            "ref_planes_dev": [plane(np.asarray(p), device)
                               for p in planes]}
