"""The port stands alone: no module of ``aom_av1_psy_tpu_torch`` and not
``chip_smoke.py`` imports jax, the reference package ``aom_av1_psy_tpu``
(or a submodule) or ``bench``; a fresh interpreter that encodes a KEY
frame, a 3-frame GOP, a tune_vmaf frame, a 4-frame ARF GOP and a 2-frame
GOP of the host inter encoder (with a metric on its residual), and runs the analysis pipeline
and palette assignment and the mesh (a 2-tile frame, the sharded analysis
step) through the port, and decodes a loop-restoration
and a superres stream, has loaded none of them (one interpreter, a case
per stage); every module of the reference has a same-named counterpart in
the port (``ops/cdef_jax.py`` and ``ops/deblock_jax.py``: ``*_torch.py``),
and every public top-level function or class of a reference module has
one in its counterpart, of the same name or of the name the rename table
gives with its reason; the inter plan takes no private name of the intra
plan (their shared inputs live in ``encoder/plan_inputs.py``); the port's
test content
equals ``bench``'s; its own range coder build lives beside the reference's
in one process; and ``convert`` carries the reference's objects into the
port's classes.
Tolerance: exact equality."""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
from aom_av1_psy_tpu.ec.context import FrameContext
from aom_av1_psy_tpu.ec.native_coder import NativeEncoder as RefEncoder
from aom_av1_psy_tpu.encoder.frame import EncoderConfig, FrameEncoder
from aom_av1_psy_tpu.native import get_lib as ref_lib
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.ec.native_coder import NativeEncoder
from aom_av1_psy_tpu_torch.native import LIB_PATH, get_lib
from aom_av1_psy_tpu_torch.utils import testframes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "aom_av1_psy_tpu_torch")
FORBIDDEN = ("jax", "aom_av1_psy_tpu", "bench")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tests", "test_torch_mesh_gpu.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    """Top-level names of every absolute import in the file."""
    names = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n.split(".")[0] for n in names]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_reference_or_bench(path):
    bad = [n for n in _imported(path) if n in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


# one fresh interpreter encodes through the port alone: after each stage it
# prints the stage, its bytes and the loaded modules of jax, the reference
# package and bench (a KEY frame with flat chroma, a 3-frame GOP, a
# tune_vmaf frame, an ARF GOP with its temporal filters, the host inter
# encoder's GOP and the satd of its residual, the analysis of a plane and
# the batched step on its blocks, k-means and calc_indices on a block, a
# 2-tile KEY frame and the analysis step sharded over a mesh of two)
_STAGES = ("key", "gop", "tune_vmaf", "arf", "interframe", "analyze",
           "mesh", "decode")
_ENCODES = """
import dataclasses, json, sys
import numpy as np
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (encode_video,
                                                          encode_video_arf)
from aom_av1_psy_tpu_torch.utils.frame import Frame
from aom_av1_psy_tpu_torch.utils.testframes import make_frame, make_gop

def report(stage, n):
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "aom_av1_psy_tpu", "bench"))
    print(json.dumps([stage, n, bad]), flush=True)

y = np.random.default_rng(0).integers(0, 256, (64, 96)).astype(np.uint8)
u = np.full((32, 48), 120, np.uint8)
report("key", len(GpuFrameEncoder(Frame(y, u, u.copy()), EncoderConfig(90),
                                  device="cpu").encode()))
pk, _ = encode_video(make_gop(64, 64, 3), EncoderConfig(base_q_idx=150),
                     device="cpu")
report("gop", sum(map(len, pk)))
enc = GpuFrameEncoder(make_frame(96, 64, seed=3),
                      EncoderConfig(base_q_idx=120, tune_vmaf=True),
                      device="cpu")
n = len(enc.encode())
report("tune_vmaf", n if enc.vmaf_unsharp_amount > 0 else 0)
pk, encs = encode_video_arf(make_gop(64, 64, 4), EncoderConfig(base_q_idx=150),
                            group=3, device="cpu")
report("arf", sum(map(len, pk)) if encs[-1] is None and encs[1].tf_s
       else 0)
import torch
from aom_av1_psy_tpu_torch.encoder import interframe
from aom_av1_psy_tpu_torch.ops import metrics
from aom_av1_psy_tpu_torch.utils.testframes import panning_frames
pk, rec = interframe.encode_video(panning_frames(64, 64, 2),
                                  EncoderConfig(base_q_idx=100), device="cpu")
src = torch.as_tensor(panning_frames(64, 64, 2)[1].y.astype(np.int32))
res = src - torch.as_tensor(rec[1][0][:64, :64])
report("interframe", sum(map(len, pk))
       if int(metrics.satd(res.reshape(8, 8, 8, 8).transpose(1, 2)).sum())
       else 0)
from aom_av1_psy_tpu_torch.normative import tables
from aom_av1_psy_tpu_torch.ops import analyze, palette
from aom_av1_psy_tpu_torch.parallel.mesh import batched_analyze_step
plane = torch.as_tensor(y)
out = analyze.analyze_plane(plane, tables.dc_quant(100),
                            tables.ac_quant(100), n=16, device="cpu")
step = batched_analyze_step(16, 100, device="cpu")(
    analyze.blockify(plane, 16), *analyze._edges_from_source(plane, 16))
cents, idx, total = palette.k_means(y[:64, :64], 8, 1)
idx2, total2 = palette.calc_indices(plane[:64, :64], torch.as_tensor(cents),
                                    1)
report("analyze", int(step[4])
       if torch.equal(step[2], out["eob"]) and total2 == total
       and np.array_equal(idx2.numpy(), idx) else 0)
from aom_av1_psy_tpu_torch.parallel.mesh import (make_mesh,
                                                 sharded_analyze_step)
enc = GpuFrameEncoder(make_frame(128, 64, seed=4),
                      EncoderConfig(base_q_idx=90, tile_cols_log2=1),
                      device="cpu")
enc.mesh = make_mesh(2, device="cpu")
n = len(enc.encode())
step2 = sharded_analyze_step(make_mesh(2, device="cpu"), 16, 100)(
    analyze.blockify(plane, 16), *analyze._edges_from_source(plane, 16))
report("mesh", n if torch.equal(step2[2], out["eob"]) else 0)
from aom_av1_psy_tpu_torch.decoder.obu import decode_ivf
report("decode", sum(len(decode_ivf(f"tests/golden/streams/{n}.ivf"))
                     for n in ("lr_sgr_cpu2_q140_64x64",
                               "superres16_178x130")))
"""


def _modules(pkg):
    root = os.path.join(REPO, pkg)
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".py"))


# the JAX package's two modules whose port counterparts bear another name
_RENAMED = {"ops/cdef_jax.py": "ops/cdef_torch.py",
            "ops/deblock_jax.py": "ops/deblock_torch.py"}


@pytest.mark.parametrize("module", _modules("aom_av1_psy_tpu"))
def test_every_reference_module_has_its_counterpart(module):
    assert os.path.isfile(os.path.join(PORT, _RENAMED.get(module, module)))


# public names of a reference module whose counterpart bears another name
# or lives in another port module: (module, name) -> (port module, port
# name, why)
_NAME_RENAMES = {
    ("encoder/tpu_frame.py", "TpuFrameEncoder"): (
        "encoder/tpu_frame.py", "GpuFrameEncoder", "the device is a GPU"),
    ("encoder/tpu_frame.py", "encode_ivf_tpu"): (
        "encoder/tpu_frame.py", "encode_ivf", "the device is a GPU"),
    ("encoder/tpu_interframe.py", "TpuInterFrameEncoder"): (
        "encoder/tpu_interframe.py", "GpuInterFrameEncoder",
        "the device is a GPU"),
    **{("encoder/tpu_interframe.py", f"encode_video_tpu{s}"): (
        "encoder/tpu_interframe.py", f"encode_video{s}",
        "the device is a GPU") for s in ("", "_arf", "_cbr", "_rc")},
    ("encoder/temporal_filter.py", "apply_temporal_filter"): (
        "encoder/temporal_filter.py", "tf_span_filter",
        "kernel KK's span pass weights and accumulates every frame of a "
        "span in one launch"),
}


def _public_defs(path):
    """Public top-level functions and classes defined in the file."""
    tree = ast.parse(open(path).read(), path)
    return sorted(n.name for n in tree.body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                  and not n.name.startswith("_"))


def _bound_names(path):
    """Every name bound at the file's top level (definitions, assignments
    and imports)."""
    out = set()
    for n in ast.parse(open(path).read(), path).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in n.names}
    return out


@pytest.mark.parametrize("module", _modules("aom_av1_psy_tpu"))
def test_every_public_reference_name_has_its_counterpart(module):
    missing = []
    for name in _public_defs(os.path.join(REPO, "aom_av1_psy_tpu", module)):
        where, port_name, _ = _NAME_RENAMES.get(
            (module, name), (_RENAMED.get(module, module), name, ""))
        if port_name not in _bound_names(os.path.join(PORT, where)):
            missing.append(f"{name} -> {where}:{port_name}")
    assert not missing, f"{module}: no counterpart for {missing}"


# parameters a counterpart may add after the reference's besides a
# trailing ``device`` / ``generator``: (module, name, method) -> (names,
# why); and the public names whose counterpart is another function
_EXTRA_PARAMS = {
    ("encoder/tune_vmaf.py", "gaussian_blur", ""): (
        ("moments",), "kernel KG also returns the box moments KI reads"),
}
_OTHER_FUNCTION = {("encoder/temporal_filter.py", "apply_temporal_filter")}
_TAIL = ("device", "generator")


def _params(fn):
    a = fn.args
    out = [x.arg for x in a.posonlyargs + a.args]
    out += [f"*{a.vararg.arg}"] if a.vararg else []
    out += [x.arg for x in a.kwonlyargs]
    return out + ([f"**{a.kwarg.arg}"] if a.kwarg else [])


def _signatures(path):
    """name -> {method ("" for a function) -> parameter names} of every
    public top-level function and class (its public methods and
    ``__init__``) defined in the file."""
    out = {}
    for n in ast.parse(open(path).read(), path).body:
        if isinstance(n, ast.FunctionDef):
            out[n.name] = {"": _params(n)}
        elif isinstance(n, ast.ClassDef):
            out[n.name] = {m.name: _params(m) for m in n.body
                           if isinstance(m, ast.FunctionDef)
                           and (m.name == "__init__"
                                or not m.name.startswith("_"))}
    return out


@pytest.mark.parametrize("module", _modules("aom_av1_psy_tpu"))
def test_every_counterpart_takes_the_reference_parameters(module):
    """Every public function and method of a reference module takes, in
    its port counterpart, the reference's parameter names in order; only
    a trailing ``device`` / ``generator`` (or an ``_EXTRA_PARAMS`` entry)
    may follow them."""
    ref = _signatures(os.path.join(REPO, "aom_av1_psy_tpu", module))
    wrong = []
    for name, methods in ref.items():
        if name.startswith("_") or (module, name) in _OTHER_FUNCTION:
            continue
        where, port_name, _ = _NAME_RENAMES.get(
            (module, name), (_RENAMED.get(module, module), name, ""))
        port = _signatures(os.path.join(PORT, where)).get(port_name)
        if port is None:
            continue                # bound otherwise: the test above
        for m, want in methods.items():
            got = port.get(m)
            if got is None:
                continue            # inherited in the port
            extra = _EXTRA_PARAMS.get((module, name, m), ((), ""))[0]
            tail = got[len(want):]
            while tail and tail[-1] in _TAIL:
                tail = tail[:-1]
            if got[:len(want)] != want or tuple(tail) != extra:
                wrong.append(f"{name}.{m or '()'}: {want} -> {got}")
    assert not wrong, f"{module}: {wrong}"


@pytest.mark.parametrize("key", sorted(_EXTRA_PARAMS),
                         ids=lambda k: f"{k[0]}:{k[1]}")
def test_every_extra_parameter_is_the_ports(key):
    module, name, method = key
    got = _signatures(os.path.join(PORT, module))[name][method]
    want = _signatures(os.path.join(REPO, "aom_av1_psy_tpu",
                                    module))[name][method]
    assert all(p not in want for p in _EXTRA_PARAMS[key][0])
    assert set(_EXTRA_PARAMS[key][0]) <= set(got) and _EXTRA_PARAMS[key][1]


@pytest.mark.parametrize("key", sorted(_NAME_RENAMES),
                         ids=lambda k: f"{k[0]}:{k[1]}")
def test_every_rename_names_a_reference_name(key):
    module, name = key
    assert name in _public_defs(os.path.join(REPO, "aom_av1_psy_tpu",
                                             module))
    assert _NAME_RENAMES[key][2]


def test_inter_plan_takes_no_private_name_of_the_intra_plan():
    """``encoder/tpu_inter.py`` takes the plans' shared inputs and their
    fetch from ``encoder/plan_inputs.py``: it imports no ``_``-prefixed
    name from ``encoder/tpu_intra.py`` and reads none off that module."""
    path = os.path.join(PORT, "encoder", "tpu_inter.py")
    tree = ast.parse(open(path).read(), path)
    aliases, bad = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[-1] == "tpu_intra":
                bad += [a.name for a in node.names if a.name.startswith("_")]
            aliases |= {a.asname or a.name for a in node.names
                        if a.name == "tpu_intra"}
        elif isinstance(node, ast.Import):
            aliases |= {a.asname for a in node.names
                        if a.name.endswith(".tpu_intra") and a.asname}
    bad += [n.attr for n in ast.walk(tree)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id in aliases and n.attr.startswith("_")]
    assert not bad, f"tpu_inter takes {bad} from tpu_intra"


@pytest.fixture(scope="module")
def port_alone():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _ENCODES], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return {stage: (n, bad) for stage, n, bad in
            map(json.loads, r.stdout.splitlines())}


@pytest.mark.parametrize("stage", _STAGES)
def test_port_encodes_without_loading_the_reference(port_alone, stage):
    n, bad = port_alone[stage]
    assert n > 0
    assert bad == []


@pytest.mark.parametrize("w,h", [(96, 64), (352, 288)])
def test_test_frames_equal_bench(w, h):
    for got, want in zip([testframes.make_frame(w, h, seed=5)]
                         + testframes.make_gop(w, h, 3),
                         [bench.make_frame(w, h, seed=5)]
                         + bench.make_gop(w, h, 3)):
        assert type(got).__module__ == "aom_av1_psy_tpu_torch.utils.frame"
        for a, b in zip(got.planes(), want.planes(), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_two_range_coder_builds_in_one_process():
    """The port's ``ec.cpp`` build and the reference's both loaded
    (``RTLD_LOCAL``): separate libraries, and the same bytes from the same
    symbols."""
    lib, rlib = get_lib(), ref_lib()
    assert lib is not None and rlib is not None
    assert os.path.realpath(lib._name) == os.path.realpath(LIB_PATH)
    assert os.path.realpath(lib._name) != os.path.realpath(rlib._name)
    assert lib._handle != rlib._handle
    rng = np.random.default_rng(0)
    syms = rng.integers(0, 4, 500)
    outs = []
    for cls in (NativeEncoder, RefEncoder):
        cdf = np.array([24000, 16000, 8000, 0, 0], np.uint16)
        e = cls()
        for s in syms:
            e.encode_symbol(int(s), cdf, 4)
        outs.append((e.done(), cdf.tolist()))
    assert outs[0] == outs[1]


def test_convert_gives_the_port_its_own_objects():
    cfg = EncoderConfig(base_q_idx=77, tune_vmaf=True, tile_cols_log2=1)
    pc = convert.from_jax(cfg)
    assert type(pc).__module__ == "aom_av1_psy_tpu_torch.encoder.frame"
    assert dataclasses.asdict(pc) == dataclasses.asdict(cfg)
    f = bench.make_frame(64, 64)
    pf = convert.from_jax(f)
    assert type(pf).__module__ == "aom_av1_psy_tpu_torch.utils.frame"
    for a, b in zip(pf.planes(), f.planes(), strict=True):
        assert a is not b
        np.testing.assert_array_equal(a, b)
    enc = FrameEncoder(f, EncoderConfig(base_q_idx=90))
    enc.encode()
    seq = convert.from_jax(enc.seq)
    assert type(seq).__module__ == "aom_av1_psy_tpu_torch.bitstream.headers"
    assert dataclasses.asdict(seq) == dataclasses.asdict(enc.seq)
    fc = FrameContext(90)
    pfc = convert.from_jax(fc)
    assert type(pfc).__module__ == "aom_av1_psy_tpu_torch.ec.context"
    for k, v in vars(fc).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(pfc, k), v, err_msg=k)


def test_device_encoders_raise_without_the_range_coder(monkeypatch):
    """Without the native range coder (no toolchain to build it) the device
    encoders raise, as the reference's do: nothing falls back to the
    Python coder on the encoder path."""
    from aom_av1_psy_tpu_torch.ec import native_coder
    from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig as PortCfg
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import \
        GpuInterFrameEncoder
    monkeypatch.setattr(native_coder, "get_lib", lambda: None)
    f, cfg = testframes.make_frame(64, 64), PortCfg()
    with pytest.raises(RuntimeError, match="native EC library"):
        GpuFrameEncoder(f, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="native EC library"):
        GpuInterFrameEncoder(f, cfg, None, [], 64, 64, device="cpu")
