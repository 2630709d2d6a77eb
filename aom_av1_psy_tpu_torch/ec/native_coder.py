"""ctypes wrappers over the native range coder — drop-in replacements for
ec.coder.Encoder/Decoder. CDF arrays (numpy uint16 rows) are adapted in
place by the native code, so entropy state stays shared with Python."""
from __future__ import annotations

import ctypes

import numpy as np

from ..native import get_lib


def available() -> bool:
    return get_lib() is not None


def _ptr(arr: np.ndarray):
    return ctypes.c_void_p(arr.ctypes.data)


class NativeEncoder:
    def __init__(self) -> None:
        self._lib = get_lib()
        self._h = ctypes.c_void_p(self._lib.ec_enc_new())
        self._allow = True

    @property
    def allow_update(self) -> bool:
        return self._allow

    @allow_update.setter
    def allow_update(self, v: bool) -> None:
        self._allow = bool(v)
        self._lib.ec_enc_set_allow_update(self._h, int(v))

    def encode_symbol(self, s, icdf, nsyms, allow_update=None):
        if allow_update is None or allow_update == self._allow:
            self._lib.ec_enc_symbol(self._h, int(s), _ptr(icdf), int(nsyms))
        else:
            self._lib.ec_enc_cdf(self._h, int(s), _ptr(icdf), int(nsyms))
            if allow_update:
                from .coder import update_cdf
                update_cdf(icdf, int(s), int(nsyms))

    def encode_cdf(self, s, icdf, nsyms):
        icdf = np.ascontiguousarray(icdf, np.uint16)
        self._lib.ec_enc_cdf(self._h, int(s), _ptr(icdf), int(nsyms))

    def write_bit(self, bit):
        self._lib.ec_enc_bit(self._h, int(bit))

    def write_literal(self, data, bits):
        self._lib.ec_enc_literal(self._h, int(data), int(bits))

    def tell(self):
        return int(self._lib.ec_enc_tell(self._h))

    def done(self) -> bytes:
        n = self._lib.ec_enc_done(self._h)
        out = (ctypes.c_uint8 * n)()
        self._lib.ec_enc_copy(self._h, out)
        return bytes(out)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib:
            self._lib.ec_enc_free(self._h)
            self._h = None


class NativeDecoder:
    def __init__(self, data: bytes) -> None:
        self._lib = get_lib()
        self._data = bytes(data)  # keep alive
        self._h = ctypes.c_void_p(
            self._lib.ec_dec_new(self._data, len(self._data)))
        self._allow = True

    @property
    def allow_update(self) -> bool:
        return self._allow

    @allow_update.setter
    def allow_update(self, v: bool) -> None:
        self._allow = bool(v)
        self._lib.ec_dec_set_allow_update(self._h, int(v))

    def decode_symbol(self, icdf, nsyms, allow_update=None):
        if allow_update is None or allow_update == self._allow:
            return int(self._lib.ec_dec_symbol(self._h, _ptr(icdf),
                                               int(nsyms)))
        ret = int(self._lib.ec_dec_cdf(self._h, _ptr(icdf), int(nsyms)))
        if allow_update:
            from .coder import update_cdf
            update_cdf(icdf, ret, int(nsyms))
        return ret

    def decode_cdf(self, icdf, nsyms):
        icdf = np.ascontiguousarray(icdf, np.uint16)
        return int(self._lib.ec_dec_cdf(self._h, _ptr(icdf), int(nsyms)))

    def read_bit(self):
        return int(self._lib.ec_dec_bit(self._h))

    def read_literal(self, bits):
        return int(self._lib.ec_dec_literal(self._h, int(bits)))

    def tell(self):
        return int(self._lib.ec_dec_tell(self._h))

    def __del__(self):
        if getattr(self, "_h", None) and self._lib:
            self._lib.ec_dec_free(self._h)
            self._h = None


def _force_python() -> bool:
    import os
    return bool(os.environ.get("AOMTPU_NO_NATIVE"))


def make_encoder():
    """Best-available encoder (native if the toolchain built it)."""
    if available() and not _force_python():
        return NativeEncoder()
    from .coder import Encoder
    return Encoder()


def make_decoder(data: bytes):
    if available() and not _force_python():
        return NativeDecoder(data)
    from .coder import Decoder
    return Decoder(data)


def native_coeff_loop(enc: "NativeEncoder", coeff_flat: np.ndarray,
                      width: int, height: int, bhl: int, eob: int,
                      scan: np.ndarray, tx_class: int, nz_off,
                      base_eob_cdf: np.ndarray, base_cdf: np.ndarray,
                      br_cdf: np.ndarray, dc_sign_cdf: np.ndarray) -> int:
    """Drive ec_enc_coeffs: the base/br/sign/golomb loops of one txb in a
    single native call. CDF blocks are (n_ctx, nsyms+1) contiguous uint16
    arrays adapted in place. Returns cul_level."""
    lib = enc._lib
    coeff32 = np.ascontiguousarray(coeff_flat, np.int32)
    scan32 = np.ascontiguousarray(scan, np.int32)
    if nz_off is None:
        nz32 = np.zeros(1, np.int32)
    else:
        nz32 = np.ascontiguousarray(nz_off, np.int32)
    assert base_eob_cdf.flags["C_CONTIGUOUS"] and base_cdf.flags["C_CONTIGUOUS"]
    assert br_cdf.flags["C_CONTIGUOUS"] and dc_sign_cdf.flags["C_CONTIGUOUS"]
    return int(lib.ec_enc_coeffs(
        enc._h, _ptr(coeff32), int(width), int(height), int(bhl), int(eob),
        _ptr(scan32), int(tx_class), _ptr(nz32), _ptr(base_eob_cdf),
        int(base_eob_cdf.shape[-1]), _ptr(base_cdf),
        int(base_cdf.shape[-1]), _ptr(br_cdf), int(br_cdf.shape[-1]),
        _ptr(dc_sign_cdf)))


class KfPackParams(ctypes.Structure):
    """ctypes mirror of KfPackParams in native/ec.cpp (field order must
    match exactly; all members are 8 bytes so there is no padding)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "y_mode", "uv_mode", "skip", "y_levels", "y_eob", "uv_levels",
            "uv_eob", "y_scan", "uv_scan", "y_nzoff", "uv_nzoff",
            "eob_group_start", "eob_offset_bits", "intra_mode_ctx",
            "part_cdf", "skip_cdf", "kf_y_cdf", "angle_cdf", "uv_cdf",
            "ext_tx_cdf", "y_txb_skip", "uv_txb_skip", "y_eob_cdf",
            "uv_eob_cdf", "y_eob_extra", "uv_eob_extra", "y_base_eob",
            "uv_base_eob", "y_base", "uv_base", "y_br", "uv_br",
            "y_dc_sign", "uv_dc_sign")]
        + [(n, ctypes.c_int64) for n in (
            "R", "C", "bs", "mi_rows", "mi_cols", "nplanes",
            "y_eob_nsyms", "uv_eob_nsyms", "tx_type_nsyms", "tx_type_sym",
            "block_bsize", "part_ctx_above", "part_ctx_left")]
    )


def native_pack_kf_uniform(enc: "NativeEncoder", arrays: dict,
                           scalars: dict) -> None:
    """Pack a whole uniform-grid KEY-frame tile in one native call.

    ``arrays`` maps pointer-field names to numpy arrays (kept alive by the
    caller; CDF arrays are adapted in place), ``scalars`` the int64 fields.
    """
    p = KfPackParams()
    for name, arr in arrays.items():
        setattr(p, name, ctypes.c_void_p(arr.ctypes.data)
                if arr is not None else None)
    for name, v in scalars.items():
        setattr(p, name, int(v))
    rc = enc._lib.ec_enc_pack_kf_uniform(enc._h, ctypes.byref(p))
    if rc != 0:
        raise RuntimeError(f"native kf pack failed: {rc}")


def native_coeff_read(dec: "NativeDecoder", width: int, height: int,
                      bhl: int, eob: int, scan: np.ndarray, tx_class: int,
                      nz_off, base_eob_cdf: np.ndarray, base_cdf: np.ndarray,
                      br_cdf: np.ndarray, dc_sign_cdf: np.ndarray):
    """Drive ec_dec_coeffs. Returns (coeff int32 (w*h), cul_level)."""
    lib = dec._lib
    coeff = np.zeros(width * height, np.int32)
    scan32 = np.ascontiguousarray(scan, np.int32)
    nz32 = (np.zeros(1, np.int32) if nz_off is None
            else np.ascontiguousarray(nz_off, np.int32))
    cul = int(lib.ec_dec_coeffs(
        dec._h, _ptr(coeff), int(width), int(height), int(bhl), int(eob),
        _ptr(scan32), int(tx_class), _ptr(nz32), _ptr(base_eob_cdf),
        int(base_eob_cdf.shape[-1]), _ptr(base_cdf),
        int(base_cdf.shape[-1]), _ptr(br_cdf), int(br_cdf.shape[-1]),
        _ptr(dc_sign_cdf)))
    return coeff, cul


_P2_PTRS = (
    "split32", "y_mode32", "y_mode16", "y_lv32", "y_lv16", "y_eob32",
    "y_eob16", "uv_mode16", "uv_mode8", "uv_lv16", "uv_lv8", "uv_eob16",
    "uv_eob8", "scan32", "scan16", "scan8", "nzoff32", "nzoff16", "nzoff8",
    "eob_group_start", "eob_offset_bits", "intra_mode_ctx",
    "part_cdf", "skip_cdf", "kf_y_cdf", "angle_cdf", "uv_cdf", "ext_tx16",
    "txb_skip_y32", "txb_skip_y16", "txb_skip_uv16", "txb_skip_uv8",
    "eob_y32", "eob_y16", "eob_uv16", "eob_uv8",
    "eobex_y32", "eobex_y16", "eobex_uv16", "eobex_uv8",
    "beob_y32", "beob_y16", "beob_uv16", "beob_uv8",
    "base_y32", "base_y16", "base_uv16", "base_uv8",
    "br_y32", "br_y16", "br_uv16", "br_uv8", "dcs_y", "dcs_uv",
    "y_delta32", "y_delta16",
)
_P2_INTS = (
    "R", "C", "mi_rows", "mi_cols", "nplanes",
    "eobn_y32", "eobn_y16", "eobn_uv16", "eobn_uv8",
    "txt16_nsyms", "txt16_sym",
    "pctx_a32", "pctx_l32", "pctx_a16", "pctx_l16",
    "mi_col_off", "mi_cols_frame",
)


class Pack2Params(ctypes.Structure):
    """ctypes mirror of Pack2Params in native/ec.cpp (all members 8 bytes,
    order must match exactly)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _P2_PTRS]
                + [(n, ctypes.c_int64) for n in _P2_INTS])


def native_pack_kf_part2(enc: "NativeEncoder", arrays: dict,
                         scalars: dict) -> None:
    """Pack a whole two-level-partition KEY-frame tile in one native call.
    Arrays must stay alive for the duration (caller keeps references);
    CDF arrays are adapted in place."""
    p = Pack2Params()
    for name in _P2_PTRS:
        arr = arrays[name]
        setattr(p, name, ctypes.c_void_p(arr.ctypes.data)
                if arr is not None else None)
    for name in _P2_INTS:
        setattr(p, name, int(scalars[name]))
    rc = enc._lib.ec_enc_pack_kf_part2(enc._h, ctypes.byref(p))
    if rc != 0:
        raise RuntimeError(f"native part2 pack failed: {rc}")


class ScriptBundle(ctypes.Structure):
    """ctypes mirror of ScriptBundle in native/ec.cpp."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "txb_skip", "eob", "eobex", "beob", "base", "br", "dcs",
            "scan", "nzoff")]
        + [(n, ctypes.c_int64) for n in ("eob_nsyms", "width", "bhl", "n")]
        + [("ext_tx", ctypes.c_void_p)]
        + [(n, ctypes.c_int64) for n in ("ext_nsyms", "ext_sym",
                                         "ext_stride")]
    )


def make_bundle(txb_skip, eob, eobex, beob, base, br, dcs, scan, nzoff,
                eob_nsyms, width, ext_tx=None, ext_nsyms=0, ext_sym=0,
                ext_stride=0):
    b = ScriptBundle()
    b._keep = [txb_skip, eob, eobex, beob, base, br, dcs, scan, nzoff,
               ext_tx]  # pointers outlive any caller temporaries
    for name, arr in (("txb_skip", txb_skip), ("eob", eob), ("eobex", eobex),
                      ("beob", beob), ("base", base), ("br", br),
                      ("dcs", dcs), ("scan", scan), ("nzoff", nzoff)):
        assert arr.flags["C_CONTIGUOUS"], name
        setattr(b, name, ctypes.c_void_p(arr.ctypes.data))
    b.eob_nsyms = int(eob_nsyms)
    b.width = int(width)
    b.bhl = int(width).bit_length() - 1
    b.n = int(width) * int(width)
    if ext_tx is not None:
        assert ext_tx.flags["C_CONTIGUOUS"]
        b.ext_tx = ctypes.c_void_p(ext_tx.ctypes.data)
        b.ext_nsyms = int(ext_nsyms)
        b.ext_sym = int(ext_sym)
        b.ext_stride = int(ext_stride)
    return b


def native_run_script(enc: "NativeEncoder", ops: np.ndarray,
                      cdf_tables: list, bundles: list,
                      levels_base: np.ndarray, eob_group_start: np.ndarray,
                      eob_offset_bits: np.ndarray) -> None:
    """Execute a symbol script (see native/ec.cpp ec_enc_run_script).

    ops: (N, 5) int32. cdf_tables: list of 2-D uint16 arrays (adapted in
    place; cdf_id = list index, row stride = trailing dim). bundles: list
    of ScriptBundle. levels_base: int32 flat coefficient store indexed by
    op2's levels_index * bundle.n. Caller keeps every array alive."""
    lib = enc._lib
    ops = np.ascontiguousarray(ops, np.int32)
    assert ops.ndim == 2 and ops.shape[1] == 5
    n = len(cdf_tables)
    ptrs = (ctypes.c_void_p * n)()
    strides = np.empty(n, np.int64)
    for i, t in enumerate(cdf_tables):
        assert t.dtype == np.uint16 and t.flags["C_CONTIGUOUS"], i
        ptrs[i] = t.ctypes.data
        strides[i] = t.shape[-1]
    barr = (ScriptBundle * len(bundles))(*bundles)
    lv = np.ascontiguousarray(levels_base, np.int32)
    egs = np.ascontiguousarray(eob_group_start, np.int32)
    eob_bits = np.ascontiguousarray(eob_offset_bits, np.int32)
    rc = lib.ec_enc_run_script(
        enc._h, _ptr(ops), len(ops), ptrs, _ptr(strides), barr, _ptr(lv),
        _ptr(egs), _ptr(eob_bits))
    if rc != 0:
        raise RuntimeError(f"script failed: {rc}")


_W_PTRS = ("split32", "mv8", "skip32", "skip16", "y_eob32", "y_eob16",
           "uv_eob16", "uv_eob8", "cul_y32", "cul_y16", "cul_u16", "cul_v16",
           "cul_u8", "cul_v8", "roff", "ops")
_W_INTS = ("Rc", "Cc", "mi_rows", "mi_cols", "nplanes", "cap",
           "pctx_a32", "pctx_l32", "pctx_a16", "pctx_l16", "blocks")
# the most ops of one 16x16 block: 8 mode and reference symbols, two MV
# components of 13 each, three transform blocks, and its partition symbol
_OPS_PER_BLOCK = 38


class InterWalkParams(ctypes.Structure):
    """ctypes mirror of InterWalkParams in native/ec.cpp (all members 8
    bytes, order must match exactly)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _W_PTRS]
                + [(n, ctypes.c_int64) for n in _W_INTS])


def native_inter_script_walk(inputs: dict, mi_rows: int, mi_cols: int,
                             nplanes: int, pctx) -> tuple:
    """The P-frame script's ops in one native call (ec_inter_script_walk).

    ``inputs``: ``tpu_interframe.script_inputs``' arrays (uint8 split and
    skip flags, int32 MVs, eobs and culs, the int64 region offsets
    ``roff``); the chroma arrays are absent where ``nplanes`` is 1.
    ``pctx``: PARTITION_CTX_ABOVE / _LEFT of 32x32 and of 16x16. Returns
    (ops (N, 5) int32, blocks walked)."""
    Rc, Cc = inputs["split32"].shape
    # every block a 16x16 at most, every node coding a partition symbol
    cap = _OPS_PER_BLOCK * 4 * Rc * Cc + Rc * Cc + (Rc + 1) * (Cc + 1)
    ops = np.empty((cap, 5), np.int32)
    want = {"split32": np.uint8, "skip32": np.uint8, "skip16": np.uint8,
            "roff": np.int64}
    p = InterWalkParams()
    keep = []
    for name in _W_PTRS[:-1]:
        arr = inputs.get(name)
        if arr is None:
            if nplanes > 1:
                raise ValueError(f"the walk needs {name}")
            continue
        arr = np.ascontiguousarray(arr, want.get(name, np.int32))
        keep.append(arr)
        setattr(p, name, ctypes.c_void_p(arr.ctypes.data))
    p.ops = ctypes.c_void_p(ops.ctypes.data)
    for name, v in zip(_W_INTS, (Rc, Cc, mi_rows, mi_cols, nplanes, cap,
                                 *pctx, 0)):
        setattr(p, name, int(v))
    n = get_lib().ec_inter_script_walk(ctypes.byref(p))
    if n < 0:
        raise RuntimeError("native inter script walk failed: "
                           + ("ops past their bound" if n == -1
                              else "a read of a block not yet coded"))
    return ops[:n], int(p.blocks)
