"""The native (C++) range coder, ``native/ec.cpp``, with ctypes bindings
(``ec/native_coder.py``); the same file holds the KEY packs and the inter
frame's symbol walk.

``g++`` builds it into ``build/aom_av1_psy_tpu_torch/libnative_ec.so`` at
first use, and again when the source is newer, by the rule
``kernels/build.py`` follows for the ``.cu`` files (a per-process temporary
file, then an atomic rename, so concurrent first uses do not race).
``get_lib`` returns None when no toolchain is present: the host
``FrameEncoder`` and the decoder then use the pure-Python coder, and the
device encoders, which need the native packs, raise.

``ctypes.CDLL`` opens the library ``RTLD_LOCAL``, so its ``ec_*`` symbols
stay apart from any other library in the process that exports the same
names.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

from ..kernels.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ec.cpp")
LIB_PATH = os.path.join(BUILD_DIR, "libnative_ec.so")
_lib = None


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIB_PATH + f".{os.getpid()}.tmp"
    try:
        subprocess.check_call(
            ["g++", "-O2", "-shared", "-fPIC", _SRC, "-o", tmp],
            stderr=subprocess.DEVNULL)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, LIB_PATH)
    return True


def get_lib():
    """Load (building if needed) the native EC library, or None."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(LIB_PATH) or (
            os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.ec_enc_new.restype = ctypes.c_void_p
    lib.ec_dec_new.restype = ctypes.c_void_p
    lib.ec_dec_new.argtypes = [ctypes.c_char_p, ctypes.c_long]
    for name in ("ec_enc_free", "ec_enc_set_allow_update", "ec_enc_symbol",
                 "ec_enc_cdf", "ec_enc_bit", "ec_enc_literal", "ec_enc_copy",
                 "ec_dec_free", "ec_dec_set_allow_update"):
        getattr(lib, name).restype = None
    for name in ("ec_enc_done", "ec_enc_size", "ec_enc_tell", "ec_dec_tell"):
        getattr(lib, name).restype = ctypes.c_long
    for name in ("ec_dec_symbol", "ec_dec_cdf", "ec_dec_bit"):
        getattr(lib, name).restype = ctypes.c_int
    lib.ec_dec_literal.restype = ctypes.c_uint
    lib.ec_enc_pack_kf_uniform.restype = ctypes.c_int
    lib.ec_inter_script_walk.restype = ctypes.c_long
    lib.ec_inter_script_walk.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib
