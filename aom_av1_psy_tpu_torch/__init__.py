"""aom_av1_psy_tpu_torch — the PyTorch + CUDA port of the fused encoder of
``aom_av1_psy_tpu``: the all-intra KEY frame (``encoder/tpu_frame.py``)
and the IPPP GOP (``encoder/tpu_interframe.encode_video``).

The JAX package stays the reference; this package mirrors its module paths
(``encoder/tpu_intra.py``, ``encoder/tpu_intra_dir.py``,
``encoder/tpu_frame.py``, ``encoder/tpu_inter.py``,
``encoder/tpu_interframe.py``, ``ops/txfm.py``, ``ops/deblock_torch.py``,
``ops/cdef_torch.py``) so each counterpart is easy to find. It imports
``torch`` and never ``jax``; the host layers it shares with the reference
(``normative/``, ``bitstream/``, ``ec/`` + the native range coder,
``decoder/``, ``utils/``, ``encoder/frame.py``, ``encoder/psy.py``,
``encoder/temporal_filter.py``, ``ops/cdef.py``, ``ops/convolve.py``, the
numpy constants of ``ops/txfm.py`` and ``ops/intra.py``) are JAX-free.

Device work runs as plain torch ops plus six hand-written CUDA kernels
(``csrc/``), each beside a plain PyTorch version of the same function:

- KA ``intra_pred_sse`` (``ops/intra_pred.py``): all intra candidates of a
  block (edge buffer, plain + directional predictions) and their SSE;
- KB ``txq_recon_skip`` (``ops/txq.py``): forward transform, quantize,
  dequantize, inverse transform + recon and the skip-RD decision;
- KC ``lpf_ladder`` (``ops/deblock_torch.py``): the loop-filter level
  ladder with an exact per-level SSE;
- KD ``mc_8tap`` (``ops/mc.py``): batched 8-tap motion compensation over a
  candidate axis, with per-block SAD / SSE;
- KE ``fullpel_ssd`` (``ops/fullpel.py``): the exhaustive +/-16 full-pel
  search with the reference's first-index ties;
- KF ``cdef_filter`` (``ops/cdef_torch.py``): the frame CDEF apply.

A wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors; there is no fallback from one to the other.
"""

__version__ = "0.1.0"
