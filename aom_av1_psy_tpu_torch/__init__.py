"""aom_av1_psy_tpu_torch — the PyTorch + CUDA port of the fused encoder of
``aom_av1_psy_tpu``: the all-intra KEY frame (``encoder/tpu_frame.py``:
the two-level partition plan, tile columns batched on one GPU
(``parallel/mesh.py``), the uniform-grid fallback, the CDEF strength
search, ``tune_vmaf``) and the GOP encoders of
``encoder/tpu_interframe.py``: the IPPP GOP (``encode_video``), the ARF
star group (``encode_video_arf``) and the rate-controlled CBR and RC GOPs
(``encode_video_cbr``, ``encode_video_rc``), with the temporal filter of
the KEY frame and of each ARF on the device
(``encoder/temporal_filter.py``).

The JAX package stays the reference; this package mirrors its module paths
(``encoder/tpu_intra.py``, ``encoder/tpu_intra_dir.py``,
``encoder/tpu_frame.py``, ``encoder/tpu_inter.py``,
``encoder/tpu_interframe.py``, ``ops/txfm.py``, ``ops/deblock_torch.py``,
``ops/cdef_torch.py``, ``encoder/tune_vmaf.py``) so each counterpart is
easy to find. It imports ``torch`` and nothing of ``jax`` or of the
reference package: it has its own copies of the host layers, at the
reference's relative paths (``normative/`` with its data, ``bitstream/``,
``ec/``, ``native/ec.cpp`` — built with g++ into
``build/aom_av1_psy_tpu_torch/`` at first use —, ``decoder/``, ``utils/``,
``errors.py``, ``encoder/frame.py``, ``encoder/psy.py``, the numpy
``ops/`` modules; the host half of
the reference's ``ops/txfm.py`` is ``ops/txfm_host.py``), numpy only.
``convert.py`` carries the reference's objects into the port's classes.

Device work runs as plain torch ops plus eighteen hand-written CUDA
kernels (``csrc/``), each beside a plain PyTorch version of the same
function:

- KA ``intra_pred_sse`` (``ops/intra_pred.py``): all intra candidates of a
  block (edge buffer, plain + directional predictions) and their SSE;
- KB ``txq_recon_skip`` (``ops/txq.py``): forward transform, quantize,
  dequantize, inverse transform + recon and the skip-RD decision (or, as
  ``txq_recon``, no skip decision), 4x4 to 32x32; ``TxqStep``, the
  wavefronts' in-place entry over the same body, also reads the blocks
  where they lie, prices the partition paths, takes the split and writes
  the plan's maps;
- KC ``lpf_ladder`` (``ops/deblock_torch.py``): the loop-filter level
  ladder with an exact per-level SSE, one launch per plane: one CTA per
  tile of 4 x 4 cells whose origin sits half a cell before an edge (no
  halo), looping over the levels with the tile and the source in
  registers;
- KD ``mc_8tap`` (``ops/mc.py``): batched 8-tap motion compensation over a
  candidate axis, with per-block SAD / SSE;
- KE ``fullpel_ssd`` (``ops/fullpel.py``): the exhaustive +/-16 full-pel
  search with the reference's first-index ties, on KJ's strip engine
  (``csrc/strips.cuh``: strips of 12 offsets in registers, 8-bit words
  where the staged values allow);
- KF ``cdef_filter`` (``ops/cdef_torch.py``): the frame CDEF pass, one
  launch per frame: the normative direction search, the three planes
  and the A/B gate's exact squared errors, one CTA per 64 x 64 luma
  tile staged with its 2-px halo;
- KG ``gauss_blur``, KH ``unsharp_apply``, KI ``vif_scale`` / ``vif_down2``
  (``encoder/tune_vmaf.py``): the tune_vmaf blur (with exact moment sums),
  the unsharp mask and the VIF pyramid;
- KJ ``fullpel_sad`` (``ops/mvsearch.py``): the dense full-pel SAD search
  over the caller's windows (and the strided coarse level of
  ``full_pel_hierarchical``) or, through its plane entry
  (``full_pel_plane_search``, the temporal filter's), over windows read
  where they lie in a plane; first-index argmin; the strip engine of
  ``csrc/strips.cuh``, templated on the metric, shared with KE;
- KK ``tf_weight_accum`` (``encoder/temporal_filter.py``): the temporal
  filter's block-local 5x5 windowed error, float64 weight and int64
  accumulation over every block of a frame;
- KL-KQ (``ops/convolve.py``, ``ops/mvsearch.py``, ``ops/metrics.py``,
  ``ops/analyze.py``, ``ops/palette.py``; the README describes them) and
  KR (``ops/txfm.py``): the general 2-D transforms, every tx size and
  type forward and inverse at bd 8 / 10 / 12, and the lossless WHT pair.

A wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors; there is no fallback from one to the other.
"""

__version__ = "0.1.0"
