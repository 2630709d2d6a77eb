"""Port parity of a GOP whose KEY frame has tile columns:
``encode_video(device="cpu")`` with ``tile_cols_log2=1`` gives the
byte-identical packets of the JAX ``encode_video_tpu`` (a 2-tile KEY frame,
then single-tile P-frames on its stitched post-LPF, post-CDEF recon), and
every frame decodes to the port's reference chain. The 128x64 frames (two
1-SB tiles) hold one JAX compile of each plan. Tolerance: exact
equality."""
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from test_tpu_inter import panning
from test_torch_gop import assert_decodes_to_chain, assert_same_frames, \
    encode_both


def test_tiled_key_gop_matches_jax():
    frames = panning(128, 64, 3, seed=12)
    pj, ej, pt, et = encode_both(frames, EncoderConfig(base_q_idx=90,
                                                       tile_cols_log2=1))
    assert et[0].tile_T == ej[0].tile_T == 2
    assert et[1].fh.tiles.tile_cols == 1
    assert pt == pj
    assert_same_frames(ej, et)
    assert_decodes_to_chain(pt, et)
