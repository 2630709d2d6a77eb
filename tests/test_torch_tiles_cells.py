"""Port parity of tile columns (see test_torch_tiles.py) on two more frame
shapes: 240x64 with two tiles, whose last tile has a visible mi width of
28 (= 4 mod 8, where the reference's top-right availability is computed
against the nominal tile width: the stream still decodes to the recon on
this frame), and 192x64, whose 3 SB columns do not split into 2 equal
tiles, so both packages code one tile. Tolerance: exact equality."""
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from test_multichip import _frame
from test_torch_encoder import assert_decodes_to_recon, encode_both
from test_torch_tiles import check_tiled


def test_tiled_240x64_partial_last_tile_matches_jax():
    enc = check_tiled(_frame(240, 64, seed=3),
                      EncoderConfig(base_q_idx=90, tile_cols_log2=1), 2)
    last = enc.mi_cols - (enc.tile_T - 1) * enc.tile_mi
    assert last == 28 and last % 8 == 4


def test_192x64_stays_single_tile_like_jax():
    ref, want, enc, got = encode_both(
        _frame(192, 64, seed=4), EncoderConfig(base_q_idx=90,
                                               tile_cols_log2=1))
    assert ref.tile_T == enc.tile_T == 1
    assert enc.fh.tiles.tile_cols == 1
    assert got == want
    assert_decodes_to_recon(got, enc)
