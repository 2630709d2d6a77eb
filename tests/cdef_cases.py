"""Blocks on which CDEF's direction search is easy to get wrong: shared by
the CPU parity tests and the card's kernel tests (this module imports
neither jax nor the reference package)."""
import numpy as np

# the line of pixel (i, j) on each direction (cdef_find_dir_c's partial[])
LINES = [lambda i, j: i + j, lambda i, j: i + j // 2, lambda i, j: i,
         lambda i, j: 3 + i - j // 2, lambda i, j: 7 + i - j,
         lambda i, j: 3 - i // 2 + j, lambda i, j: j,
         lambda i, j: i // 2 + j]


def extreme_blocks():
    """(N, 8, 8) int32: constant 0 and 255 (all eight costs tie: direction
    0, var 0, the largest cost 64 * 128^2 * 840), 0 / 255 stripes along
    each direction's lines (and graded ones), 1- and 2-px checkerboards,
    and, last, 48 blocks symmetric about the diagonal (costs 1 = 7, 2 = 6,
    3 = 5 tie)."""
    ii, jj = np.mgrid[0:8, 0:8]
    out = [np.zeros((8, 8)), np.full((8, 8), 255)]
    for d in range(8):
        ln = LINES[d](ii, jj)
        out += [np.where(ln % 2, 255, 0), np.where(ln % 2, 0, 255),
                (ln * 17) % 256, 255 - (ln * 17) % 256]
    out += [np.where((ii + jj) % 2, 255, 0), np.where((ii + jj) % 2, 0, 255),
            np.where((ii // 2 + jj // 2) % 2, 255, 0)]
    rng = np.random.default_rng(7)
    for _ in range(24):
        a = rng.integers(0, 256, (8, 8))
        out.append(np.triu(a) + np.triu(a, 1).T)
        b = rng.choice([0, 255], (8, 8))
        out.append(np.triu(b) + np.triu(b, 1).T)
    return np.stack(out).astype(np.int32)


def as_plane(blocks):
    """(N, 8, 8) blocks side by side in one 8-row plane."""
    return np.ascontiguousarray(blocks.transpose(1, 0, 2).reshape(8, -1))


def blocky(rng, shape):
    """Flat 4x4 patches plus noise: every direction and the clip fire."""
    h, w = shape
    base = np.kron(rng.integers(0, 256, (-(-h // 4), -(-w // 4))),
                   np.ones((4, 4), np.int64))[:h, :w]
    return np.clip(base + rng.integers(-6, 7, shape), 0, 255) \
        .astype(np.int32)
