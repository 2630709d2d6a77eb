"""Spans on which the temporal filter's span pass (kernel KK) is held to
its plain version and to the reference: shared by the CPU parity tests and
the card's kernel tests (this module imports neither jax nor the reference
package)."""
import numpy as np


def panning(n, w, h, seed):
    """A noisy textured scene panning by a few pixels per frame (a
    different step per frame), with textured chroma: the search finds MVs
    toward every border. Block (1, 1) holds the same random texture in
    every frame (a static logo: its squared errors are 0 at MV 0, so every
    frame weighs 1000 there)."""
    rng = np.random.default_rng(seed)
    logo = [rng.integers(0, 256, (32, 32)), rng.integers(0, 256, (16, 16)),
            rng.integers(0, 256, (16, 16))]
    yy, xx = np.mgrid[0:h + 48, 0:w + 48].astype(np.float32)
    base = 110 + 60 * np.sin(xx / 7.0 + yy / 11.0) * np.cos(yy / 5.0)
    steps = rng.integers(-3, 4, (n, 2))
    out = []
    for i in range(n):
        oy, ox = 24 + steps[i, 0] * i, 24 + steps[i, 1] * i
        y = np.clip(base[oy:oy + h, ox:ox + w]
                    + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(128 + 30 * np.sin(xx[:h:2, :w:2] / 4.0 + i)
                    + rng.normal(0, 3, (h // 2, w // 2)), 0, 255) \
            .astype(np.uint8)
        v = np.clip(255 - u.astype(np.int32) + rng.integers(-4, 5, u.shape),
                    0, 255).astype(np.uint8)
        y[32:64, 32:64] = logo[0][:h - 32]
        u[16:32, 16:32] = logo[1][:h // 2 - 16]
        v[16:32, 16:32] = logo[2][:h // 2 - 16]
        out.append([y, u, v])
    return out


SIZES = {"112x80": (112, 80), "88x56": (88, 56), "66x48": (66, 48)}
NOISE = (2.2, 0.7, 1.4)
# (frames, centre, strength, q, size): every N with the centre first, in
# the middle and last; the two strengths; q at both ends of the weights
CASES = [
    (2, 0, 1, 500, "112x80"), (2, 1, 2, 30000, "66x48"),
    (2, 1, 1, 1, "88x56"), (3, 0, 1, 500, "112x80"),
    (3, 1, 2, 500, "88x56"), (3, 2, 2, 1, "66x48"),
    (3, 0, 2, 30000, "112x80"), (4, 0, 2, 500, "66x48"),
    (4, 2, 1, 30000, "88x56"), (4, 3, 1, 500, "112x80"),
    (5, 0, 1, 1, "112x80"), (5, 2, 2, 500, "112x80"),
    (5, 4, 2, 500, "88x56"), (5, 2, 1, 500, "66x48"),
    (5, 2, 2, 30000, "66x48"), (4, 1, 2, 1, "112x80"),
]


def case_id(c):
    return f"n{c[0]}-c{c[1]}-s{c[2]}-q{c[3]}-{c[4]}"
