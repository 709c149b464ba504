"""The yardstick's arithmetic: the card's published peaks and the work a
frame needs, counted from the reference's needed pairs (reference.Work)
and from the shapes, whatever the program does to compute it.

Per-pair counts are f32 operations of the serial per-pixel blend:
* B1 (blend forward), per needed pair: dx, dy, the power (7), its test,
  exp, opacity x G, the 0.99 clip, the 1/255 test, 1 - alpha, T (1 - alpha)
  and the 1e-4 test (18); then the weight and four accumulations (9). With
  LOD, the kid alpha and the lerp add 10 (two of them transcendental).
* B2 (blend backward), per needed pair: the forward's test again (14),
  then 1 - alpha, the T division, the contribution, the colour dot (4),
  dL/dalpha (4), the suffix update, the clip test, dpower, the two
  moments of the mean, the three of the conic and the four colour
  products (24).
Bytes: each Gaussian a needed pair names is read once (12 f32 features);
B1 writes its colour, inverse depth and final transmittance (20 bytes a
pixel); B2 reads the image and final-T cotangents and the final
transmittance (24 bytes a pixel) and writes one 12-float gradient row a
named Gaussian.
Per Gaussian, by formula: projection (covariance, view transform, EWA
Jacobian, conic, radius) 120 operations, SH of degree 3 140, their
backward twice the forward; Adam 10 a parameter element; the LOD cut 25 a
node and its interpolation 2 a feature (59 features at SH degree 3).
"""

from __future__ import annotations

PEAK_F32_S = 67e12        # H100 SXM, f32 outside the tensor cores
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3

OPS_EVAL, OPS_APPLY, OPS_LOD = 18, 9, 10
B2_OPS_NEED, B2_OPS_APPLY = 14, 24
FEATURE_BYTES = 12 * 4
B1_PIXEL_BYTES = 20
B2_PIXEL_BYTES = 24
PROJECT_OPS, SH3_OPS, BACKWARD_FACTOR = 120, 140, 2
ADAM_OPS = 10
CUT_OPS, INTERP_OPS = 25, 2


def sh_features(degree: int) -> int:
    """Features a Gaussian carries: mean 3, scale 3, rotation 4, opacity 1
    and 3 per SH coefficient."""
    return 11 + 3 * (degree + 1) ** 2


def b1(w, pixels: int, lod: bool):
    """(f32 operations, bytes) of the blend forward of one frame."""
    per = OPS_EVAL + OPS_APPLY + (OPS_LOD if lod else 0)
    return (w.pairs * per,
            w.gaussians * FEATURE_BYTES + pixels * B1_PIXEL_BYTES)


def b2(w, pixels: int):
    """(f32 operations, bytes) of the blend backward of one frame."""
    return (w.pairs * (B2_OPS_NEED + B2_OPS_APPLY),
            2 * w.gaussians * FEATURE_BYTES + pixels * B2_PIXEL_BYTES)


def train_step(w, pixels: int, degree: int):
    """{b1, b2: (ops, bytes), total_ops} of one training step: the blend
    both ways, projection and SH both ways for the visible Gaussians, and
    Adam on their parameters."""
    f = b1(w, pixels, lod=False)
    b = b2(w, pixels)
    per_g = (PROJECT_OPS + SH3_OPS) * (1 + BACKWARD_FACTOR) \
        + ADAM_OPS * sh_features(degree)
    return dict(b1=f, b2=b, total_ops=f[0] + b[0] + w.visible * per_g)


def lod_frame(w, pixels: int, degree: int, nodes: int, drawn: int):
    """{b1: (ops, bytes), total_ops} of one hierarchical frame: the cut
    over every node, the interpolation, projection and SH of the `drawn`
    ones, and the blend with the LOD alpha."""
    f = b1(w, pixels, lod=True)
    per_drawn = PROJECT_OPS + SH3_OPS + INTERP_OPS * sh_features(degree)
    return dict(b1=f, total_ops=f[0] + nodes * CUT_OPS + drawn * per_drawn)


def bound_s(ops: float, n_bytes: float) -> float:
    """The least time the card could take for the work."""
    return max(ops / PEAK_F32_S, n_bytes / PEAK_BYTES_S)
