"""RGBA <-> YUV420 conversion in PyTorch (BT.601, integer-exact).

Port of tpuh264/kernels/color.py (the JAX package computes these outside
any Pallas kernel).  The coefficients bit-match the reference's two
conversions (its CPU C++ and its WGSL shader):

  Y =  ((  66 R + 129 G +  25 B + 128) >> 8) + 16
  U =  (( -38 R -  74 G + 112 B + 128) >> 8) + 128
  V =  (( 112 R -  94 G -  18 B + 128) >> 8) + 128

Chroma is taken from the top-left sample of each 2x2 block (no
averaging).  The inverse (decode side):

  C = Y - 16, D = U - 128, E = V - 128
  R = clip((298 C + 409 E + 128) >> 8)
  G = clip((298 C - 100 D - 208 E + 128) >> 8)
  B = clip((298 C + 516 D + 128) >> 8)

All arithmetic is int32 (`>>` floors, as XLA's arithmetic shift does).
"""

from __future__ import annotations

from typing import Tuple

import torch

I32 = torch.int32


def rgba_to_yuv420(rgba: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., H, W, 4] uint8/int -> (Y [..., H, W], U, V [..., H/2, W/2])
    int32."""
    x = rgba.to(I32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    r2, g2, b2 = r[..., ::2, ::2], g[..., ::2, ::2], b[..., ::2, ::2]
    u = ((-38 * r2 - 74 * g2 + 112 * b2 + 128) >> 8) + 128
    v = ((112 * r2 - 94 * g2 - 18 * b2 + 128) >> 8) + 128
    return y, u, v


def yuv420_to_rgba(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """(Y [..., H, W], U, V [..., H/2, W/2]) -> [..., H, W, 4] uint8 RGBA,
    chroma upsampled nearest-neighbour."""
    h, w = y.shape[-2:]
    c = y.to(I32) - 16
    up = lambda p: (p.to(I32) - 128).repeat_interleave(2, -1) \
        .repeat_interleave(2, -2)[..., :h, :w]
    d, e = up(u), up(v)
    r = torch.clamp((298 * c + 409 * e + 128) >> 8, 0, 255)
    g = torch.clamp((298 * c - 100 * d - 208 * e + 128) >> 8, 0, 255)
    b = torch.clamp((298 * c + 516 * d + 128) >> 8, 0, 255)
    a = torch.full_like(r, 255)
    return torch.stack([r, g, b, a], dim=-1).to(torch.uint8)
