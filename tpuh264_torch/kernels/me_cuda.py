"""K1: the stage-A integer motion search, as a CUDA kernel plus its plain
PyTorch version.

Replaces the Pallas kernel tpuh264/kernels/me_pallas.py `_kernel`
(pallas_call at me_pallas.py:139, entry `sad_field` :103).  It computes
the exact SAD of every MB's stride-2 (8x8 even-sample) subsample
against the G half-pel plane at all 289 offsets of the +-8 grid.

Layout: [S, R, C, 289], candidate minor and dy-major -- the layout of
tpuh264's `pframe._sad_field`, which `pframe._int_winner` consumes with
the candidate axis last.  The kernel (csrc/me_sad.cu) and the plain
version below produce the same layout.

`sad_field` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..golden.inter import SEARCH_PAD, SEARCH_RANGE
from . import cuda_lib

PE = SEARCH_PAD + 1            # half-pel plane pad (13)
N = 2 * SEARCH_RANGE + 1       # 17 offsets per axis
NN = N * N                     # 289 candidates

def _sad_field(src2: torch.Tensor, gplane: torch.Tensor, h: int, w: int
               ) -> torch.Tensor:
    """Plain version: src2 [S, h/2, w/2] stride-2 source subsample, gplane
    [S, h+26, w+26] -> int32 [S, R, C, 289] (dy-major, dx-minor)."""
    s = src2.shape[0]
    r, c = h // 16, w // 16
    src2 = src2.to(torch.int32)
    g = gplane.to(torch.int32)
    out = []
    for dy in range(-SEARCH_RANGE, SEARCH_RANGE + 1):
        rows = g[:, PE + dy:PE + dy + h:2]
        for dx in range(-SEARCH_RANGE, SEARCH_RANGE + 1):
            r2 = rows[:, :, PE + dx:PE + dx + w:2]
            out.append((src2 - r2).abs().reshape(s, r, 8, c, 8)
                       .sum((2, 4), dtype=torch.int32))
    return torch.stack(out, dim=-1)


def sad_field(y: torch.Tensor, gplane: torch.Tensor) -> torch.Tensor:
    """Stage-A SAD table [S, R, C, 289] int32.

    y [S, h, w] int32, the full-resolution source (even rows and columns
    are read); gplane [S, h+26, w+26], the G half-pel plane: on the card
    the uint8 view `pframe._references` returns (rows 16-byte aligned, a
    pitch of a multiple of 16 bytes: the kernel reads it 16 bytes at a
    time; any other layout raises), on the CPU any integer plane.

    Precondition of the kernel: every sample of y lies in [0, 255] --
    true of every source the P path encodes (uint8 pictures); the kernel
    packs samples four to a 32-bit word (csrc/me_sad.cu).  The plain
    version takes any int32."""
    s, h, w = y.shape
    if y.device.type == "cpu":
        return _sad_field(y[:, ::2, ::2], gplane, h, w)
    if h % 16 or w % 16:
        raise ValueError(f"sad_field: frame {h}x{w} is not whole MBs")
    cuda_lib.check_inputs("sad_field", y.device, [(y, (s, h, w))])
    cuda_lib.check_plane("sad_field", y.device, gplane,
                         (s, h + 2 * PE, w + 2 * PE))
    out = torch.empty((s, h // 16, w // 16, NN), dtype=torch.int32,
                      device=y.device)
    err = cuda_lib.load().th264_sad_field(
        cuda_lib.pointers([y, gplane, out]), cuda_lib.ints(
            _k1_ints(y, gplane)), cuda_lib.stream(y.device))
    cuda_lib.check(err, "th264_sad_field")
    sad_field.launches += 1
    return out


sad_field.launches = 0  # launches of the K1 kernel


def _k1_ints(y: torch.Tensor, gplane: torch.Tensor) -> list:
    """K1's ints in its entry's order (csrc/me_sad.cu `sad_args`): S, H,
    W and the G plane's pitch."""
    s, h, w = y.shape
    return [s, h, w, gplane.stride(-2)]
