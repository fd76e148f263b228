"""Deterministic synthetic sources: on the device, and on the host.

Port of tpuh264/engine/sources.py.  The device sources `_hash_noise`,
`_device_source_gop` (kinds "rigid", "noise", "moving_gradient") and
`_device_source_frames` make frames where the codec runs, as in the JAX
version, so no pixel crosses the host link.  The host sources
(`yuv_frame`, `rgba_frame`, `read_y4m` / `write_y4m`, `clip_frames`) are
numpy copies of the originals, kept identical (tests hold them so): the
original module's package imports JAX.

"noise" is integer-exact (the int32 wraparound of the JAX hash is
reproduced in int64 arithmetic), so pipeline parity tests run on it.
"rigid" and "moving_gradient" use float32 sin/cos: different math
libraries (XLA's CPU, PyTorch's CPU, CUDA's sinf) may differ by an ulp,
which can flip a truncated uint8 by one level on a few pixels.

`device_source_gop` is a router: CPU tensors take the plain version
`_device_source_gop_plain` (the eager formulas), a CUDA device launches
K15 (csrc/source.cu), one launch for every frame and plane, equal on the
card to the plain version's chain of float32 ATen ops sample for sample;
any other device raises.  `device_source_frames` (the DevicePipeline's
source) is `device_source_gop` with one stream.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels import cuda_lib

_M32 = (1 << 32) - 1
KINDS = ("rigid", "noise", "moving_gradient")  # K15's kind codes 0, 1, 2


def _wrap32(h: torch.Tensor) -> torch.Tensor:
    """int64 -> the same value wrapped to signed 32 bits (still int64)."""
    return ((h + (1 << 31)) & _M32) - (1 << 31)


def _hash_noise(*terms: torch.Tensor) -> torch.Tensor:
    """Integer-hash noise in [0, 256), the JAX version's int32 math."""
    h = sum(t.to(torch.int64) * m
            for t, m in zip(terms, (1664525, 1013904223, 69069)))
    h = _wrap32(h)
    h = h ^ (h >> 13)  # arithmetic shift of the signed 32-bit value
    h = _wrap32(h * 1103515245 + 12345)
    h = h ^ (h >> 7)
    return (h & 255).to(torch.uint8)


def _device_source_gop_plain(width: int, height: int, k: int, streams: int,
                             kind: str, t: int, device
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of `device_source_gop` (same arguments)."""
    i32, f32 = torch.int32, torch.float32
    ti = (t + torch.arange(k, dtype=i32, device=device))[:, None, None, None]
    si = torch.arange(streams, dtype=i32, device=device)[None, :, None, None]
    yy = torch.arange(height, dtype=i32, device=device)[None, None, :, None]
    xx = torch.arange(width, dtype=i32, device=device)[None, None, None, :]
    if kind == "rigid":
        xf = (xx - 2.0 * ti).to(f32)
        yf = (yy - 1.0 * ti).to(f32)
        ph = si.to(f32) * 1.7
        y = (128.0
             + 46.0 * torch.sin(xf / 17.0 + ph) * torch.cos(yf / 23.0)
             + 34.0 * torch.sin((xf + yf) / 7.1 + ph)
             + 18.0 * torch.cos(xf / 3.3) * torch.sin(yf / 4.7 + ph))
        y = torch.clamp(y, 0, 255).to(torch.uint8)
        x2 = (xx[..., ::2] - 1.0 * ti).to(f32)
        y2 = (yy[:, :, ::2] - 0.5 * ti).to(f32)
        u = (128.0 + 44.0 * torch.sin(x2 / 19.0 + ph)
             * torch.cos(y2 / 13.0)).to(torch.uint8)
        v = (128.0 + 44.0 * torch.cos(x2 / 11.0 - ph)
             * torch.sin(y2 / 29.0)).to(torch.uint8)
    elif kind == "noise":
        y = _hash_noise(xx + si * 97, yy, ti)
        u = _hash_noise(xx[..., ::2] + si * 97 + 7, yy[:, :, ::2] + 3, ti)
        v = _hash_noise(xx[..., ::2] + si * 97 + 13, yy[:, :, ::2] + 11, ti)
    elif kind == "moving_gradient":
        y = ((xx * 2 + yy + ti * 7 + si * 37) % 256).to(torch.uint8)
        yy2 = yy[:, :, ::2, :]
        xx2 = xx[:, :, :, ::2]
        u = (128 + 47 * torch.sin(((xx2 + ti * 3 + si * 11) / 37.0).to(f32))
             ).to(torch.uint8)
        v = (128 + 47 * torch.cos(((yy2 - ti * 5 + si * 13) / 29.0).to(f32))
             ).to(torch.uint8)
    else:
        raise ValueError(f"unknown device source kind {kind!r}")
    shape2 = (k, streams, height // 2, width // 2)
    return (y.expand(k, streams, height, width).contiguous(),
            u.expand(shape2).contiguous(), v.expand(shape2).contiguous())


def _k15_operands(width: int, height: int, k: int, streams: int, kind: str,
                  t: int, device):
    """K15's operands in its entry's order (csrc/source.cu
    `source_args`): (input tensors (none), output tensors -- the luma and
    the two chroma planes, fresh --, ints)."""
    outs = [torch.empty(sh, dtype=torch.uint8, device=device) for sh in (
        (k, streams, height, width),
        (k, streams, height // 2, width // 2),
        (k, streams, height // 2, width // 2))]
    return [], outs, [width, height, streams, k, t, KINDS.index(kind)]


def device_source_gop(width: int, height: int, k: int, streams: int,
                      kind: str, t: int, device
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frames t..t+k-1 of every stream: [k, streams, H, W] uint8 planes
    (chroma [k, streams, H/2, W/2]), as tpuh264's _device_source_gop:
    the plain version on the CPU, K15 on a CUDA device."""
    device = torch.device(device)
    if device.type == "cpu":
        return _device_source_gop_plain(width, height, k, streams, kind, t,
                                        device)
    if kind not in KINDS:
        raise ValueError(f"unknown device source kind {kind!r}")
    if device.type != "cuda":
        raise ValueError(f"device_source_gop: device {device}, neither the "
                         f"CPU nor a CUDA device")
    if (width < 2 or height < 2 or width % 2 or height % 2 or streams < 1
            or k < 1 or not -(1 << 31) <= t <= (1 << 31) - k):
        raise ValueError(f"device_source_gop: {k} frames of {width}x{height}"
                         f" x {streams} from t = {t}: K15 takes even sizes "
                         f"and int32 times")
    ins, outs, ints = _k15_operands(width, height, k, streams, kind, t,
                                    device)
    err = cuda_lib.load().th264_source(
        cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
        cuda_lib.stream(device))
    cuda_lib.check(err, "th264_source")
    device_source_gop.launches += 1
    return tuple(outs)


device_source_gop.launches = 0  # launches of K15


def device_source_frames(width: int, height: int, k: int, kind: str, t: int,
                         device) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Frames t..t+k-1 of one stream, the batch axis being TIME: [k, H, W]
    uint8 planes (chroma [k, H/2, W/2]), as tpuh264's
    _device_source_frames ("noise", or the moving gradient for any other
    kind): `device_source_gop` with one stream, whose stream terms then
    vanish."""
    kind = "noise" if kind == "noise" else "moving_gradient"
    return tuple(p[:, 0] for p in device_source_gop(width, height, k, 1,
                                                    kind, t, device))


# -- host sources: numpy copies of tpuh264/engine/sources.py ----------------


def yuv_frame(
    width: int, height: int, t: int, kind: str = "moving_gradient", seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One I420 frame [H,W]+[H/2,W/2]x2 int32, deterministic in (t, seed)."""
    rng = np.random.default_rng(seed * 1_000_003 + t)
    yy, xx = np.mgrid[0:height, 0:width]
    if kind == "moving_gradient":
        y = ((xx * 2 + yy + t * 7) % 256 + rng.integers(0, 8, (height, width)))
        y = y.clip(0, 255)
    elif kind == "rigid":
        # camera-like rigid motion (one (2,1) px/frame field for all
        # planes; see _device_source_gop for rationale)
        xf = xx - 2.0 * t
        yf = yy - 1.0 * t
        y = (
            128.0
            + 46.0 * np.sin(xf / 17.0) * np.cos(yf / 23.0)
            + 34.0 * np.sin((xf + yf) / 7.1)
            + 18.0 * np.cos(xf / 3.3) * np.sin(yf / 4.7)
        ).clip(0, 255)
        x2 = xx[::2, ::2] - 1.0 * t
        y2 = yy[::2, ::2] - 0.5 * t
        u = (128.0 + 44.0 * np.sin(x2 / 19.0) * np.cos(y2 / 13.0))
        v = (128.0 + 44.0 * np.cos(x2 / 11.0) * np.sin(y2 / 29.0))
        return (
            np.asarray(y, np.int32),
            u.clip(0, 255).astype(np.int32),
            v.clip(0, 255).astype(np.int32),
        )
    elif kind == "colorbars":
        y = ((xx * 8 // max(width, 1)) * 32 + 16 + (t % 2)).clip(0, 235)
    elif kind == "noise":
        y = rng.integers(0, 256, (height, width))
    elif kind == "checker":
        y = (((xx // 32 + yy // 32 + t) % 2) * 200 + 28)
    else:
        raise ValueError(kind)
    u = (128 + 48 * np.sin((xx[::2, ::2] + t * 3) / 37.0)).astype(np.int64)
    v = (128 + 48 * np.cos((yy[::2, ::2] - t * 5) / 29.0)).astype(np.int64)
    return (
        np.asarray(y, np.int32),
        u.clip(0, 255).astype(np.int32),
        v.clip(0, 255).astype(np.int32),
    )


def rgba_frame(
    width: int, height: int, t: int, kind: str = "moving_gradient", seed: int = 0
) -> np.ndarray:
    """One RGBA frame [H, W, 4] uint8 (camera-like input for encode_frame)."""
    y, u, v = yuv_frame(width, height, t, kind, seed)
    r = np.clip(y + 30 * ((t % 7) - 3) // 3, 0, 255)
    g = np.clip(y, 0, 255)
    b = np.clip(255 - y, 0, 255)
    a = np.full_like(r, 255)
    return np.stack([r, g, b, a], axis=-1).astype(np.uint8)


# -- file sources (Y4M) -------------------------------------------------------
# The reference only ever encodes live camera frames (app.js:245-247);
# real deployments encode FILES too, and the north star's RD comparisons
# need recorded clips.  YUV4MPEG2 is the interchange format every
# standard test clip (Akiyo, Foreman, ...) ships in.


def write_y4m(path: str, frames, fps: int = 30) -> None:
    """Write I420 frames [(y, u, v)] as a YUV4MPEG2 file."""
    y0 = np.asarray(frames[0][0])
    h, w = y0.shape
    with open(path, "wb") as f:
        f.write(
            f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420jpeg\n".encode()
        )
        for (y, u, v) in frames:
            f.write(b"FRAME\n")
            f.write(np.asarray(y, np.uint8).tobytes())
            f.write(np.asarray(u, np.uint8).tobytes())
            f.write(np.asarray(v, np.uint8).tobytes())


def read_y4m(path: str, max_frames: int = 0):
    """Read a YUV4MPEG2 (8-bit 4:2:0) file -> [(y, u, v)] int32 planes.

    Accepts the C420/C420jpeg/C420mpeg2/C420paldv chroma taggings (all
    are 8-bit 2x2-subsampled layouts; siting differences do not change
    the sample container).  Interlaced or non-4:2:0 files are rejected.
    """
    with open(path, "rb") as f:
        header = f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a YUV4MPEG2 file")
        w = h = None
        for tok in header.split()[1:]:
            if tok.startswith("W"):
                w = int(tok[1:])
            elif tok.startswith("H"):
                h = int(tok[1:])
            elif tok.startswith("C") and not tok.startswith("C420"):
                raise NotImplementedError(f"chroma {tok} (4:2:0 only)")
            elif tok.startswith("I") and tok not in ("Ip", "I?"):
                raise NotImplementedError("interlaced Y4M")
        if not w or not h:
            raise ValueError("Y4M header missing W/H")
        frames = []
        ylen, clen = w * h, (w // 2) * (h // 2)
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError("bad FRAME marker")
            raw = f.read(ylen + 2 * clen)
            if len(raw) < ylen + 2 * clen:
                break
            y = np.frombuffer(raw, np.uint8, ylen).reshape(h, w)
            u = np.frombuffer(raw, np.uint8, clen, ylen).reshape(
                h // 2, w // 2
            )
            v = np.frombuffer(raw, np.uint8, clen, ylen + clen).reshape(
                h // 2, w // 2
            )
            frames.append((
                y.astype(np.int32), u.astype(np.int32),
                v.astype(np.int32),
            ))
            if max_frames and len(frames) >= max_frames:
                break
    return frames


def clip_frames(width: int, height: int, n: int, kind: str = "meeting",
                seed: int = 0):
    """Camera-like synthetic CLIPS for RD measurement: richer than the
    per-frame sources above (textured regions, independently moving
    foreground, sensor noise), deterministic, any resolution.

    These stand in for standard test clips in the build environment,
    which has no network egress to fetch Akiyo/Foreman et al.; real
    clips go through read_y4m on the same code path.
    """
    rng = np.random.default_rng(seed * 7 + 13)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    # static textured background (smoothed noise + structure)
    bg = rng.normal(0, 1, (height + 64, width + 64)).astype(np.float32)
    for _ in range(3):  # cheap separable smoothing
        bg = (bg + np.roll(bg, 1, 0) + np.roll(bg, -1, 0)
              + np.roll(bg, 1, 1) + np.roll(bg, -1, 1)) / 5.0
    bg = 110 + 70 * bg / max(np.abs(bg).max(), 1e-6)
    bg += 25 * np.sin(np.mgrid[0:height + 64, 0:width + 64][1] / 41.0)
    out = []
    for t in range(n):
        if kind == "meeting":
            # slow global drift + a larger talking-head-like ellipse
            # moving independently + slight luma flicker
            gx, gy = 0.7 * t, 0.3 * t
            y = bg[int(gy):int(gy) + height, int(gx):int(gx) + width].copy()
            cx = width * 0.5 + 14 * np.sin(t / 6.0)
            cy = height * 0.55 + 6 * np.cos(t / 9.0)
            d2 = ((xx - cx) / (0.16 * width)) ** 2 + (
                (yy - cy) / (0.3 * height)) ** 2
            obj = 150 + 40 * np.sin((xx - cx) / 9.0) * np.cos(
                (yy - cy) / 11.0)
            y = np.where(d2 < 1.0, obj, y) + 1.5 * np.sin(t / 3.0)
        elif kind == "pan_detail":
            # constant pan over high-detail texture (stress ME + rate)
            gx, gy = 1.8 * t, 0.9 * t
            y = bg[int(gy):int(gy) + height, int(gx):int(gx) + width].copy()
            y += 20 * np.sin((xx + 2.3 * t) / 3.1) * np.cos(yy / 2.7)
        else:
            raise ValueError(kind)
        y += rng.normal(0, 1.2, (height, width))  # sensor noise
        u = 118 + 30 * np.sin((xx[::2, ::2] + 3 * t) / 53.0)
        v = 130 + 26 * np.cos((yy[::2, ::2] + 2 * t) / 47.0)
        out.append((
            np.clip(y, 0, 255).astype(np.int32),
            np.clip(u, 0, 255).astype(np.int32),
            np.clip(v, 0, 255).astype(np.int32),
        ))
    return out
