"""Point cloud -> equirectangular panorama, z-buffered splat (port of
piccolo_tpu.ops.pano).

A pixel's winner is (1) the tap layer with the highest priority that hits
it (centre first, then the reference's idx1..idx8), then (2) within that
layer the nearest point.  Both passes are integer scatter-mins, so the
result is deterministic on any hardware.

Positive f32 distance bits are monotonic as integers.  The key packing is
done in int64, where every 32-bit unsigned key is a plain non-negative
number; only the final buffer goes back to the JAX package's int32 bit
pattern (unsigned order mapped to signed order by the 0x80000000 flip).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .projection import spherical_project, sum_sq

__all__ = [
    "render_pano",
    "render_winner",
    "render_attr_min",
    "attr_min_keys",
    "attr_min_keys_from_pixels",
    "attr_min_decode",
    "project_pixels",
]

# (priority, dr, dc); reference tap offsets utils.py:172-198
_TAPS = (
    (0, 0, 0),
    (1, 1, 1),
    (2, 1, 0),
    (3, 1, -1),
    (4, -1, 1),
    (5, -1, 0),
    (6, -1, -1),
    (7, 0, 1),
    (8, 0, -1),
)

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit unsigned value -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _dist_bits(dist: torch.Tensor) -> torch.Tensor:
    """f32 distances (>= 0) -> their bit patterns as int64."""
    return dist.clamp_min(0.0).contiguous().view(torch.int32).to(torch.int64)


def project_pixels(xyz: torch.Tensor, resolution: Tuple[int, int]):
    """(..., N, 3) camera-frame points -> distance, row0 and col0 of the
    splat's centre tap (the geometry half of :func:`attr_min_keys`)."""
    H, W = resolution
    dist = torch.sqrt(sum_sq(xyz))
    coords = spherical_project(xyz)
    px = (coords[..., 0] + 1.0) / 2.0 * (W - 1)
    py = (coords[..., 1] + 1.0) / 2.0 * (H - 1)
    return (dist, torch.floor(py).to(torch.int64),
            torch.floor(px).to(torch.int64))


def _batched_scatter_min(pix, key, fill, n_pix):
    """Per-row scatter-min of (B, M) keys into (B, n_pix) buffers."""
    B = pix.shape[0]
    off = torch.arange(B, device=pix.device)[:, None] * n_pix
    buf = torch.full((B * n_pix,), fill, dtype=key.dtype, device=key.device)
    buf.scatter_reduce_(0, (pix + off).reshape(-1), key.reshape(-1), "amin",
                        include_self=True)
    return buf.reshape(B, n_pix)


def render_winner(xyz: torch.Tensor, resolution: Tuple[int, int] = (200, 400),
                  point_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Winning point index per pixel, (H*W,) int64 (N for background)."""
    H, W = resolution
    N = xyz.shape[0]
    dev = xyz.device
    dist, row0, col0 = project_pixels(xyz, resolution)
    valid = (torch.ones(N, dtype=torch.bool, device=dev)
             if point_mask is None else point_mask)
    pix = torch.stack([
        (row0 + dr).clamp(0, H - 1) * W + (col0 + dc).clamp(0, W - 1)
        for _, dr, dc in _TAPS
    ]).reshape(-1)
    prio = torch.tensor([p for p, _, _ in _TAPS], device=dev)[:, None]
    prio = prio.expand(9, N).reshape(-1)
    valid9 = valid[None].expand(9, N).reshape(-1)
    bits = _dist_bits(dist)[None].expand(9, N).reshape(-1)
    # (prio << 27) | (dist_bits >> 5): priority, then the distance's high bits
    big_prio = torch.where(valid9, prio, torch.full_like(prio, 9))
    max_key = 10 << 27
    key = torch.where(valid9, (big_prio << 27) | (bits >> 5),
                      torch.full_like(bits, max_key)).to(torch.int32)
    min_key = _batched_scatter_min(pix[None], key[None], max_key, H * W)[0]
    on_key = valid9 & (key == min_key[pix])
    # pass 2: lowest point index among the key winners
    idx9 = torch.arange(N, device=dev)[None].expand(9, N).reshape(-1)
    i_eff = torch.where(on_key, idx9, torch.full_like(idx9, N))
    return _batched_scatter_min(pix[None], i_eff[None], N, H * W)[0]


def render_pano(xyz: torch.Tensor, rgb: torch.Tensor,
                resolution: Tuple[int, int] = (200, 400),
                point_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(H, W, 3) image in [0, 255] of a coloured camera-frame cloud;
    background pixels are 0."""
    H, W = resolution
    N = xyz.shape[0]
    winner = render_winner(xyz, resolution, point_mask)
    hit = winner < N
    img = torch.where(hit[:, None], rgb[winner.clamp_max(N - 1)],
                      torch.zeros((), dtype=rgb.dtype, device=rgb.device))
    return img.reshape(H, W, 3) * 255.0


def _shift_min_rows(buf: torch.Tensor, d: int, sentinel: int,
                    dim: int) -> torch.Tensor:
    """S[r] = min over r0 with clip(r0 + d, 0, n-1) == r of buf[r0] along
    ``dim`` (|d| <= 1): a shift with a sentinel fill, where the border row
    absorbs the row that clamps onto it."""
    if d == 0:
        return buf
    n = buf.shape[dim]
    shape = list(buf.shape)
    shape[dim] = 1
    sent = torch.full(shape, sentinel, dtype=buf.dtype, device=buf.device)
    nar = buf.narrow
    if d == 1:
        return torch.cat([sent, nar(dim, 0, n - 2),
                          torch.minimum(nar(dim, n - 2, 1), nar(dim, n - 1, 1))],
                         dim=dim)
    return torch.cat([torch.minimum(nar(dim, 0, 1), nar(dim, 1, 1)),
                      nar(dim, 2, n - 2), sent], dim=dim)


def attr_min_keys_from_pixels(dist, row0, col0, attr, attr_bits: int,
                              resolution: Tuple[int, int],
                              point_mask: Optional[torch.Tensor] = None):
    """The key half of :func:`attr_min_keys`, from projected centre pixels.

    ``dist``/``row0``/``col0`` are (B, N); returns (B, H*W) int32 keys in
    the JAX package's sign-flipped unsigned order."""
    H, W = resolution
    B = dist.shape[0]
    nbits = 28 - attr_bits
    key28 = (_dist_bits(dist) >> (32 - nbits)) << attr_bits
    key28 = (key28 | attr.to(torch.int64)).to(torch.int32)
    sent28 = (1 << 28) - 1
    if point_mask is not None:
        key28 = torch.where(point_mask, key28, torch.full_like(key28, sent28))
    buf = _batched_scatter_min(row0 * W + col0, key28, sent28, H * W)
    buf = buf.reshape(B, H, W).to(torch.int64)
    # dense 9-tap dilation: min over priorities of shifted centre keys
    out = torch.full_like(buf, _U32)
    for p, dr, dc in _TAPS:
        s = _shift_min_rows(buf, dr, sent28, 1)
        s = _shift_min_rows(s, dc, sent28, 2)
        cand = torch.where(s == sent28, torch.full_like(s, _U32),
                           (p << 28) | s)
        out = torch.minimum(out, cand)
    return _u32_to_i32(out ^ _SIGN).reshape(B, H * W)


def attr_min_keys(xyz: torch.Tensor, attr: torch.Tensor, attr_bits: int,
                  resolution: Tuple[int, int] = (200, 400),
                  point_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel packed min keys of a z-buffered splat of a small integer
    attribute: [tap priority (4b) | distance (28 - attr_bits msb) | attr].

    ``xyz`` is (N, 3) or (B, N, 3) camera-frame points; returns (H*W,) or
    (B, H*W) int32 keys; :func:`attr_min_decode` recovers the attribute.
    """
    batched = xyz.dim() == 3
    pts = xyz if batched else xyz[None]
    dist, row0, col0 = project_pixels(pts, resolution)
    keys = attr_min_keys_from_pixels(dist, row0, col0, attr, attr_bits,
                                     resolution, point_mask)
    return keys if batched else keys[0]


def attr_min_decode(min_keys: torch.Tensor, attr_bits: int) -> torch.Tensor:
    """Winning attribute per pixel (int32, -1 where no point splats)."""
    min_u = (min_keys.to(torch.int64) & _U32) ^ _SIGN
    out = (min_u & ((1 << attr_bits) - 1)).to(torch.int32)
    return torch.where(min_u != _U32, out, torch.full_like(out, -1))


def render_attr_min(xyz: torch.Tensor, attr: torch.Tensor, attr_bits: int,
                    resolution: Tuple[int, int] = (200, 400),
                    point_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Z-buffered splat of a small integer attribute: (H*W,) int32, -1
    where no point splats."""
    return attr_min_decode(
        attr_min_keys(xyz, attr, attr_bits, resolution, point_mask), attr_bits
    )
