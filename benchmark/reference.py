"""The plain reference: PICCOLO's localization written out in plain PyTorch
and numpy, to judge the served answers.

It imports neither JAX nor anything of the program under test, and takes
nothing the program made: from the cloud, the panorama and the
configuration the benchmark hands both sides, it works out again what the
program derives per query:

* the colour preprocessing: ``match_color`` (per-channel CDF matching of
  the image to the cloud, rows weighted by sin(latitude), then the uint8
  requantisation) and ``sharpen_color`` (a joint image + cloud luminance
  equalisation in YCrCb with OpenCV's 8-bit fixed-point formulas);
* the candidate grids (translations from the cloud's quantiles, the
  rotation grid with duplicate sampling grids dropped);
* stage 1, the sampling loss of every (translation, rotation) pair, and the
  ``num_intermediate`` lowest;
* stage 2, the block-histogram score of each of those candidates from a
  z-buffered 9-tap splat of the cloud's colour bins, and the ``num_input``
  best;
* stage 3, the multi-start descent (``torch.optim.Adam`` and
  ``ReduceLROnPlateau`` per start, the translation clamped to the cloud's
  quantile box), and the winner;
* for a tracked frame, the single-start descent from the previous pose.

The sampling loss is PICCOLO's: points moved into the camera frame
``R (x - t)``, projected to equirectangular coordinates, sampled
bilinearly with ``grid_sample``'s conventions (``align_corners=False``,
zeros outside, coordinates clipped to [-0.99, 0.99]), black samples
dropped, and the mean colour distance of the rest.

``dtype`` runs the whole chain at another precision: the control puts this
reference, in bfloat16, in the program's place.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .scene import rot_from_ypr_np

# ---------------------------------------------------------------------------
# geometry and the sampling loss


def rot_from_ypr(ypr: torch.Tensor) -> torch.Tensor:
    """(..., 3) yaw, pitch, roll -> (..., 3, 3) R = RZ @ RY @ RX."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cz, sz, cy, sy, cx, sx = (torch.cos(y), torch.sin(y), torch.cos(p),
                              torch.sin(p), torch.cos(r), torch.sin(r))
    row0 = torch.stack([cz * cy, cz * sy * sx - sz * cx,
                        cz * sy * cx + sz * sx], -1)
    row1 = torch.stack([sz * cy, sz * sy * sx + cz * cx,
                        sz * sy * cx - cz * sx], -1)
    row2 = torch.stack([-sy, cy * sx, cy * cx], -1)
    return torch.stack([row0, row1, row2], -2)


def project(t: torch.Tensor, R: torch.Tensor, xyz: torch.Tensor):
    """Normalised equirect coords (..., N, 2) of world points seen from
    poses t (..., 3), R (..., 3, 3)."""
    c = xyz - t[..., None, :]
    cam = (c[..., None, :] * R[..., None, :, :]).sum(-1)
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    # the xy norm's gradient is kept finite on the camera's own axis
    theta = torch.atan2(torch.sqrt((x * x + y * y).clamp_min(1e-30)),
                        z + 1e-6)
    phi = torch.atan2(y, x + 1e-6) + math.pi
    u = 2.0 * (1.0 - phi / (2.0 * math.pi)) - 1.0
    v = 2.0 * (theta / math.pi) - 1.0
    return torch.stack([u, v], -1), cam


def bilinear(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``grid_sample(img, coords, align_corners=False, padding='zeros')``
    after clipping coords to [-0.99, 0.99], on an (H, W, C) image, written
    as four gathers so that it runs at any dtype."""
    H, W, C = img.shape
    c = coords.clamp(-0.99, 0.99)
    x = ((c[..., 0] + 1.0) * W - 1.0) / 2.0
    y = ((c[..., 1] + 1.0) * H - 1.0) / 2.0
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0f, y - y0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0, y0 = x0f.long(), y0f.long()
    flat = img.reshape(H * W, C)
    out = 0
    for ix, iy, w in ((x0, y0, wx0 * wy0), (x0 + 1, y0, wx1 * wy0),
                      (x0, y0 + 1, wx0 * wy1), (x0 + 1, y0 + 1, wx1 * wy1)):
        inside = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        out = out + flat[idx] * (w * inside)[..., None]
    return out


def sampling_loss(t, R, xyz, rgb, img) -> torch.Tensor:
    """PICCOLO's loss of each pose (leading dims of t / R) against img."""
    coords, _ = project(t, R, xyz)
    s = bilinear(img, coords)
    keep = (s != 0).any(-1)
    dist = torch.sqrt(((s - rgb) ** 2).sum(-1).clamp_min(1e-30))
    dist = torch.where(keep, dist, torch.zeros_like(dist))
    n = keep.sum(-1)
    mean = dist.sum(-1) / n.clamp_min(1)
    return torch.where(n > 0, mean, torch.full_like(mean, math.inf))


def pose_loss(t, R, xyz, rgb, img) -> float:
    """The f32 loss of one pose given by (t (3,), R (3, 3))."""
    dev = xyz.device
    t = torch.as_tensor(np.asarray(t, np.float32), device=dev)
    R = torch.as_tensor(np.asarray(R, np.float32), device=dev)
    return float(sampling_loss(t, R, xyz, rgb, img))


# ---------------------------------------------------------------------------
# colour


_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_R2CR, _B2CB = 11682, 9241
_CR2R, _CR2G, _CB2G, _CB2B = 22987, -11698, -5636, 29049


def _descale(x):
    return (x + (1 << 13)) >> 14


def _rgb2ycc(v: torch.Tensor) -> torch.Tensor:
    """OpenCV's 8-bit RGB -> YCrCb (fixed point), int64 in and out."""
    r, g, b = v[..., 0], v[..., 1], v[..., 2]
    y = _descale(r * _R2Y + g * _G2Y + b * _B2Y)
    cr = _descale((r - y) * _R2CR) + 128
    cb = _descale((b - y) * _B2CB) + 128
    return torch.stack([y, cr, cb], -1).clamp(0, 255)


def _ycc2rgb(v: torch.Tensor) -> torch.Tensor:
    y, cr, cb = v[..., 0], v[..., 1] - 128, v[..., 2] - 128
    r = y + _descale(cr * _CR2R)
    g = y + _descale(cr * _CR2G + cb * _CB2G)
    b = y + _descale(cb * _CB2B)
    return torch.stack([r, g, b], -1).clamp(0, 255)


def _trunc255(x: torch.Tensor) -> torch.Tensor:
    """int(x * 255) of values in [0, 1], float32 arithmetic."""
    return (x.float() * 255.0).long()


def match_color(img_u8: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """The image's per-channel CDF matched to the cloud's colours, rows
    weighted by sin(latitude), black pixels kept; uint8 (requantised)."""
    H, W, _ = img_u8.shape
    flat = img_u8.reshape(-1, 3).float() / 255.0
    bins = _trunc255(flat)
    nonblack = bins.sum(-1) > 0
    rows = torch.arange(H, device=img_u8.device, dtype=torch.float32)
    w = torch.sin(rows / H * math.pi).repeat_interleave(W).double()
    out = flat.clone()
    for c in range(3):
        src = bins[nonblack, c]
        counts = torch.zeros(256, dtype=torch.float64, device=img_u8.device)
        counts.index_add_(0, src, w[nonblack])
        q = torch.cumsum(counts, 0)
        q = q / q[-1]
        vals, cnt = torch.unique(rgb[:, c].float(), return_counts=True)
        tq = torch.cumsum(cnt, 0).double() / rgb.shape[0]
        lut = _interp(q, tq, vals.double()).float()
        out[nonblack, c] = lut[src]
    return _trunc255(out).clamp(0, 255).to(torch.uint8).reshape(H, W, 3)


def _interp(x, xp, fp):
    """numpy.interp for increasing xp."""
    n = xp.shape[0]
    j = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    x0, x1, f0, f1 = xp[j - 1], xp[j], fp[j - 1], fp[j]
    dx = x1 - x0
    f = torch.where(dx > 0, f0 + (x - x0) / torch.where(dx > 0, dx, 1.0)
                    * (f1 - f0), f0)
    f = torch.where(x <= xp[0], fp[0], f)
    return torch.where(x >= xp[-1], fp[-1], f)


def sharpen_color(img: torch.Tensor, rgb: torch.Tensor):
    """Joint luminance equalisation (256 bins) of the image's non-black
    pixels and the cloud: returns (image f32 in [0, 1], cloud colours f32).
    The luminance and chroma go through [0, 1] in float64 and back by
    truncation, as PICCOLO's numpy does."""
    H, W, _ = img.shape
    flat = img.reshape(-1, 3).float()
    bins = _trunc255(flat)
    nonblack = bins.sum(-1) > 0
    tgt = _rgb2ycc(bins[nonblack]).double() / 255.0
    cloud = _rgb2ycc(_trunc255(rgb)).double() / 255.0
    ty = (tgt[:, 0] * 255).long()
    cy = (cloud[:, 0] * 255).long()
    hist = (torch.bincount(ty, minlength=256)
            + torch.bincount(cy, minlength=256)).double()
    cdf = torch.cumsum(hist / hist.sum(), 0)
    tgt[:, 0] = cdf[ty]
    cloud[:, 0] = cdf[cy]
    out = flat.clone()
    out[nonblack] = (_ycc2rgb((tgt * 255).long()).double() / 255.0).float()
    return (out.reshape(H, W, 3),
            (_ycc2rgb((cloud * 255).long()).double() / 255.0).float())


# ---------------------------------------------------------------------------
# candidate grids (host, numpy)


def _axis_points(col: np.ndarray, n: int) -> np.ndarray:
    split = ((np.arange(n) + 1) / (n + 1) if 1 / (n + 1) > 0.1
             else np.linspace(0.1, 0.9, n))
    return np.quantile(col, split)


def trans_grid(xyz: np.ndarray, cfg: Dict) -> np.ndarray:
    """(K, 3) starting translations: a grid over the cloud's 10-90%
    quantile box, the budget split by extent."""
    hi = np.quantile(xyz, 0.90, axis=0)
    lo = np.quantile(xyz, 0.10, axis=0)
    lx, ly, lz = (hi - lo).tolist()
    n = cfg["num_trans"]
    if cfg.get("xy_only", False):
        nx = math.ceil((lx * n / ly) ** 0.5)
        ny = math.ceil((ly * n / lx) ** 0.5)
        gx, gy = np.meshgrid(_axis_points(xyz[:, 0], nx),
                             _axis_points(xyz[:, 1], ny), indexing="ij")
        z = cfg.get("z_prior")
        gz = np.full(gx.shape, xyz[:, 2].mean() if z is None else z)
        return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1).astype(
            np.float32)
    nx = math.ceil((lx ** 2 * n / (ly * lz)) ** (1 / 3))
    ny = math.ceil((ly ** 2 * n / (lx * lz)) ** (1 / 3))
    nz = math.ceil((lz ** 2 * n / (lx * ly)) ** (1 / 3))
    nx, ny, nz = (k - 1 if k % 2 == 0 else k for k in (nx, ny, nz))
    gx, gy, gz = np.meshgrid(_axis_points(xyz[:, 0], nx),
                             _axis_points(xyz[:, 1], ny),
                             _axis_points(xyz[:, 2], nz), indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1).astype(
        np.float32)


def _fingerprint(ypr, sh: int, sw: int) -> bytes:
    """Where a coarse sh x sw grid of directions lands after the rotation:
    two rotations with equal fingerprints are one candidate."""
    R = rot_from_ypr_np(ypr)
    xs = np.linspace(0, sw - 1, sw)
    ys = np.linspace(0, sh - 1, sh)
    phi_g, theta_g = np.meshgrid(ys * np.pi / sh, np.pi - xs * 2 * np.pi / sw,
                                 indexing="ij")
    a0 = theta_g - np.pi / sw
    a1 = phi_g + np.pi / (sh * 2)
    A = np.stack([np.sin(a1) * np.cos(a0), np.sin(a1) * np.sin(a0),
                  np.cos(a1)], -1).reshape(-1, 3)
    B = A @ R  # R^T applied to each direction
    theta = np.arctan2(np.linalg.norm(B[:, :2], axis=-1), B[:, 2] + 1e-6)
    phi = np.arctan2(B[:, 1], B[:, 0] + 1e-6) + np.pi
    uv = np.stack([2 * (1.0 - phi / (2 * np.pi)) - 1, 2 * (theta / np.pi) - 1],
                  -1)
    return np.around(uv, 3).tobytes()


def rot_grid(cfg: Dict) -> np.ndarray:
    """(K, 3) starting yaw, pitch, roll."""
    ny = cfg["num_yaw"]
    if cfg.get("yaw_only", False):
        rot = np.zeros((ny, 3), np.float32)
        rot[:, 0] = np.arange(ny) * 2 * np.pi / ny
        return rot
    npi, nr = cfg["num_pitch"], cfg["num_roll"]
    g = np.meshgrid(np.arange(ny) / ny, np.arange(npi) / npi,
                    np.arange(nr) / nr, indexing="ij")
    rot = np.stack([a.ravel() for a in g], -1) * 2 * np.pi
    seen, keep = set(), []
    for i, ypr in enumerate(rot):
        key = _fingerprint(ypr, ny, npi)
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return rot[keep].astype(np.float32)


def clamp_box(xyz: np.ndarray, q: float):
    """Per-axis order-quantile box of the cloud."""
    s = np.sort(xyz, axis=0)
    n = xyz.shape[0]
    return s[int(n * q)], s[int(n * (1 - q))]


# ---------------------------------------------------------------------------
# stage 2: block histograms of a splat

_BIN = 32  # ceil(255 / 8): 8 x 8 x 8 colour bins
_NB = 512
_TAPS = ((0, 0, 0), (1, 1, 1), (2, 1, 0), (3, 1, -1), (4, -1, 1), (5, -1, 0),
         (6, -1, -1), (7, 0, 1), (8, 0, -1))


def _bins(v255: torch.Tensor) -> torch.Tensor:
    v = v255.long()
    return v[..., 0] // _BIN + 8 * (v[..., 1] // _BIN) + 64 * (v[..., 2] // _BIN)


def _block_hists(ids, valid, H, W, sh, sw):
    """(sh*sw, 512) counts of ids over the valid pixels of each block."""
    bh, bw = H // sh, W // sw
    ids = ids.reshape(H, W)[: sh * bh, : sw * bw]
    valid = valid.reshape(H, W)[: sh * bh, : sw * bw]
    r = torch.arange(sh * bh, device=ids.device)[:, None] // bh
    c = torch.arange(sw * bw, device=ids.device)[None, :] // bw
    flat = ((r * sw + c) * _NB + ids.clamp(0, _NB - 1))[valid]
    return torch.bincount(flat, minlength=sh * sw * _NB).reshape(
        sh * sw, _NB).double()


def hist_score(img, t, R, xyz, rgb, sh: int, sw: int) -> float:
    """Block-histogram intersection of the query image with a splat of the
    cloud's colour bins at one pose: each point covers its pixel and its 8
    neighbours, the centre before the neighbours, then the nearest point,
    then the lower bin; only the middle block rows count."""
    H, W, _ = img.shape
    img255 = img.float() * 255.0
    q_ok = (img255 != 0).any(-1)
    qh = _block_hists(_bins(img255), q_ok, H, W, sh, sw)
    qc = qh.sum(-1)
    qn = qh / qc.clamp_min(1e-12)[:, None]
    coords, cam = project(t, R, xyz)
    dist = torch.sqrt((cam.float() ** 2).sum(-1))
    px = (coords[..., 0].float() + 1.0) / 2.0 * (W - 1)
    py = (coords[..., 1].float() + 1.0) / 2.0 * (H - 1)
    row0, col0 = torch.floor(py).long(), torch.floor(px).long()
    pb = _bins(rgb.float() * 255.0)
    black = (rgb.float() * 255.0 == 0).all(-1)
    # order: tap priority, then distance, then bin; int64 keys
    dkey = torch.argsort(torch.argsort(dist))  # rank by distance
    n = xyz.shape[0]
    key_base = dkey * (_NB + 1) + torch.where(black, _NB, pb)
    big = (len(_TAPS) + 1) * n * (_NB + 1)
    best = torch.full((H * W,), big, dtype=torch.int64, device=xyz.device)
    for p, dr, dc in _TAPS:
        pix = (row0 + dr).clamp(0, H - 1) * W + (col0 + dc).clamp(0, W - 1)
        best.scatter_reduce_(0, pix, p * n * (_NB + 1) + key_base, "amin")
    won = best < big
    pbin = torch.where(won, best % (_NB + 1), torch.full_like(best, -1))
    in_grid = torch.zeros(H, W, dtype=torch.bool, device=xyz.device)
    in_grid[: sh * (H // sh), : sw * (W // sw)] = True
    ok = (pbin >= 0) & (pbin < _NB) & (q_ok & in_grid).reshape(-1)
    ph = _block_hists(pbin, ok, H, W, sh, sw)
    pc = ph.sum(-1)
    pn = ph / pc.clamp_min(1e-12)[:, None]
    inter = torch.minimum(pn, qn).sum(-1)
    rows = torch.arange(sh * sw, device=xyz.device) // sw
    good = (pc > 0) & (qc > 0) & (rows >= 1) & (rows <= sh - 2)
    return float((inter * good).sum() / (sh * sw))


# ---------------------------------------------------------------------------
# the descent


def descend(img, xyz, rgb, t0, ypr0, lo, hi, num_iter: int, lr: float,
            patience: int, factor: float, dtype=torch.float32):
    """Each start's own Adam and ReduceLROnPlateau; returns the final
    (t (S, 3), ypr (S, 3)) and each start's loss before its last update."""
    dev = xyz.device
    S = t0.shape[0]
    leaves = [[torch.tensor(np.asarray(t0[s]), dtype=dtype, device=dev,
                            requires_grad=True)]
              + [torch.tensor(float(ypr0[s][k]), dtype=dtype, device=dev,
                              requires_grad=True) for k in range(3)]
              for s in range(S)]
    opts = [torch.optim.Adam(ls, lr=lr) for ls in leaves]
    scheds = [torch.optim.lr_scheduler.ReduceLROnPlateau(
        o, mode="min", factor=factor, patience=patience, threshold=1e-4)
        for o in opts]
    lo_t = torch.as_tensor(np.asarray(lo), dtype=dtype, device=dev)
    hi_t = torch.as_tensor(np.asarray(hi), dtype=dtype, device=dev)
    xyz, rgb, img = xyz.to(dtype), rgb.to(dtype), img.to(dtype)
    last = torch.zeros(S, dtype=torch.float64)
    for _ in range(num_iter):
        t = torch.stack([ls[0] for ls in leaves])
        ypr = torch.stack([torch.stack(ls[1:]) for ls in leaves])
        loss = sampling_loss(t, rot_from_ypr(ypr), xyz, rgb, img)
        for o in opts:
            o.zero_grad(set_to_none=True)
        loss.sum().backward()
        vals = loss.detach().double().cpu()
        for s in range(S):
            opts[s].step()
            scheds[s].step(float(vals[s]))
            with torch.no_grad():
                leaves[s][0].copy_(torch.maximum(torch.minimum(
                    leaves[s][0], hi_t), lo_t))
        last = vals
    t = torch.stack([ls[0].detach() for ls in leaves]).float()
    ypr = torch.stack([torch.stack([x.detach() for x in ls[1:]])
                       for ls in leaves]).float()
    return t, ypr, last


# ---------------------------------------------------------------------------
# a whole query


class Room:
    """The reference's copy of one room: the cloud on ``device`` and what
    it derives from it once (grids, clamp box)."""

    def __init__(self, xyz: np.ndarray, rgb: np.ndarray, cfg: Dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.xyz_np = xyz
        self.rgb_np = rgb
        self.xyz = torch.as_tensor(xyz, device=self.device)
        self.rgb = torch.as_tensor(rgb, device=self.device)
        self.trans = trans_grid(xyz, cfg)
        self.rot = rot_grid(cfg)
        self.lo, self.hi = clamp_box(xyz, cfg.get("out_of_room_quantile",
                                                  0.05))

    def prepare(self, img_u8: np.ndarray):
        """(init image, main image, cloud colours) of a query, as PICCOLO
        prepares them: OmniScenes matches colours (and requantises), then
        sharpens; Stanford sharpens the init image and the cloud only."""
        cfg = self.cfg
        img = torch.as_tensor(img_u8, device=self.device)
        rgb = self.rgb
        omni = "mni" in cfg["dataset"]
        if omni and cfg.get("match_color", False):
            img = match_color(img, rgb)
        f = img.float() / 255.0
        init, main = f, f
        if cfg.get("sharpen_color", False):
            sharp, rgb = sharpen_color(f, rgb)
            init = sharp
            if omni:
                main = init = _trunc255(sharp).to(torch.uint8).float() / 255.0
        return init, main, rgb

    def scores(self, img, rgb, dtype=torch.float32, block: int = 16):
        """Stage 1: every pair's loss, translation-major."""
        t = torch.as_tensor(self.trans, device=self.device)
        ypr = torch.as_tensor(self.rot, device=self.device)
        R = rot_from_ypr(ypr)
        T, K = t.shape[0], R.shape[0]
        pt = t.repeat_interleave(K, 0).to(dtype)
        pR = R.repeat(T, 1, 1).to(dtype)
        xyz, rgb_d, img_d = self.xyz.to(dtype), rgb.to(dtype), img.to(dtype)
        return torch.cat([sampling_loss(pt[i:i + block], pR[i:i + block],
                                        xyz, rgb_d, img_d).float()
                          for i in range(0, pt.shape[0], block)])

    def localize(self, img_u8: np.ndarray, dtype=torch.float32):
        """The whole query: returns dict(t, R, loss) of the winner and the
        main image and colours its loss is judged on."""
        cfg = self.cfg
        init, main, rgb = self.prepare(img_u8)
        K = self.rot.shape[0]
        with torch.no_grad():
            s = self.scores(init, rgb, dtype)
            k1 = min(cfg["num_intermediate"], s.shape[0])
            idx1 = torch.sort(s, stable=True).indices[:k1].cpu().numpy()
            t1 = self.trans[idx1 // K]
            r1 = self.rot[idx1 % K]
            hs = []
            for i in range(k1):
                ti = torch.as_tensor(t1[i], device=self.device).to(dtype)
                Ri = rot_from_ypr(torch.as_tensor(
                    r1[i], device=self.device)).to(dtype)
                hs.append(hist_score(init.to(dtype), ti, Ri,
                                     self.xyz.to(dtype), rgb,
                                     cfg["num_split_h"], cfg["num_split_w"]))
        k2 = min(cfg["num_input"], k1)
        idx2 = torch.sort(-torch.tensor(hs, dtype=torch.float64),
                          stable=True).indices[:k2].numpy()
        t, ypr, loss = descend(main, self.xyz, rgb, t1[idx2], r1[idx2],
                               self.lo, self.hi, cfg["num_iter"], cfg["lr"],
                               cfg["patience"], cfg["factor"], dtype)
        w = int(torch.argmin(loss))
        R = rot_from_ypr(ypr[w:w + 1].to(self.device))[0]
        return dict(t=t[w].cpu().numpy(), R=R.cpu().numpy(),
                    loss=float(loss[w]), main=main, rgb=rgb)

    def track(self, img_u8: np.ndarray, prev_t, prev_ypr,
              dtype=torch.float32, main=None, rgb=None):
        """One tracked frame: the single-start descent from the previous
        pose with the tracking budget."""
        cfg = self.cfg
        if main is None:
            _, main, rgb = self.prepare(img_u8)
        t, ypr, loss = descend(
            main, self.xyz, rgb, np.asarray(prev_t, np.float32)[None],
            np.asarray(prev_ypr, np.float32)[None], self.lo, self.hi,
            cfg.get("track_num_iter", 30), cfg.get("track_lr", 0.03),
            cfg.get("track_patience", 3), cfg.get("track_factor", 0.5),
            dtype)
        R = rot_from_ypr(ypr.to(self.device))[0]
        return dict(t=t[0].cpu().numpy(), R=R.cpu().numpy(),
                    loss=float(loss[0]), main=main, rgb=rgb)

    def loss_of(self, t, R, main, rgb) -> float:
        """The f32 loss of a pose (t, R) on a prepared main image."""
        return pose_loss(t, R, self.xyz, rgb, main.float())


def regret(answer_loss: float, reference_loss: float) -> float:
    """How far an answer's loss lies above the reference's answer, as a
    share of the reference's."""
    return (answer_loss - reference_loss) / max(reference_loss, 1e-12)


def ypr_of(R: np.ndarray) -> Tuple[float, float, float]:
    """yaw, pitch, roll of R = RZ @ RY @ RX."""
    R = np.asarray(R, np.float64)
    pitch = math.asin(max(-1.0, min(1.0, -R[2, 0])))
    yaw = math.atan2(R[1, 0], R[0, 0])
    roll = math.atan2(R[2, 1], R[2, 2])
    return yaw, pitch, roll


def main_image_only(room: Room, img_u8: np.ndarray):
    """The main image and colours a tracked or full answer is judged on."""
    _, main, rgb = room.prepare(img_u8)
    return main, rgb


__all__ = ["Room", "regret", "sampling_loss", "pose_loss", "rot_from_ypr",
           "match_color", "sharpen_color", "hist_score", "descend", "ypr_of",
           "main_image_only", "trans_grid", "rot_grid", "clamp_box"]

