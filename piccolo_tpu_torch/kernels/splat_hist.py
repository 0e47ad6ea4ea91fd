"""Stage 2's live splat, straight to per-block colour counts.

A candidate pose's stage-2 score needs the 512-bin colour histograms of the
sh x sw blocks of the cloud rendered at that pose (a z-buffered splat of
each point's colour bin with the reference's 9-tap dilation,
``ops/pano.py``).  :func:`splat_block_counts_plain` computes them as the
port always has: the render's per-pixel winner bins in device memory
(:func:`splat_bins`), laid out by block (:func:`bin_rows`) and counted by
``block_histogram_plain``.  :func:`splat_block_counts` launches two
hand-written CUDA kernels instead (``csrc/splat_hist.cu``):

  * ``splat_keys``: a chunk of candidates' centre-tap z-buffers, one int32
    atomicMin a point and candidate, the keys packed and the projection
    computed with the plain version's bits;
  * ``dilate_block_hist``: the 9-tap dilation, the bin decode and the
    block histograms, fused per (candidate, block tile), into shared
    counters.

Added, with no TPU counterpart: the JAX package's splat is an XLA
scatter-min (no Pallas kernel).  The counts are integers and equal the
plain version's bit for bit.  The wrapper takes the plain version only for
tensors on the CPU; a CUDA tensor launches the kernels or raises.
``splat_block_counts.launches`` counts calls on the card, each of which
launches the pair once a chunk (a fill of the chunk's z-buffers before
it: three launches a chunk).

Who takes which (``init/refine.py``): ``hist_scores_core``, the live-splat
route of the one-device query, takes :func:`splat_block_counts`; a
HistPlan's build, the mesh's stage 2 (which takes the min of the shards'
keys before decoding) and ``render_attr_min`` keep the plain splat.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..loss import Pose, transform_cloud
from ..ops.pano import attr_min_decode, attr_min_keys
from ..ops.rotation import rot_from_ypr
from ._build import count_launch, load_library, on_device
from .block_histogram import block_histogram_plain

__all__ = ["splat_block_counts", "splat_block_counts_plain", "splat_keys",
           "splat_bins", "bin_rows", "block_rows", "ATTR_BITS", "NUM_BINS"]

ATTR_BITS = 10  # bins 0..512, the background sentinel included
NUM_BINS = 512  # the (8, 8, 8) colour bins; 512 is a black point's
_EMPTY = (1 << 28) - 1  # attr_min_keys_from_pixels' empty key (sent28)
_GRID_MAX = 65535  # CUDA's limit on a grid's y and z


def splat_keys(xyz, bins, trans, ypr, point_mask, height: int, width: int):
    """(k, H*W) packed z-buffer keys of the cloud's colour bins rendered at
    k poses; a min over a split cloud's keys is the whole cloud's."""
    pose = Pose(t=trans, yaw=ypr[:, 0], pitch=ypr[:, 1], roll=ypr[:, 2])
    cam = transform_cloud(pose, xyz)
    return attr_min_keys(cam, bins, ATTR_BITS, (height, width), point_mask)


def splat_bins(xyz, bins, trans, ypr, point_mask, height: int, width: int):
    """(k, H*W) winner colour bins of the cloud rendered at k poses (-1
    where no point splats)."""
    return attr_min_decode(
        splat_keys(xyz, bins, trans, ypr, point_mask, height, width),
        ATTR_BITS)


def block_rows(flat: torch.Tensor, height: int, width: int, sh: int,
               sw: int) -> torch.Tensor:
    """(k, H*W) per-pixel values -> (k, sh*sw, bh*bw), block (i, j) of bh =
    H // sh rows and bw = W // sw columns at i * sw + j; pixels outside the
    grid are dropped."""
    k = flat.shape[0]
    bh, bw = height // sh, width // sw
    return (flat.reshape(k, height, width)[:, :sh * bh, :sw * bw]
            .reshape(k, sh, bh, sw, bw)
            .permute(0, 1, 3, 2, 4)
            .reshape(k, sh * sw, bh * bw))


def bin_rows(pbin: torch.Tensor, pix_ok: torch.Tensor, height: int,
             width: int, sh: int, sw: int):
    """The (k * sh*sw, bh*bw) int32 ids and f32 mask rows whose block
    histograms are the counts of (k, H*W) winner bins: a pixel counts where
    its bin lies in [0, 512) and ``pix_ok`` (H*W,) is set."""
    k = pbin.shape[0]
    valid = (pbin >= 0) & (pbin < NUM_BINS) & pix_ok
    ids = block_rows(pbin.clamp(0, NUM_BINS - 1).to(torch.int32), height,
                     width, sh, sw)
    msk = block_rows(valid.to(torch.float32), height, width, sh, sw)
    return (ids.reshape(k * sh * sw, -1).contiguous(),
            msk.reshape(k * sh * sw, -1).contiguous())


def splat_block_counts_plain(xyz, bins, trans, ypr, point_mask, pix_ok,
                             height: int, width: int, sh: int, sw: int,
                             chunk: int) -> torch.Tensor:
    """(k, sh*sw, 512) f32 block counts of the cloud's colour bins rendered
    at k poses, ``chunk`` poses at a time; see :func:`bin_rows`."""
    k = trans.shape[0]
    counts = [
        block_histogram_plain(*bin_rows(
            splat_bins(xyz, bins, trans[c:c + chunk], ypr[c:c + chunk],
                       point_mask, height, width),
            pix_ok, height, width, sh, sw), NUM_BINS)
        for c in range(0, k, chunk)
    ]
    return torch.cat(counts).reshape(k, sh * sw, NUM_BINS)


@functools.cache
def _library():
    lib = load_library("splat_hist")
    lib.splat_keys_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_longlong, ctypes.c_void_p])
    lib.splat_keys_launch.restype = ctypes.c_int
    lib.dilate_block_hist_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    lib.dilate_block_hist_launch.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"splat_block_counts {what} failed: CUDA error "
                           f"{err}")


def _check_inputs(xyz, bins, trans, ypr, point_mask, pix_ok, height, width,
                  sh, sw, chunk) -> None:
    dev = xyz.device
    n, k = xyz.shape[0], trans.shape[0]
    want = ((xyz, torch.float32, (n, 3)), (bins, torch.int32, (n,)),
            (point_mask, torch.bool, (n,)), (trans, torch.float32, (k, 3)),
            (ypr, torch.float32, (k, 3)),
            (pix_ok, torch.bool, (height * width,)))
    for a, dtype, shape in want:
        if a is None:
            continue
        if (a.dtype != dtype or a.device != dev or not a.is_contiguous()
                or tuple(a.shape) != shape):
            raise ValueError(f"splat_block_counts needs a contiguous {dtype} "
                             f"{shape} on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if not (0 < sh <= height and 0 < sw <= width):
        raise ValueError(f"a {sh} x {sw} block grid does not fit {height} x "
                         f"{width} pixels")
    if sh * sw > _GRID_MAX or not 0 < chunk <= _GRID_MAX:
        raise ValueError(f"{sh * sw} blocks and chunks of {chunk} must each "
                         f"be in (0, {_GRID_MAX}]")
    if n >= 2**31 or chunk * height * width >= 2**62:
        raise ValueError("the cloud or the chunk's buffer is too large")


def splat_block_counts(xyz, bins, trans, ypr, point_mask, pix_ok,
                       height: int, width: int, sh: int, sw: int,
                       chunk: int) -> torch.Tensor:
    """(k, sh*sw, 512) f32 block counts of the (N, 3) cloud ``xyz``'s (N,)
    int32 colour ``bins`` rendered at the k poses ``trans`` / ``ypr`` (k,
    3), the points where ``point_mask`` is False left out; see
    :func:`splat_block_counts_plain`.  On the card the kernel pair, once a
    chunk of ``chunk`` poses (a (chunk, H*W) int32 buffer); on the CPU the
    plain version."""
    if xyz.device.type == "cpu":
        return splat_block_counts_plain(xyz, bins, trans, ypr, point_mask,
                                        pix_ok, height, width, sh, sw, chunk)
    if xyz.device.type != "cuda":
        raise ValueError(f"unsupported device {xyz.device}")
    _check_inputs(xyz, bins, trans, ypr, point_mask, pix_ok, height, width,
                  sh, sw, chunk)
    dev = xyz.device
    k, n = trans.shape[0], xyz.shape[0]
    nb = sh * sw
    if n == 0:  # no point splats: every count is 0
        return torch.zeros((k, nb, NUM_BINS), dtype=torch.float32, device=dev)
    # the plain version's rotation, in its own PyTorch ops
    rot = rot_from_ypr(ypr).reshape(k, 9).contiguous()
    counts = torch.empty((k, nb, NUM_BINS), dtype=torch.float32, device=dev)
    lib = _library()
    mask = None if point_mask is None else point_mask.data_ptr()
    with on_device(dev) as stream:
        for c in range(0, k, chunk):
            kc = min(chunk, k - c)
            keys = torch.full((kc, height * width), _EMPTY,
                              dtype=torch.int32, device=dev)
            _check(lib.splat_keys_launch(
                xyz.data_ptr(), bins.data_ptr(), mask, n, rot[c].data_ptr(),
                trans[c].data_ptr(), kc, height, width, keys.data_ptr(),
                counts[c].data_ptr(), kc * nb * NUM_BINS, stream),
                "splat_keys launch")
            _check(lib.dilate_block_hist_launch(
                keys.data_ptr(), pix_ok.data_ptr(), kc, height, width, sh,
                sw, counts[c].data_ptr(), stream), "dilate_block_hist launch")
    count_launch(splat_block_counts, dev)
    return counts


splat_block_counts.launches, splat_block_counts.by_card = 0, {}
