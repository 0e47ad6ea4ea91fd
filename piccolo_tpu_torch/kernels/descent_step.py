"""The descent's step as two hand-written CUDA kernels.

Added, with no TPU counterpart: the JAX package's descent is an XLA gather
under ``jax.grad`` and has no Pallas kernel.  ``csrc/descent_step.cu``
computes one iteration of ``solver._make_step``'s step on a packed table:

  * ``descent_partials``: one pass over the cloud for every start (or each
    of K streams stacked through ``row_offset``).  Each start-point's
    projection, texel row, bilinear sample, validity and colour distance,
    and the distance's analytic gradient in the camera frame g, go into 14
    sums a start: the distance total, the valid count, sum g and sum g c^T
    (c = x - t), one partial a block;
  * ``descent_update``: one block a start adds the partials in a fixed
    order, forms the loss (``masked_mean``: +inf and no gradient where a
    start samples nothing) and its gradient by t, yaw, pitch and roll,
    then ``optim.adam_plateau_step``'s transition and the translation
    clamp, written in place into the step's 16 state leaves and its loss.

:func:`descent_step` launches the pair; the plain PyTorch version of the
same function is :func:`partials_plain` (the 14 sums) and
:func:`update_plain` (:func:`pose_gradient`, then Adam + plateau + clamp in
:func:`tail_plain`); :func:`descent_step_plain` chains them.  The
wrapper takes the plain version only for tensors on the CPU; a CUDA tensor
launches the kernels or raises.  ``descent_step.launches`` counts calls
(each launches the pair) made eagerly or while a graph is captured, not a
captured graph's replays.

Where the solver takes it (:func:`engages`): the card's single-device
step, graphed or eager, on one cloud ((N, 3)) and (S, 3) starts, any table
dtype (f32, bf16, uint8), wrap or not, masked or not, stacked or not.  The
autograd step stays on the CPU (where the JAX parity tests hold its bits),
under anomaly detection (``debug_nans``), for an (R, N, 3) stack of rooms,
and in the mesh's ``_shard_step`` / ``_combine_step``; the partials are
what a mesh shard reports, so the mesh could take the first kernel too.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..loss import Pose, masked_mean, transform_cloud
from ..ops.projection import safe_norm, spherical_project, sum_sq
from ..ops.rotation import matmul33, rot_from_ypr, rot_x, rot_y, rot_z
from ..ops.sampling import packed_rows_and_weights
from ..optim import _BETA1, _BETA2, _EPS, _LR_EPS, _THRESHOLD
from ._build import count_launch, load_library, on_device

__all__ = ["descent_step", "descent_step_plain", "descent_partials",
           "partials_plain", "pose_gradient", "update_plain", "tail_plain",
           "engages",
           "scratch", "SUMS"]

SUMS = 14  # total, count, sum g (3), sum g c^T (9)
_TABLES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_ALIGN = {torch.float32: 16, torch.bfloat16: 8, torch.uint8: 4}
# the state leaves' dtypes, in solver._state_leaves' order
_LEAF_DTYPES = (torch.float32,) * 12 + (torch.int32, torch.float32,
                                        torch.float32, torch.int32)


def _broadcasts(box: torch.Tensor, t) -> bool:
    """Whether ``box`` broadcasts to ``t``'s shape.  Plain Python:
    ``torch.broadcast_shapes`` imports sympy (seconds) at its first call."""
    return box.dim() <= t.dim() and all(
        b in (1, n) for b, n in zip(reversed(box.shape), reversed(t.shape)))


def engages(x, t: torch.Tensor) -> bool:
    """Whether the step of inputs ``x`` (``solver.StepInputs``) at starts
    ``t`` runs the kernels: on a card, outside anomaly detection, for one
    cloud and (S, 3) starts on a packed 12-texel table of a dtype the
    kernel reads, each start's table offset (if any) one value."""
    if t.device.type != "cuda" or torch.is_anomaly_enabled():
        return False
    return (t.dim() == 2 and t.shape[1] == 3
            and x.xyz.dim() == 2 and x.xyz.shape[1] == 3
            and x.rgb.shape == x.xyz.shape
            and x.blocks.dim() == 2 and x.blocks.shape[1] == 12
            and x.blocks.dtype in _TABLES
            and (x.point_mask is None
                 or x.point_mask.shape == x.xyz.shape[:1])
            and (x.row_offset is None or x.row_offset.numel() == t.shape[0])
            and _broadcasts(x.lo, t) and _broadcasts(x.hi, t))


# ---------------------------------------------------------------------------
# the plain version


def _sample(blocks: torch.Tensor, row: torch.Tensor, wx1, wy1):
    """(sampled (..., 3), the texels in f32 (..., 12), wx0, wy0) as
    ``ops.sampling.bilinear_sample_packed`` computes the sample."""
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    g = blocks[row.to(torch.int64)]
    if g.dtype == torch.uint8:
        g = g.to(torch.float32) * (1.0 / 255.0)
    sampled = (g[..., 0:3] * (wx0 * wy0)[..., None]
               + g[..., 3:6] * (wx1 * wy0)[..., None]
               + g[..., 6:9] * (wx0 * wy1)[..., None]
               + g[..., 9:] * (wx1 * wy1)[..., None])
    return sampled, g.to(torch.float32), wx0, wy0


def partials_plain(x, s, t, yaw, pitch, roll) -> torch.Tensor:
    """(S, 14) f32 sums of every start over the whole cloud: [distance
    total, valid count, sum g (3), sum g c^T (9, row-major)], g the colour
    distance's gradient by the camera-frame point and c = x - t.  The
    forward is the loss's own code (``loss.sampling_partials_packed``), so
    on one device its total and count are the autograd step's."""
    pose = Pose(t, yaw, pitch, roll)
    H, W = s.height, s.width
    c = x.xyz - t[:, None, :]
    xc = transform_cloud(pose, x.xyz)
    coords = spherical_project(xc)
    row, wx1, wy1 = packed_rows_and_weights(coords, H, W, True, s.wrap)
    if x.row_offset is not None:
        row = row + x.row_offset.reshape(-1, 1)
    sampled, g, wx0, wy0 = _sample(x.blocks, row, wx1, wy1)
    valid = (sampled == 0.0).sum(-1) != 3
    if x.point_mask is not None:
        valid = valid & x.point_mask
    d = sampled - x.rgb
    dist = safe_norm(d)
    total = (dist * valid).sum(-1)
    count = valid.sum(-1)

    # the gradient: safe_norm's is 0 at the origin, and an invalid point
    # gives none
    live = valid & (sum_sq(d) > 0)
    gs = d / torch.where(live, dist, torch.ones_like(dist))[..., None]
    dwx = (wy0[..., None] * (g[..., 3:6] - g[..., 0:3])
           + wy1[..., None] * (g[..., 9:12] - g[..., 6:9]))
    dwy = (wx0[..., None] * (g[..., 6:9] - g[..., 0:3])
           + wx1[..., None] * (g[..., 9:12] - g[..., 3:6]))
    gwx = _dot3(gs, dwx)
    gwy = _dot3(gs, dwy)
    # floor passes nothing, the wrap's remainder 1, the clamp its interval
    u, v = coords[..., 0], coords[..., 1]
    gu = gwx * (W * 0.5)
    if not s.wrap:
        gu = torch.where((u >= -0.99) & (u <= 0.99), gu, 0.0)
    gv = torch.where((v >= -0.99) & (v <= 0.99), gwy * (H * 0.5), 0.0)
    gphi = gu * (-1.0 / math.pi)
    gtheta = gv * (2.0 / math.pi)
    xcx, ycy, zcz = xc[..., 0], xc[..., 1], xc[..., 2]
    rho = safe_norm(xc[..., :2])
    xx = xcx + 1e-6
    zz = zcz + 1e-6
    rphi = 1.0 / (xx * xx + ycy * ycy)
    rtheta = 1.0 / (rho * rho + zz * zz)
    pos = sum_sq(xc[..., :2]) > 0
    grho = torch.where(pos, zz * gtheta * rtheta
                       / torch.where(pos, rho, torch.ones_like(rho)), 0.0)
    gx = -ycy * gphi * rphi + grho * xcx
    gy = xx * gphi * rphi + grho * ycy
    gz = -rho * gtheta * rtheta
    gcam = torch.where(live[..., None], torch.stack([gx, gy, gz], -1), 0.0)
    sum_g = gcam.sum(-2)
    sum_gc = (gcam[..., :, None] * c[..., None, :]).sum(-3).reshape(-1, 9)
    return torch.cat([total[:, None], count.to(torch.float32)[:, None],
                      sum_g, sum_gc], 1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel dot product of (..., 3) tensors, added left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _stack_rows(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rotation_derivatives(ypr: torch.Tensor):
    """dR/dyaw, dR/dpitch, dR/droll of R = RZ @ RY @ RX, each (..., 3, 3)."""
    a, b, c = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    o = torch.zeros_like(a)
    dz = _stack_rows([[-torch.sin(a), -torch.cos(a), o],
                      [torch.cos(a), -torch.sin(a), o], [o, o, o]])
    dy = _stack_rows([[-torch.sin(b), o, torch.cos(b)], [o, o, o],
                      [-torch.cos(b), o, -torch.sin(b)]])
    dx = _stack_rows([[o, o, o], [o, -torch.sin(c), -torch.cos(c)],
                      [o, torch.cos(c), -torch.sin(c)]])
    Z, Y, X = rot_z(a), rot_y(b), rot_x(c)
    return (matmul33(matmul33(dz, Y), X), matmul33(matmul33(Z, dy), X),
            matmul33(matmul33(Z, Y), dx))


def pose_gradient(sums: torch.Tensor, t, yaw, pitch, roll):
    """The loss and its gradient by (t, yaw, pitch, roll) from (S, 14)
    sums: ``masked_mean`` of total and count, d/dt = -R^T sum g / count,
    d/dangle = sum_jk (sum g c^T)_jk (dR/dangle)_jk / count, and zeros
    where the count is 0."""
    count = sums[:, 1].to(torch.int64)
    loss = masked_mean(sums[:, 0], count)
    ypr = torch.stack([yaw, pitch, roll], -1)
    R = rot_from_ypr(ypr)
    cf = count.to(torch.float32)
    sg = sums[:, 2:5]
    g_t = -(R[:, 0, :] * sg[:, 0:1] + R[:, 1, :] * sg[:, 1:2]
            + R[:, 2, :] * sg[:, 2:3]) / cf[:, None]
    sgc = sums[:, 5:14]
    angles = []
    for dR in _rotation_derivatives(ypr):
        flat = dR.reshape(-1, 9)
        acc = sgc[:, 0] * flat[:, 0]
        for e in range(1, 9):
            acc = acc + sgc[:, e] * flat[:, e]
        angles.append(acc / cf)
    has = count > 0
    g_t = torch.where(has[:, None], g_t, 0.0)
    angles = [torch.where(has, a, 0.0) for a in angles]
    return loss, Pose(g_t, *angles)


def update_plain(sums: torch.Tensor, leaves, lo, hi, patience: int,
                 factor: float):
    """The new 16 state leaves and the loss from the (S, 14) sums: the
    loss and gradient of :func:`pose_gradient`, then :func:`tail_plain`."""
    loss, grads = pose_gradient(sums, *leaves[0:4])
    return tail_plain(leaves, grads, loss, lo, hi, patience, factor), loss


def tail_plain(leaves, grads: Pose, loss: torch.Tensor, lo, hi,
               patience: int, factor: float):
    """The new 16 state leaves: ``optim.adam_plateau_step``'s transition
    on each start's six pose values as the kernel computes it, then the
    translation clamp."""
    count, lr, best, num_bad = leaves[12:16]

    def six(a, b, c, d):
        return torch.cat([a, b[:, None], c[:, None], d[:, None]], 1)

    p = six(*leaves[0:4])
    m = six(*leaves[4:8])
    v = six(*leaves[8:12])
    g = six(*grads.leaves())
    count = count + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(_BETA1, cf)
    bc2 = 1.0 - torch.pow(_BETA2, cf)
    m = _BETA1 * m + (1 - _BETA1) * g
    v = _BETA2 * v + (1 - _BETA2) * g * g
    step_size = lr / bc1
    sqrt_bc2 = torch.sqrt(bc2)
    p = p - step_size[:, None] * m / (torch.sqrt(v) / sqrt_bc2[:, None]
                                      + _EPS)
    is_better = loss < best * (1.0 - _THRESHOLD)
    best = torch.where(is_better, loss, best)
    num_bad = torch.where(is_better, torch.zeros_like(num_bad), num_bad + 1)
    reduce = num_bad > patience
    cand_lr = lr * factor
    lr = torch.where(reduce & (lr - cand_lr > _LR_EPS), cand_lr, lr)
    num_bad = torch.where(reduce, torch.zeros_like(num_bad), num_bad)
    t = torch.clamp(p[:, 0:3], lo, hi)

    def split(a):
        return [a[:, 0:3], a[:, 3], a[:, 4], a[:, 5]]

    return [t, *split(p)[1:], *split(m), *split(v), count, lr, best, num_bad]


def descent_step_plain(x, s, leaves):
    """One step in plain PyTorch: (the new 16 leaves, the loss)."""
    sums = partials_plain(x, s, *leaves[0:4])
    return update_plain(sums, leaves, x.lo, x.hi, s.patience, s.factor)


# ---------------------------------------------------------------------------
# the kernels


@functools.cache
def _library():
    lib = load_library("descent_step")
    lib.descent_partials_blocks.argtypes = [ctypes.c_int]
    lib.descent_partials_blocks.restype = ctypes.c_int
    lib.descent_partials_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.descent_partials_launch.restype = ctypes.c_int
    lib.descent_update_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_void_p])
    lib.descent_update_launch.restype = ctypes.c_int
    return lib


def scratch(n: int, starts: int, device) -> torch.Tensor:
    """The partials buffer a step of ``starts`` starts over ``n`` points
    writes: (starts, 14, blocks) f32."""
    blocks = _library().descent_partials_blocks(int(n))
    return torch.empty((starts, SUMS, blocks), dtype=torch.float32,
                       device=device)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"descent_step {what} failed: CUDA error {err}")


def _check_inputs(x, leaves, loss, partials) -> None:
    t = leaves[0]
    S = t.shape[0]
    dev = t.device
    if t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"starts' t must be (S, 3), got {tuple(t.shape)}")
    for a, dtype in zip((*leaves, loss), _LEAF_DTYPES + (torch.float32,)):
        if a.dtype != dtype or a.device != dev or not a.is_contiguous():
            raise ValueError(f"state leaves must be contiguous {dtype} on "
                             f"{dev}, got {a.dtype} {tuple(a.shape)}")
        if a.shape[0] != S:
            raise ValueError("every state leaf must lead with the starts")
    N = x.xyz.shape[0]
    inputs = ((x.xyz, torch.float32, (N, 3)), (x.rgb, torch.float32, (N, 3)),
              (x.point_mask, torch.bool, (N,)),
              (x.row_offset, torch.int32, None))
    for a, dtype, shape in inputs:
        if a is None:
            continue
        if (a.dtype != dtype or a.device != dev or not a.is_contiguous()
                or (shape is not None and tuple(a.shape) != shape)):
            raise ValueError(f"step input must be contiguous {dtype} "
                             f"{shape} on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if x.row_offset is not None and x.row_offset.numel() != S:
        raise ValueError("row_offset must give one offset a start")
    b = x.blocks
    if (b.dtype not in _TABLES or b.dim() != 2 or b.shape[1] != 12
            or b.device != dev or not b.is_contiguous()
            or b.data_ptr() % _ALIGN[b.dtype]):
        raise ValueError(f"the table must be a contiguous, aligned (rows, 12) "
                         f"f32, bf16 or uint8 tensor on {dev}, got {b.dtype} "
                         f"{tuple(b.shape)}")
    for box in (x.lo, x.hi):
        if (box.dtype != torch.float32 or box.device != dev
                or not _broadcasts(box, t)):
            raise ValueError("the clamp box must be f32 on the starts' "
                             "device and broadcast against (S, 3)")
    if (partials.dtype != torch.float32 or partials.device != dev
            or not partials.is_contiguous()
            or tuple(partials.shape[:2]) != (S, SUMS)
            or partials.shape[2] != _library().descent_partials_blocks(N)):
        raise ValueError("partials must be scratch(n, starts, device)")


def _launch_partials(x, s, leaves, partials) -> None:
    b = x.blocks
    pose = (ctypes.c_void_p * 4)(*(a.data_ptr() for a in leaves[0:4]))
    with on_device(leaves[0].device) as stream:
        err = _library().descent_partials_launch(
            x.xyz.data_ptr(), x.rgb.data_ptr(),
            None if x.point_mask is None else x.point_mask.data_ptr(),
            x.xyz.shape[0], b.data_ptr(), _TABLES[b.dtype], b.shape[0],
            s.height, s.width, int(s.wrap), pose,
            None if x.row_offset is None else x.row_offset.data_ptr(),
            leaves[0].shape[0], partials.data_ptr(), stream)
    _check(err, "partials launch")


def descent_partials(x, s, leaves, partials) -> torch.Tensor:
    """Launch ``descent_partials`` alone: ``partials`` ((S, 14, blocks),
    :func:`scratch`) holds each block's sums, whose total over the blocks
    is :func:`partials_plain`'s."""
    _check_inputs(x, leaves, torch.empty_like(leaves[1]), partials)
    _launch_partials(x, s, leaves, partials)
    return partials


def descent_step(x, s, leaves, loss: torch.Tensor,
                 partials: torch.Tensor) -> None:
    """One step in place: ``leaves`` (``solver._state_leaves``: t, yaw,
    pitch, roll, Adam's m and v of each, count, lr, best, num_bad) become
    the next state and ``loss`` the loss at the poses before the update.
    ``x``: ``solver.StepInputs``; ``s``: ``solver.StepStatics``;
    ``partials``: :func:`scratch`.  On the CPU the plain version."""
    if leaves[0].device.type == "cpu":
        new, value = descent_step_plain(x, s, leaves)
        for dst, src in zip(leaves, new):
            dst.copy_(src)
        loss.copy_(value)
        return
    _check_inputs(x, leaves, loss, partials)
    t = leaves[0]
    _launch_partials(x, s, leaves, partials)
    lo = torch.broadcast_to(x.lo, t.shape)
    hi = torch.broadcast_to(x.hi, t.shape)
    state = (ctypes.c_void_p * 17)(*(a.data_ptr() for a in (*leaves, loss)))
    with on_device(t.device) as stream:
        err = _library().descent_update_launch(
            partials.data_ptr(), partials.shape[2], state, lo.data_ptr(),
            hi.data_ptr(), lo.stride(0), lo.stride(1), hi.stride(0),
            hi.stride(1), t.shape[0], int(s.patience), float(s.factor),
            stream)
    _check(err, "update launch")
    count_launch(descent_step, t.device)


descent_step.launches, descent_step.by_card = 0, {}
