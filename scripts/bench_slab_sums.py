#!/usr/bin/env python3
"""Time the slab group-sum kernels (f32, compact and q8 plans) and the
masked histogram on one NVIDIA GPU: against older sources, and apart by
what they spend.

    python3 scripts/bench_slab_sums.py [--old OLD.cu] [--old-hist OLD.cu]
        [--layouts f32,compact,q8] [--out FILE.json]

``--old`` is a copy of an earlier ``csrc/slab_sampling.cu`` with the
per-block f32 kernel (``slab_partials_launch``) and the compact and q8
group-sum kernels (``slab_sums_launch``, layout 0 or 1); ``--old-hist`` an
earlier ``csrc/masked_histogram.cu`` (``masked_histogram_launch`` into a
zeroed output).  Both are built with the port's nvcc flags and timed
against the current kernels in turns (ABBA order each round).  Device-time
medians in ms (CUDA events, the host put ahead of the card by a sleep
kernel):
  * f32: group 0 of the library room's plan (chip_smoke.py phase 3, window
    128, block 1024) and of an f32 plan at the CLI's shapes (run D's,
    window 256, block 512): the old kernel and its sum, the new kernel
    with the plan's targets (the main path's call) and, at the CLI's
    shapes, with the colours re-baked in the kernel, against the route of
    a re-bake into a copy of the group;
  * compact and q8: group 0 of the plans chip_smoke.py's phase 9 builds
    (point ids in tps): old and new kernel, fused and unfused, and the
    gather re-bake alone; grid sizes and chunk lengths; the plan cut to its
    blocks with a real slot 0 (the probes' share);
  * for every layout, variants built from the current source with one part
    taken out or changed: the warp's aggregation of lanes that share a pair
    (each lane adds alone), the table of quotients by 255, the window
    restages, the pair-slot adds, the scoring (streams, probes and staging
    only), an f32 read-ahead (the next block's first three rows, or all),
    and caps of 64 and 80 registers a thread; each also at one CTA an SM,
    where the time is the CTA's chain of latencies; the window restages the
    walk makes;
  * the masked histogram at N = 524,288 and 8,388,608, old and new, beside
    an empty kernel.
Needs CUDA; writes the numbers as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from piccolo_tpu_torch.kernels import _build  # noqa: E402
from piccolo_tpu_torch.kernels import slab_sampling as slab  # noqa: E402
from piccolo_tpu_torch.kernels.histogram import (  # noqa: E402
    masked_histogram_counts,
    masked_histogram_counts_plain,
)

SRC = os.path.join(ROOT, "piccolo_tpu_torch", "kernels", "csrc",
                   "slab_sampling.cu")
CODES = {"compact": slab._COMPACT, "q8": slab._Q8, "f32": slab._F32}
MATCH = "    const unsigned peers = __match_any_sync(kFull, ok ? cid : kGroup);\n"
ADDS = (MATCH + """    stage[lane] = loss;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) {
        float sum = 0.0f;
        for (unsigned m = peers; m != 0u; m &= m - 1) {
            sum += stage[__ffs(m) - 1];
        }
        wacc[cid] += sum;
        wcnt[cid] += __popc(peers);
    }
    __syncwarp();
""")
LUT = ("    *tr = q255[(p >> 16) & 0xFF];\n    *tg = q255[(p >> 8) & 0xFF];\n"
       "    *tb = q255[p & 0xFF];\n")
RESTAGE = "        if (nxt >= 0 && nwin != win) {\n"
SCORING = ("            score4<L, kPid>(now, live, tab, window, palette, n_pal, "
           "q255,\n                            wacc, wcnt, stage + warp * "
           "32);\n")
BOUNDS = "__global__ void __launch_bounds__(kSumThreads)\n"
AHEAD = "constexpr int kF32AheadRows = 0;\n"
# each variant: (text in the source, its replacement), ...
VARIANTS = {
    # every lane adds alone (racy where lanes share a pair): no match_any
    "no_aggregation": ((MATCH, "    const unsigned peers = 1u << lane;\n"),),
    # no pair slots at all: the losses are only kept live
    "no_adds": ((ADDS, "    if (ok && loss == -12345.0f) wacc[cid] = loss;\n"),),
    # the three IEEE divisions by 255 instead of the quotient table
    "no_lut": ((LUT, "    *tr = __fdiv_rn(static_cast<float>((p >> 16) & 0xFF), "
                     "255.0f);\n"
                     "    *tg = __fdiv_rn(static_cast<float>((p >> 8) & 0xFF), "
                     "255.0f);\n"
                     "    *tb = __fdiv_rn(static_cast<float>(p & 0xFF), 255.0f);"
                     "\n"),),
    # at most 64 (80) registers a thread, so that 8 (6) CTAs fit an SM
    "regs_64": ((BOUNDS, "__global__ void __launch_bounds__(kSumThreads, 8)\n"),),
    "regs_80": ((BOUNDS, "__global__ void __launch_bounds__(kSumThreads, 6)\n"),),
    # f32: the next block's lidx, wx1 and wy1 rows read ahead, or all seven
    "f32_ahead_3": ((AHEAD, "constexpr int kF32AheadRows = 3;\n"),),
    "f32_ahead_8": ((AHEAD, "constexpr int kF32AheadRows = 8;\n"),),
    # each CTA keeps its first window: no restage (wrong sums, real rows)
    "no_restage": ((RESTAGE, "        if (false) {\n"),),
    # keep every loaded word live, score nothing
    "streams_only": ((SCORING,
                      "            { const float* q = reinterpret_cast<const "
                      "float*>(&now); float z = 0.0f;\n"
                      "              for (int i = 0; i < int(sizeof(now) / 4);"
                      " ++i) z += q[i];\n"
                      "              if (z == -12345.0f) wacc[0] = z; }\n"),),
}
F32_VARIANTS = ("no_aggregation", "no_adds", "regs_64", "regs_80",
                "f32_ahead_3", "f32_ahead_8", "no_restage", "streams_only")
PACKED_VARIANTS = ("no_aggregation", "no_adds", "no_lut", "regs_64",
                   "no_restage", "streams_only")


def _start_nvcc(src, out, verbose=False):
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose
                                                   else []) + ["-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_libraries(old_src, old_hist, tmp):
    """Build the current source (with ptxas' report), its variants and the
    old sources, one nvcc each, all started together."""
    text = open(SRC).read()
    jobs = {"current": _start_nvcc(SRC, os.path.join(tmp, "current.so"),
                                   verbose=True)}
    for name, edits in VARIANTS.items():
        variant = text
        for old, new in edits:
            if variant.count(old) != 1:
                raise RuntimeError(f"variant {name}: its target text is not "
                                   "in the source once")
            variant = variant.replace(old, new)
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant)
        jobs[name] = _start_nvcc(path, os.path.join(tmp, f"{name}.so"))
    if old_src:
        jobs["old"] = _start_nvcc(old_src, os.path.join(tmp, "old.so"))
    if old_hist:
        jobs["old_hist"] = _start_nvcc(old_hist,
                                       os.path.join(tmp, "old_hist.so"))
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        if name == "current":
            cs.log("ptxas (current source):\n" + "\n".join(
                ln for ln in out.splitlines() if "sums" in ln or "Used" in ln
                or "spill" in ln))
        libs[name] = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
    return libs


def sass_summary(tmp):
    """Per group-sum kernel (layout code, pid), its SASS instruction count
    and the count of each opcode that touches memory or the warp, when
    cuobjdump is there."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found"
    out = subprocess.run([tool, "-sass", os.path.join(tmp, "current.so")],
                         capture_output=True, text=True).stdout
    kernels, ops = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            ops = None
            if "slab_sums_kernel" in name:
                m = re.search(r"LayoutE(\d)ELb(\d)E", name)
                key = f"layout {m.group(1)}, pid {m.group(2)}" if m else name
                ops = kernels.setdefault(key, {})
        elif ops is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         ln)
            if m:
                op = m.group(1)
                ops["all"] = ops.get("all", 0) + 1
                key = op.split(".")[0]
                if key in ("LDS", "STS", "LDG", "LDGSTS", "MATCH", "SHFL",
                           "BAR", "WARPSYNC", "ATOMS", "F2I", "I2F", "FRND",
                           "MUFU", "BRA", "CALL", "BSSY", "BSYNC"):
                    ops[key] = ops.get(key, 0) + 1
    return kernels


def sums_launcher(lib):
    """The group sums through ``lib``'s slab_sums_launch (this source's, or
    an older one's for layouts 0 and 1)."""
    fn = lib.slab_sums_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    cap = lib.slab_sums_max_ctas
    cap.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    cap.restype = ctypes.c_int

    def run(layout, table, f, tps, w, window, palette=None,
            chunk=slab._SUM_CHUNK, ctas=None):
        nb, _, block = f.shape
        if ctas is None:
            c = ctypes.c_int(0)
            assert cap(layout, int(palette is not None), window,
                       ctypes.byref(c)) == 0
            ctas = c.value
        n_cta = max(1, min(-(-nb // chunk), ctas))
        part = torch.empty((n_cta, 2, 128), dtype=torch.float32,
                           device=f.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = fn(layout, table.data_ptr(), f.data_ptr(),
                 None if tps is None else tps.data_ptr(),
                 None if palette is None else palette.data_ptr(),
                 0 if palette is None else palette.shape[0], w.data_ptr(),
                 part.data_ptr(), n_cta, nb, block, window, chunk, stream)
        assert err == 0, err
        s = part.sum(0)
        return s[0], s[1]

    return run


def old_f32_launcher(lib):
    """The old per-block f32 kernel and the sum of its (nb, 2, 128)
    partials: what one f32 group cost before."""
    fn = lib.slab_partials_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(table, f, w, window):
        nb, _, block = f.shape
        out = torch.empty((nb, 2, 128), dtype=torch.float32, device=f.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        assert fn(table.data_ptr(), f.data_ptr(), w.data_ptr(),
                  out.data_ptr(), nb, block, window, stream) == 0
        return out[:, 0].sum(0), out[:, 1].sum(0)

    return run


def abba_ms(fns, reps=20):
    """Median device ms of each of ``fns``, one call of each per round, the
    order reversed every other round; CUDA events around each call, after a
    sleep kernel that puts the host ahead of the card (chip_smoke.cuda_ms)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            torch.cuda._sleep(cs.HOST_LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: float(np.median(v)) for k, v in times.items()}


def restages(real, windows, n_cta, chunk):
    """Window stagings of the walk: one when a CTA starts and one whenever
    the window changes between the real blocks it visits in turn."""
    b = np.nonzero(real)[0]
    cta = (b // chunk) % n_cta
    order = np.lexsort((b, cta))
    b, cta = b[order], cta[order]
    w = windows[b]
    new = np.ones(len(b), bool)
    new[1:] = (cta[1:] != cta[:-1]) | (w[1:] != w[:-1])
    return int(new.sum())


def _max_ctas(lib, layout, pid, window):
    c = ctypes.c_int(0)
    lib.slab_sums_max_ctas(layout, int(pid), window, ctypes.byref(c))
    return c.value


def parts_ms(libs, names, layout, call, dev):
    """Each variant (and the current source, "full") on one call, and the
    same at one CTA an SM."""
    code = CODES[layout]
    parts = {"full": sums_launcher(libs["current"])}
    parts.update({k: sums_launcher(libs[k]) for k in names})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {
        "parts": abba_ms({k: (lambda fn=fn: call(fn, code)) for k, fn in
                          parts.items()}),
        "parts, one CTA an SM": abba_ms(
            {k: (lambda fn=fn: call(fn, code, ctas=sms)) for k, fn in
             parts.items()}, reps=6),
    }


def walk_stats(real, windows, window, max_ctas, sms):
    real_np, win_np = real.cpu().numpy(), windows.cpu().numpy()
    nb = real_np.shape[0]
    return dict(
        nb=nb, window=window, real_blocks=int(real_np.sum()),
        distinct_windows=int(np.unique(win_np).size), max_ctas=max_ctas,
        sms=sms, chunk=slab._SUM_CHUNK, restages_one_per_block=nb,
        restages_by_chunk={c: restages(real_np, win_np,
                                       min(-(-nb // c), max_ctas), c)
                           for c in (1, 2, 4, 8)})


def layout_bench(layout, cli, dev, libs, out):
    code = CODES[layout]
    grids = cli["grids"]
    img = torch.as_tensor(cli["img_init"], device=dev)
    H, W = img.shape[0], img.shape[1]
    rgb = cli["rgb_used"]
    plan = slab.build_grid_plan(
        cli["xyz_d"], cli["rgb_d"], cli["mask_d"],
        grids.trans[:grids.n_trans], grids.rot, H, W, compact=True,
        tp_is_pid=True, quant=layout == "q8", device=dev)
    window = plan.window
    table = slab.slab_table(img, window=window)
    palette = slab.pack_rgb24(rgb)
    f, w, tp = plan.fields[0], plan.windows[0], plan.tps[0]
    rebaked = palette[tp.to(torch.int64)]
    new = sums_launcher(libs["current"])
    res = {}

    want = (slab.slab_group_sums_q8_plain if layout == "q8"
            else slab.slab_group_sums_compact_plain)(table, f, tp, w, window,
                                                     palette)
    got = new(code, table, f, tp, w, window, palette)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    fns = {}
    if "old" in libs:
        old = sums_launcher(libs["old"])
        assert torch.equal(old(code, table, f, tp, w, window, palette)[1],
                           want[1])
        fns["old kernel, unfused"] = lambda: old(code, table, f, rebaked, w,
                                                 window)
        fns["old kernel, fused"] = lambda: old(code, table, f, tp, w, window,
                                               palette)
    fns["new kernel, unfused"] = lambda: new(code, table, f, rebaked, w,
                                             window)
    fns["new kernel, fused"] = lambda: new(code, table, f, tp, w, window,
                                           palette)
    fns["gather re-bake alone"] = lambda: slab.pack_rgb24(rgb)[
        tp.to(torch.int64)]
    res["turns"] = abba_ms(fns)
    res.update(parts_ms(libs, PACKED_VARIANTS, layout,
                        lambda fn, c, ctas=None: fn(c, table, f, tp, w, window,
                                                    palette, ctas=ctas), dev))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_ctas = _max_ctas(libs["current"], code, True, window)
    grid = {}
    for chunk, ctas in ((2, sms), (2, 2 * sms), (2, 4 * sms), (1, max_ctas),
                        (2, max_ctas), (4, max_ctas), (8, max_ctas)):
        grid[f"chunk {chunk}, {ctas} CTAs"] = (
            lambda chunk=chunk, ctas=ctas: new(code, table, f, tp, w, window,
                                               palette, chunk, ctas))
    res["grid"] = abba_ms(grid, reps=10)

    real = (((f[:, 0, 0] >> 23) & 0x1FF) < window) if layout == "q8" else (
        f[:, 0, 0] >= 0)
    idx = torch.nonzero(real).squeeze(1)
    fr, wr, tr = f[idx].contiguous(), w[idx].contiguous(), tp[idx].contiguous()
    res["real blocks only"] = abba_ms({
        "all blocks": lambda: new(code, table, f, tp, w, window, palette),
        "blocks with a real slot 0": lambda: new(code, table, fr, tr, wr,
                                                 window, palette)})
    res["walk"] = walk_stats(real, w, window, max_ctas, sms)
    out[layout] = res
    for k, v in res.items():
        cs.log(f"{layout} {k}: {json.dumps(v)}")
    del plan, table, f, w, tp, rebaked, fr, wr, tr


def f32_bench(cli, dev, libs, out):
    """The f32 group-sum kernel at the library room's and the CLI's shapes."""
    room = cs.phase_room(dev)
    plan = room["plan"]
    _, _, img_lib, _ = cs._query_images(100, room["xyz"], room["rgb"], dev)
    shapes = {"library room": (slab.slab_table(img_lib, window=plan.window),
                               plan.fields[0], plan.windows[0], plan.window,
                               None)}
    del room, plan
    grids = cli["grids"]
    img = torch.as_tensor(cli["img_init"], device=dev)
    cplan = slab.build_grid_plan(
        cli["xyz_d"], cli["rgb_d"], cli["mask_d"],
        grids.trans[:grids.n_trans], grids.rot, img.shape[0], img.shape[1],
        device=dev)
    shapes["CLI shapes"] = (slab.slab_table(img, window=cplan.window),
                            cplan.fields[0], cplan.windows[0], cplan.window,
                            cli["rgb_used"])
    del cplan
    new = sums_launcher(libs["current"])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    code = slab._F32
    res_all = {}
    for name, (table, f, w, window, rgb) in shapes.items():
        res = {}
        want = slab.slab_group_sums_f32_plain(table, f, w, window)
        got = new(code, table, f, None, w, window)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        fns = {}
        if "old" in libs:
            old = old_f32_launcher(libs["old"])
            assert torch.equal(old(table, f, w, window)[1], want[1])
            fns["old kernel and its sum"] = lambda: old(table, f, w, window)
        fns["new kernel"] = lambda: new(code, table, f, None, w, window)
        if rgb is not None:
            rgb4 = slab._rgb4(rgb)
            fused = new(code, table, f, None, w, window, rgb4)
            want = slab.slab_group_sums_f32_plain(table, f, w, window, rgb)
            assert torch.equal(fused[1], want[1])
            torch.testing.assert_close(fused[0], want[0], rtol=1e-5,
                                       atol=1e-6)

            def rebake():
                c = f.clone()
                c[:, 3:6] = rgb[f[:, 7].to(torch.int64)].permute(0, 2, 1)
                return c

            fns["new kernel, re-bake fused"] = lambda: new(code, table, f,
                                                           None, w, window,
                                                           rgb4)
            fns["re-bake into a copy, then the new kernel"] = lambda: new(
                code, table, rebake(), None, w, window)
            if "old" in libs:
                fns["re-bake into a copy, old kernel, sums"] = lambda: old(
                    table, rebake(), w, window)
            fns["re-bake into a copy alone"] = rebake
        res["turns"] = abba_ms(fns)
        res.update(parts_ms(libs, F32_VARIANTS, "f32",
                            lambda fn, c, ctas=None: fn(c, table, f, None, w,
                                                        window, ctas=ctas),
                            dev))
        nb, _, block = f.shape
        samples, pads, pad_blocks, n_win = cs._f32_plan_stats(f, w)
        n_unfused, n_blk = cs._f32_bytes(samples, pads, nb, n_win, window)
        ops = samples * cs.F32_OPS_PER_SAMPLE
        res["bound"] = dict(
            block=block, samples=samples, pads=pads, pad_blocks=pad_blocks,
            bytes=n_unfused, bound_ms=cs._bound(n_unfused, ops)[0],
            bytes_per_block=n_blk, bound_per_block_ms=cs._bound(n_blk, ops)[0])
        if rgb is not None:
            n_fused, _ = cs._f32_bytes(samples, pads, nb, n_win, window,
                                       rgb.shape[0])
            res["bound"].update(bytes_fused=n_fused,
                                bound_fused_ms=cs._bound(n_fused, ops)[0])
        max_ctas = _max_ctas(libs["current"], code, False, window)
        res["walk"] = walk_stats(f[:, 0, 0] >= 0, w, window, max_ctas, sms)
        res_all[name] = res
        for k, v in res.items():
            cs.log(f"f32 {name} {k}: {json.dumps(v)}")
    out["f32"] = res_all


def hist_bench(libs, dev, out):
    """The masked histogram, old (when given) against new in turns, at a
    1024x512 image and a 4096x2048 panorama, beside an empty kernel."""
    res = {"empty kernel": cs.cuda_ms(lambda: torch.cuda._sleep(0))}
    g = torch.Generator(device="cpu").manual_seed(3)
    for n in (524288, 8388608):
        ids = torch.randint(0, 512, (n,), generator=g, dtype=torch.int32).to(dev)
        mask = (torch.rand((n,), generator=g) < 0.7).to(torch.float32).to(dev)
        want = masked_histogram_counts_plain(ids, mask)
        assert torch.equal(masked_histogram_counts(ids, mask), want)
        fns = {"new": lambda: masked_histogram_counts(ids, mask)}
        if "old_hist" in libs:
            fn = libs["old_hist"].masked_histogram_launch
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def old(fn=fn, ids=ids, mask=mask):
                o = torch.zeros(512, dtype=torch.float32, device=dev)
                stream = ctypes.c_void_p(
                    torch.cuda.current_stream().cuda_stream)
                assert fn(ids.data_ptr(), mask.data_ptr(), o.data_ptr(), n,
                          512, stream) == 0
                return o

            assert torch.equal(old(), want)
            fns["old"] = old
        res[f"N={n}"] = abba_ms(fns)
        res[f"N={n}"]["bound_ms"] = cs._bound(n * 8 + 512 * 4, n * 2)[0]
    out["masked_histogram"] = res
    cs.log(f"masked histogram: {json.dumps(res)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="an earlier slab_sampling.cu to time "
                    "against")
    ap.add_argument("--old-hist", help="an earlier masked_histogram.cu to "
                    "time against")
    ap.add_argument("--layouts", default="f32,compact,q8",
                    help="comma-separated plan layouts to time")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "bench_slab_sums.json"))
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    tmp = tempfile.mkdtemp(prefix="slab_bench_")
    try:
        t0 = time.time()
        libs = build_libraries(args.old, args.old_hist, tmp)
        cs.log(f"built {sorted(libs)} in {time.time() - t0:.2f} s; SASS "
               f"of slab_sums_kernel: {json.dumps(sass_summary(tmp))}")
        out = dict(device=smi)
        hist_bench(libs, dev, out)
        cli = cs.phase_cli_room(dev, tmp)
        for layout in args.layouts.split(","):
            if layout == "f32":
                f32_bench(cli, dev, libs, out)
            else:
                layout_bench(layout, cli, dev, libs, out)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    cs.log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
