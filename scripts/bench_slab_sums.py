#!/usr/bin/env python3
"""Time the compact and q8 group-sum slab kernels at the CLI's shapes on one
NVIDIA GPU: against an older slab_sampling.cu, apart by what they spend, and
beside the f32 slab kernel as the control.

    python3 scripts/bench_slab_sums.py [--old OLD.cu] [--out FILE.json]

``--old`` is a copy of an earlier ``csrc/slab_sampling.cu`` whose compact
and q8 kernels write per-block partials (``slab_partials_compact_launch``,
``slab_partials_q8_launch``); it is built with the port's nvcc flags and
timed against the current kernels in turns (ABBA order each round).  On
group 0 of the plans chip_smoke.py's phase 9 builds (the CLI's room and
grids, point ids in tps) it reports device-time medians in ms (CUDA
events, the host put ahead of the card by a sleep kernel):
  * old kernel, new kernel unfused (re-baked targets) and fused (palette),
    PR 2's stage-1 route per group (gather re-bake, old kernel, two sums)
    and the gather re-bake alone;
  * variants built from the current source with one part taken out: the
    warp's aggregation of lanes that share a pair (each lane adds alone),
    the table of quotients by 255 (IEEE divisions instead), the window
    restages, the pair-slot adds, or the scoring (streams, probes and
    staging only); and one capped at 64 registers a thread; each also at
    one CTA an SM, where the time is the CTA's chain of latencies;
  * grid sizes and chunk lengths, and the plan cut to its blocks with a
    real slot 0 (the probes' share); the window restages the walk makes;
  * the f32 kernel on group 0 of the library room's plan (chip_smoke.py
    phase 3) and of an f32 plan at the CLI's shapes (run D's layout).
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

SRC = os.path.join(ROOT, "piccolo_tpu_torch", "kernels", "csrc",
                   "slab_sampling.cu")
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
SCORING = ("            score4<kQ8, kPid>(now, live, tab, window, palette, n_pal, "
           "q255,\n                              wacc, wcnt, stage + warp * "
           "32);\n")
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
    # at most 64 registers a thread, so that 8 CTAs fit an SM
    "regs_64": (("__global__ void __launch_bounds__(kSumThreads)\n",
                 "__global__ void __launch_bounds__(kSumThreads, 8)\n"),),
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


def _start_nvcc(src, out, verbose=False):
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose
                                                   else []) + ["-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_libraries(old_src, tmp):
    """Build the current source (with ptxas' report), its variants and the
    old source, one nvcc each, all started together."""
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
    """Per group-sum kernel, its SASS instruction count and the count of
    each opcode that touches memory or the warp, when cuobjdump is there."""
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
                ops = kernels.setdefault(name[name.index("ILb"):][:10], {})
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
    fn = lib.slab_sums_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    cap = lib.slab_sums_max_ctas
    cap.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    cap.restype = ctypes.c_int

    def run(quant, table, f, tps, w, window, palette=None,
            chunk=slab._SUM_CHUNK,
            ctas=None):
        nb, _, block = f.shape
        if ctas is None:
            c = ctypes.c_int(0)
            assert cap(int(quant), int(palette is not None), window,
                       ctypes.byref(c)) == 0
            ctas = c.value
        n_cta = max(1, min(-(-nb // chunk), ctas))
        part = torch.empty((n_cta, 2, 128), dtype=torch.float32,
                           device=f.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = fn(int(quant), table.data_ptr(), f.data_ptr(), tps.data_ptr(),
                 None if palette is None else palette.data_ptr(),
                 0 if palette is None else palette.shape[0], w.data_ptr(),
                 part.data_ptr(), n_cta, nb, block, window, chunk, stream)
        assert err == 0, err
        s = part.sum(0)
        return s[0], s[1]

    return run


def old_launcher(lib, quant):
    fn = getattr(lib, "slab_partials_q8_launch" if quant
                 else "slab_partials_compact_launch")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(table, f, tps, w, window):
        nb, _, block = f.shape
        out = torch.empty((nb, 2, 128), dtype=torch.float32, device=f.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        assert fn(table.data_ptr(), f.data_ptr(), tps.data_ptr(),
                  w.data_ptr(), out.data_ptr(), nb, block, window, stream) == 0
        return out

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


def layout_bench(layout, cli, dev, libs, out):
    quant = layout == "q8"
    grids = cli["grids"]
    img = torch.as_tensor(cli["img_init"], device=dev)
    H, W = img.shape[0], img.shape[1]
    rgb = cli["rgb_used"]
    plan = slab.build_grid_plan(
        cli["xyz_d"], cli["rgb_d"], cli["mask_d"],
        grids.trans[:grids.n_trans], grids.rot, H, W, compact=True,
        tp_is_pid=True, quant=quant, device=dev)
    window = plan.window
    table = slab.slab_table(img, window=window)
    palette = slab.pack_rgb24(rgb)
    f, w, tp = plan.fields[0], plan.windows[0], plan.tps[0]
    rebaked = palette[tp.to(torch.int64)]
    new = sums_launcher(libs["current"])
    res = {}

    want = (slab.slab_group_sums_q8_plain if quant
            else slab.slab_group_sums_compact_plain)(table, f, tp, w, window,
                                                     palette)
    got = new(quant, table, f, tp, w, window, palette)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    fns = {}
    if "old" in libs:
        old = old_launcher(libs["old"], quant)
        o = old(table, f, rebaked, w, window)
        assert torch.equal(o[:, 1].sum(0), want[1])

        def pr2_route():
            tps = slab.pack_rgb24(rgb)[tp.to(torch.int64)]
            o = old(table, f, tps, w, window)
            return o[:, 0].sum(0), o[:, 1].sum(0)

        fns["old kernel"] = lambda: old(table, f, rebaked, w, window)
    fns["new kernel, unfused"] = lambda: new(quant, table, f, rebaked, w,
                                             window)
    fns["new kernel, fused"] = lambda: new(quant, table, f, tp, w, window,
                                           palette)
    if "old" in libs:
        fns["PR 2 route (gather re-bake, old kernel, sums)"] = pr2_route
    fns["gather re-bake alone"] = lambda: slab.pack_rgb24(rgb)[
        tp.to(torch.int64)]
    res["turns"] = abba_ms(fns)

    parts = {"full": new}
    parts.update({k: sums_launcher(libs[k]) for k in VARIANTS})
    res["parts"] = abba_ms({k: (lambda fn=fn: fn(quant, table, f, tp, w,
                                                 window, palette))
                            for k, fn in parts.items()})
    # one CTA an SM: the time is the CTA's chain of latencies
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    one = {k: (lambda fn=fn: fn(quant, table, f, tp, w, window, palette,
                                ctas=sms)) for k, fn in parts.items()}
    one["full, unfused"] = lambda: new(quant, table, f, rebaked, w, window,
                                       ctas=sms)
    res["parts, one CTA an SM"] = abba_ms(one, reps=6)

    c = ctypes.c_int(0)
    libs["current"].slab_sums_max_ctas(int(quant), 1, window, ctypes.byref(c))
    max_ctas = c.value
    grid = {}
    for chunk, ctas in ((2, sms), (2, 2 * sms), (2, 4 * sms), (1, max_ctas),
                        (2, max_ctas), (3, max_ctas), (4, max_ctas),
                        (8, max_ctas), (16, max_ctas)):
        grid[f"chunk {chunk}, {ctas} CTAs"] = (
            lambda chunk=chunk, ctas=ctas: new(quant, table, f, tp, w, window,
                                               palette, chunk, ctas))
    res["grid"] = abba_ms(grid, reps=10)

    nb, _, block = f.shape
    real = (((f[:, 0, 0] >> 23) & 0x1FF) < window) if quant else (
        f[:, 0, 0] >= 0)
    idx = torch.nonzero(real).squeeze(1)
    fr, wr, tr = f[idx].contiguous(), w[idx].contiguous(), tp[idx].contiguous()
    res["real blocks only"] = abba_ms({
        "all blocks": lambda: new(quant, table, f, tp, w, window, palette),
        "blocks with a real slot 0": lambda: new(quant, table, fr, tr, wr,
                                                 window, palette)})
    real_np, win_np = real.cpu().numpy(), w.cpu().numpy()
    res["walk"] = dict(
        nb=nb, block=block, window=window, real_blocks=int(real_np.sum()),
        distinct_windows=int(np.unique(win_np).size), max_ctas=max_ctas,
        sms=sms, chunk=slab._SUM_CHUNK, restages_one_per_block=nb,
        restages_by_chunk={c: restages(real_np, win_np,
                                       min(-(-nb // c), max_ctas), c)
                           for c in (1, 2, 3, 4, 8)})
    out[layout] = res
    for k, v in res.items():
        cs.log(f"{layout} {k}: {json.dumps(v)}")
    del plan, table, f, w, tp, rebaked, fr, wr, tr


def f32_control(cli, dev, out):
    room = cs.phase_room(dev)
    plan = room["plan"]
    _, _, img_lib, _ = cs._query_images(100, room["xyz"], room["rgb"], dev)
    t_lib = slab.slab_table(img_lib, window=plan.window)
    f_lib, w_lib = plan.fields[0], plan.windows[0]
    del room
    grids = cli["grids"]
    img = torch.as_tensor(cli["img_init"], device=dev)
    cplan = slab.build_grid_plan(
        cli["xyz_d"], cli["rgb_d"], cli["mask_d"],
        grids.trans[:grids.n_trans], grids.rot, img.shape[0], img.shape[1],
        device=dev)
    t_cli = slab.slab_table(img, window=cplan.window)
    f, w = cplan.fields[0], cplan.windows[0]
    real = (f[:, 0] >= 0) & (f[:, 6] >= 0)
    samples = int(real.sum())
    pads = f.shape[0] * f.shape[2] - samples
    n_win = int(torch.unique(w).numel())
    # chip_smoke.py phase 4's count
    nbytes = (samples * 28 + pads * 8 + n_win * cplan.window * 48
              + f.shape[0] * 4 + f.shape[0] * 2 * 128 * 4)
    bound_ms, by = cs._bound(nbytes, samples * 42)
    ms = abba_ms({
        "library room": lambda: slab.slab_block_partials(
            t_lib, f_lib, w_lib, plan.window),
        "CLI shapes": lambda: slab.slab_block_partials(t_cli, f, w,
                                                       cplan.window)})
    out["f32"] = dict(ms=ms, cli_shape=dict(
        nb=f.shape[0], block=f.shape[2], window=cplan.window,
        samples=samples, pads=pads, distinct_windows=n_win, bytes=nbytes,
        bound_ms=bound_ms, bound_by=by))
    cs.log(f"f32 control: {json.dumps(out['f32'])}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="an earlier slab_sampling.cu to time "
                    "against")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "bench_slab_sums.json"))
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    tmp = tempfile.mkdtemp(prefix="slab_bench_")
    try:
        t0 = time.time()
        libs = build_libraries(args.old, tmp)
        cs.log(f"built {sorted(libs)} in {time.time() - t0:.2f} s; SASS "
               f"of slab_sums_kernel: {json.dumps(sass_summary(tmp))}")
        out = dict(device=smi)
        cli = cs.phase_cli_room(dev, tmp)
        for layout in ("compact", "q8"):
            layout_bench(layout, cli, dev, libs, out)
            torch.cuda.empty_cache()
        f32_control(cli, dev, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    cs.log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
