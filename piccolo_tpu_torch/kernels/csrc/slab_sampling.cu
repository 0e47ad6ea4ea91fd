// Stage-1 slab scorers: loss sum and valid count per candidate pair of one
// 128-pair group, from a room-static plan of sorted sample blocks, in the
// plan's three layouts.
//
// Replaces: piccolo_tpu/kernels/slab_sampling.py::_kernel (f32 plans),
// _kernel_compact and _kernel_q8 (shared core _score_core), launched by
// slab_group_partials.  The TPU kernels gather texels with a one-hot MXU
// product over a 3-way bf16 split of the table, because the MXU is the
// TPU's only fast gather; an f32 gather from shared memory is exact as it
// is, so neither trick is carried over.
//
// Inputs: table (rp, 12) f32 row-major (the packed bilinear table, rows
// padded to a multiple of the window) and windows (nb,) int32, plus per
// layout:
//   f32      fields (nb, 8, block) f32 rows [lidx, wx1, wy1, r, g, b, cid,
//            pid]; pads have lidx = cid = -1;
//   compact  fields (nb, 3, block) f32 rows [lidx*128 + cid, wx1, wy1] and
//            tps (nb, 1, block) f32 targets packed as r<<16|g<<8|b, or
//            point ids; pads have lc = -1, so lidx < 0;
//   q8       fields (nb, 1, block) int32 lidx(9)|cid(7)|wx(8)|wy(8) and the
//            same tps; pads have lidx = 511 >= window.
// Both builders put each window's samples at the head of its blocks, so a
// block whose slot 0 is a pad holds no real sample.
//
// Scoring, one core for the three layouts (lerp_texels, target_loss): lerp
// the 12-texel row in bilinear_sample_packed's tap order, drop pure-black
// samples, take safe_norm's distance to the target rgb, and add it (and 1)
// into the sample's pair slots.  f32 plans hold their targets as f32 values
// and need no decode.  Compact and q8 decodes follow the JAX kernels:
// compact splits lc = lidx*128 + cid and the packed target into exact
// integers and divides the target bytes by 255 with IEEE rounding; q8
// multiplies its 8-bit fractions by the f32 reciprocal of 255.  Built with
// -fmad=false: every sample's value rounds exactly like the plain PyTorch
// version's on plans as the builders make them (integer lc and 24-bit
// targets); the sums differ from it only in the order of the float adds
// (counts are exact).
//
// slab_sums_kernel<layout, pid>: a group's sums in one launch, for all three
// layouts.  Its byte bound on the H100: 28 B (f32; 20 B when the kernel
// re-bakes), 16 B (compact) or 8 B (q8) a real sample, a 4 B probe a plan
// block, each distinct table window once (48 B a row), the windows, the
// colours once when the kernel re-bakes, and 1 KB out: at the CLI's shapes
// (window 256, block 512, 24,576 blocks, 8.4 M real samples a group)
// 92.5 MB, 0.028 ms, for q8, 159.6 MB, 0.048 ms, for compact and about
// 260 MB, 0.078 ms, for f32.  What the design does:
//   * persistent CTAs (as many as the card holds) walk the plan in chunks of
//     `chunk` consecutive blocks, chunk c to CTA c mod grid, so that every
//     CTA gets an even share; the table window is restaged only when
//     windows[b] changes, into the second of two shared buffers (cp.async,
//     16 B a thread) while the current block is scored;
//   * one probe (a lane a block, one ballot) covers the CTA's next 32
//     blocks and finds those whose slot 0 is real: pad-only blocks cost a
//     4 B read and no staging;
//   * streams are read 16 B a thread (four samples), with the streaming
//     cache hint; compact and q8 read the next block's while the current
//     one is scored; f32 reads a block's seven rows when it scores it, as
//     holding them a block ahead costs more in occupancy than it hides;
//   * the four samples of a thread are lerped before their targets are
//     needed, and the target bytes' quotients by 255 come from a 256-entry
//     table of IEEE quotients in shared memory instead of three divisions;
//   * no atomics: each warp owns a copy of the pair slots; lanes that share
//     a pair (match_any) hand their losses to the lowest of them, which adds
//     them in lane order.  Neighbouring table rows see the same poses, so a
//     warp's lanes often share a pair, and shared memory has no float add of
//     its own: atomics there are compare-and-swap loops that serialise on
//     each shared slot.  The CTA adds its warps' copies in warp order and
//     writes one (2, 128) partial; the wrapper adds the partials in a fixed
//     order, so a group's sums do not change from run to run;
//   * the per-query re-bake is fused: with a palette the kernel reads each
//     sample's point id and looks its target up itself, so no target stream
//     is rewritten.  Compact and q8 plans hold point ids in tps and take
//     pack_rgb24 of the colours (4 B a point); f32 plans keep their pid row
//     and take the colours as (N, 4) f32, one 16 B load a target, the same
//     floats a re-bake would write into the plan.
// It stays well above that bound: measured apart (scripts/
// bench_slab_sums.py; numbers in PERF.md), the scoring's latency holds it
// (few CTAs an SM at 70-80 registers a thread hide too little of it), then
// the walk and its streams, the palette gathers (a 32 B L2 sector a target)
// and the adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kTexels = 12;
constexpr float kInv255 = 1.0f / 255.0f;
constexpr int kSumThreads = 128;
constexpr int kWarps = kSumThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// rows of an f32 block read one block ahead (the rest when it is scored):
// none, since seven rows held ahead cost more occupancy than they hide
// latency (scripts/bench_slab_sums.py, variants f32_ahead_*)
constexpr int kF32AheadRows = 0;

enum class Layout : int { kCompact = 0, kQ8 = 1, kF32 = 2 };

// The scoring core shared by the three layouts, in two halves.  First the
// sample's 12 texels v lerped in bilinear_sample_packed's tap order into
// s; false for a pure-black sample.
__device__ __forceinline__ bool lerp_texels(const float* v, float x1,
                                            float y1, float* s) {
    const float x0 = 1.0f - x1;
    const float y0 = 1.0f - y1;
    const float w00 = x0 * y0, w10 = x1 * y0, w01 = x0 * y1, w11 = x1 * y1;
    int zeros = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        s[c] = v[c] * w00 + v[3 + c] * w10 + v[6 + c] * w01 + v[9 + c] * w11;
        zeros += (s[c] == 0.0f);
    }
    return zeros != 3;
}

// Then safe_norm's distance from s to the target rgb.
__device__ __forceinline__ float target_loss(const float* s, float tr,
                                             float tg, float tb) {
    const float d0 = s[0] - tr;
    const float d1 = s[1] - tg;
    const float d2 = s[2] - tb;
    const float sq = d0 * d0 + d1 * d1 + d2 * d2;
    return sq > 0.0f ? sqrtf(sq) : 0.0f;
}

// A packed target r<<16|g<<8|b (a 24-bit integer held in an f32, as
// pack_rgb24 makes it) -> rgb in [0, 1]: its three bytes, each divided by
// 255 with IEEE rounding (q255[i] = __fdiv_rn(i, 255)), as the JAX
// compact/q8 kernels split and divide it.
__device__ __forceinline__ void unpack_target(float tp, const float* q255,
                                              float* tr, float* tg,
                                              float* tb) {
    const int p = static_cast<int>(tp);
    *tr = q255[(p >> 16) & 0xFF];
    *tg = q255[(p >> 8) & 0xFF];
    *tb = q255[p & 0xFF];
}

// A byte as an f32, exactly, without the conversion unit: 2^23 + x spelt
// in the mantissa, less 2^23.
__device__ __forceinline__ float byte_to_float(uint32_t x) {
    return __uint_as_float(0x4B000000u | x) - 8388608.0f;
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ uint32_t lane4(const uint4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

// Start copying table window `win` (window x 12 f32) into `dst`.
__device__ __forceinline__ void stage_async(float4* dst,
                                            const float4* __restrict__ table,
                                            int win, int window) {
    const int n = window * 3;
    const float4* src = table + static_cast<size_t>(win) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async16(dst + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four consecutive samples of one block, as they come from the streams.
// load_ahead reads what is read one block ahead, load_rest the rest, load
// both; target(k) is sample k's target (rgb, or a packed value in .x) or,
// when the kernel re-bakes (kPid), its point id in .x.
template <Layout L, bool kPid>
struct Samples;

template <bool kPid>
struct Samples<Layout::kCompact, kPid> {  // rows lc, wx1, wy1, then tps
    float4 lc, x1, y1, tp;

    __device__ __forceinline__ void load(const void* fields,
                                         const float* tps, int b, int block,
                                         int v) {
        const float4* f = reinterpret_cast<const float4*>(
            static_cast<const float*>(fields) + static_cast<size_t>(b) * 3 * block);
        const int q = block >> 2;
        lc = __ldcs(f + v);
        x1 = __ldcs(f + q + v);
        y1 = __ldcs(f + 2 * q + v);
        tp = __ldcs(reinterpret_cast<const float4*>(
                        tps + static_cast<size_t>(b) * block) + v);
    }

    __device__ __forceinline__ void load_ahead(const void* fields,
                                               const float* tps, int b,
                                               int block, int v) {
        load(fields, tps, b, block, v);
    }

    __device__ __forceinline__ void load_rest(const void*, const float*, int,
                                              int, int) {}

    // Sample k's row, pair and fractions; false for a pad.
    __device__ __forceinline__ bool decode(int k, int window, int* li,
                                           int* cid, float* wx,
                                           float* wy) const {
        // lc = lidx * 128 + cid, an exact integer; a pad's -1 gives lidx -1
        const int l = static_cast<int>(lane4(lc, k));
        *li = l >> 7;
        *cid = l & (kGroup - 1);
        *wx = lane4(x1, k);
        *wy = lane4(y1, k);
        return l >= 0;
    }

    __device__ __forceinline__ float4 target(int k) const {
        return make_float4(lane4(tp, k), 0.0f, 0.0f, 0.0f);
    }

    static __device__ __forceinline__ bool real_block(const void* fields,
                                                      int b, int block,
                                                      int window) {
        return __ldg(static_cast<const float*>(fields) +
                     static_cast<size_t>(b) * 3 * block) >= 0.0f;
    }
};

template <bool kPid>
struct Samples<Layout::kQ8, kPid> {  // q8: one packed word, then tps
    uint4 g;
    float4 tp;

    __device__ __forceinline__ void load(const void* fields,
                                         const float* tps, int b, int block,
                                         int v) {
        g = __ldcs(reinterpret_cast<const uint4*>(
                       static_cast<const uint32_t*>(fields) +
                       static_cast<size_t>(b) * block) + v);
        tp = __ldcs(reinterpret_cast<const float4*>(
                        tps + static_cast<size_t>(b) * block) + v);
    }

    __device__ __forceinline__ void load_ahead(const void* fields,
                                               const float* tps, int b,
                                               int block, int v) {
        load(fields, tps, b, block, v);
    }

    __device__ __forceinline__ void load_rest(const void*, const float*, int,
                                              int, int) {}

    __device__ __forceinline__ bool decode(int k, int window, int* li,
                                           int* cid, float* wx,
                                           float* wy) const {
        const uint32_t p = lane4(g, k);
        *li = static_cast<int>(p >> 23);
        *cid = static_cast<int>((p >> 16) & 0x7Fu);
        *wx = byte_to_float((p >> 8) & 0xFFu) * kInv255;
        *wy = byte_to_float(p & 0xFFu) * kInv255;
        return *li < window;  // pads have lidx = 511
    }

    __device__ __forceinline__ float4 target(int k) const {
        return make_float4(lane4(tp, k), 0.0f, 0.0f, 0.0f);
    }

    static __device__ __forceinline__ bool real_block(const void* fields,
                                                      int b, int block,
                                                      int window) {
        const uint32_t p = __ldg(static_cast<const uint32_t*>(fields) +
                                 static_cast<size_t>(b) * block);
        return static_cast<int>(p >> 23) < window;
    }
};

// f32: rows lidx, wx1, wy1, then r, g, b, cid or, when the kernel re-bakes
// the targets, cid and pid (20 B a sample instead of 28).
template <bool kPid>
struct Samples<Layout::kF32, kPid> {
    static constexpr int kRows = kPid ? 5 : 7;
    static constexpr int kAhead = kF32AheadRows < kRows ? kF32AheadRows : kRows;
    float4 row[kRows];

    // the plan row that holds row r of this struct
    static __device__ __forceinline__ int plan_row(int r) {
        return kPid && r >= 3 ? r + 3 : r;
    }

    template <int kLo, int kHi>
    __device__ __forceinline__ void load_rows(const void* fields, int b,
                                              int block, int v) {
        const float4* f = reinterpret_cast<const float4*>(
            static_cast<const float*>(fields) + static_cast<size_t>(b) * 8 * block);
        const int q = block >> 2;
#pragma unroll
        for (int r = kLo; r < kHi; ++r) row[r] = __ldcs(f + plan_row(r) * q + v);
    }

    __device__ __forceinline__ void load(const void* fields, const float*,
                                         int b, int block, int v) {
        load_rows<0, kRows>(fields, b, block, v);
    }

    __device__ __forceinline__ void load_ahead(const void* fields,
                                               const float*, int b, int block,
                                               int v) {
        load_rows<0, kAhead>(fields, b, block, v);
    }

    __device__ __forceinline__ void load_rest(const void* fields,
                                              const float*, int b, int block,
                                              int v) {
        load_rows<kAhead, kRows>(fields, b, block, v);
    }

    __device__ __forceinline__ bool decode(int k, int window, int* li,
                                           int* cid, float* wx,
                                           float* wy) const {
        *li = static_cast<int>(lane4(row[0], k));
        *cid = static_cast<int>(lane4(row[kPid ? 3 : 6], k));
        *wx = lane4(row[1], k);
        *wy = lane4(row[2], k);
        return *li >= 0 && *cid >= 0;  // pads have lidx = cid = -1
    }

    __device__ __forceinline__ float4 target(int k) const {
        if constexpr (kPid) {
            return make_float4(lane4(row[4], k), 0.0f, 0.0f, 0.0f);
        } else {
            return make_float4(lane4(row[3], k), lane4(row[4], k),
                               lane4(row[5], k), 0.0f);
        }
    }

    static __device__ __forceinline__ bool real_block(const void* fields,
                                                      int b, int block,
                                                      int window) {
        return __ldg(static_cast<const float*>(fields) +
                     static_cast<size_t>(b) * 8 * block) >= 0.0f;
    }
};

// Add one sample a lane into the warp's own pair slots, without atomics:
// the lanes of one pair (match_any) hand their losses to the lowest of
// them through `stage`, which adds them in lane order and alone updates
// the pair's slots.  All 32 lanes call it; lanes with ok false add nothing.
__device__ __forceinline__ void warp_add(float* wacc, int* wcnt, float* stage,
                                         int cid, float loss, bool ok) {
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(kFull, ok ? cid : kGroup);
    stage[lane] = loss;
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
}

// Score four samples against the staged window `tab` (none unless
// `live`).  Pads are scored against row 0 and dropped, so that the four
// rows are read up front and the four samples' arithmetic interleaves.
template <Layout L, bool kPid>
__device__ __forceinline__ void score4(const Samples<L, kPid>& s, bool live,
                                       const float4* tab, int window,
                                       const void* __restrict__ palette,
                                       int n_pal, const float* q255,
                                       float* wacc, int* wcnt, float* stage) {
    int li[4], cid[4];
    float wx[4], wy[4], loss[4];
    float4 tgt[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        ok[k] = s.decode(k, window, &li[k], &cid[k], &wx[k], &wy[k]) && live;
        if (!ok[k]) li[k] = 0;
        tgt[k] = s.target(k);
    }
    if constexpr (kPid) {  // the re-bake: point id -> target
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int pid = static_cast<int>(tgt[k].x);
            if (ok[k] && static_cast<unsigned>(pid) >=
                             static_cast<unsigned>(n_pal)) {
                __trap();  // a point id outside the palette: not this cloud
            }
            const int p = ok[k] ? pid : 0;
            if constexpr (L == Layout::kF32) {
                tgt[k] = __ldg(static_cast<const float4*>(palette) + p);
            } else {
                tgt[k].x = __ldg(static_cast<const float*>(palette) + p);
            }
        }
    }
    // the lerps need no target: they cover the palette loads' latency
    float rgb[4][3];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float4* row = tab + li[k] * 3;
        const float4 a = row[0], b = row[1], c = row[2];
        const float v[kTexels] = {a.x, a.y, a.z, a.w, b.x, b.y,
                                  b.z, b.w, c.x, c.y, c.z, c.w};
        ok[k] = lerp_texels(v, wx[k], wy[k], rgb[k]) && ok[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        float tr = tgt[k].x, tg = tgt[k].y, tb = tgt[k].z;
        if constexpr (L != Layout::kF32) {
            unpack_target(tgt[k].x, q255, &tr, &tg, &tb);
        }
        loss[k] = target_loss(rgb[k], tr, tg, tb);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        warp_add(wacc, wcnt, stage, cid[k], loss[k], ok[k]);
    }
}

// A CTA's walk over the plan: chunks blockIdx.x, blockIdx.x + gridDim.x,
// ... of `chunk` consecutive blocks, and in each the blocks whose slot 0
// is real.  One probe (a lane a block, one ballot) covers the CTA's next
// 32 / chunk chunks.  Every thread of the CTA holds the same state.
template <Layout L>
struct Walker {
    const void* fields;
    const int* windows;
    int nb, block, window, chunk, n_chunks;
    int c;             // first chunk of the current probe
    unsigned mask;     // its real blocks not yet returned
    int lane_win;      // lane l: the window of the block it probed

    __device__ __forceinline__ int lane_block(int lane) const {
        return (c + lane / chunk * static_cast<int>(gridDim.x)) * chunk +
               lane % chunk;
    }

    __device__ __forceinline__ void probe() {
        const int lane = threadIdx.x & 31;
        const int b = lane_block(lane);
        bool real = false;
        lane_win = 0;
        if (lane < 32 / chunk * chunk && b < nb) {
            real = Samples<L, false>::real_block(fields, b, block, window);
            lane_win = __ldg(windows + b);
        }
        mask = __ballot_sync(kFull, real);
    }

    // The next block with a real sample, or -1 past the end; *win is its
    // table window.
    __device__ __forceinline__ int next(int* win) {
        while (mask == 0) {
            c += 32 / chunk * static_cast<int>(gridDim.x);
            if (c >= n_chunks) return -1;
            probe();
        }
        const int bit = __ffs(mask) - 1;
        mask &= mask - 1;
        *win = __shfl_sync(kFull, lane_win, bit);
        return lane_block(bit);
    }
};

template <Layout L, bool kPid>
__global__ void __launch_bounds__(kSumThreads)
slab_sums_kernel(const float4* __restrict__ table,
                 const void* __restrict__ fields,
                 const float* __restrict__ tps,
                 const void* __restrict__ palette, int n_pal,
                 const int* __restrict__ windows,
                 float* __restrict__ partials, int nb, int block, int window,
                 int chunk) {
    // two windows, then per warp its pair slots and a stage, then q255
    extern __shared__ float4 smem4[];
    const int wsize = window * 3;      // float4s in one staged window
    const int warp = threadIdx.x >> 5;
    float* acc = reinterpret_cast<float*>(smem4 + 2 * wsize);
    int* cnt = reinterpret_cast<int*>(acc + kWarps * kGroup);
    float* stage = reinterpret_cast<float*>(cnt + kWarps * kGroup);
    float* q255 = stage + kWarps * 32;
    float* wacc = acc + warp * kGroup;
    int* wcnt = cnt + warp * kGroup;
    for (int i = threadIdx.x; i < kWarps * kGroup; i += blockDim.x) {
        acc[i] = 0.0f;
        cnt[i] = 0;
    }
    if constexpr (L != Layout::kF32) {
        for (int i = threadIdx.x; i < 256; i += blockDim.x) {
            q255[i] = __fdiv_rn(static_cast<float>(i), 255.0f);
        }
    }

    Walker<L> walk{fields, windows, nb, block, window, chunk,
                   (nb + chunk - 1) / chunk,
                   static_cast<int>(blockIdx.x) -
                       32 / chunk * static_cast<int>(gridDim.x),
                   0u, 0};
    const int nvec = block >> 2;
    const int v0 = threadIdx.x;
    int win = 0;
    int cur = walk.next(&win);
    int buf = 0;
    Samples<L, kPid> pre;
    if (cur >= 0) {
        stage_async(smem4, table, win, window);
        if (v0 < nvec) pre.load_ahead(fields, tps, cur, block, v0);
    }
    while (cur >= 0) {
        stage_wait();
        // the window is in; every thread is done with the previous block,
        // so the other buffer is free
        __syncthreads();
        int nwin = win;
        const int nxt = walk.next(&nwin);
        int nbuf = buf;
        if (nxt >= 0 && nwin != win) {
            nbuf = buf ^ 1;
            stage_async(smem4 + nbuf * wsize, table, nwin, window);
        }
        Samples<L, kPid> now = pre;
        if (nxt >= 0 && v0 < nvec) pre.load_ahead(fields, tps, nxt, block, v0);
        const float4* tab = smem4 + buf * wsize;
        // every lane takes part in each round (the warp's adds are
        // collective); lanes past the block's end add nothing
        for (int v = v0; v - v0 < nvec; v += blockDim.x) {
            const bool live = v < nvec;
            if (live) {
                if (v == v0) {
                    now.load_rest(fields, tps, cur, block, v);
                } else {
                    now.load(fields, tps, cur, block, v);
                }
            }
            score4<L, kPid>(now, live, tab, window, palette, n_pal, q255,
                            wacc, wcnt, stage + warp * 32);
        }
        cur = nxt;
        win = nwin;
        buf = nbuf;
    }
    __syncthreads();
    float* o = partials + static_cast<size_t>(blockIdx.x) * 2 * kGroup;
    for (int i = threadIdx.x; i < kGroup; i += blockDim.x) {
        float a = 0.0f;
        int n = 0;
        for (int w = 0; w < kWarps; ++w) {  // in warp order
            a += acc[w * kGroup + i];
            n += cnt[w * kGroup + i];
        }
        o[i] = a;
        o[kGroup + i] = static_cast<float>(n);
    }
}

using SumsKernel = void (*)(const float4*, const void*, const float*,
                            const void*, int, const int*, float*, int, int,
                            int, int);

template <Layout L>
SumsKernel pick(int pid) {
    return pid ? slab_sums_kernel<L, true> : slab_sums_kernel<L, false>;
}

// The kernel of layout 0 (compact), 1 (q8) or 2 (f32); null for another.
SumsKernel sums_kernel(int layout, int pid) {
    switch (layout) {
        case 0: return pick<Layout::kCompact>(pid);
        case 1: return pick<Layout::kQ8>(pid);
        case 2: return pick<Layout::kF32>(pid);
        default: return nullptr;
    }
}

size_t sums_smem_bytes(int window) {
    return (static_cast<size_t>(window) * kTexels * 2 +
            kWarps * (2 * kGroup + 32) + 256) *
           sizeof(float);
}

// Allow the kernel the shared memory of `window` (above 48 KB only on
// request).
cudaError_t allow_smem(SumsKernel kernel, int window) {
    const size_t smem = sums_smem_bytes(window);
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

}  // namespace

// Resident CTAs of the group-sum kernel on the current device (SMs times
// CTAs an SM holds at this window); 0 when it cannot stage the window.
extern "C" int slab_sums_max_ctas(int layout, int pid, int window, int* ctas) {
    *ctas = 0;
    const SumsKernel kernel = sums_kernel(layout, pid);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) err = allow_smem(kernel, window);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kSumThreads, sums_smem_bytes(window));
    }
    if (err != cudaSuccess) {
        cudaGetLastError();  // leave no sticky error for the caller
        return static_cast<int>(err);
    }
    *ctas = sms * per_sm;
    return 0;
}

// Group sums of a compact (layout 0), q8 (1) or f32 (2) plan group into
// partials (n_cta, 2, 128).  With a palette the kernel re-bakes: tps (compact,
// q8) or the pid row (f32) holds point ids, and the palette is pack_rgb24
// of the colours (compact, q8) or the colours as (n_pal, 4) f32 (f32).
extern "C" int slab_sums_launch(int layout, const void* table,
                                const void* fields, const void* tps,
                                const void* palette, int n_pal,
                                const void* windows, void* partials, int n_cta,
                                int nb, int block, int window, int chunk,
                                void* stream) {
    const SumsKernel kernel = sums_kernel(layout, palette != nullptr);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_smem(kernel, window);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_cta, kSumThreads, sums_smem_bytes(window),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(table), fields,
        static_cast<const float*>(tps), palette, n_pal,
        static_cast<const int*>(windows), static_cast<float*>(partials), nb,
        block, window, chunk);
    return static_cast<int>(cudaGetLastError());
}
