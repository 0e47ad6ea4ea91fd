// Stage-1 slab scorer: loss sum and valid count per candidate pair of one
// 128-pair group, from a room-static plan of sorted sample blocks, in the
// plan's three layouts.
//
// Replaces: piccolo_tpu/kernels/slab_sampling.py::_kernel, _kernel_compact
// and _kernel_q8 (shared core _score_core), launched by
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
//            tps (nb, 1, block) f32 targets packed as r<<16|g<<8|b; pads
//            have lc = -1, so lidx < 0;
//   q8       fields (nb, 1, block) int32 lidx(9)|cid(7)|wx(8)|wy(8) and the
//            same tps; pads have lidx = 511 >= window.
// Output (nb, 2, 128) f32: per block, the loss sum and the valid count of
// each pair id.  The sum over blocks happens outside, as in the JAX package.
//
// Design: one CUDA block per plan block.  The block stages its window's
// window x 12 floats into shared memory (6 KB at window 128), then each
// thread takes samples i, i + blockDim, ...: it decodes the layout, skips
// pads, and hands the sample to score_sample, the one scoring core: lerp
// the 12-texel row in bilinear_sample_packed's tap order, drop pure-black
// samples, take safe_norm's distance to the target rgb and add it (and 1)
// into the pair's shared-memory slots with atomicAdd.  Decodes follow the
// JAX kernels: compact splits lc and the packed target with power-of-two
// scalings (exact) and divides the target bytes by 255 (IEEE division);
// q8 multiplies its 8-bit fractions by the f32 reciprocal of 255.  Built
// with -fmad=false: every sample's value rounds exactly like the plain
// PyTorch version; the sums differ from it only by the order of the float
// atomics (counts are exact integers).
//
// Bound on the H100: bytes.  A real sample reads 28 B (f32: every field
// but pid), 16 B (compact) or 8 B (q8); a pad slot 8 B (f32: lidx and
// cid) or 4 B (compact, q8: the first field); the table windows stay hot
// in L2.  Reads are coalesced (row-wise 4 B a thread).  Blocks that hold
// only pads still stage their window; skipping them, TMA streaming of the
// plan and warp-level pre-aggregation of the atomics are left for later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kTexels = 12;
constexpr float kInv255 = 1.0f / 255.0f;

// Stage the block's table window and zero the pair accumulators.
__device__ void stage_window(const float* __restrict__ table,
                             const int* __restrict__ windows, int window,
                             float* tab, float* acc, int* cnt) {
    const float* src =
        table + static_cast<size_t>(windows[blockIdx.x]) * window * kTexels;
    for (int i = threadIdx.x; i < window * kTexels; i += blockDim.x) {
        tab[i] = src[i];
    }
    for (int i = threadIdx.x; i < kGroup; i += blockDim.x) {
        acc[i] = 0.0f;
        cnt[i] = 0;
    }
    __syncthreads();
}

// The scoring core shared by the three layouts: one decoded sample.
__device__ __forceinline__ void score_sample(const float* tab, int li,
                                             float x1, float y1, float tr,
                                             float tg, float tb, int cid,
                                             float* acc, int* cnt) {
    const float x0 = 1.0f - x1;
    const float y0 = 1.0f - y1;
    const float w00 = x0 * y0, w10 = x1 * y0, w01 = x0 * y1, w11 = x1 * y1;
    const float* v = tab + li * kTexels;
    float s[3];
    int zeros = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        s[c] = v[c] * w00 + v[3 + c] * w10 + v[6 + c] * w01 + v[9 + c] * w11;
        zeros += (s[c] == 0.0f);
    }
    if (zeros == 3) return;  // pure-black sample
    const float d0 = s[0] - tr;
    const float d1 = s[1] - tg;
    const float d2 = s[2] - tb;
    const float sq = d0 * d0 + d1 * d1 + d2 * d2;
    atomicAdd(&acc[cid], sq > 0.0f ? sqrtf(sq) : 0.0f);
    atomicAdd(&cnt[cid], 1);
}

// Packed 24-bit target -> rgb in [0, 1], as the JAX compact/q8 kernels.
__device__ __forceinline__ void unpack_target(float tp, float* tr, float* tg,
                                              float* tb) {
    const float r = floorf(tp * (1.0f / 65536.0f));
    const float rem = tp - r * 65536.0f;
    const float g = floorf(rem * (1.0f / 256.0f));
    const float b = rem - g * 256.0f;
    *tr = __fdiv_rn(r, 255.0f);
    *tg = __fdiv_rn(g, 255.0f);
    *tb = __fdiv_rn(b, 255.0f);
}

__device__ void write_partials(float* __restrict__ out, const float* acc,
                               const int* cnt) {
    __syncthreads();
    float* o = out + static_cast<size_t>(blockIdx.x) * 2 * kGroup;
    for (int i = threadIdx.x; i < kGroup; i += blockDim.x) {
        o[i] = acc[i];
        o[kGroup + i] = static_cast<float>(cnt[i]);
    }
}

__global__ void slab_partials_kernel(const float* __restrict__ table,
                                     const float* __restrict__ fields,
                                     const int* __restrict__ windows,
                                     float* __restrict__ out,
                                     int block, int window) {
    extern __shared__ float smem[];
    float* tab = smem;                                  // window * 12
    float* acc = tab + window * kTexels;                // 128
    int* cnt = reinterpret_cast<int*>(acc + kGroup);    // 128
    stage_window(table, windows, window, tab, acc, cnt);

    const float* f = fields + static_cast<size_t>(blockIdx.x) * 8 * block;
    for (int i = threadIdx.x; i < block; i += blockDim.x) {
        const int li = static_cast<int>(f[i]);
        const int cid = static_cast<int>(f[6 * block + i]);
        if (li < 0 || cid < 0) continue;  // padding slot
        score_sample(tab, li, f[block + i], f[2 * block + i], f[3 * block + i],
                     f[4 * block + i], f[5 * block + i], cid, acc, cnt);
    }
    write_partials(out, acc, cnt);
}

__global__ void slab_partials_compact_kernel(const float* __restrict__ table,
                                             const float* __restrict__ fields,
                                             const float* __restrict__ tps,
                                             const int* __restrict__ windows,
                                             float* __restrict__ out,
                                             int block, int window) {
    extern __shared__ float smem[];
    float* tab = smem;
    float* acc = tab + window * kTexels;
    int* cnt = reinterpret_cast<int*>(acc + kGroup);
    stage_window(table, windows, window, tab, acc, cnt);

    const size_t base = static_cast<size_t>(blockIdx.x) * block;
    const float* f = fields + 3 * base;
    const float* tp = tps + base;
    for (int i = threadIdx.x; i < block; i += blockDim.x) {
        const float lc = f[i];
        const float lif = floorf(lc * (1.0f / kGroup));
        if (lif < 0.0f) continue;  // padding slot
        const int cid = static_cast<int>(lc - lif * kGroup);
        float tr, tg, tb;
        unpack_target(tp[i], &tr, &tg, &tb);
        score_sample(tab, static_cast<int>(lif), f[block + i],
                     f[2 * block + i], tr, tg, tb, cid, acc, cnt);
    }
    write_partials(out, acc, cnt);
}

__global__ void slab_partials_q8_kernel(const float* __restrict__ table,
                                        const int* __restrict__ fields,
                                        const float* __restrict__ tps,
                                        const int* __restrict__ windows,
                                        float* __restrict__ out,
                                        int block, int window) {
    extern __shared__ float smem[];
    float* tab = smem;
    float* acc = tab + window * kTexels;
    int* cnt = reinterpret_cast<int*>(acc + kGroup);
    stage_window(table, windows, window, tab, acc, cnt);

    const size_t base = static_cast<size_t>(blockIdx.x) * block;
    const uint32_t* g = reinterpret_cast<const uint32_t*>(fields) + base;
    const float* tp = tps + base;
    for (int i = threadIdx.x; i < block; i += blockDim.x) {
        const uint32_t p = g[i];
        const int li = static_cast<int>(p >> 23);
        if (li >= window) continue;  // padding slot (lidx = 511)
        const int cid = static_cast<int>((p >> 16) & 0x7Fu);
        const float x1 = static_cast<float>((p >> 8) & 0xFFu) * kInv255;
        const float y1 = static_cast<float>(p & 0xFFu) * kInv255;
        float tr, tg, tb;
        unpack_target(tp[i], &tr, &tg, &tb);
        score_sample(tab, li, x1, y1, tr, tg, tb, cid, acc, cnt);
    }
    write_partials(out, acc, cnt);
}

constexpr int kThreads = 256;

size_t smem_bytes(int window) {
    return (static_cast<size_t>(window) * kTexels + 2 * kGroup) * sizeof(float);
}

}  // namespace

extern "C" int slab_partials_launch(const void* table, const void* fields,
                                    const void* windows, void* out, int nb,
                                    int block, int window, void* stream) {
    slab_partials_kernel<<<nb, kThreads, smem_bytes(window),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(fields),
        static_cast<const int*>(windows), static_cast<float*>(out), block,
        window);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int slab_partials_compact_launch(const void* table,
                                            const void* fields,
                                            const void* tps,
                                            const void* windows, void* out,
                                            int nb, int block, int window,
                                            void* stream) {
    slab_partials_compact_kernel<<<nb, kThreads, smem_bytes(window),
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(fields),
        static_cast<const float*>(tps), static_cast<const int*>(windows),
        static_cast<float*>(out), block, window);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int slab_partials_q8_launch(const void* table, const void* fields,
                                       const void* tps, const void* windows,
                                       void* out, int nb, int block,
                                       int window, void* stream) {
    slab_partials_q8_kernel<<<nb, kThreads, smem_bytes(window),
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(fields),
        static_cast<const float*>(tps), static_cast<const int*>(windows),
        static_cast<float*>(out), block, window);
    return static_cast<int>(cudaGetLastError());
}
