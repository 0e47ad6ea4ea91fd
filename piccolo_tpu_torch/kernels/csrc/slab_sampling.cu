// Stage-1 slab scorer: loss sum and valid count per candidate pair of one
// 128-pair group, from a room-static plan of sorted sample blocks.
//
// Replaces: piccolo_tpu/kernels/slab_sampling.py::_kernel (core
// _score_core), launched by slab_group_partials, for the f32 plan layout.
// The TPU kernel gathers texels with a one-hot MXU product over a 3-way
// bf16 split of the table, because the MXU is the TPU's only fast gather;
// an f32 gather from shared memory is exact as it is, so neither trick is
// carried over.
//
// Inputs: table (rp, 12) f32 row-major (the packed bilinear table, rows
// padded to a multiple of the window); fields (nb, 8, block) f32 with rows
// [lidx, wx1, wy1, r, g, b, cid, pid]; windows (nb,) int32.  Output
// (nb, 2, 128) f32: per block, the loss sum and the valid count of each
// pair id.  The sum over blocks happens outside, as in the JAX package.
//
// Design: one CUDA block per plan block.  The block stages its window's
// window x 12 floats into shared memory (6 KB at window 128), then each
// thread takes samples i, i + blockDim, ...: it skips the lidx = -1 /
// cid = -1 pads, lerps the 12-texel row in bilinear_sample_packed's tap
// order, drops pure-black samples, takes safe_norm's distance to the
// target rgb and adds it (and 1) into the pair's shared-memory slots with
// atomicAdd.  Built with -fmad=false: every sample's value rounds exactly
// like the plain PyTorch version; the sums differ from it only by the
// order of the float atomics (counts are exact integers).
//
// Bound on the H100: bytes.  A real sample reads 28 B (every field but
// pid), a pad slot 8 B (lidx and cid); the table windows stay hot in L2.
// Field reads are coalesced (row-wise 4 B a thread).  Blocks that hold only
// pads still stage their window; skipping them, TMA streaming of the plan
// and warp-level pre-aggregation of the atomics are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 128;
constexpr int kTexels = 12;

__global__ void slab_partials_kernel(const float* __restrict__ table,
                                     const float* __restrict__ fields,
                                     const int* __restrict__ windows,
                                     float* __restrict__ out,
                                     int block, int window) {
    extern __shared__ float smem[];
    float* tab = smem;                                  // window * 12
    float* acc = tab + window * kTexels;                // 128
    int* cnt = reinterpret_cast<int*>(acc + kGroup);    // 128

    const int b = blockIdx.x;
    const float* src = table + static_cast<size_t>(windows[b]) * window * kTexels;
    for (int i = threadIdx.x; i < window * kTexels; i += blockDim.x) {
        tab[i] = src[i];
    }
    for (int i = threadIdx.x; i < kGroup; i += blockDim.x) {
        acc[i] = 0.0f;
        cnt[i] = 0;
    }
    __syncthreads();

    const float* f = fields + static_cast<size_t>(b) * 8 * block;
    for (int i = threadIdx.x; i < block; i += blockDim.x) {
        const int li = static_cast<int>(f[i]);
        const int cid = static_cast<int>(f[6 * block + i]);
        if (li < 0 || cid < 0) continue;  // padding slot
        const float x1 = f[block + i];
        const float y1 = f[2 * block + i];
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
        if (zeros == 3) continue;  // pure-black sample
        const float d0 = s[0] - f[3 * block + i];
        const float d1 = s[1] - f[4 * block + i];
        const float d2 = s[2] - f[5 * block + i];
        const float sq = d0 * d0 + d1 * d1 + d2 * d2;
        atomicAdd(&acc[cid], sq > 0.0f ? sqrtf(sq) : 0.0f);
        atomicAdd(&cnt[cid], 1);
    }
    __syncthreads();

    float* o = out + static_cast<size_t>(b) * 2 * kGroup;
    for (int i = threadIdx.x; i < kGroup; i += blockDim.x) {
        o[i] = acc[i];
        o[kGroup + i] = static_cast<float>(cnt[i]);
    }
}

}  // namespace

extern "C" int slab_partials_launch(const void* table, const void* fields,
                                    const void* windows, void* out, int nb,
                                    int block, int window, void* stream) {
    const int threads = 256;
    const size_t smem = (static_cast<size_t>(window) * kTexels + 2 * kGroup)
                        * sizeof(float);
    slab_partials_kernel<<<nb, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(fields),
        static_cast<const int*>(windows), static_cast<float*>(out), block,
        window);
    return static_cast<int>(cudaGetLastError());
}
