// One masked histogram: (N,) int32 bin ids weighted by an (N,) f32 mask
// -> (num_bins,) f32 sums of the mask over the entries of each bin; ids
// outside [0, num_bins) are dropped, as the one-hot kernel drops them.
//
// Replaces: piccolo_tpu/kernels/histogram_mxu.py::_hist_kernel (launched
// by histogram_pallas), a (1, TILE) @ (TILE, num_bins) one-hot MXU dot
// accumulated over tiles of N.  On Hopper a histogram is a scatter, not a
// matrix product.
//
// Bound on the H100: bytes, 8 B an entry (id + mask) and 4 B a bin; below
// a few hundred thousand entries the launch itself costs more.  What the
// design does:
//   * loads are 16 B a thread (four ids, four mask values), streamed; a
//     scalar head and tail cover N % 4 and a base that is not 16 B aligned
//     (every entry goes the scalar way when ids and mask are misaligned
//     against each other);
//   * each warp owns its num_bins bins in shared memory, and the CTA runs as
//     many warps (up to 8) as their bins and tags fit.  The lanes of one
//     bin add into it in lane order, in rounds: in each round the lowest
//     lane of every bin still to add wins an integer atomicMax on the bin's
//     tag (a stamp the round makes anew) and adds its mask.  Random ids
//     rarely share a bin, so most entries take one round.  There are no
//     float atomics: shared ones are compare-and-swap loops, and their
//     order, like that of bins shared by warps, would change the sums from
//     run to run; match_any, which the slab kernels use, costs a step for
//     each distinct value among the lanes, and here they are mostly
//     distinct;
//   * each CTA adds its warps' bins in warp order into its row of (n_cta,
//     num_bins) partials, with no global atomic; a second small launch adds
//     the rows in a fixed order.
// So the result is the same bits on every run for any mask.  With 0/1
// masks and counts below 2^24 every partial sum is an integer that f32
// holds exactly: the result is bit-exact against the plain version and
// against histogram_pallas.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kReduceThreads = kMaxWarps * 32;
constexpr size_t kMaxSmem = 232448;  // shared memory a CTA may use on Hopper
constexpr unsigned kFull = 0xffffffffu;

// Warps a CTA runs for num_bins: each owns num_bins f32 bins and as many
// int32 tags in shared memory.
int hist_warps(int num_bins) {
    const int w = static_cast<int>(
        kMaxSmem / (static_cast<size_t>(num_bins) * 2 * sizeof(float)));
    return w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
}

size_t hist_smem(int num_bins) {
    return static_cast<size_t>(hist_warps(num_bins)) * num_bins * 2 *
           sizeof(float);
}

// Add one entry a lane into the warp's bins, in lane order within a bin,
// without float atomics.  All 32 lanes call it with the warp's round count
// (the same in every lane); entries whose id is out of range or whose mask
// is 0 add nothing.  A round's stamps, round * 32 + 31 - lane, exceed every
// earlier round's, so tags need no reset.  A warp makes at most one round
// for each entry it takes, and takes fewer than 2^26 (N < 2^31 over at least
// 32 warps), so the stamps do not overflow.
__device__ __forceinline__ void warp_bin_add(float* bins, int* tags,
                                             int& round, int id, float m,
                                             int num_bins) {
    const int lane = threadIdx.x & 31;
    bool pending = m != 0.0f &&
                   static_cast<unsigned>(id) < static_cast<unsigned>(num_bins);
    while (__any_sync(kFull, pending)) {
        const int stamp = ++round * 32 + 31 - lane;
        if (pending) atomicMax(&tags[id], stamp);
        __syncwarp();
        if (pending && tags[id] == stamp) {  // the lowest pending lane
            bins[id] += m;
            pending = false;
        }
        __syncwarp();
    }
}

// Entries [0, head) and [head + 4 * nvec, n) one at a time, the 4 * nvec
// between them 16 B at a time; entry i always goes to the same lane of the
// same warp, in the same turn.
__global__ void masked_histogram_kernel(const int* __restrict__ ids,
                                        const float* __restrict__ mask,
                                        float* __restrict__ partials, int n,
                                        int head, int nvec, int num_bins) {
    extern __shared__ float smem[];  // every warp's bins, then its tags
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    float* all_bins = smem;
    int* all_tags = reinterpret_cast<int*>(smem + warps * num_bins);
    for (int i = threadIdx.x; i < warps * num_bins; i += blockDim.x) {
        all_bins[i] = 0.0f;
        all_tags[i] = 0;
    }
    __syncthreads();
    float* bins = all_bins + warp * num_bins;
    int* tags = all_tags + warp * num_bins;
    int round = 0;
    const int stride = gridDim.x * blockDim.x;
    const int first = blockIdx.x * blockDim.x + warp * 32;  // warp-uniform

    const int4* ids4 = reinterpret_cast<const int4*>(ids + head);
    const float4* mask4 = reinterpret_cast<const float4*>(mask + head);
    for (int s = first; s < nvec; s += stride) {
        int4 id = make_int4(-1, -1, -1, -1);
        float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (s + lane < nvec) {
            id = __ldcs(ids4 + s + lane);
            m = __ldcs(mask4 + s + lane);
        }
        warp_bin_add(bins, tags, round, id.x, m.x, num_bins);
        warp_bin_add(bins, tags, round, id.y, m.y, num_bins);
        warp_bin_add(bins, tags, round, id.z, m.z, num_bins);
        warp_bin_add(bins, tags, round, id.w, m.w, num_bins);
    }
    const int body = 4 * nvec;
    for (int s = first; s < n - body; s += stride) {
        const int r = s + lane;
        int id = -1;
        float m = 0.0f;
        if (r < n - body) {
            const int i = r < head ? r : r + body;
            id = __ldg(ids + i);
            m = __ldg(mask + i);
        }
        warp_bin_add(bins, tags, round, id, m, num_bins);
    }
    __syncthreads();
    float* row = partials + static_cast<size_t>(blockIdx.x) * num_bins;
    for (int j = threadIdx.x; j < num_bins; j += blockDim.x) {
        float a = 0.0f;
        for (int w = 0; w < warps; ++w) a += all_bins[w * num_bins + j];
        row[j] = a;
    }
}

// out[j] = the sum of column j of partials (n_cta, num_bins), in a fixed
// order: warp w adds rows w, w + 8, ... of 32 bins (one a lane), then the
// warps' sums are added in warp order.
__global__ void __launch_bounds__(kReduceThreads)
masked_histogram_reduce(const float* __restrict__ partials,
                        float* __restrict__ out, int n_cta, int num_bins) {
    __shared__ float sums[kMaxWarps][32];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int j = blockIdx.x * 32 + lane;
    float a = 0.0f;
    if (j < num_bins) {
        for (int r = warp; r < n_cta; r += kMaxWarps) {
            a += partials[static_cast<size_t>(r) * num_bins + j];
        }
    }
    sums[warp][lane] = a;
    __syncthreads();
    if (warp == 0 && j < num_bins) {
        float t = 0.0f;
        for (int w = 0; w < kMaxWarps; ++w) t += sums[w][lane];
        out[j] = t;
    }
}

cudaError_t allow_smem(int num_bins) {
    const size_t smem = hist_smem(num_bins);
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(masked_histogram_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

}  // namespace

// CTAs of the histogram kernel the current device holds at once for
// num_bins (SMs times CTAs an SM holds).
extern "C" int masked_histogram_max_ctas(int num_bins, int* ctas) {
    *ctas = 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) err = allow_smem(num_bins);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, masked_histogram_kernel, hist_warps(num_bins) * 32,
            hist_smem(num_bins));
    }
    if (err != cudaSuccess) {
        cudaGetLastError();  // leave no sticky error for the caller
        return static_cast<int>(err);
    }
    *ctas = sms * per_sm;
    return 0;
}

// The histogram of n entries into out (num_bins,), through partials
// (n_cta, num_bins): two launches on `stream`.
extern "C" int masked_histogram_launch(const void* ids, const void* mask,
                                       void* partials, void* out, int n,
                                       int num_bins, int n_cta, void* stream) {
    // the 16 B body starts where ids is aligned; mask must be aligned there
    // too, or every entry takes the scalar way
    const uintptr_t a = reinterpret_cast<uintptr_t>(ids);
    const uintptr_t b = reinterpret_cast<uintptr_t>(mask);
    int head = static_cast<int>((16 - a % 16) % 16 / sizeof(int));
    if (head > n) head = n;
    int nvec = (n - head) / 4;
    if ((b + static_cast<uintptr_t>(head) * sizeof(float)) % 16 != 0) nvec = 0;
    cudaError_t err = allow_smem(num_bins);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    masked_histogram_kernel<<<n_cta, hist_warps(num_bins) * 32,
                              hist_smem(num_bins), s>>>(
        static_cast<const int*>(ids), static_cast<const float*>(mask),
        static_cast<float*>(partials), n, head, nvec, num_bins);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    masked_histogram_reduce<<<(num_bins + 31) / 32, kReduceThreads, 0, s>>>(
        static_cast<const float*>(partials), static_cast<float*>(out), n_cta,
        num_bins);
    return static_cast<int>(cudaGetLastError());
}
