// One masked histogram: (N,) int32 bin ids weighted by an (N,) f32 mask
// -> (num_bins,) f32 sums of the mask over the entries of each bin; ids
// outside [0, num_bins) are dropped, as the one-hot kernel drops them.
//
// Replaces: piccolo_tpu/kernels/histogram_mxu.py::_hist_kernel (launched
// by histogram_pallas), a (1, TILE) @ (TILE, num_bins) one-hot MXU dot
// accumulated over tiles of N.  On Hopper a histogram is a scatter, not a
// matrix product: a grid-stride kernel in which every CUDA block adds its
// share of the entries into num_bins f32 bins in shared memory, then adds
// each non-zero bin into the zeroed output with one global atomicAdd.
//
// Exactness: the masks in use are 0/1 and the counts stay below 2^24, so
// every partial sum is an integer that f32 holds exactly and the order of
// the float atomics cannot change the result: it is bit-exact against the
// plain version and against histogram_pallas.  For other mask values the
// sums differ from them only by the order of the additions.
//
// Bound on the H100: bytes, 8 B per entry (id + mask) and 4 B per bin.
// Loads are coalesced 4 B a thread; vector loads and warp-private
// sub-histograms are left for later work.

#include <cuda_runtime.h>

namespace {

__global__ void masked_histogram_kernel(const int* __restrict__ ids,
                                        const float* __restrict__ mask,
                                        float* __restrict__ out, int n,
                                        int num_bins) {
    extern __shared__ float hist[];
    for (int j = threadIdx.x; j < num_bins; j += blockDim.x) hist[j] = 0.0f;
    __syncthreads();

    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const int id = ids[i];
        const float m = mask[i];
        if (m != 0.0f && id >= 0 && id < num_bins) atomicAdd(&hist[id], m);
    }
    __syncthreads();

    for (int j = threadIdx.x; j < num_bins; j += blockDim.x) {
        if (hist[j] != 0.0f) atomicAdd(&out[j], hist[j]);
    }
}

}  // namespace

extern "C" int masked_histogram_launch(const void* ids, const void* mask,
                                       void* out, int n, int num_bins,
                                       void* stream) {
    const int threads = 256;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    int blocks = (n + threads - 1) / threads;
    if (blocks > 2 * sms) blocks = 2 * sms;
    if (blocks < 1) blocks = 1;
    const size_t smem = static_cast<size_t>(num_bins) * sizeof(float);
    masked_histogram_kernel<<<blocks, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(mask),
        static_cast<float*>(out), n, num_bins);
    return static_cast<int>(cudaGetLastError());
}
