// Batched masked histograms: (B, N) int32 bin ids + (B, N) f32 mask
// -> (B, num_bins) f32 counts of the entries with mask != 0 and an id in
// [0, num_bins); other ids are dropped, as the one-hot kernel drops them.
//
// Replaces: piccolo_tpu/kernels/histogram_mxu.py::_block_hist_kernel
// (launched by block_histogram_pallas), the TPU's factored hi(32) x lo(16)
// one-hot MXU dot.  On Hopper a histogram is an integer scatter, not a
// matrix product.  Counts are integers, so the result is bit-exact against
// the plain version whatever the order of the adds.
//
// Bound on the H100: bytes, 8 B an entry (id + mask) and 4 B a bin.  The
// main path's calls are stage 2's blocks of its candidates' renders
// ((320, 8192) on the library room, (128, 8192) on a 2 x 2 mesh's shard,
// (800, 131072) on OmniScenes) and a tracked frame's image rows ((3072,
// 2048), 256 bins).  At the small ones an empty kernel launched the same
// way already takes about 0.005 ms of CUDA-event time, twice the shard's
// bound.  The design, each choice timed against its alternatives on the
// main path's recorded calls and on uniform ids by
// scripts/bench_block_histogram.py (times in PERF.md):
//   * one CTA a row, its num_bins int32 counters in shared memory;
//   * 16 B loads of ids and of mask, kUnroll of each in flight a lane, the
//     next turn's loaded before this turn's adds and the first before the
//     counters are zeroed; the entries before the row's first 16 B-aligned
//     id and after its last whole vector go one at a time, and so does
//     every entry when mask is not aligned where ids is (a view that
//     starts one element in, N % 4 != 0);
//   * one shared-memory atomicAdd an entry.  Lane l of a warp holds vector
//     l of 32 consecutive ones, so the 32 lanes of one add sit four entries
//     apart: the main path's runs of equal bins (about 3 counted entries a
//     run in stage 2, 4 in a tracked frame) rarely put two lanes of one add
//     on one counter.  One add a run (shuffles and a ballot),
//     match_any-aggregated adds and warp-private counters all measured
//     slower, on coherent and on uniform ids;
//   * 512 threads a CTA when the rows fit one CTA an SM, else 256
//     (kernels/block_histogram.py::cta_threads): fewer rows get a shorter
//     chain of loads a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kUnroll = 1;  // 16 B loads of ids and of mask in flight a lane

// The entry's bin when it is counted, else -1.
__device__ __forceinline__ int counted(int id, float m, int num_bins) {
    return m != 0.0f &&
                   static_cast<unsigned>(id) < static_cast<unsigned>(num_bins)
               ? id
               : -1;
}

// Row blockIdx.x of n entries.
__global__ void __launch_bounds__(kMaxThreads)
block_histogram_kernel(const int* __restrict__ ids,
                       const float* __restrict__ mask,
                       float* __restrict__ out, int n, int num_bins) {
    extern __shared__ int hist[];
    const int row = blockIdx.x;
    const int threads = blockDim.x;
    const int* rid = ids + static_cast<size_t>(row) * n;
    const float* rmask = mask + static_cast<size_t>(row) * n;
    const int head = min(
        n, static_cast<int>((16 - reinterpret_cast<uintptr_t>(rid) % 16) % 16 /
                            sizeof(int)));
    int nvec = (n - head) / 4;
    if (reinterpret_cast<uintptr_t>(rmask + head) % 16 != 0) nvec = 0;

    const int4* ids4 = reinterpret_cast<const int4*>(rid + head);
    const float4* mask4 = reinterpret_cast<const float4*>(rmask + head);
    // lane l of a warp takes vectors l, l + 32, ... of the warp's run of
    // kUnroll * 32: the four entries of one vector go to four adds, and the
    // 32 lanes of one add sit four entries apart
    const int first = (threadIdx.x >> 5) * 32 * kUnroll + (threadIdx.x & 31);
    int4 next_ids[kUnroll];
    float4 next_mask[kUnroll];
    auto load = [&](int v0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int i = v0 + u * 32;
            if (i < nvec) {
                next_ids[u] = __ldg(ids4 + i);
                next_mask[u] = __ldg(mask4 + i);
            } else {
                next_ids[u] = make_int4(-1, -1, -1, -1);
                next_mask[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
        }
    };
    load(first);  // in flight while the counters are zeroed
    for (int j = threadIdx.x; j < num_bins; j += threads) hist[j] = 0;
    __syncthreads();
    for (int v0 = first; v0 < nvec; v0 += threads * kUnroll) {
        int4 a[kUnroll];
        float4 m[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            a[u] = next_ids[u];
            m[u] = next_mask[u];
        }
        load(v0 + threads * kUnroll);  // in flight during these adds
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int v[4] = {counted(a[u].x, m[u].x, num_bins),
                              counted(a[u].y, m[u].y, num_bins),
                              counted(a[u].z, m[u].z, num_bins),
                              counted(a[u].w, m[u].w, num_bins)};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if (v[k] >= 0) atomicAdd(&hist[v[k]], 1);
            }
        }
    }
    const int rest = n - 4 * nvec;  // the head and the tail
    for (int r = threadIdx.x; r < rest; r += threads) {
        const int i = r < head ? r : r + 4 * nvec;
        const int v = counted(__ldg(rid + i), __ldg(rmask + i), num_bins);
        if (v >= 0) atomicAdd(&hist[v], 1);
    }
    __syncthreads();
    float* orow = out + static_cast<size_t>(row) * num_bins;
    for (int j = threadIdx.x; j < num_bins; j += threads) {
        orow[j] = static_cast<float>(hist[j]);
    }
}

// The same launch with nothing in the kernel: the floor under which CUDA
// events cannot time one launch of this geometry.
__global__ void __launch_bounds__(kMaxThreads)
block_histogram_empty(const int*, const float*, float*, int, int) {}

cudaError_t launch(void (*kernel)(const int*, const float*, float*, int, int),
                   const void* ids, const void* mask, void* out, int rows,
                   int n, int num_bins, int threads, void* stream) {
    const size_t smem = static_cast<size_t>(num_bins) * sizeof(int);
    kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const float*>(mask),
        static_cast<float*>(out), n, num_bins);
    return cudaGetLastError();  // a refused launch, cleared
}

}  // namespace

// One CTA of `threads` threads a row, on `stream`.  A launch the card
// refuses (too many threads, too much shared memory) returns its error and
// never runs.
extern "C" int block_histogram_launch(const void* ids, const void* mask,
                                      void* out, int rows, int n,
                                      int num_bins, int threads,
                                      void* stream) {
    return static_cast<int>(launch(block_histogram_kernel, ids, mask, out,
                                   rows, n, num_bins, threads, stream));
}

extern "C" int block_histogram_empty_launch(int rows, int n, int num_bins,
                                            int threads, void* stream) {
    return static_cast<int>(launch(block_histogram_empty, nullptr, nullptr,
                                   nullptr, rows, n, num_bins, threads,
                                   stream));
}
