// Stage 2's live splat: every candidate pose's z-buffered render of the
// cloud's colour bins, straight to per-block 512-bin counts.
//
//   * splat_keys_kernel: one thread a (candidate, point).  The point is
//     moved into the candidate's camera frame and projected as
//     loss.transform_cloud + ops/pano.py::project_pixels compute it, its
//     key (distance bits >> 14) << 10 | colour bin is packed as
//     attr_min_keys_from_pixels packs it, and an int32 atomicMin puts it in
//     the centre-tap z-buffer of its pixel.  A min does not depend on the
//     order of the adds, so the buffer is the plain version's
//     scatter-min, bit for bit.  The same launch zeroes the chunk's counts.
//   * dilate_block_hist_kernel: one CTA a tile of one block of one
//     candidate.  Each pixel's winner is the minimum over the nine taps of
//     (priority << 28) | S_p, S_p the centre buffer shifted by the tap
//     with the border clamped as ops/pano.py::_shift_min_rows clamps it,
//     of taps where S_p is not empty; its low 10 bits are the winning
//     colour bin.  A bin under 512 on a pixel where the query's pix_ok is
//     set is counted in a shared int32 histogram, which goes out as f32.
//
// Replaces no TPU kernel: the JAX package's splat is an XLA scatter-min
// and a dense 9-tap dilation (piccolo_tpu/ops/pano.py), with no Pallas
// kernel.  It was added because the plain PyTorch version widens each
// chunk's z-buffer to int64 and runs the dilation as two copies, a where
// and a minimum a tap over the whole (chunk, H, W) buffer, then lays the
// decoded bins out by block and masks them: ~70 GB of device traffic and
// ~1,400 launches a 2048x1024 query of 50 candidates, against a splat
// whose own work is 240,000 scatters and one 9-tap min over the pixels a
// candidate.
//
// Bound on the H100: f32 operations (roofline.stage2: 74 a point and
// candidate, 3 a pixel); the bytes are the cloud, read once a candidate,
// and the centre buffer, 4 B a pixel, written and read while it stays in
// the 50 MB L2 (a chunk of 4 candidates at 2048x1024 is 32 MB).  The
// design:
//   * every __ldg reads an address inside its buffer whatever the thread's
//     condition: nvcc may issue a guarded __ldg unpredicated, so the index
//     is clamped and the value selected after the load;
//   * each projection is computed in f32 exactly as the plain version
//     computes it: -fmad=false in the build keeps every mul and add apart,
//     as PyTorch's separate kernels do; a division by a Python constant is
//     a multiply by its f32 reciprocal, as PyTorch's CUDA division by a
//     scalar is; the rotation comes from PyTorch (ops/rotation.py), so the
//     keys are the plain version's;
//   * every key is below 2^28 - 1, the empty key, so signed int32
//     atomicMin orders them as the plain version's int64 min does;
//   * the dilation reads the centre buffer once: a thread walks one column
//     of its tile down kRows rows with the 3x3 neighbourhood in registers,
//     a warp 32 neighbouring columns; each lane loads its own column of the
//     next row (coalesced) and takes its neighbours' by shuffles, the
//     warp's two edge lanes loading the column beyond; a pixel off the
//     image's border takes the first non-empty tap straight from the
//     neighbourhood, and only border pixels walk the clamped taps;
//   * a run of equal bins down a thread's column goes to the shared
//     histogram as one atomicAdd.  Aggregating the adds across a warp's
//     row (shuffles and a ballot, or match_any) and one add a pixel all
//     timed slower or no faster (scripts/bench_splat_hist.py's shapes);
//   * a block is split into tiles of kCols x kRows pixels, so a chunk of 4
//     candidates x 16 blocks of 512 x 256 is 2,048 CTAs (tiles of 32 or 64
//     rows, fewer CTAs, timed 19-28% slower a call); each tile adds
//     its nonzero counts to the block's with f32 atomicAdd, exact because
//     every count is an integer below 2^24 (a block holds at most H * W
//     pixels), so the result does not depend on the order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // splat_keys_kernel: points a CTA
constexpr int kCols = 256;        // dilate_block_hist_kernel: columns a CTA
constexpr int kRows = 16;         // rows a CTA walks down
constexpr int kBins = 512;        // (8, 8, 8) colour bins; 512 = black
constexpr int kAttrBits = 10;
constexpr int kDistShift = 32 - (28 - kAttrBits);
constexpr int kEmpty = (1 << 28) - 1;  // no point: above every key

// PyTorch's f32 values of the projection's Python constants
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kInvTwoPi = 1.0f / static_cast<float>(6.283185307179586);
constexpr float kInvPi = 1.0f / static_cast<float>(3.141592653589793);
constexpr float kOffset = static_cast<float>(1e-6);

// One (candidate, point): blockIdx.y the candidate; n >= 1.  rot (k, 9)
// row-major, trans (k, 3); keys (k, height * width), filled with kEmpty by
// the caller; counts (n_counts,) zeroed on the way.
__global__ void __launch_bounds__(kThreads)
splat_keys_kernel(const float* __restrict__ xyz, const int* __restrict__ bins,
                  const unsigned char* __restrict__ mask, int n,
                  const float* __restrict__ rot,
                  const float* __restrict__ trans, int height, int width,
                  int* __restrict__ keys, float* __restrict__ counts,
                  long long n_counts) {
    const long long stride =
        static_cast<long long>(gridDim.x) * gridDim.y * blockDim.x;
    for (long long j = (static_cast<long long>(blockIdx.y) * gridDim.x +
                        blockIdx.x) * blockDim.x + threadIdx.x;
         j < n_counts; j += stride) {
        counts[j] = 0.0f;
    }
    // __ldg loads are unconditional, from an index clamped into the cloud
    // (n >= 1): see dilate_block_hist_kernel.  The mask, which may be null,
    // is read by a plain load, which the compiler does not hoist
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int ic = min(i, n - 1);
    const float p0 = __ldg(xyz + 3 * ic);
    const float p1 = __ldg(xyz + 3 * ic + 1);
    const float p2 = __ldg(xyz + 3 * ic + 2);
    const unsigned bin = static_cast<unsigned>(__ldg(bins + ic));
    if (i >= n || (mask != nullptr && mask[ic] == 0)) return;
    const int cand = blockIdx.y;
    const float* R = rot + 9 * cand;
    const float* t = trans + 3 * cand;
    // loss.transform_cloud: R @ (x - t), summed j = 0, 1, 2
    const float c0 = p0 - __ldg(t);
    const float c1 = p1 - __ldg(t + 1);
    const float c2 = p2 - __ldg(t + 2);
    const float xc = c0 * __ldg(R) + c1 * __ldg(R + 1) + c2 * __ldg(R + 2);
    const float yc = c0 * __ldg(R + 3) + c1 * __ldg(R + 4) + c2 * __ldg(R + 5);
    const float zc = c0 * __ldg(R + 6) + c1 * __ldg(R + 7) + c2 * __ldg(R + 8);
    // project_pixels: the distance, then spherical_project's u and v
    const float sq = xc * xc + yc * yc;
    const float dist = sqrtf(sq + zc * zc);
    const float rho = sq > 0.0f ? sqrtf(sq) : 0.0f;
    const float theta = atan2f(rho, zc + kOffset);
    const float phi = atan2f(yc, xc + kOffset) + kPi;
    const float u = 2.0f * (1.0f - phi * kInvTwoPi) - 1.0f;
    const float v = 2.0f * (theta * kInvPi) - 1.0f;
    const float px = (u + 1.0f) * 0.5f * static_cast<float>(width - 1);
    const float py = (v + 1.0f) * 0.5f * static_cast<float>(height - 1);
    const float row0 = floorf(py);
    const float col0 = floorf(px);
    // the plain version's flat index row0 * W + col0; one outside the
    // buffer (which only a non-finite pose gives) would fault its scatter
    if (!(fabsf(row0) < 1e9f && fabsf(col0) < 1e9f)) return;
    const long long pix = static_cast<long long>(row0) * width +
                          static_cast<long long>(col0);
    const long long hw = static_cast<long long>(height) * width;
    if (pix < 0 || pix >= hw) return;
    const unsigned bits = __float_as_uint(dist);
    const int key = static_cast<int>(((bits >> kDistShift) << kAttrBits) | bin);
    atomicMin(keys + cand * hw + pix, key);
}

// The key of tap (DR, DC) at a pixel from its 3x3 neighbourhood v (v[a][b]
// at row r - 1 + a, column c - 1 + b; kEmpty outside the image):
// _shift_min_rows along the rows, then the columns, is the min over the
// sources r0 with clip(r0 + DR, 0, H - 1) == r, which are r - DR and, where
// r + DR clamps back onto r (DR = 1 at the last row, -1 at the first), r
// itself; the same for the columns.  No wrap.
template <int DR, int DC>
__device__ __forceinline__ int tap(const int (&v)[3][3], bool first_row,
                                   bool last_row, bool first_col,
                                   bool last_col) {
    const bool row_self = (DR == 1 && last_row) || (DR == -1 && first_row);
    const bool col_self = (DC == 1 && last_col) || (DC == -1 && first_col);
    int s = v[1 - DR][1 - DC];
    if (row_self) s = min(s, v[1][1 - DC]);
    if (col_self) s = min(s, v[1 - DR][1]);
    if (row_self && col_self) s = min(s, v[1][1]);
    return s;
}

template <int P, int DR, int DC>
__device__ __forceinline__ void take(unsigned& best, const int (&v)[3][3],
                                     bool fr, bool lr, bool fc, bool lc) {
    const int s = tap<DR, DC>(v, fr, lr, fc, lc);
    if (s != kEmpty) {
        best = min(best, (static_cast<unsigned>(P) << 28) |
                             static_cast<unsigned>(s));
    }
}

// The winning colour bin of the pixel whose neighbourhood is v, or -1:
// the taps in ops/pano.py::_TAPS order (priority, dr, dc).
__device__ __forceinline__ int winner(const int (&v)[3][3], bool fr, bool lr,
                                      bool fc, bool lc) {
    unsigned best = 0xffffffffu;
    take<0, 0, 0>(best, v, fr, lr, fc, lc);
    take<1, 1, 1>(best, v, fr, lr, fc, lc);
    take<2, 1, 0>(best, v, fr, lr, fc, lc);
    take<3, 1, -1>(best, v, fr, lr, fc, lc);
    take<4, -1, 1>(best, v, fr, lr, fc, lc);
    take<5, -1, 0>(best, v, fr, lr, fc, lc);
    take<6, -1, -1>(best, v, fr, lr, fc, lc);
    take<7, 0, 1>(best, v, fr, lr, fc, lc);
    take<8, 0, -1>(best, v, fr, lr, fc, lc);
    return best == 0xffffffffu
               ? -1
               : static_cast<int>(best & ((1u << kAttrBits) - 1));
}

// The winning bin of an interior pixel (no row or column clamp applies):
// the first non-empty key in _TAPS order, each tap's source v[1 - dr][1 - dc].
__device__ __forceinline__ int interior_winner(const int (&v)[3][3]) {
    int s = v[1][2];                          // 8: (0, -1)
    s = v[1][0] != kEmpty ? v[1][0] : s;      // 7: (0, 1)
    s = v[2][2] != kEmpty ? v[2][2] : s;      // 6: (-1, -1)
    s = v[2][1] != kEmpty ? v[2][1] : s;      // 5: (-1, 0)
    s = v[2][0] != kEmpty ? v[2][0] : s;      // 4: (-1, 1)
    s = v[0][2] != kEmpty ? v[0][2] : s;      // 3: (1, -1)
    s = v[0][1] != kEmpty ? v[0][1] : s;      // 2: (1, 0)
    s = v[0][0] != kEmpty ? v[0][0] : s;      // 1: (1, 1)
    s = v[1][1] != kEmpty ? v[1][1] : s;      // 0: (0, 0)
    return s == kEmpty ? -1 : (s & ((1 << kAttrBits) - 1));
}

// blockIdx.x a tile of kCols x kRows pixels of block blockIdx.y (row-major
// over the sh x sw grid of bh x bw blocks) of candidate blockIdx.z.
// counts (k, sh * sw, kBins), zeroed by splat_keys_kernel.
__global__ void __launch_bounds__(kCols)
dilate_block_hist_kernel(const int* __restrict__ keys,
                         const unsigned char* __restrict__ pix_ok,
                         int height, int width, int sw, int bh, int bw,
                         int col_tiles, float* __restrict__ counts) {
    __shared__ int hist[kBins];
    for (int j = threadIdx.x; j < kBins; j += kCols) hist[j] = 0;
    const int cand = blockIdx.z;
    const int block = blockIdx.y;
    const int tile_r = blockIdx.x / col_tiles;
    const int tile_c = blockIdx.x % col_tiles;
    const int lane = threadIdx.x & 31;
    const int c = (block % sw) * bw + tile_c * kCols + threadIdx.x;
    const int r_begin = (block / sw) * bh + tile_r * kRows;
    const int r_end = min(r_begin + kRows, (block / sw + 1) * bh);
    const bool live = tile_c * kCols + threadIdx.x < bw;
    const int* kb = keys + static_cast<long long>(cand) * height * width;
    // row r of the buffer at this lane's column and its two neighbours: the
    // lane's own load, its neighbours' by shuffles, the warp's two edge
    // lanes loading the column beyond them; kEmpty outside the image.  Every
    // __ldg is unconditional, from a row and column clamped into the image,
    // and only its value is selected after: nvcc issues an __ldg guarded by
    // a condition without its predicate (the edge lanes' loads of row -1
    // read before the buffer, a fault where the buffer starts an
    // allocation)
    struct Row3 {
        int left, x, right;
    };
    const int c_in = min(c, width - 1);
    auto row3 = [&](int r) {
        const bool in_row = r >= 0 && r < height;
        const int* rp =
            kb + static_cast<long long>(min(max(r, 0), height - 1)) * width;
        const int x = __ldg(rp + c_in);
        Row3 out;
        out.x = in_row && c < width ? x : kEmpty;
        int left = __shfl_up_sync(0xffffffffu, out.x, 1);
        int right = __shfl_down_sync(0xffffffffu, out.x, 1);
        if (lane == 0) {
            const int e = __ldg(rp + max(c_in - 1, 0));
            left = in_row && c >= 1 ? e : kEmpty;
        }
        if (lane == 31) {
            const int e = __ldg(rp + min(c + 1, width - 1));
            right = in_row && c + 1 < width ? e : kEmpty;
        }
        out.left = c >= 1 ? left : kEmpty;
        out.right = c + 1 < width ? right : kEmpty;
        return out;
    };
    __syncthreads();
    const Row3 above = row3(r_begin - 1), here = row3(r_begin);
    int v[3][3] = {{above.left, above.x, above.right},
                   {here.left, here.x, here.right},
                   {kEmpty, kEmpty, kEmpty}};
    const bool fc = c == 0, lc = c == width - 1;
    int run_bin = -1, run = 0;
    for (int r = r_begin; r < r_end; ++r) {
        const Row3 below = row3(r + 1);
        v[2][0] = below.left;
        v[2][1] = below.x;
        v[2][2] = below.right;
        const unsigned char ok =
            __ldg(pix_ok + static_cast<long long>(r) * width + c_in);
        if (live) {
            const bool fr = r == 0, lr = r == height - 1;
            const int bin = (fr || lr || fc || lc) ? winner(v, fr, lr, fc, lc)
                                                   : interior_winner(v);
            if (bin >= 0 && bin < kBins && ok) {
                if (bin == run_bin) {
                    ++run;
                } else {
                    if (run) atomicAdd(&hist[run_bin], run);
                    run_bin = bin;
                    run = 1;
                }
            }
        }
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            v[0][b] = v[1][b];
            v[1][b] = v[2][b];
        }
    }
    if (run) atomicAdd(&hist[run_bin], run);
    __syncthreads();
    float* out = counts + (static_cast<long long>(cand) * gridDim.y + block) *
                              kBins;
    for (int j = threadIdx.x; j < kBins; j += kCols) {
        if (hist[j]) atomicAdd(out + j, static_cast<float>(hist[j]));
    }
}

}  // namespace

// The centre-tap z-buffers of k candidates over n >= 1 points, on `stream`:
// keys (k, height * width) int32 filled with 2^28 - 1 beforehand; counts'
// first n_counts floats are zeroed.  Returns the launch's CUDA error.
extern "C" int splat_keys_launch(const void* xyz, const void* bins,
                                 const void* mask, int n, const void* rot,
                                 const void* trans, int k, int height,
                                 int width, void* keys, void* counts,
                                 long long n_counts, void* stream) {
    const dim3 grid((n + kThreads - 1) / kThreads, k);
    splat_keys_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xyz), static_cast<const int*>(bins),
        static_cast<const unsigned char*>(mask), n,
        static_cast<const float*>(rot), static_cast<const float*>(trans),
        height, width, static_cast<int*>(keys), static_cast<float*>(counts),
        n_counts);
    return static_cast<int>(cudaGetLastError());
}

// The dilation and block histograms of k candidates' centre buffers, on
// `stream`: counts (k, sh * sw, 512) f32, zeroed by splat_keys_launch,
// gets each block's counts of the pixels where pix_ok (height * width,
// bool) is set.  Returns the launch's CUDA error.
extern "C" int dilate_block_hist_launch(const void* keys, const void* pix_ok,
                                        int k, int height, int width, int sh,
                                        int sw, void* counts, void* stream) {
    const int bh = height / sh, bw = width / sw;
    if (bh == 0 || bw == 0 || k == 0) return 0;  // no block: counts stay 0
    const int col_tiles = (bw + kCols - 1) / kCols;
    const int row_tiles = (bh + kRows - 1) / kRows;
    const dim3 grid(col_tiles * row_tiles, sh * sw, k);
    dilate_block_hist_kernel<<<grid, kCols, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys),
        static_cast<const unsigned char*>(pix_ok), height, width, sw, bh, bw,
        col_tiles, static_cast<float*>(counts));
    return static_cast<int>(cudaGetLastError());
}
