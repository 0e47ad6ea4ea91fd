// The descent's step: every start's sampling loss, its valid count and its
// analytic pose gradient in one pass over the cloud (descent_partials),
// then Adam, the plateau schedule and the translation clamp in place
// (descent_update).  Together they are one iteration of
// solver._make_step_for's step on a packed table, which autograd
// computes in about 460 small kernels.
//
// Replaces no TPU kernel: the JAX package's descent is an XLA gather under
// jax.grad (piccolo_tpu/solver.py), with no Pallas kernel.  It was added
// because the autograd step streams (starts x points)-sized f32
// intermediates through device memory once an op, while the step's own
// traffic is the cloud (28 B a point, read once), one 12-texel row a
// start-point (48 B f32, 24 B bf16, 12 B uint8) and 14 sums a start.
//
// Bound on the H100: the row gathers, bytes over 3.35 TB/s; the
// arithmetic, two atan2 and a few divisions a start-point, stays under the
// f32 roof at the main path's 6 x 240,000 and 3 x 240,000 start-points.
// The design:
//   * one thread takes kPoints points and keeps them in registers; a block
//     loops over the starts, holding kChunk starts' rotation, translation
//     and table offset in shared memory;
//   * each start-point is computed in f32 registers exactly as the plain
//     version computes it (kernels/descent_step.py; -fmad=false in the
//     build keeps every mul and add apart, as PyTorch's separate kernels
//     do, and a division by a constant is a multiply by its f32 reciprocal,
//     as PyTorch's CUDA division by a Python scalar is), so the forward
//     values and the valid count are the autograd step's on the card;
//   * the backward keeps every zero autograd gives: safe_norm's at 0, the
//     clamp's outside [-0.99, 0.99], floor's, and nothing from a point that
//     is not valid;
//   * the 14 sums (distance total, count, sum g, sum g c^T, g the gradient
//     in the camera frame, c = x - t) are reduced by warp shuffles, then
//     over the warps in shared memory, into one partial a block and start:
//     no float atomics, so every replay gives the same bits;
//   * descent_update: one block a start adds the blocks' partials in a
//     fixed order, chains the sums to t, yaw, pitch and roll, and applies
//     optim.adam_plateau_step's transition and the clamp in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 2;  // points a thread keeps in registers
constexpr int kTile = kThreads * kPoints;
constexpr int kChunk = 16;  // starts a block holds in shared memory at once
constexpr int kSums = 14;   // total, count, sum g (3), sum g c^T (9)
constexpr int kUpdateThreads = 128;

enum TableKind { kF32 = 0, kBF16 = 1, kU8 = 2 };

// PyTorch's f32 values of the Python constants of the loss and optimizer
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kInvTwoPi = 1.0f / static_cast<float>(6.283185307179586);
constexpr float kInvPi = 1.0f / static_cast<float>(3.141592653589793);
constexpr float kOffset = static_cast<float>(1e-6);
constexpr float kClip = static_cast<float>(0.99);
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kBeta1 = static_cast<float>(0.9);
constexpr float kBeta2 = static_cast<float>(0.999);
constexpr float kOneMinusBeta1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusBeta2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = static_cast<float>(1e-8);
constexpr float kRel = static_cast<float>(1.0 - 1e-4);
constexpr float kLrEps = static_cast<float>(1e-8);

struct Cloud {
    const float* xyz;            // (n, 3)
    const float* rgb;            // (n, 3)
    const unsigned char* mask;   // (n,) bool, or null
    int n;
    const void* table;           // (rows, 12) packed texels
    long long rows;
    int height;
    int width;
};

struct Poses {
    const float* t;       // (starts, 3)
    const float* yaw;     // (starts,)
    const float* pitch;
    const float* roll;
    const int* offset;    // (starts,) table row offset, or null
    int starts;
};

struct State {  // the step's 16 leaves and the loss, each (starts, ...)
    float* t;
    float* yaw;
    float* pitch;
    float* roll;
    float* m[4];  // t, yaw, pitch, roll
    float* v[4];
    int* count;
    float* lr;
    float* best;
    int* num_bad;
    float* loss;
};

struct Box {  // the clamp box broadcast against (starts, 3)
    const float* lo;
    const float* hi;
    long long lo_s, lo_k, hi_s, hi_k;
};

struct Start {
    float R[9];
    float t[3];
    int offset;
};

// a @ b for 3 x 3 row-major matrices, summed j = 0, 1, 2 (ops/rotation.py)
__device__ void mat33(const float* a, const float* b, float* out) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            out[i * 3 + k] = a[i * 3 + 0] * b[0 * 3 + k] +
                             a[i * 3 + 1] * b[1 * 3 + k] +
                             a[i * 3 + 2] * b[2 * 3 + k];
        }
    }
}

// R = RZ(yaw) @ RY(pitch) @ RX(roll), and with `d` its derivatives by the
// three angles
__device__ void rotation(float yaw, float pitch, float roll, float* R,
                         float (*d)[9] = nullptr) {
    const float cz = cosf(yaw), sz = sinf(yaw);
    const float cy = cosf(pitch), sy = sinf(pitch);
    const float cx = cosf(roll), sx = sinf(roll);
    const float Z[9] = {cz, -sz, 0.0f, sz, cz, 0.0f, 0.0f, 0.0f, 1.0f};
    const float Y[9] = {cy, 0.0f, sy, 0.0f, 1.0f, 0.0f, -sy, 0.0f, cy};
    const float X[9] = {1.0f, 0.0f, 0.0f, 0.0f, cx, -sx, 0.0f, sx, cx};
    float ZY[9];
    mat33(Z, Y, ZY);
    mat33(ZY, X, R);
    if (d == nullptr) return;
    const float dZ[9] = {-sz, -cz, 0.0f, cz, -sz, 0.0f, 0.0f, 0.0f, 0.0f};
    const float dY[9] = {-sy, 0.0f, cy, 0.0f, 0.0f, 0.0f, -cy, 0.0f, -sy};
    const float dX[9] = {0.0f, 0.0f, 0.0f, 0.0f, -sx, -cx, 0.0f, cx, -sx};
    float tmp[9];
    mat33(dZ, Y, tmp);
    mat33(tmp, X, d[0]);
    mat33(Z, dY, tmp);
    mat33(tmp, X, d[1]);
    mat33(ZY, dX, d[2]);
}

// torch.clamp's NaN-keeping min/max
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float bf16_bits(unsigned bits) {
    return __uint_as_float(bits << 16);
}

// the 12 texels of packed row `row`, in f32
template <int kKind>
__device__ __forceinline__ void gather(const void* table, long long row,
                                       float* g) {
    if (kKind == kF32) {
        const float4* p = reinterpret_cast<const float4*>(table) + row * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const float4 q = __ldg(p + i);
            g[4 * i] = q.x;
            g[4 * i + 1] = q.y;
            g[4 * i + 2] = q.z;
            g[4 * i + 3] = q.w;
        }
    } else if (kKind == kBF16) {
        const uint2* p = reinterpret_cast<const uint2*>(table) + row * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const uint2 q = __ldg(p + i);
            g[4 * i] = bf16_bits(q.x & 0xffffu);
            g[4 * i + 1] = bf16_bits(q.x >> 16);
            g[4 * i + 2] = bf16_bits(q.y & 0xffffu);
            g[4 * i + 3] = bf16_bits(q.y >> 16);
        }
    } else {
        const unsigned* p = reinterpret_cast<const unsigned*>(table) + row * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const unsigned q = __ldg(p + i);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                g[4 * i + b] =
                    static_cast<float>((q >> (8 * b)) & 0xffu) * kInv255;
            }
        }
    }
}

// One valid start-point's terms added to acc: its colour distance, 1, the
// distance's gradient g in the camera frame and g c^T.  A point that is
// not valid adds nothing.
template <int kKind, bool kWrap>
__device__ __forceinline__ void add_point(const Start& st, const float* p,
                                          const float* rgb,
                                          const Cloud& cloud, float* acc) {
    const float c0 = p[0] - st.t[0];
    const float c1 = p[1] - st.t[1];
    const float c2 = p[2] - st.t[2];
    const float* R = st.R;
    const float xc = c0 * R[0] + c1 * R[1] + c2 * R[2];
    const float yc = c0 * R[3] + c1 * R[4] + c2 * R[5];
    const float zc = c0 * R[6] + c1 * R[7] + c2 * R[8];
    // spherical_project
    const float sq = xc * xc + yc * yc;
    const bool pos = sq > 0.0f;
    const float rho = pos ? sqrtf(sq) : 0.0f;
    const float zz = zc + kOffset;
    const float theta = atan2f(rho, zz);
    const float xx = xc + kOffset;
    const float phi = atan2f(yc, xx) + kPi;
    const float u = 2.0f * (1.0f - phi * kInvTwoPi) - 1.0f;
    const float v = 2.0f * (theta * kInvPi) - 1.0f;
    // packed_rows_and_weights: the clip, or the seam's wrap, then pixels
    float xn;
    if (kWrap) {
        float a = fmodf(u + 1.0f, 2.0f);
        if (a != 0.0f && a < 0.0f) a += 2.0f;
        xn = a - 1.0f;
    } else {
        xn = clampf(u, -kClip, kClip);
    }
    const float yn = clampf(v, -kClip, kClip);
    const float W = static_cast<float>(cloud.width);
    const float H = static_cast<float>(cloud.height);
    const float x = ((xn + 1.0f) * W - 1.0f) * 0.5f;
    const float y = ((yn + 1.0f) * H - 1.0f) * 0.5f;
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    long long row = static_cast<long long>(
        (static_cast<int>(y0f) + 1) * (cloud.width + 1) +
        (static_cast<int>(x0f) + 1) + st.offset);
    if (row < 0 || row >= cloud.rows) row = 0;  // only a NaN pose lands here
    float g[12];
    gather<kKind>(cloud.table, row, g);
    const float wx1 = x - x0f;
    const float wy1 = y - y0f;
    const float wx0 = 1.0f - wx1;
    const float wy0 = 1.0f - wy1;
    const float w00 = wx0 * wy0, w10 = wx1 * wy0;
    const float w01 = wx0 * wy1, w11 = wx1 * wy1;
    float s[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        s[c] = g[c] * w00 + g[3 + c] * w10 + g[6 + c] * w01 + g[9 + c] * w11;
    }
    if (s[0] == 0.0f && s[1] == 0.0f && s[2] == 0.0f) return;  // black
    const float d0 = s[0] - rgb[0];
    const float d1 = s[1] - rgb[1];
    const float d2 = s[2] - rgb[2];
    const float dsq = d0 * d0 + d1 * d1 + d2 * d2;
    const bool dpos = dsq > 0.0f;
    const float dist = dpos ? sqrtf(dsq) : 0.0f;
    acc[0] += dist;
    acc[1] += 1.0f;
    if (!dpos) return;  // safe_norm's zero gradient at the origin
    // the distance's gradient by the sample, then by the lerp weights
    const float inv = 1.0f / dist;
    const float gs[3] = {d0 * inv, d1 * inv, d2 * inv};
    float gwx = 0.0f, gwy = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        gwx += gs[c] * (wy0 * (g[3 + c] - g[c]) + wy1 * (g[9 + c] - g[6 + c]));
        gwy += gs[c] * (wx0 * (g[6 + c] - g[c]) + wx1 * (g[9 + c] - g[3 + c]));
    }
    // floor passes nothing, the wrap's remainder 1, the clamp its interval
    const float gu = (kWrap || (u >= -kClip && u <= kClip)) ? gwx * (W * 0.5f)
                                                            : 0.0f;
    const float gv = (v >= -kClip && v <= kClip) ? gwy * (H * 0.5f) : 0.0f;
    const float gphi = gu * (-2.0f * kInvTwoPi);
    const float gtheta = gv * (2.0f * kInvPi);
    // phi = atan2(yc, xx), theta = atan2(rho, zz)
    const float rphi = 1.0f / (xx * xx + yc * yc);
    const float rtheta = 1.0f / (rho * rho + zz * zz);
    float gx = -yc * gphi * rphi;
    float gy = xx * gphi * rphi;
    const float gz = -rho * gtheta * rtheta;
    if (pos) {  // safe_norm(xc, yc): no gradient at the pole
        const float grho = zz * gtheta * rtheta / rho;
        gx += grho * xc;
        gy += grho * yc;
    }
    acc[2] += gx;
    acc[3] += gy;
    acc[4] += gz;
    const float gcam[3] = {gx, gy, gz};
    const float cw[3] = {c0, c1, c2};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[5 + 3 * j + k] += gcam[j] * cw[k];
    }
}

// Block b's partial sums of every start over its kTile points, written to
// partials[(s * kSums + k) * gridDim.x + b].
template <int kKind, bool kWrap>
__global__ void __launch_bounds__(kThreads)
descent_partials_kernel(Cloud cloud, Poses poses, float* __restrict__ partials) {
    __shared__ Start starts[kChunk];
    __shared__ float warp_sums[kWarps][kChunk][kSums];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float px[kPoints][3], pc[kPoints][3];
    bool live[kPoints];
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
        const int i = blockIdx.x * kTile + p * kThreads + threadIdx.x;
        live[p] = i < cloud.n && (cloud.mask == nullptr || cloud.mask[i] != 0);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            px[p][k] = live[p] ? __ldg(cloud.xyz + 3 * i + k) : 0.0f;
            pc[p][k] = live[p] ? __ldg(cloud.rgb + 3 * i + k) : 0.0f;
        }
    }
    for (int s0 = 0; s0 < poses.starts; s0 += kChunk) {
        const int cs = min(kChunk, poses.starts - s0);
        __syncthreads();  // the last chunk's starts and sums are read
        if (threadIdx.x < cs) {
            const int s = s0 + threadIdx.x;
            Start& st = starts[threadIdx.x];
            rotation(poses.yaw[s], poses.pitch[s], poses.roll[s], st.R);
#pragma unroll
            for (int k = 0; k < 3; ++k) st.t[k] = poses.t[3 * s + k];
            st.offset = poses.offset == nullptr ? 0 : poses.offset[s];
        }
        __syncthreads();
        for (int j = 0; j < cs; ++j) {
            float acc[kSums];
#pragma unroll
            for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
#pragma unroll
            for (int p = 0; p < kPoints; ++p) {
                if (live[p]) {
                    add_point<kKind, kWrap>(starts[j], px[p], pc[p], cloud,
                                            acc);
                }
            }
#pragma unroll
            for (int k = 0; k < kSums; ++k) {
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
                }
            }
            if (lane == 0) {
#pragma unroll
                for (int k = 0; k < kSums; ++k) warp_sums[warp][j][k] = acc[k];
            }
        }
        __syncthreads();
        for (int e = threadIdx.x; e < cs * kSums; e += kThreads) {
            const int j = e / kSums, k = e % kSums;
            float total = 0.0f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) total += warp_sums[w][j][k];
            partials[(static_cast<size_t>(s0 + j) * kSums + k) * gridDim.x +
                     blockIdx.x] = total;
        }
    }
}

// Start blockIdx.x: the blocks' partials added in a fixed order, the loss
// and pose gradient, then Adam + plateau + clamp, written in place.
__global__ void __launch_bounds__(kUpdateThreads)
descent_update_kernel(const float* __restrict__ partials, int blocks,
                      State st, Box box, int patience, float factor) {
    __shared__ float sums[kSums][kUpdateThreads];
    __shared__ long long counts[kUpdateThreads];
    const int s = blockIdx.x;
    const int tid = threadIdx.x;
    const float* mine = partials + static_cast<size_t>(s) * kSums * blocks;
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
        float acc = 0.0f;
        long long n = 0;
        for (int b = tid; b < blocks; b += kUpdateThreads) {
            const float x = mine[static_cast<size_t>(k) * blocks + b];
            if (k == 1) {
                n += static_cast<long long>(x);  // a block's count is exact
            } else {
                acc += x;
            }
        }
        sums[k][tid] = acc;
        if (k == 1) counts[tid] = n;
    }
    __syncthreads();
    for (int stride = kUpdateThreads / 2; stride > 0; stride >>= 1) {
        if (tid < stride) {
#pragma unroll
            for (int k = 0; k < kSums; ++k) sums[k][tid] += sums[k][tid + stride];
            counts[tid] += counts[tid + stride];
        }
        __syncthreads();
    }
    if (tid != 0) return;
    const long long count = counts[0];
    const float cf = static_cast<float>(count);
    // masked_mean: +inf where the start samples nothing, with no gradient
    const float loss = count > 0 ? sums[0][0] / cf : INFINITY;
    float R[9], dR[3][9];
    rotation(st.yaw[s], st.pitch[s], st.roll[s], R, dR);
    float grad[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (count > 0) {
        // x_cam = R (x - t): d/dt = -R^T sum g, d/dR = sum g c^T
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            grad[k] = -(R[k] * sums[2][0] + R[3 + k] * sums[3][0] +
                        R[6 + k] * sums[4][0]) / cf;
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float acc = 0.0f;
#pragma unroll
            for (int e = 0; e < 9; ++e) acc += sums[5 + e][0] * dR[a][e];
            grad[3 + a] = acc / cf;
        }
    }
    // optim.adam_plateau_step, torch's factorisation, then the clamp
    const int step = st.count[s] + 1;
    const float stepf = static_cast<float>(step);
    const float bc1 = 1.0f - powf(kBeta1, stepf);
    const float bc2 = 1.0f - powf(kBeta2, stepf);
    const float lr = st.lr[s];
    const float step_size = lr / bc1;
    const float sqrt_bc2 = sqrtf(bc2);
    float* params[6] = {st.t + 3 * s, st.t + 3 * s + 1, st.t + 3 * s + 2,
                        st.yaw + s, st.pitch + s, st.roll + s};
    float* ms[6] = {st.m[0] + 3 * s, st.m[0] + 3 * s + 1, st.m[0] + 3 * s + 2,
                    st.m[1] + s, st.m[2] + s, st.m[3] + s};
    float* vs[6] = {st.v[0] + 3 * s, st.v[0] + 3 * s + 1, st.v[0] + 3 * s + 2,
                    st.v[1] + s, st.v[2] + s, st.v[3] + s};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const float g = grad[i];
        const float m = kBeta1 * *ms[i] + kOneMinusBeta1 * g;
        const float v = kBeta2 * *vs[i] + kOneMinusBeta2 * g * g;
        float p = *params[i] - step_size * m / (sqrtf(v) / sqrt_bc2 + kEps);
        if (i < 3) {
            p = clampf(p, box.lo[s * box.lo_s + i * box.lo_k],
                       box.hi[s * box.hi_s + i * box.hi_k]);
        }
        *ms[i] = m;
        *vs[i] = v;
        *params[i] = p;
    }
    const float best = st.best[s];
    const bool better = loss < best * kRel;
    int num_bad = better ? 0 : st.num_bad[s] + 1;
    const bool reduce = num_bad > patience;
    const float cand = lr * factor;
    st.lr[s] = (reduce && lr - cand > kLrEps) ? cand : lr;
    st.num_bad[s] = reduce ? 0 : num_bad;
    st.best[s] = better ? loss : best;
    st.count[s] = step;
    st.loss[s] = loss;
}

using PartialsKernel = void (*)(Cloud, Poses, float*);

template <int kKind>
PartialsKernel pick(bool wrap) {
    return wrap ? descent_partials_kernel<kKind, true>
                : descent_partials_kernel<kKind, false>;
}

}  // namespace

// The number of blocks (and partials a start and sum) for n points.
extern "C" int descent_partials_blocks(int n) {
    return (n + kTile - 1) / kTile;
}

// pose: the t, yaw, pitch and roll pointers.  partials holds
// starts x 14 x descent_partials_blocks(n) floats.  A launch the card
// refuses returns its error and never runs.
extern "C" int descent_partials_launch(const void* xyz, const void* rgb,
                                       const void* mask, int n,
                                       const void* table, int kind,
                                       long long rows, int height, int width,
                                       int wrap, const void* const* pose,
                                       const void* offset, int starts,
                                       void* partials, void* stream) {
    const int blocks = descent_partials_blocks(n);
    if (blocks == 0 || starts == 0) return 0;
    const Cloud cloud{static_cast<const float*>(xyz),
                      static_cast<const float*>(rgb),
                      static_cast<const unsigned char*>(mask), n, table, rows,
                      height, width};
    const Poses poses{static_cast<const float*>(pose[0]),
                      static_cast<const float*>(pose[1]),
                      static_cast<const float*>(pose[2]),
                      static_cast<const float*>(pose[3]),
                      static_cast<const int*>(offset), starts};
    PartialsKernel kernel = kind == kF32    ? pick<kF32>(wrap != 0)
                            : kind == kBF16 ? pick<kBF16>(wrap != 0)
                                            : pick<kU8>(wrap != 0);
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        cloud, poses, static_cast<float*>(partials));
    return static_cast<int>(cudaGetLastError());
}

// state: t, yaw, pitch, roll, their Adam m and v (4 each), count, lr, best,
// num_bad and the loss, each contiguous over the starts.  lo and hi are
// read at s * *_s + k * *_k (element strides of their broadcast to
// (starts, 3)).
extern "C" int descent_update_launch(const void* partials, int blocks,
                                     void* const* state, const void* lo,
                                     const void* hi, long long lo_s,
                                     long long lo_k, long long hi_s,
                                     long long hi_k, int starts, int patience,
                                     float factor, void* stream) {
    if (starts == 0) return 0;
    State st;
    st.t = static_cast<float*>(state[0]);
    st.yaw = static_cast<float*>(state[1]);
    st.pitch = static_cast<float*>(state[2]);
    st.roll = static_cast<float*>(state[3]);
    for (int i = 0; i < 4; ++i) {
        st.m[i] = static_cast<float*>(state[4 + i]);
        st.v[i] = static_cast<float*>(state[8 + i]);
    }
    st.count = static_cast<int*>(state[12]);
    st.lr = static_cast<float*>(state[13]);
    st.best = static_cast<float*>(state[14]);
    st.num_bad = static_cast<int*>(state[15]);
    st.loss = static_cast<float*>(state[16]);
    const Box box{static_cast<const float*>(lo), static_cast<const float*>(hi),
                  lo_s, lo_k, hi_s, hi_k};
    descent_update_kernel<<<starts, kUpdateThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(partials), blocks, st, box, patience, factor);
    return static_cast<int>(cudaGetLastError());
}
