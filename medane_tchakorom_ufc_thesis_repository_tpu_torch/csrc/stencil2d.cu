// Hopper (sm_90a) kernels E and L, and the 2D half of kernel M (the
// multigrid cycle's coarse Chebyshev solve in one launch, whose device code
// is in chebyshev_coarse.cuh): the matrix-free 2D 5-point Poisson apply on
// a batch of Dirichlet rectangles,
//
//   y[b,i,j] = diag*x[b,i,j] + off*(((x[b,i-1,j] + x[b,i+1,j]) + x[b,i,j-1]) + x[b,i,j+1])
//
// with zero outside each (m, n) slab: the batch index is a hard boundary.
//
// Replaces ops/stencil_pallas.py:stencil2d_mv_pallas (_kernel2d, one grid)
// and ops/fused_pallas.py:stencil2d_spmm_pallas (_spmm2d_kernel, R = A S for
// an (s, m, n) basis panel): one kernel serves both, the panel being a batch
// of s grids.  The multisplitting strips A_ii x_i are the same operator on
// each (rows, n) strip, so a stack of strips is a batch too.
//
// Kernel L is the same kernel with a fused residual norm: it replaces
// ops/fused_pallas.py:stencil2d_mv_norm_pallas (_mv_norm2d_kernel), y = A x
// and ||b - y||^2 of one grid in one pass.  Its y has kernel E's bits (one
// kernel template, one expression).  Each block writes the partial sum of
// its (b - y)^2 and a second one-block kernel adds the partials in a fixed
// order: no float atomics, so two launches give equal bits.  (The Pallas
// kernel carried the sum across its sequential grid.)  Bound: memory bytes,
// reads of x and b and one write: 12 bytes a point in f32 (0.81 GB at
// 8192^2, 0.24 ms).
//
// Plain C interface, bound with ctypes by ops/stencil2d.py and ops/fused.py.
// The entry points launch on the stream they are given, allocate nothing,
// and return the cudaError_t of their launches.  Storage and arithmetic are
// f32 or f64 (dtype code 0 or 2), or, for kernel E only, bf16 storage (code
// 1: the level-0 applies of a bf16 multigrid cycle) with f32 arithmetic and
// one rounding where y is stored; indices are 64-bit (a basis panel at
// 8192^2 holds s x 2^26 points).  The file builds with -fmad=false: the apply is then rounded
// operation by operation in the order of the plain PyTorch version
// (stencil2d_apply_plain), and agrees with it bit for bit.
//
// Bound: memory bytes.  One read of x and one write of y: 8 bytes a point
// in f32 (0.54 GB at 8192^2, 0.16 ms at 3.35 TB/s), 16 in f64.
//
// Design: one thread per column j and slab of ROWS rows, threads along j
// so that a warp reads 32 neighbouring values of a row; each thread walks
// its slab keeping x[i-1,j], x[i,j] and x[i+1,j] in registers, and re-reads
// the j-1 and j+1 neighbours through L1.  What the simple design gives up:
// no shared-memory tile or TMA staging of the rows, no 16-byte vector loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { F32 = 0, BF16 = 1, F64 = 2 };

// the arithmetic type of a storage type
template <typename T> struct Compute { typedef T type; };
template <> struct Compute<bf16> { typedef float type; };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ double load(const double* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const bf16* p, int64_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(double* p, int64_t i, double v) { p[i] = v; }
__device__ __forceinline__ void store(bf16* p, int64_t i, float v) { p[i] = __float2bfloat16_rn(v); }

constexpr int BX = 32;     // threads along n
constexpr int BY = 8;      // threads along m
constexpr int ROWS = 16;   // rows walked by one thread
constexpr int64_t MAX_GRID_YZ = 65535;

constexpr int FINISH_THREADS = 1024;

// A c at one point from its four neighbours: the one expression kernels E,
// L and M evaluate, rounded op by op (the file builds with -fmad=false).
template <typename TC>
__device__ __forceinline__ TC stencil5(TC diag, TC off, TC c, TC up, TC down,
                                       TC left, TC right) {
    return diag * c + off * (((up + down) + left) + right);
}

// Sum of v over the block, valid in thread 0.  Fixed order: warp shuffles,
// then the warp sums in warp order.
template <int THREADS, typename T>
__device__ __forceinline__ T block_sum(T v) {
    __shared__ T warp_sums[THREADS / 32];
    const int t = threadIdx.x + threadIdx.y * blockDim.x;
    const int lane = t & 31, warp = t >> 5;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    T s = T(0);
    if (warp == 0) {
        s = lane < THREADS / 32 ? warp_sums[lane] : T(0);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    }
    return s;
}

// NORM: also read b and write the block's partial sum of (b - y)^2.
template <typename T, bool NORM>
__global__ void __launch_bounds__(BX * BY) apply2d_kernel(
    const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y,
    typename Compute<T>::type* __restrict__ partials, int64_t m, int64_t n,
    typename Compute<T>::type diag, typename Compute<T>::type off) {
    typedef typename Compute<T>::type TC;
    const int64_t j = (int64_t)blockIdx.x * BX + threadIdx.x;
    const int64_t i0 = ((int64_t)blockIdx.y * BY + threadIdx.y) * ROWS;
    TC acc = TC(0);
    if (j < n && i0 < m) {
        const int64_t i1 = i0 + ROWS < m ? i0 + ROWS : m;
        const int64_t slab = (int64_t)blockIdx.z * m * n;
        const T* __restrict__ xs = x + slab;
        T* __restrict__ ys = y + slab;
        int64_t idx = i0 * n + j;
        TC up = i0 > 0 ? load(xs, idx - n) : TC(0);
        TC cur = load(xs, idx);
        for (int64_t i = i0; i < i1; ++i, idx += n) {
            const TC down = i + 1 < m ? load(xs, idx + n) : TC(0);
            const TC left = j > 0 ? load(xs, idx - 1) : TC(0);
            const TC right = j + 1 < n ? load(xs, idx + 1) : TC(0);
            const TC v = stencil5(diag, off, cur, up, down, left, right);
            store(ys, idx, v);
            if (NORM) {
                const TC d = load(b, slab + idx) - v;
                acc += d * d;
            }
            up = cur;
            cur = down;
        }
    }
    if (NORM) {
        const TC s = block_sum<BX * BY>(acc);
        if (threadIdx.x == 0 && threadIdx.y == 0)
            partials[blockIdx.x + (int64_t)gridDim.x *
                     (blockIdx.y + (int64_t)gridDim.y * blockIdx.z)] = s;
    }
}

// One block adds the partials: thread t takes t, t + 1024, ... in order,
// then the block sum.  Deterministic for a given partial count.
template <typename T>
__global__ void __launch_bounds__(FINISH_THREADS) sum_partials(
    const T* __restrict__ partials, int64_t n, T* __restrict__ out) {
    T s = T(0);
    for (int64_t i = threadIdx.x; i < n; i += FINISH_THREADS) s += partials[i];
    s = block_sum<FINISH_THREADS>(s);
    if (threadIdx.x == 0) out[0] = s;
}

// The launch grid, or false when the shape exceeds it.
bool grid_of(int64_t batch, int64_t m, int64_t n, dim3* grid) {
    const int64_t rows_per_block = (int64_t)BY * ROWS;
    const int64_t gx = (n + BX - 1) / BX;
    const int64_t gy = (m + rows_per_block - 1) / rows_per_block;
    if (gy > MAX_GRID_YZ || batch > MAX_GRID_YZ || gx > INT32_MAX) return false;
    *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)batch);
    return true;
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t batch, int64_t m, int64_t n,
                   double diag, double off, cudaStream_t stream) {
    dim3 grid;
    if (!grid_of(batch, m, n, &grid)) return cudaErrorInvalidValue;
    typedef typename Compute<T>::type TC;
    apply2d_kernel<T, false><<<grid, dim3(BX, BY), 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<T*>(y), nullptr, m, n,
        (TC)diag, (TC)off);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_norm(const void* x, const void* b, void* y, void* partials,
                        void* out, int64_t m, int64_t n, double diag,
                        double off, cudaStream_t stream) {
    dim3 grid;
    if (!grid_of(1, m, n, &grid)) return cudaErrorInvalidValue;
    apply2d_kernel<T, true><<<grid, dim3(BX, BY), 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(y),
        static_cast<T*>(partials), m, n, (T)diag, (T)off);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sum_partials<T><<<1, FINISH_THREADS, 0, stream>>>(
        static_cast<const T*>(partials), (int64_t)grid.x * grid.y,
        static_cast<T*>(out));
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel M (2D): the coarse Chebyshev solve, chebyshev_coarse.cuh, on a
// 5-point grid whose A d is stencil5, as kernel E evaluates it; a batch of
// grids is the stack of multisplitting strips under inner pc='mg'.
// ---------------------------------------------------------------------------

#include "chebyshev_coarse.cuh"

template <typename TC> struct Grid5 {
    int m, n;
    TC diag, off;
    __host__ __device__ __forceinline__ int points() const { return m * n; }
    // bits: row above, row below, column left, column right inside the grid
    __device__ __forceinline__ unsigned mask(int p) const {
        const int j = p % n, i = p / n;
        return (i > 0) | (i + 1 < m) << 1 | (j > 0) << 2 | (j + 1 < n) << 3;
    }
    __device__ __forceinline__ TC apply(const TC* s, int p, unsigned k) const {
        return stencil5(diag, off, s[p], k & 1 ? s[p - n] : TC(0),
                        k & 2 ? s[p + n] : TC(0), k & 4 ? s[p - 1] : TC(0),
                        k & 8 ? s[p + 1] : TC(0));
    }
};

template <typename T>
cudaError_t launch_chebyshev5(const void* b, void* x, int64_t batch, int64_t m,
                              int64_t n, double diag, double off,
                              const double* coefs, int steps, cudaStream_t s) {
    typedef typename Compute<T>::type TC;
    if (m < 1 || n < 1 || m * n > CHEB_MAX_POINTS) return cudaErrorInvalidValue;
    const Grid5<TC> g = {(int)m, (int)n, (TC)diag, (TC)off};
    return launch_chebyshev_coarse<T>(b, x, batch, g, coefs, steps, s);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y = A x on a contiguous (batch, m, n) array of f32 (dtype 0), bf16 (1) or
// f64 (2).
int stencil2d_apply(int dtype, const void* x, void* y, int64_t batch,
                    int64_t m, int64_t n, double diag, double off,
                    cudaStream_t stream) {
    if (batch < 1 || m < 1 || n < 1) return cudaErrorInvalidValue;
    switch (dtype) {
        case F32:
            return launch<float>(x, y, batch, m, n, diag, off, stream);
        case BF16:
            return launch<bf16>(x, y, batch, m, n, diag, off, stream);
        case F64:
            return launch<double>(x, y, batch, m, n, diag, off, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// Number of partial sums stencil2d_mv_norm writes, or -1 for a shape the
// launch grid cannot take.
int64_t stencil2d_mv_norm_partials(int64_t m, int64_t n) {
    dim3 grid;
    if (m < 1 || n < 1 || !grid_of(1, m, n, &grid)) return -1;
    return (int64_t)grid.x * grid.y;
}

// Kernel L: y = A x and out[0] = sum (b - y)^2 on one contiguous (m, n)
// grid of f32 (dtype 0) or f64 (2); partials (stencil2d_mv_norm_partials
// values) and out are device memory of the same type.
int stencil2d_mv_norm(int dtype, const void* x, const void* b, void* y,
                      void* partials, void* out, int64_t m, int64_t n,
                      double diag, double off, cudaStream_t stream) {
    if (m < 1 || n < 1) return cudaErrorInvalidValue;
    switch (dtype) {
        case F32:
            return launch_norm<float>(x, b, y, partials, out, m, n, diag, off, stream);
        case F64:
            return launch_norm<double>(x, b, y, partials, out, m, n, diag, off, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// Kernel M: `steps` Chebyshev steps from x0 = 0 on each of `batch`
// contiguous (m, n) grids of b, into x, of f32, bf16 or f64 (dtype 0, 1,
// 2); at most 4096 points a grid and 128 steps.  coefs: host doubles,
// inv_theta then c1[k], c2[k] (chebyshev_coarse.cuh).
int stencil2d_chebyshev(int dtype, const void* b, void* x, int64_t batch,
                        int64_t m, int64_t n, double diag, double off,
                        const double* coefs, int steps, cudaStream_t stream) {
    switch (dtype) {
        case F32:
            return launch_chebyshev5<float>(b, x, batch, m, n, diag, off, coefs, steps, stream);
        case BF16:
            return launch_chebyshev5<bf16>(b, x, batch, m, n, diag, off, coefs, steps, stream);
        case F64:
            return launch_chebyshev5<double>(b, x, batch, m, n, diag, off, coefs, steps, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // extern "C"
