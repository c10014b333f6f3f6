// Hopper (sm_90a) kernel E: the matrix-free 2D 5-point Poisson apply on a
// batch of Dirichlet rectangles,
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
// Plain C interface, bound with ctypes by ops/stencil2d.py.  The entry point
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launch.  Storage and arithmetic are f32 or f64 (dtype
// code 0 or 2); indices are 64-bit (a basis panel at 8192^2 holds s x 2^26
// points).  The file builds with -fmad=false: the apply is then rounded
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
#include <stdint.h>

namespace {

enum { F32 = 0, F64 = 2 };

constexpr int BX = 32;     // threads along n
constexpr int BY = 8;      // threads along m
constexpr int ROWS = 16;   // rows walked by one thread
constexpr int64_t MAX_GRID_YZ = 65535;

template <typename T>
__global__ void __launch_bounds__(BX * BY) apply2d_kernel(
    const T* __restrict__ x, T* __restrict__ y, int64_t m, int64_t n, T diag,
    T off) {
    const int64_t j = (int64_t)blockIdx.x * BX + threadIdx.x;
    const int64_t i0 = ((int64_t)blockIdx.y * BY + threadIdx.y) * ROWS;
    if (j >= n || i0 >= m) return;
    const int64_t i1 = i0 + ROWS < m ? i0 + ROWS : m;
    const int64_t slab = (int64_t)blockIdx.z * m * n;
    const T* __restrict__ xs = x + slab;
    T* __restrict__ ys = y + slab;
    int64_t idx = i0 * n + j;
    T up = i0 > 0 ? xs[idx - n] : T(0);
    T cur = xs[idx];
    for (int64_t i = i0; i < i1; ++i, idx += n) {
        const T down = i + 1 < m ? xs[idx + n] : T(0);
        const T left = j > 0 ? xs[idx - 1] : T(0);
        const T right = j + 1 < n ? xs[idx + 1] : T(0);
        ys[idx] = diag * cur + off * (((up + down) + left) + right);
        up = cur;
        cur = down;
    }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t batch, int64_t m, int64_t n,
                   double diag, double off, cudaStream_t stream) {
    const int64_t rows_per_block = (int64_t)BY * ROWS;
    const int64_t gx = (n + BX - 1) / BX;
    const int64_t gy = (m + rows_per_block - 1) / rows_per_block;
    if (gy > MAX_GRID_YZ || batch > MAX_GRID_YZ || gx > INT32_MAX)
        return cudaErrorInvalidValue;
    apply2d_kernel<T><<<dim3((unsigned)gx, (unsigned)gy, (unsigned)batch),
                        dim3(BX, BY), 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), m, n, (T)diag, (T)off);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y = A x on a contiguous (batch, m, n) array of f32 (dtype 0) or f64 (2).
int stencil2d_apply(int dtype, const void* x, void* y, int64_t batch,
                    int64_t m, int64_t n, double diag, double off,
                    cudaStream_t stream) {
    if (batch < 1 || m < 1 || n < 1) return cudaErrorInvalidValue;
    switch (dtype) {
        case F32:
            return launch<float>(x, y, batch, m, n, diag, off, stream);
        case F64:
            return launch<double>(x, y, batch, m, n, diag, off, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // extern "C"
