// Hopper (sm_90a) kernels for the matrix-free 3D 7-point Poisson stencil
// family: the apply with its fused epilogues (kernel A), the multigrid
// cycle's fused residual + restriction (kernel B) and its fused
// prolongation + Jacobi sweep (kernel C).
//
// Plain C interface, bound with ctypes by ops/stencil3d.py.  Every entry
// point launches on the stream it is given, allocates nothing, and returns
// the cudaError_t of its launches (0 on success).  Grids are C-ordered
// (nx, ny, nz) arrays, z contiguous; indices are 64-bit.  Storage is f32
// or bf16 (dtype code 0 or 1); arithmetic is f32.  The taps are summed in
// the order of the plain PyTorch versions beside the wrappers:
// diag*c + off*((((x- + x+) + y-) + y+) + (z- + z+)).
//
// All three are bound by memory bytes: a few flops per point against
// 4-12 bytes moved per point, far below the card's ~20 flop/byte balance
// for f32 outside the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { F32 = 0, BF16 = 1 };
enum { MV = 0, MV_DOT = 1, RESIDUAL = 2, JACOBI = 3, JACOBI_DOT = 4, MV_CAST = 5 };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const bf16* p, int64_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(bf16* p, int64_t i, float v) { p[i] = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// Kernel A: stencil3d_apply
//
// Replaces ops/stencil_pallas.py:stencil3d_apply_pallas (_kernel3d, kinds
// mv, mv_dot, residual, jacobi, jacobi_dot) and stencil3d_mv_cast_pallas
// (_kernel3d_mvc, here the kind mv_cast).
//
// Bound: memory bytes.  The floor is one read of x (and of b for the
// residual and Jacobi kinds) and one write of y (and of the cast copy for
// mv_cast): 8 bytes a point for an f32 mv, 1.07 GB at 512^3, 0.32 ms at
// 3.35 TB/s.
//
// Design: one thread per (y, z) column, threads along z so that a warp
// reads 32 neighbouring floats; each thread walks a slab of SLAB x planes
// and keeps its x-1, x and x+1 values in registers.  The y and z
// neighbours are re-read from global memory and served by L1/L2.  What the
// simple design gives up: no shared-memory tile or TMA staging of the
// plane, no 16-byte vector loads, and the halo reads of the y and z
// neighbours cost L1 bandwidth and instructions.
//
// The dot kinds (x.Ax for mv_dot, b.x' for jacobi_dot, both in f32 on the
// f32 value before its cast to the output type) write one partial sum per
// block; sum_partials adds the partials in a fixed order.  No float
// atomics, so a dot is the same from run to run and CG's iteration counts
// repeat.  (The Pallas kernel carried the sum across its sequential grid,
// which Hopper's blocks do not have.)
// ---------------------------------------------------------------------------

constexpr int BZ = 32;      // threads along z
constexpr int BY = 8;       // threads along y
constexpr int SLAB = 16;    // x planes walked by one thread
constexpr int NT = BZ * BY;
constexpr int FINISH_THREADS = 1024;

// Sum of v over the block, valid in thread 0.  Fixed order: warp shuffles,
// then the warp sums in warp order.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
    __shared__ float warp_sums[THREADS / 32];
    const int lane = (threadIdx.x + threadIdx.y * blockDim.x) & 31;
    const int warp = (threadIdx.x + threadIdx.y * blockDim.x) >> 5;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    float s = 0.f;
    if (warp == 0) {
        s = lane < THREADS / 32 ? warp_sums[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    }
    return s;
}

template <int KIND, typename TX, typename TO>
__global__ void __launch_bounds__(NT) apply_kernel(
    const TX* __restrict__ x, const TX* __restrict__ b, TO* __restrict__ y,
    TO* __restrict__ y2, float* __restrict__ partials, int64_t nx,
    int64_t ny, int64_t nz, float diag, float off, float omega) {
    const int64_t k = (int64_t)blockIdx.x * BZ + threadIdx.x;
    const int64_t j = (int64_t)blockIdx.y * BY + threadIdx.y;
    const int64_t i0 = (int64_t)blockIdx.z * SLAB;
    const int64_t i1 = i0 + SLAB < nx ? i0 + SLAB : nx;
    const int64_t plane = ny * nz;
    float acc = 0.f;
    if (j < ny && k < nz) {
        int64_t idx = i0 * plane + j * nz + k;
        float prev = i0 > 0 ? load(x, idx - plane) : 0.f;
        float cur = load(x, idx);
        for (int64_t i = i0; i < i1; ++i, idx += plane) {
            const float next = i + 1 < nx ? load(x, idx + plane) : 0.f;
            const float yn = j > 0 ? load(x, idx - nz) : 0.f;
            const float ys = j + 1 < ny ? load(x, idx + nz) : 0.f;
            const float zw = k > 0 ? load(x, idx - 1) : 0.f;
            const float ze = k + 1 < nz ? load(x, idx + 1) : 0.f;
            float v = diag * cur + off * ((((prev + next) + yn) + ys) + (zw + ze));
            if (KIND == RESIDUAL) {
                v = load(b, idx) - v;
            } else if (KIND == JACOBI || KIND == JACOBI_DOT) {
                const float bv = load(b, idx);
                v = cur + omega * (bv - v);
                if (KIND == JACOBI_DOT) acc += bv * v;
            } else if (KIND == MV_DOT) {
                acc += cur * v;
            }
            store(y, idx, v);
            if (KIND == MV_CAST) store(y2, idx, cur);
            prev = cur;
            cur = next;
        }
    }
    if (KIND == MV_DOT || KIND == JACOBI_DOT) {
        const float s = block_sum<NT>(acc);
        if (threadIdx.x == 0 && threadIdx.y == 0)
            partials[blockIdx.x + (int64_t)gridDim.x *
                     (blockIdx.y + (int64_t)gridDim.y * blockIdx.z)] = s;
    }
}

// One block adds the partials: thread t takes t, t + 1024, ... in order,
// then the block sum.  Deterministic for a given partial count.
__global__ void __launch_bounds__(FINISH_THREADS) sum_partials(
    const float* __restrict__ partials, int64_t n, float* __restrict__ out) {
    float s = 0.f;
    for (int64_t i = threadIdx.x; i < n; i += FINISH_THREADS) s += partials[i];
    s = block_sum<FINISH_THREADS>(s);
    if (threadIdx.x == 0) out[0] = s;
}

dim3 apply_grid(int64_t nx, int64_t ny, int64_t nz) {
    return dim3((unsigned)((nz + BZ - 1) / BZ), (unsigned)((ny + BY - 1) / BY),
                (unsigned)((nx + SLAB - 1) / SLAB));
}

template <int KIND, typename TX, typename TO>
cudaError_t launch_apply(const void* x, const void* b, void* y, void* y2,
                         void* partials, void* dot, int64_t nx, int64_t ny,
                         int64_t nz, float diag, float off, float omega,
                         cudaStream_t stream) {
    const dim3 grid = apply_grid(nx, ny, nz);
    apply_kernel<KIND, TX, TO><<<grid, dim3(BZ, BY), 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(b), static_cast<TO*>(y),
        static_cast<TO*>(y2), static_cast<float*>(partials), nx, ny, nz, diag,
        off, omega);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (KIND == MV_DOT || KIND == JACOBI_DOT) {
        const int64_t n = (int64_t)grid.x * grid.y * grid.z;
        sum_partials<<<1, FINISH_THREADS, 0, stream>>>(
            static_cast<const float*>(partials), n, static_cast<float*>(dot));
        err = cudaGetLastError();
    }
    return err;
}

template <typename TX, typename TO>
cudaError_t dispatch_kind(int kind, const void* x, const void* b, void* y,
                          void* y2, void* partials, void* dot, int64_t nx,
                          int64_t ny, int64_t nz, float diag, float off,
                          float omega, cudaStream_t s) {
    switch (kind) {
        case MV:
            return launch_apply<MV, TX, TO>(x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
        case MV_DOT:
            return launch_apply<MV_DOT, TX, TO>(x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
        case RESIDUAL:
            return launch_apply<RESIDUAL, TX, TO>(x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
        case JACOBI:
            return launch_apply<JACOBI, TX, TO>(x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
        case JACOBI_DOT:
            return launch_apply<JACOBI_DOT, TX, TO>(x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
        case MV_CAST:
            return launch_apply<MV_CAST, TX, TO>(x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
        default:
            return cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// Shared by kernels B and C: A x at one point, zero outside the grid.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float apply_at(const T* __restrict__ x, int64_t i,
                                          int64_t j, int64_t k, int64_t nx,
                                          int64_t ny, int64_t nz, float diag,
                                          float off) {
    const int64_t plane = ny * nz;
    const int64_t idx = i * plane + j * nz + k;
    const float c = load(x, idx);
    const float xn = i > 0 ? load(x, idx - plane) : 0.f;
    const float xs = i + 1 < nx ? load(x, idx + plane) : 0.f;
    const float yn = j > 0 ? load(x, idx - nz) : 0.f;
    const float ys = j + 1 < ny ? load(x, idx + nz) : 0.f;
    const float zw = k > 0 ? load(x, idx - 1) : 0.f;
    const float ze = k + 1 < nz ? load(x, idx + 1) : 0.f;
    return diag * c + off * ((((xn + xs) + yn) + ys) + (zw + ze));
}

constexpr int POINT_THREADS = 256;

// ---------------------------------------------------------------------------
// Kernel B: stencil3d_residual_restrict
//
// Replaces ops/stencil_pallas.py:stencil3d_residual_restrict_pallas
// (_kernel3d_rr): rc = (scale/8) * sum over each 2x2x2 cell of (b - A x),
// written only to the (nx/2, ny/2, nz/2) coarse grid.  The fine residual
// never reaches device memory.
//
// Bound: memory bytes, one read of x and b and a write of rc (1/8 size):
// 8.5 bytes a fine point in f32.
//
// Design: one thread per coarse point computes its 8 fine residuals, each
// from 7 reads of x served by L1/L2.  The sums run over x pairs, then y
// pairs, then z pairs, and the result is rounded once to the storage type.
// (The Pallas kernel's 0/1 pairing matmuls were a Mosaic work-around for
// strided addressing and are not ported; in bf16 it rounded the pair sums
// twice.)  What the simple design gives up: neighbouring threads read
// every other z element, so loads are half coalesced, and each x value is
// read up to 7 times through the cache.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(POINT_THREADS) residual_restrict_kernel(
    const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ rc,
    int64_t nx, int64_t ny, int64_t nz, float diag, float off, float s8) {
    const int64_t nxc = nx / 2, nyc = ny / 2, nzc = nz / 2;
    const int64_t t = (int64_t)blockIdx.x * POINT_THREADS + threadIdx.x;
    if (t >= nxc * nyc * nzc) return;
    const int64_t kc = t % nzc;
    const int64_t jc = (t / nzc) % nyc;
    const int64_t ic = t / (nzc * nyc);
    float r[2][2][2];
    for (int di = 0; di < 2; ++di)
        for (int dj = 0; dj < 2; ++dj)
            for (int dk = 0; dk < 2; ++dk) {
                const int64_t i = 2 * ic + di, j = 2 * jc + dj, k = 2 * kc + dk;
                r[di][dj][dk] = load(b, (i * ny + j) * nz + k) -
                                apply_at(x, i, j, k, nx, ny, nz, diag, off);
            }
    float sx[2][2];
    for (int dj = 0; dj < 2; ++dj)
        for (int dk = 0; dk < 2; ++dk) sx[dj][dk] = r[0][dj][dk] + r[1][dj][dk];
    const float sy0 = sx[0][0] + sx[1][0];
    const float sy1 = sx[0][1] + sx[1][1];
    store(rc, t, s8 * (sy0 + sy1));
}

// ---------------------------------------------------------------------------
// Kernel C: stencil3d_prolong_jacobi
//
// Replaces ops/stencil_pallas.py:stencil3d_prolong_jacobi_pallas
// (_kernel3d_pj): out = m + omega (b - A m) with m = x + P e, P the
// piecewise-constant prolongation of the coarse correction e.  The
// prolonged m never reaches device memory.
//
// Bound: memory bytes, reads of x, b and e (1/8 size) and one write:
// 12.5 bytes a fine point in f32.
//
// Design: one thread per fine point.  m is formed in f32 and never
// rounded to the storage type; each of the 6 neighbours takes the e of
// its own coarse cell, and m is 0 outside the grid, for x and e alike.
// What the simple design gives up: every m is recomputed by up to 7
// threads (7 reads of x and 7 of e through the cache per point).
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float m_at(const T* __restrict__ x, const T* __restrict__ e,
                                      int64_t i, int64_t j, int64_t k, int64_t nx,
                                      int64_t ny, int64_t nz) {
    if (i < 0 || i >= nx || j < 0 || j >= ny || k < 0 || k >= nz) return 0.f;
    const int64_t nyc = ny / 2, nzc = nz / 2;
    return load(x, (i * ny + j) * nz + k) + load(e, ((i / 2) * nyc + j / 2) * nzc + k / 2);
}

template <typename T>
__global__ void __launch_bounds__(POINT_THREADS) prolong_jacobi_kernel(
    const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ e,
    T* __restrict__ out, int64_t nx, int64_t ny, int64_t nz, float diag,
    float off, float omega) {
    const int64_t t = (int64_t)blockIdx.x * POINT_THREADS + threadIdx.x;
    if (t >= nx * ny * nz) return;
    const int64_t k = t % nz;
    const int64_t j = (t / nz) % ny;
    const int64_t i = t / (nz * ny);
    const float c = m_at(x, e, i, j, k, nx, ny, nz);
    const float xn = m_at(x, e, i - 1, j, k, nx, ny, nz);
    const float xs = m_at(x, e, i + 1, j, k, nx, ny, nz);
    const float yn = m_at(x, e, i, j - 1, k, nx, ny, nz);
    const float ys = m_at(x, e, i, j + 1, k, nx, ny, nz);
    const float zw = m_at(x, e, i, j, k - 1, nx, ny, nz);
    const float ze = m_at(x, e, i, j, k + 1, nx, ny, nz);
    const float am = diag * c + off * ((((xn + xs) + yn) + ys) + (zw + ze));
    store(out, t, c + omega * (load(b, t) - am));
}

unsigned point_blocks(int64_t n) {
    return (unsigned)((n + POINT_THREADS - 1) / POINT_THREADS);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Number of f32 partial sums the dot kinds of stencil3d_apply write.
int64_t stencil3d_apply_partials(int64_t nx, int64_t ny, int64_t nz) {
    const dim3 g = apply_grid(nx, ny, nz);
    return (int64_t)g.x * g.y * g.z;
}

// kind: 0 mv, 1 mv_dot, 2 residual, 3 jacobi, 4 jacobi_dot, 5 mv_cast.
// b: the residual/Jacobi right-hand side (x's type) or null.  y2: the cast
// copy of x for mv_cast, or null.  partials (stencil3d_apply_partials f32
// values) and dot (one f32) for the dot kinds, or null.
int stencil3d_apply(int kind, int x_dtype, int out_dtype, const void* x,
                    const void* b, void* y, void* y2, void* partials,
                    void* dot, int64_t nx, int64_t ny, int64_t nz, float diag,
                    float off, float omega, void* stream) {
    if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_dtype == F32 && out_dtype == F32)
        return dispatch_kind<float, float>(kind, x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
    if (x_dtype == F32 && out_dtype == BF16)
        return dispatch_kind<float, bf16>(kind, x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
    if (x_dtype == BF16 && out_dtype == F32)
        return dispatch_kind<bf16, float>(kind, x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
    if (x_dtype == BF16 && out_dtype == BF16)
        return dispatch_kind<bf16, bf16>(kind, x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
    return cudaErrorInvalidValue;
}

// x, b: fine (nx, ny, nz), even dims; rc: coarse (nx/2, ny/2, nz/2); all of
// one type.  s8 = scale / 8.
int stencil3d_residual_restrict(int dtype, const void* x, const void* b,
                                void* rc, int64_t nx, int64_t ny, int64_t nz,
                                float diag, float off, float s8, void* stream) {
    if (nx < 2 || ny < 2 || nz < 2 || nx % 2 || ny % 2 || nz % 2)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = point_blocks((nx / 2) * (ny / 2) * (nz / 2));
    if (dtype == F32)
        residual_restrict_kernel<float><<<blocks, POINT_THREADS, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(b),
            static_cast<float*>(rc), nx, ny, nz, diag, off, s8);
    else if (dtype == BF16)
        residual_restrict_kernel<bf16><<<blocks, POINT_THREADS, 0, s>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(b),
            static_cast<bf16*>(rc), nx, ny, nz, diag, off, s8);
    else
        return cudaErrorInvalidValue;
    return cudaGetLastError();
}

// x, b, out: fine (nx, ny, nz), even dims; e: coarse (nx/2, ny/2, nz/2);
// all of one type.
int stencil3d_prolong_jacobi(int dtype, const void* x, const void* b,
                             const void* e, void* out, int64_t nx, int64_t ny,
                             int64_t nz, float diag, float off, float omega,
                             void* stream) {
    if (nx < 2 || ny < 2 || nz < 2 || nx % 2 || ny % 2 || nz % 2)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = point_blocks(nx * ny * nz);
    if (dtype == F32)
        prolong_jacobi_kernel<float><<<blocks, POINT_THREADS, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(b),
            static_cast<const float*>(e), static_cast<float*>(out), nx, ny, nz,
            diag, off, omega);
    else if (dtype == BF16)
        prolong_jacobi_kernel<bf16><<<blocks, POINT_THREADS, 0, s>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(b),
            static_cast<const bf16*>(e), static_cast<bf16*>(out), nx, ny, nz,
            diag, off, omega);
    else
        return cudaErrorInvalidValue;
    return cudaGetLastError();
}

}  // extern "C"
