// Hopper (sm_90a) kernels for the matrix-free 3D 7-point Poisson stencil
// family: the apply with its fused epilogues (kernel A, and as one more
// kind the fused residual norm, kernel K), the multigrid cycle's fused
// residual + restriction (kernel B) and its fused prolongation + Jacobi
// sweep (kernel C), and PCG's fused direction update (kernel J).
//
// Plain C interface, bound with ctypes by ops/stencil3d.py.  Every entry
// point launches on the stream it is given, allocates nothing, and returns
// the cudaError_t of its launches (0 on success).  Grids are C-ordered
// (nx, ny, nz) arrays, z contiguous; indices are 64-bit.  Storage is f32
// or bf16 (dtype code 0 or 1) with f32 arithmetic, or, for kernels A, J
// and K, f64 (code 2) with f64 arithmetic.  The taps are summed in the
// order of the plain PyTorch versions beside the wrappers:
// diag*c + off*((((x- + x+) + y-) + y+) + (z- + z+)).
//
// All of them are bound by memory bytes: a few flops per point against
// 4-12 bytes moved per point, far below the card's ~20 flop/byte balance
// for f32 outside the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { F32 = 0, BF16 = 1, F64 = 2 };
enum { MV = 0, MV_DOT = 1, RESIDUAL = 2, JACOBI = 3, JACOBI_DOT = 4, MV_CAST = 5,
       MV_NORM = 6 };

// the arithmetic type of a storage type
template <typename T> struct Compute { typedef float type; };
template <> struct Compute<double> { typedef double type; };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const bf16* p, int64_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ double load(const double* p, int64_t i) { return p[i]; }
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(bf16* p, int64_t i, float v) { p[i] = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(double* p, int64_t i, double v) { p[i] = v; }

// A c at one point from its six neighbours: the one expression every
// kernel of the apply family evaluates, so that they round alike.
template <typename TC>
__device__ __forceinline__ TC stencil7(TC diag, TC off, TC c, TC xm, TC xp,
                                       TC ym, TC yp, TC zm, TC zp) {
    return diag * c + off * ((((xm + xp) + ym) + yp) + (zm + zp));
}

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
// Kernel K is the kind mv_norm: it replaces
// ops/fused_pallas.py:stencil3d_mv_norm_pallas (_mv_norm3d_kernel), y = A x
// and ||b - y||^2 in one pass, for f32 or f64 x, b and y.  Being the same
// instantiation pattern as mv, its y has mv's bits.  Bound: memory bytes,
// reads of x and b and one write, 12 bytes a point in f32 (1.61 GB at
// 512^3, 0.48 ms).
//
// The dot kinds (x.Ax for mv_dot, b.x' for jacobi_dot, both on the
// arithmetic-type value before its cast to the output type; the sum of
// (b - y)^2 for mv_norm) write one partial sum per
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
template <int THREADS, typename T>
__device__ __forceinline__ T block_sum(T v) {
    __shared__ T warp_sums[THREADS / 32];
    const int lane = (threadIdx.x + threadIdx.y * blockDim.x) & 31;
    const int warp = (threadIdx.x + threadIdx.y * blockDim.x) >> 5;
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

__host__ __device__ constexpr bool has_sum(int kind) {
    return kind == MV_DOT || kind == JACOBI_DOT || kind == MV_NORM;
}

template <int KIND, typename TX, typename TO>
__global__ void __launch_bounds__(NT) apply_kernel(
    const TX* __restrict__ x, const TX* __restrict__ b, TO* __restrict__ y,
    TO* __restrict__ y2, typename Compute<TX>::type* __restrict__ partials,
    int64_t nx, int64_t ny, int64_t nz, typename Compute<TX>::type diag,
    typename Compute<TX>::type off, typename Compute<TX>::type omega) {
    typedef typename Compute<TX>::type TC;
    const int64_t k = (int64_t)blockIdx.x * BZ + threadIdx.x;
    const int64_t j = (int64_t)blockIdx.y * BY + threadIdx.y;
    const int64_t i0 = (int64_t)blockIdx.z * SLAB;
    const int64_t i1 = i0 + SLAB < nx ? i0 + SLAB : nx;
    const int64_t plane = ny * nz;
    TC acc = TC(0);
    if (j < ny && k < nz) {
        int64_t idx = i0 * plane + j * nz + k;
        TC prev = i0 > 0 ? load(x, idx - plane) : TC(0);
        TC cur = load(x, idx);
        for (int64_t i = i0; i < i1; ++i, idx += plane) {
            const TC next = i + 1 < nx ? load(x, idx + plane) : TC(0);
            const TC yn = j > 0 ? load(x, idx - nz) : TC(0);
            const TC ys = j + 1 < ny ? load(x, idx + nz) : TC(0);
            const TC zw = k > 0 ? load(x, idx - 1) : TC(0);
            const TC ze = k + 1 < nz ? load(x, idx + 1) : TC(0);
            TC v = stencil7(diag, off, cur, prev, next, yn, ys, zw, ze);
            if (KIND == RESIDUAL) {
                v = load(b, idx) - v;
            } else if (KIND == JACOBI || KIND == JACOBI_DOT) {
                const TC bv = load(b, idx);
                v = cur + omega * (bv - v);
                if (KIND == JACOBI_DOT) acc += bv * v;
            } else if (KIND == MV_DOT) {
                acc += cur * v;
            } else if (KIND == MV_NORM) {
                // x, b and y share one type here, so v is y's value
                const TC d = load(b, idx) - v;
                acc += d * d;
            }
            store(y, idx, v);
            if (KIND == MV_CAST) store(y2, idx, cur);
            prev = cur;
            cur = next;
        }
    }
    if (has_sum(KIND)) {
        const TC s = block_sum<NT>(acc);
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

dim3 apply_grid(int64_t nx, int64_t ny, int64_t nz) {
    return dim3((unsigned)((nz + BZ - 1) / BZ), (unsigned)((ny + BY - 1) / BY),
                (unsigned)((nx + SLAB - 1) / SLAB));
}

template <int KIND, typename TX, typename TO>
cudaError_t launch_apply(const void* x, const void* b, void* y, void* y2,
                         void* partials, void* dot, int64_t nx, int64_t ny,
                         int64_t nz, double diag, double off, double omega,
                         cudaStream_t stream) {
    typedef typename Compute<TX>::type TC;
    const dim3 grid = apply_grid(nx, ny, nz);
    apply_kernel<KIND, TX, TO><<<grid, dim3(BZ, BY), 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(b), static_cast<TO*>(y),
        static_cast<TO*>(y2), static_cast<TC*>(partials), nx, ny, nz, (TC)diag,
        (TC)off, (TC)omega);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (has_sum(KIND)) {
        const int64_t n = (int64_t)grid.x * grid.y * grid.z;
        sum_partials<TC><<<1, FINISH_THREADS, 0, stream>>>(
            static_cast<const TC*>(partials), n, static_cast<TC*>(dot));
        err = cudaGetLastError();
    }
    return err;
}

template <typename TX, typename TO>
cudaError_t dispatch_kind(int kind, const void* x, const void* b, void* y,
                          void* y2, void* partials, void* dot, int64_t nx,
                          int64_t ny, int64_t nz, double diag, double off,
                          double omega, cudaStream_t s) {
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
// Kernel J: stencil3d_axpy_mv_dot
//
// Replaces ops/stencil_pallas.py:stencil3d_axpy_mv_dot_pallas
// (_kernel3d_amvd): PCG's direction update, matvec and direction dot in one
// pass, p' = z + beta p, ap = A p', dot = p' . ap, with beta read from
// device memory (it is the solver's per-iteration scalar and never visits
// the host).
//
// Bound: memory bytes, reads of z and p and writes of p' and ap: 16 bytes a
// point in f32 (2.15 GB at 512^3, 0.64 ms at 3.35 TB/s), against the 20
// bytes of an axpy pass followed by the mv_dot kind.
//
// Design: kernel A's walk (one thread per (y, z) column over a slab of x
// planes, p' at x-1, x and x+1 in registers).  p' is never read back from
// memory: a thread forms it from z and p at its own point and again at the
// four in-plane neighbours, whose reads L1/L2 serve.  Every point's p' is
// the one expression axpy(z, beta, p), product and sum each rounded on its
// own (no FMA, whatever the compiler's contraction), so the p' a
// neighbouring thread or block recomputes is the p' that was written, and
// it has the bits of the two plain passes z + (beta * p).  Outside the grid
// p' is 0 by the index tests, not by reading padded memory.  The apply is
// stencil7, as in kernel A, and the dot's partials have kernel A's layout
// and order: on the f32 p' the triple is what axpy + mv_dot gives.  With
// bf16 storage p' stays f32 for the stencil and the dot and is rounded
// only where it is stored, as in the Pallas kernel.  What the simple design
// gives up: ten loads a point through the cache instead of a staged tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float axpy(float z, float beta, float p) {
    return __fadd_rn(z, __fmul_rn(beta, p));
}
__device__ __forceinline__ double axpy(double z, double beta, double p) {
    return __dadd_rn(z, __dmul_rn(beta, p));
}

// p' at the point of flat index q
template <typename T, typename TC>
__device__ __forceinline__ TC pn_at(const T* __restrict__ z,
                                    const T* __restrict__ p, TC beta, int64_t q) {
    return axpy(load(z, q), beta, load(p, q));
}

template <typename T>
__global__ void __launch_bounds__(NT) axpy_mv_dot_kernel(
    const T* __restrict__ z, const T* __restrict__ p,
    const typename Compute<T>::type* __restrict__ beta_ptr, T* __restrict__ pn,
    T* __restrict__ ap, typename Compute<T>::type* __restrict__ partials,
    int64_t nx, int64_t ny, int64_t nz, typename Compute<T>::type diag,
    typename Compute<T>::type off) {
    typedef typename Compute<T>::type TC;
    const TC beta = beta_ptr[0];
    const int64_t k = (int64_t)blockIdx.x * BZ + threadIdx.x;
    const int64_t j = (int64_t)blockIdx.y * BY + threadIdx.y;
    const int64_t i0 = (int64_t)blockIdx.z * SLAB;
    const int64_t i1 = i0 + SLAB < nx ? i0 + SLAB : nx;
    const int64_t plane = ny * nz;
    TC acc = TC(0);
    if (j < ny && k < nz) {
        int64_t idx = i0 * plane + j * nz + k;
        TC prev = i0 > 0 ? pn_at(z, p, beta, idx - plane) : TC(0);
        TC cur = pn_at(z, p, beta, idx);
        for (int64_t i = i0; i < i1; ++i, idx += plane) {
            const TC next = i + 1 < nx ? pn_at(z, p, beta, idx + plane) : TC(0);
            const TC yn = j > 0 ? pn_at(z, p, beta, idx - nz) : TC(0);
            const TC ys = j + 1 < ny ? pn_at(z, p, beta, idx + nz) : TC(0);
            const TC zw = k > 0 ? pn_at(z, p, beta, idx - 1) : TC(0);
            const TC ze = k + 1 < nz ? pn_at(z, p, beta, idx + 1) : TC(0);
            const TC v = stencil7(diag, off, cur, prev, next, yn, ys, zw, ze);
            acc += cur * v;
            store(pn, idx, cur);
            store(ap, idx, v);
            prev = cur;
            cur = next;
        }
    }
    const TC s = block_sum<NT>(acc);
    if (threadIdx.x == 0 && threadIdx.y == 0)
        partials[blockIdx.x + (int64_t)gridDim.x *
                 (blockIdx.y + (int64_t)gridDim.y * blockIdx.z)] = s;
}

template <typename T>
cudaError_t launch_axpy_mv_dot(const void* z, const void* p, const void* beta,
                               void* pn, void* ap, void* partials, void* dot,
                               int64_t nx, int64_t ny, int64_t nz, double diag,
                               double off, cudaStream_t stream) {
    typedef typename Compute<T>::type TC;
    const dim3 grid = apply_grid(nx, ny, nz);
    axpy_mv_dot_kernel<T><<<grid, dim3(BZ, BY), 0, stream>>>(
        static_cast<const T*>(z), static_cast<const T*>(p),
        static_cast<const TC*>(beta), static_cast<T*>(pn), static_cast<T*>(ap),
        static_cast<TC*>(partials), nx, ny, nz, (TC)diag, (TC)off);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sum_partials<TC><<<1, FINISH_THREADS, 0, stream>>>(
        static_cast<const TC*>(partials),
        (int64_t)grid.x * grid.y * grid.z, static_cast<TC*>(dot));
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel B's A x at one point, zero outside the grid.
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
// 12.5 bytes a fine point in f32, 6.25 in bf16 (0.84 GB at 512^3, 0.25 ms
// at 3.35 TB/s).
//
// Design: kernel A's walk, a warp wide and PJ_R rows deep.  A lane owns one
// coarse cell in z (a z pair) and PJ_CY cells in y: PJ_R = 2 PJ_CY fine
// rows, whose 2 PJ_R points share PJ_CY values of e.  It walks a slab of x
// planes (ops/stencil3d.py PJ_SLAB or fewer) keeping m at x-1, x and
// x+1 of its points in registers, so that m = x + e is formed once a point,
// in f32 and never rounded.  The y neighbours are its own rows, but for
// the two rows above and below, which it loads; the z neighbours are the
// next lanes' points, passed by shuffles, but for the warp's two ends,
// which lanes 0 and 31 load.  No shared memory and no barrier: each warp
// walks on its own.  A lane's loads go out one plane ahead of their use
// (x and e of plane x+2, b and the halo of plane x+1, while plane x is
// computed), one float2 or __nv_bfloat162 load a row and grid: with even
// nz every pair starts aligned when the arrays do, and arrays that do not
// (a view at an odd offset) take scalar loads in the same kernel (the VEC
// template flag, chosen per launch).  m is 0 outside the grid, for x and e
// alike, by index tests.  The taps are stencil7's sum, rounded once at the
// store, as the plain version and kernel A do.  No per-point division:
// coarse indices are the lane's own, shifted.
// ---------------------------------------------------------------------------

constexpr int PJ_TZ = 32;                  // lanes along z, a coarse cell each
constexpr int PJ_CY = 2;                   // coarse cells along y a lane owns
constexpr int PJ_R = 2 * PJ_CY;            // its fine rows
constexpr int PJ_WY = 4;                   // warps along y in a block
constexpr int PJ_NT = PJ_TZ * PJ_WY;
// blocks an SM must hold: 6 in bf16 (at most 80 registers a thread), 4 in
// f32 (128), the caps under which the walk ran fastest at 512^3 on an H100
// (a tighter cap spills, a looser one leaves too few warps in flight)
template <typename T> struct PjResident { enum { value = sizeof(T) == 2 ? 6 : 4 }; };

// a z pair of a storage type, as loaded
template <typename T> struct PairOf;
template <> struct PairOf<float> { typedef float2 type; };
template <> struct PairOf<bf16> { typedef __nv_bfloat162 type; };

__device__ __forceinline__ float2 to_f2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }

template <bool VEC>
__device__ __forceinline__ float2 load_pair(const float* __restrict__ p, int64_t i) {
    if (VEC) return __ldg(reinterpret_cast<const float2*>(p + i));
    return make_float2(__ldg(p + i), __ldg(p + i + 1));
}
template <bool VEC>
__device__ __forceinline__ __nv_bfloat162 load_pair(const bf16* __restrict__ p, int64_t i) {
    if (VEC) return __ldg(reinterpret_cast<const __nv_bfloat162*>(p + i));
    return __halves2bfloat162(__ldg(p + i), __ldg(p + i + 1));
}
template <bool VEC>
__device__ __forceinline__ void store_pair(float* __restrict__ p, int64_t i, float2 v) {
    if (VEC) {
        *reinterpret_cast<float2*>(p + i) = v;
    } else {
        p[i] = v.x;
        p[i + 1] = v.y;
    }
}
template <bool VEC>
__device__ __forceinline__ void store_pair(bf16* __restrict__ p, int64_t i, float2 v) {
    if (VEC) {
        *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(v.x, v.y);
    } else {
        p[i] = __float2bfloat16_rn(v.x);
        p[i + 1] = __float2bfloat16_rn(v.y);
    }
}

__device__ __forceinline__ float2 add_e(float2 v, float e) {
    return make_float2(v.x + e, v.y + e);
}

__device__ __forceinline__ float pj_point(float c, float xn, float xs, float yn, float ys,
                                          float zw, float ze, float bv, float diag,
                                          float off, float omega) {
    const float am = diag * c + off * ((((xn + xs) + yn) + ys) + (zw + ze));
    return c + omega * (bv - am);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16_rn(0.f); }
template <> __device__ __forceinline__ float2 zero_of<float2>() { return make_float2(0.f, 0.f); }
template <> __device__ __forceinline__ __nv_bfloat162 zero_of<__nv_bfloat162>() {
    return __floats2bfloat162_rn(0.f, 0.f);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Where a lane works: the grids' extents, its coarse cells and fine corner
struct PjLane {
    int64_t nx, ny, nz, nzc, plane, cplane;
    int64_t cy0, kc, j0, k0;
    int cells;      // of its PJ_CY cells, those inside the grid (0 past z)
    bool top, bot;  // whether rows j0 - 1 and j0 + PJ_R are inside the grid
    int zdir;       // -1 for lane 0 (z point k0 - 1), +1 for lane 31 (k0 + 2)
};

// The loads of one plane, in the storage type, 0 outside the grid: the
// lane's x pairs and e values ("own"), and its b pairs with the halo it
// fills ("edge").  m = x + e is formed one plane after the loads go out.
template <typename T> struct PjOwn {
    typename PairOf<T>::type x[PJ_R];
    T e[PJ_CY];
};
template <typename T> struct PjEdge {
    typename PairOf<T>::type b[PJ_R], yt, yb;
    T eyt, eyb;
    T z[PJ_R];      // lanes 0 and 31: the z halo of each row
    T ez[PJ_CY];
};

template <bool VEC, typename T>
__device__ __forceinline__ PjOwn<T> pj_own(const T* __restrict__ x, const T* __restrict__ e,
                                           const PjLane& l, int64_t p) {
    PjOwn<T> o;
    const bool in = p >= 0 && p < l.nx;
    const int64_t q = p * l.plane + l.j0 * l.nz + l.k0;
    const int64_t qe = (p >> 1) * l.cplane + l.cy0 * l.nzc + l.kc;
#pragma unroll
    for (int c = 0; c < PJ_CY; ++c) {
        const bool ok = in && c < l.cells;
        o.x[2 * c] = ok ? load_pair<VEC>(x, q + 2 * c * l.nz) : zero_of<typename PairOf<T>::type>();
        o.x[2 * c + 1] =
            ok ? load_pair<VEC>(x, q + (2 * c + 1) * l.nz) : zero_of<typename PairOf<T>::type>();
        o.e[c] = ok ? e[qe + c * l.nzc] : zero_of<T>();
    }
    return o;
}

template <bool VEC, typename T>
__device__ __forceinline__ PjEdge<T> pj_edge(const T* __restrict__ x, const T* __restrict__ e,
                                             const T* __restrict__ b, const PjLane& l,
                                             int64_t p, bool in) {
    typedef typename PairOf<T>::type P;
    PjEdge<T> d;
    const int64_t q = p * l.plane + l.j0 * l.nz + l.k0;
    const int64_t cp = (p >> 1) * l.cplane;
#pragma unroll
    for (int r = 0; r < PJ_R; ++r)
        d.b[r] = in && r / 2 < l.cells ? load_pair<VEC>(b, q + r * l.nz) : zero_of<P>();
    const bool top = in && l.top, bot = in && l.bot;
    d.yt = top ? load_pair<VEC>(x, q - l.nz) : zero_of<P>();
    d.eyt = top ? e[cp + (l.cy0 - 1) * l.nzc + l.kc] : zero_of<T>();
    d.yb = bot ? load_pair<VEC>(x, q + PJ_R * l.nz) : zero_of<P>();
    d.eyb = bot ? e[cp + (l.cy0 + PJ_CY) * l.nzc + l.kc] : zero_of<T>();
    const int64_t kh = l.zdir < 0 ? l.k0 - 1 : l.k0 + 2;
    const bool zin = in && l.zdir != 0 && kh >= 0 && kh < l.nz;
#pragma unroll
    for (int c = 0; c < PJ_CY; ++c) {
        const bool ok = zin && l.cy0 + c < l.ny / 2;
        d.z[2 * c] = ok ? x[q + 2 * c * l.nz + (kh - l.k0)] : zero_of<T>();
        d.z[2 * c + 1] = ok ? x[q + (2 * c + 1) * l.nz + (kh - l.k0)] : zero_of<T>();
        d.ez[c] = ok ? e[cp + (l.cy0 + c) * l.nzc + (kh >> 1)] : zero_of<T>();
    }
    return d;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(PJ_NT, PjResident<T>::value) prolong_jacobi_kernel(
    const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ e,
    T* __restrict__ out, int64_t nx, int64_t ny, int64_t nz, int64_t slab,
    float diag, float off, float omega) {
    const int lane = threadIdx.x;
    PjLane l;
    l.nx = nx; l.ny = ny; l.nz = nz; l.nzc = nz / 2;
    l.plane = ny * nz; l.cplane = (ny / 2) * l.nzc;
    l.kc = (int64_t)blockIdx.x * PJ_TZ + lane;
    l.cy0 = ((int64_t)blockIdx.y * PJ_WY + threadIdx.y) * PJ_CY;
    l.j0 = 2 * l.cy0;
    l.k0 = 2 * l.kc;
    {
        const int64_t left = ny / 2 - l.cy0;
        l.cells = l.kc >= l.nzc || left <= 0 ? 0 : left < PJ_CY ? (int)left : PJ_CY;
    }
    l.top = l.j0 >= 1 && l.j0 - 1 < ny && l.kc < l.nzc;
    l.bot = l.j0 + PJ_R < ny && l.kc < l.nzc;
    l.zdir = lane == 0 ? -1 : lane == PJ_TZ - 1 ? 1 : 0;
    const int64_t i0 = (int64_t)blockIdx.z * slab;
    const int64_t i1 = i0 + slab < nx ? i0 + slab : nx;

    // m of the lane's points at planes i-1, i and i+1; when plane i starts,
    // the loads of own(i+1) and edge(i) are in flight
    float2 prev[PJ_R], cur[PJ_R], next[PJ_R];
    {
        const PjOwn<T> a = pj_own<VEC>(x, e, l, i0 - 1);
        const PjOwn<T> c = pj_own<VEC>(x, e, l, i0);
#pragma unroll
        for (int r = 0; r < PJ_R; ++r) {
            prev[r] = add_e(to_f2(a.x[r]), to_f(a.e[r / 2]));
            cur[r] = add_e(to_f2(c.x[r]), to_f(c.e[r / 2]));
        }
    }
    PjOwn<T> own = pj_own<VEC>(x, e, l, i0 + 1);
    PjEdge<T> edge = pj_edge<VEC>(x, e, b, l, i0, true);
    for (int64_t i = i0; i < i1; ++i) {
#pragma unroll
        for (int r = 0; r < PJ_R; ++r) next[r] = add_e(to_f2(own.x[r]), to_f(own.e[r / 2]));
        const PjEdge<T> d = edge;
        // the next plane's loads go out before this plane is computed
        own = pj_own<VEC>(x, e, l, i + 1 < i1 ? i + 2 : -1);
        edge = pj_edge<VEC>(x, e, b, l, i + 1, i + 1 < i1);
        const float2 yt = add_e(to_f2(d.yt), to_f(d.eyt));
        const float2 yb = add_e(to_f2(d.yb), to_f(d.eyb));
        const int64_t q = i * l.plane + l.j0 * nz + l.k0;
#pragma unroll
        for (int r = 0; r < PJ_R; ++r) {
            const float zh = to_f(d.z[r]) + to_f(d.ez[r / 2]);
            const float up = __shfl_up_sync(0xffffffffu, cur[r].y, 1);
            const float down = __shfl_down_sync(0xffffffffu, cur[r].x, 1);
            const float zw = lane == 0 ? zh : up;
            const float ze = lane == PJ_TZ - 1 ? zh : down;
            const float2 yn = r == 0 ? yt : cur[r - 1];
            const float2 ys = r == PJ_R - 1 ? yb : cur[r + 1];
            const float2 bv = to_f2(d.b[r]);
            float2 o;
            o.x = pj_point(cur[r].x, prev[r].x, next[r].x, yn.x, ys.x, zw, cur[r].y, bv.x,
                           diag, off, omega);
            o.y = pj_point(cur[r].y, prev[r].y, next[r].y, yn.y, ys.y, cur[r].x, ze, bv.y,
                           diag, off, omega);
            if (r / 2 < l.cells) store_pair<VEC>(out, q + r * nz, o);
        }
#pragma unroll
        for (int r = 0; r < PJ_R; ++r) {
            prev[r] = cur[r];
            cur[r] = next[r];
        }
    }
}

template <typename T>
cudaError_t launch_prolong_jacobi(const void* x, const void* b, const void* e, void* out,
                                  int64_t nx, int64_t ny, int64_t nz, int64_t slab,
                                  float diag, float off, float omega, cudaStream_t s) {
    const int64_t cells_y = PJ_CY * PJ_WY;
    const dim3 grid((unsigned)((nz / 2 + PJ_TZ - 1) / PJ_TZ),
                    (unsigned)((ny / 2 + cells_y - 1) / cells_y),
                    (unsigned)((nx + slab - 1) / slab));
    const dim3 block(PJ_TZ, PJ_WY);
    // pairs are aligned when every array starts on a pair (nz is even)
    const uintptr_t pair = 2 * sizeof(T);
    const bool vec = reinterpret_cast<uintptr_t>(x) % pair == 0 &&
                     reinterpret_cast<uintptr_t>(b) % pair == 0 &&
                     reinterpret_cast<uintptr_t>(out) % pair == 0;
    if (vec)
        prolong_jacobi_kernel<T, true><<<grid, block, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(e),
            static_cast<T*>(out), nx, ny, nz, slab, diag, off, omega);
    else
        prolong_jacobi_kernel<T, false><<<grid, block, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(e),
            static_cast<T*>(out), nx, ny, nz, slab, diag, off, omega);
    return cudaGetLastError();
}

unsigned point_blocks(int64_t n) {
    return (unsigned)((n + POINT_THREADS - 1) / POINT_THREADS);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Number of partial sums the kinds with a sum, and kernel J, write.
int64_t stencil3d_apply_partials(int64_t nx, int64_t ny, int64_t nz) {
    const dim3 g = apply_grid(nx, ny, nz);
    return (int64_t)g.x * g.y * g.z;
}

// kind: 0 mv, 1 mv_dot, 2 residual, 3 jacobi, 4 jacobi_dot, 5 mv_cast,
// 6 mv_norm (kernel K).  b: the right-hand side of the residual, Jacobi and
// mv_norm kinds (x's type) or null.  y2: the cast copy of x for mv_cast, or
// null.  partials (stencil3d_apply_partials values) and dot (one value),
// both of the arithmetic type (f32, or f64 for f64 storage), for the kinds
// with a sum, or null.  f64 goes with f64 only; mv_norm takes one type for
// x, b and y, f32 or f64.
int stencil3d_apply(int kind, int x_dtype, int out_dtype, const void* x,
                    const void* b, void* y, void* y2, void* partials,
                    void* dot, int64_t nx, int64_t ny, int64_t nz, double diag,
                    double off, double omega, void* stream) {
    if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == MV_NORM) {
        if (x_dtype == F32 && out_dtype == F32)
            return launch_apply<MV_NORM, float, float>(x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
        if (x_dtype == F64 && out_dtype == F64)
            return launch_apply<MV_NORM, double, double>(x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
        return cudaErrorInvalidValue;
    }
    if (x_dtype == F32 && out_dtype == F32)
        return dispatch_kind<float, float>(kind, x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
    if (x_dtype == F32 && out_dtype == BF16)
        return dispatch_kind<float, bf16>(kind, x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
    if (x_dtype == BF16 && out_dtype == F32)
        return dispatch_kind<bf16, float>(kind, x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
    if (x_dtype == BF16 && out_dtype == BF16)
        return dispatch_kind<bf16, bf16>(kind, x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
    if (x_dtype == F64 && out_dtype == F64)
        return dispatch_kind<double, double>(kind, x, b, y, y2, partials, dot, nx, ny, nz, diag, off, omega, s);
    return cudaErrorInvalidValue;
}

// Kernel J.  z, p, pn, ap: (nx, ny, nz) of one type (f32, bf16 or f64); pn
// and ap are new arrays that alias neither input.  beta, partials
// (stencil3d_apply_partials values) and dot: device memory of the
// arithmetic type (f32, or f64 for f64 storage).
int stencil3d_axpy_mv_dot(int dtype, const void* z, const void* p,
                          const void* beta, void* pn, void* ap, void* partials,
                          void* dot, int64_t nx, int64_t ny, int64_t nz,
                          double diag, double off, void* stream) {
    if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case F32:
            return launch_axpy_mv_dot<float>(z, p, beta, pn, ap, partials, dot, nx, ny, nz, diag, off, s);
        case BF16:
            return launch_axpy_mv_dot<bf16>(z, p, beta, pn, ap, partials, dot, nx, ny, nz, diag, off, s);
        case F64:
            return launch_axpy_mv_dot<double>(z, p, beta, pn, ap, partials, dot, nx, ny, nz, diag, off, s);
        default:
            return cudaErrorInvalidValue;
    }
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
// all of one type.  slab: x planes a block walks (ops/stencil3d.py
// prolong_jacobi_slab).
int stencil3d_prolong_jacobi(int dtype, const void* x, const void* b,
                             const void* e, void* out, int64_t nx, int64_t ny,
                             int64_t nz, int64_t slab, float diag, float off,
                             float omega, void* stream) {
    if (nx < 2 || ny < 2 || nz < 2 || nx % 2 || ny % 2 || nz % 2 || slab < 1 ||
        (nx + slab - 1) / slab > 65535 || ny / 2 > 65535LL * PJ_CY * PJ_WY)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch_prolong_jacobi<float>(x, b, e, out, nx, ny, nz, slab, diag, off, omega, s);
    if (dtype == BF16)
        return launch_prolong_jacobi<bf16>(x, b, e, out, nx, ny, nz, slab, diag, off, omega, s);
    return cudaErrorInvalidValue;
}

}  // extern "C"
