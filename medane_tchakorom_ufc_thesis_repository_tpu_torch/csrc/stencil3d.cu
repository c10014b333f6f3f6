// Hopper (sm_90a) kernels for the matrix-free 3D 7-point Poisson stencil
// family: the apply with its fused epilogues (kernel A, and as one more
// kind the fused residual norm, kernel K), the multigrid cycle's fused
// residual + restriction (kernel B) and its fused prolongation + Jacobi
// sweep (kernel C), PCG's fused direction update (kernel J), and the
// cycle's coarse Chebyshev solve in one launch (kernel M, whose device code
// is in chebyshev_coarse.cuh, shared with stencil2d.cu).  Kernel A's kinds
// without a sum (mv, residual, jacobi, mv_cast) take a stack of grids in
// one launch and stage each plane's tile in shared memory (stack_kernel),
// and its kind mv_dot walks the same staged tiles on one grid; kernels B
// and C, and kernel A's kind jacobi_dot on f32 and bf16 storage, are
// barrier-free warp walks; A's jacobi_dot on f64, and J and K, walk one
// thread a (y, z) column.
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
// Kernel A: stencil3d_apply, the kinds with a sum
//
// Replaces ops/stencil_pallas.py:stencil3d_apply_pallas (_kernel3d, kinds
// mv, mv_dot, residual, jacobi, jacobi_dot) and stencil3d_mv_cast_pallas
// (_kernel3d_mvc, here the kind mv_cast).  The kinds without a sum (mv,
// residual, jacobi, mv_cast) run stack_kernel below, over a stack of grids,
// and so does mv_dot, on one grid, with this walk's summation order; this
// column walk serves jacobi_dot on f64 storage (f32 and bf16 take their own
// walk, stencil3d_jacobi_dot below) and kernel K.
//
// Bound: memory bytes.  Reads of x and b and one write of y: 24 bytes a
// point for an f64 jacobi_dot.
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
// and ||b - y||^2 in one pass, for f32 or f64 x, b and y.  Its y is
// stencil7 on the same operands as stack_kernel's mv, so it has mv's bits.
// Bound: memory bytes, reads of x and b and one write, 12 bytes a point in
// f32 (1.61 GB at 512^3, 0.48 ms).
//
// The dot kinds (b.x' for jacobi_dot, on the arithmetic-type value before
// its cast to the output type; the sum of (b - y)^2 for mv_norm) write one
// partial sum per block, in apply_grid's layout, which kernel J and the dot
// walk of mv_dot share (x.Ax, summed in this walk's order: a thread's
// products over the block's planes by dot_step, then block_sum);
// sum_partials adds the partials in a fixed order.  No float atomics, so a
// dot is the same from run to run and CG's iteration counts repeat.  (The
// Pallas kernel carried the sum across its sequential grid, which Hopper's
// blocks do not have.)
// ---------------------------------------------------------------------------

constexpr int BZ = 32;      // threads along z
constexpr int BY = 8;       // threads along y
constexpr int SLAB = 16;    // x planes walked by one thread
constexpr int NT = BZ * BY;
constexpr int FINISH_THREADS = 1024;

// acc + a b, rounded once: the dots of kind mv_dot, of kernel J and of the
// f64 jacobi_dot add their products so (the column walk's acc += a * b,
// which nvcc contracts into an FMA, written out), so that two kernels
// summing the same products in the same order agree in every bit
__device__ __forceinline__ float dot_step(float a, float b, float acc) {
    return __fmaf_rn(a, b, acc);
}
__device__ __forceinline__ double dot_step(double a, double b, double acc) {
    return __fma_rn(a, b, acc);
}

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

template <int KIND, typename TX, typename TO>
__global__ void __launch_bounds__(NT) apply_kernel(
    const TX* __restrict__ x, const TX* __restrict__ b, TO* __restrict__ y,
    typename Compute<TX>::type* __restrict__ partials, int64_t nx, int64_t ny,
    int64_t nz, typename Compute<TX>::type diag,
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
            if (KIND == JACOBI_DOT) {
                const TC bv = load(b, idx);
                v = cur + omega * (bv - v);
                acc = dot_step(bv, v, acc);
            } else if (KIND == MV_NORM) {
                // x, b and y share one type here, so v is y's value.  The
                // norm is held against no other kernel's bits, and written
                // as dot_step it ran 8% slower (the same FFMA, another
                // schedule), so it keeps its contracted form.
                const TC d = load(b, idx) - v;
                acc += d * d;
            }
            store(y, idx, v);
            prev = cur;
            cur = next;
        }
    }
    const TC s = block_sum<NT>(acc);
    if (threadIdx.x == 0 && threadIdx.y == 0)
        partials[blockIdx.x + (int64_t)gridDim.x *
                 (blockIdx.y + (int64_t)gridDim.y * blockIdx.z)] = s;
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
cudaError_t launch_apply(const void* x, const void* b, void* y, void* partials,
                         void* dot, int64_t nx, int64_t ny, int64_t nz,
                         double diag, double off, double omega,
                         cudaStream_t stream) {
    typedef typename Compute<TX>::type TC;
    const dim3 grid = apply_grid(nx, ny, nz);
    apply_kernel<KIND, TX, TO><<<grid, dim3(BZ, BY), 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TX*>(b), static_cast<TO*>(y),
        static_cast<TC*>(partials), nx, ny, nz, (TC)diag, (TC)off, (TC)omega);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t n = (int64_t)grid.x * grid.y * grid.z;
    sum_partials<TC><<<1, FINISH_THREADS, 0, stream>>>(
        static_cast<const TC*>(partials), n, static_cast<TC*>(dot));
    return cudaGetLastError();
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
// Design: kernel A's column walk (one thread per (y, z) column over a slab of x
// planes, p' at x-1, x and x+1 in registers).  p' is never read back from
// memory: a thread forms it from z and p at its own point and again at the
// four in-plane neighbours, whose reads L1/L2 serve.  Every point's p' is
// the one expression axpy(z, beta, p), product and sum each rounded on its
// own (no FMA, whatever the compiler's contraction), so the p' a
// neighbouring thread or block recomputes is the p' that was written, and
// it has the bits of the two plain passes z + (beta * p).  Outside the grid
// p' is 0 by the index tests, not by reading padded memory.  The apply is
// stencil7, as in kernel A, and the dot's partials have kernel A's layout
// and order (dot_step, block_sum; mv_dot's walk keeps the same): on the
// f32 p' the triple is what axpy + mv_dot gives.  With
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
            acc = dot_step(cur, v, acc);
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
// The warp walk of kernels B and C and of kernel A's kind jacobi_dot
//
// One tile and one lane layout (walk_lane) for the three; kernel C and
// jacobi_dot also share the loads (walk_own, walk_edge) and the taps
// (taps_of), while B stages its loads through shared memory.  A lane
// owns a z pair, the points k0 = 2 (blockIdx.x WK_TZ + lane) and k0 + 1,
// in WK_R fine rows j0 .. j0 + WK_R - 1; a block is WK_WY warps along y,
// a tile of 16 rows by 64 z points (ops/stencil3d.py WALK_TY, WALK_TZ), and walks a
// slab of x planes (ops/stencil3d.py walk_slab) keeping x at planes i-1, i
// and i+1 of its points in f32 registers.  The y neighbours are its own
// rows, but for the two halo rows, which it loads; the z neighbours are
// the next lanes' points, passed by shuffles, but for the warp's two ends,
// which lanes 0 and 31 load.  No barrier.  The loads
// of plane i+1 go out while plane i is computed, one float2 or
// __nv_bfloat162 load a row and array; a launch whose arrays do not all
// start on a pair, or whose nz is odd, takes scalar loads (VEC false),
// guarded point by point.  A point outside the grid is 0 by the index
// tests, and a lane with no point in the grid still walks, with zeros,
// so that every lane takes part in the shuffles.
// ---------------------------------------------------------------------------

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

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16_rn(0.f); }
template <> __device__ __forceinline__ float2 zero_of<float2>() { return make_float2(0.f, 0.f); }
template <> __device__ __forceinline__ __nv_bfloat162 zero_of<__nv_bfloat162>() {
    return __floats2bfloat162_rn(0.f, 0.f);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

constexpr int WK_TZ = 32;                  // lanes along z, a z pair each
constexpr int WK_R = 4;                    // fine rows a lane owns
constexpr int WK_WY = 4;                   // warps along y in a block
constexpr int WK_NT = WK_TZ * WK_WY;
// blocks an SM must hold, by storage type: the register cap of
// jacobi_dot's walk (kernels B and C set their own)
template <typename T> struct WalkResident { enum { value = sizeof(T) == 2 ? 6 : 4 }; };

struct WalkLane {
    int64_t nx, ny, nz, plane, j0, k0;
    int rows;       // of its WK_R rows, those inside the grid (0 without points)
    int pts;        // of its z pair, the points inside the grid: 0, 1 or 2
    bool top, bot;  // whether it loads the halo rows j0 - 1 and j0 + WK_R
    int zdir;       // -1 for lane 0 (z point k0 - 1), +1 for lane 31 (k0 + 2)
};

__device__ __forceinline__ WalkLane walk_lane(int64_t nx, int64_t ny, int64_t nz) {
    WalkLane l;
    l.nx = nx; l.ny = ny; l.nz = nz; l.plane = ny * nz;
    l.k0 = 2 * ((int64_t)blockIdx.x * WK_TZ + threadIdx.x);
    l.j0 = ((int64_t)blockIdx.y * WK_WY + threadIdx.y) * WK_R;
    const int64_t pts = nz - l.k0, rows = ny - l.j0;
    l.pts = pts <= 0 ? 0 : pts < 2 ? (int)pts : 2;
    l.rows = l.pts == 0 || rows <= 0 ? 0 : rows < WK_R ? (int)rows : WK_R;
    l.top = l.rows > 0 && l.j0 > 0;
    l.bot = l.rows > 0 && l.j0 + WK_R < ny;
    l.zdir = threadIdx.x == 0 ? -1 : threadIdx.x == WK_TZ - 1 ? 1 : 0;
    return l;
}

__device__ __forceinline__ float2 first_of(const float* __restrict__ p, int64_t i) {
    return make_float2(__ldg(p + i), 0.f);
}
__device__ __forceinline__ __nv_bfloat162 first_of(const bf16* __restrict__ p, int64_t i) {
    return __halves2bfloat162(__ldg(p + i), __float2bfloat16_rn(0.f));
}

// The pair at p + i of which the first pts points are inside the grid,
// the others 0.  With VEC, nz is even and pts is 0 or 2.
template <bool VEC, typename T>
__device__ __forceinline__ typename PairOf<T>::type pair_at(const T* __restrict__ p,
                                                            int64_t i, int pts) {
    if (pts <= 0) return zero_of<typename PairOf<T>::type>();
    if (VEC || pts == 2) return load_pair<VEC>(p, i);
    return first_of(p, i);
}

template <bool VEC, typename T>
__device__ __forceinline__ void store_pts(T* __restrict__ p, int64_t i, float2 v, int pts) {
    if (pts == 2)
        store_pair<VEC>(p, i, v);
    else if (pts == 1)
        store(p, i, v.x);
}

// Whether row r of the lane lies inside the grid.  With PAIRS (ny even, as
// kernel C requires) its rows come in pairs and one test serves a pair:
// fewer predicates, and C's walk no longer spills at its register cap.
template <bool PAIRS>
__device__ __forceinline__ bool has_row(const WalkLane& l, int r) {
    return (PAIRS ? r | 1 : r) < l.rows;
}

// The loads of one plane, in the storage type, 0 outside the grid: the
// lane's x pairs ("own", a plane ahead of the next one's use), and its b
// pairs with the halo ("edge", for the plane computed next).
template <typename T> struct WalkOwn {
    typename PairOf<T>::type x[WK_R];
};
template <typename T> struct WalkEdge {
    typename PairOf<T>::type b[WK_R], yt, yb;
    T z[WK_R];      // lanes 0 and 31: the z halo of each row
};

template <bool VEC, bool PAIRS, typename T>
__device__ __forceinline__ WalkOwn<T> walk_own(const T* __restrict__ x, const WalkLane& l,
                                               int64_t p) {
    WalkOwn<T> o;
    const bool in = p >= 0 && p < l.nx;
    const int64_t q = p * l.plane + l.j0 * l.nz + l.k0;
#pragma unroll
    for (int r = 0; r < WK_R; ++r)
        o.x[r] = pair_at<VEC>(x, q + r * l.nz, in && has_row<PAIRS>(l, r) ? l.pts : 0);
    return o;
}

template <bool VEC, bool PAIRS, typename T>
__device__ __forceinline__ WalkEdge<T> walk_edge(const T* __restrict__ x,
                                                 const T* __restrict__ b, const WalkLane& l,
                                                 int64_t p, bool in) {
    WalkEdge<T> d;
    const int64_t q = p * l.plane + l.j0 * l.nz + l.k0;
#pragma unroll
    for (int r = 0; r < WK_R; ++r)
        d.b[r] = pair_at<VEC>(b, q + r * l.nz, in && has_row<PAIRS>(l, r) ? l.pts : 0);
    d.yt = pair_at<VEC>(x, q - l.nz, in && l.top ? l.pts : 0);
    d.yb = pair_at<VEC>(x, q + WK_R * l.nz, in && l.bot ? l.pts : 0);
    const int64_t kh = l.zdir < 0 ? l.k0 - 1 : l.k0 + 2;
    const bool zin = in && l.zdir != 0 && kh >= 0 && kh < l.nz;
#pragma unroll
    for (int r = 0; r < WK_R; ++r)
        d.z[r] = zin && has_row<PAIRS>(l, r) ? x[q + r * l.nz + (kh - l.k0)] : zero_of<T>();
    return d;
}

// The lane's six neighbours of each of its points at one plane
struct Taps {
    float2 yn, ys;  // rows j-1 and j+1
    float zw, ze;   // z points k0 - 1 and k0 + 2
};

// (of row r, given the halo rows yt and yb and the z halo zh of row r, all
// in f32)
__device__ __forceinline__ Taps taps_of(const float2 (&cur)[WK_R], float2 yt, float2 yb,
                                        float zh, int r) {
    const int lane = threadIdx.x;
    const float up = __shfl_up_sync(0xffffffffu, cur[r].y, 1);
    const float down = __shfl_down_sync(0xffffffffu, cur[r].x, 1);
    Taps t;
    t.zw = lane == 0 ? zh : up;
    t.ze = lane == WK_TZ - 1 ? zh : down;
    t.yn = r == 0 ? yt : cur[r - 1];
    t.ys = r == WK_R - 1 ? yb : cur[r + 1];
    return t;
}

dim3 walk_grid(int64_t nx, int64_t ny, int64_t nz, int64_t slab) {
    return dim3((unsigned)(((nz + 1) / 2 + WK_TZ - 1) / WK_TZ),
                (unsigned)((ny + WK_R * WK_WY - 1) / (WK_R * WK_WY)),
                (unsigned)((nx + slab - 1) / slab));
}

bool walk_fits(int64_t nx, int64_t ny, int64_t slab) {
    return slab >= 1 && (nx + slab - 1) / slab <= 65535 &&
           (ny + WK_R * WK_WY - 1) / (WK_R * WK_WY) <= 65535;
}

bool pair_aligned(const void* p, size_t pair) {
    return reinterpret_cast<uintptr_t>(p) % pair == 0;
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
// Design: the warp walk above, over m.  A lane's z pair is one coarse cell
// in z and its WK_R rows WK_R / 2 cells in y, whose 2 WK_R points share
// WK_R / 2 values of e.  Beside walk_own's x and walk_edge's b and halo,
// the lane loads e of its cells, of its halo rows and of its z halo, so
// that m = x + e is formed once a point, in f32 and never rounded, and
// kept at planes i-1, i and i+1.  Its loads go out one plane ahead of
// their use (x and e of plane i+2, b and the halo of plane i+1, while
// plane i is computed).  m is 0 outside the grid, for x and e alike, by
// index tests.  The taps are stencil7's sum, rounded once at the store, as
// the plain version and kernel A do.  No per-point division: coarse
// indices are the lane's own, shifted.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 add_e(float2 v, float e) {
    return make_float2(v.x + e, v.y + e);
}

__device__ __forceinline__ float pj_point(float c, float xn, float xs, float yn, float ys,
                                          float zw, float ze, float bv, float diag,
                                          float off, float omega) {
    const float am = diag * c + off * ((((xn + xs) + yn) + ys) + (zw + ze));
    return c + omega * (bv - am);
}

// walk_own's and walk_edge's loads of one plane with e beside them: of the
// lane's cells ("own"), and of its halo rows and z halo ("edge")
template <typename T> struct PjOwn {
    WalkOwn<T> w;
    T e[WK_R / 2];
};
template <typename T> struct PjEdge {
    WalkEdge<T> w;
    T eyt, eyb;
    T ez[WK_R / 2];
};

// The index in e of the lane's first coarse cell at fine plane p
__device__ __forceinline__ int64_t coarse_at(const WalkLane& l, int64_t p) {
    return ((p >> 1) * (l.ny >> 1) + (l.j0 >> 1)) * (l.nz >> 1) + (l.k0 >> 1);
}

template <bool VEC, typename T>
__device__ __forceinline__ PjOwn<T> pj_own(const T* __restrict__ x, const T* __restrict__ e,
                                           const WalkLane& l, int64_t p) {
    PjOwn<T> o;
    o.w = walk_own<VEC, true>(x, l, p);
    const bool in = p >= 0 && p < l.nx;
    const int64_t nzc = l.nz >> 1, qe = coarse_at(l, p);
#pragma unroll
    for (int r = 0; r < WK_R / 2; ++r)
        o.e[r] = in && 2 * r < l.rows ? e[qe + r * nzc] : zero_of<T>();
    return o;
}

template <bool VEC, typename T>
__device__ __forceinline__ PjEdge<T> pj_edge(const T* __restrict__ x, const T* __restrict__ e,
                                             const T* __restrict__ b, const WalkLane& l,
                                             int64_t p, bool in) {
    PjEdge<T> d;
    d.w = walk_edge<VEC, true>(x, b, l, p, in);
    const int64_t nzc = l.nz >> 1, q = coarse_at(l, p);
    d.eyt = in && l.top ? e[q - nzc] : zero_of<T>();
    d.eyb = in && l.bot ? e[q + (WK_R / 2) * nzc] : zero_of<T>();
    const int64_t kh = l.zdir < 0 ? l.k0 - 1 : l.k0 + 2;
    const bool zin = in && l.zdir != 0 && kh >= 0 && kh < l.nz;
#pragma unroll
    for (int r = 0; r < WK_R / 2; ++r)
        d.ez[r] = zin && 2 * r < l.rows ? e[q + r * nzc + l.zdir] : zero_of<T>();
    return d;
}

// blocks an SM must hold for kernel C, by storage type: 5 in bf16 (at most
// 96 registers a thread), 4 in f32 (128); with 6 in bf16 its walk spills
template <typename T> struct PjResident { enum { value = sizeof(T) == 2 ? 5 : 4 }; };

template <typename T, bool VEC>
__global__ void __launch_bounds__(WK_NT, PjResident<T>::value) prolong_jacobi_kernel(
    const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ e,
    T* __restrict__ out, int64_t nx, int64_t ny, int64_t nz, int64_t slab,
    float diag, float off, float omega) {
    const WalkLane l = walk_lane(nx, ny, nz);
    const int64_t i0 = (int64_t)blockIdx.z * slab;
    const int64_t i1 = i0 + slab < nx ? i0 + slab : nx;

    // m of the lane's points at planes i-1, i and i+1; when plane i starts,
    // the loads of own(i+1) and edge(i) are in flight
    float2 prev[WK_R], cur[WK_R], next[WK_R];
    {
        const PjOwn<T> a = pj_own<VEC>(x, e, l, i0 - 1);
        const PjOwn<T> o = pj_own<VEC>(x, e, l, i0);
#pragma unroll
        for (int r = 0; r < WK_R; ++r) {
            prev[r] = add_e(to_f2(a.w.x[r]), to_f(a.e[r / 2]));
            cur[r] = add_e(to_f2(o.w.x[r]), to_f(o.e[r / 2]));
        }
    }
    PjOwn<T> own = pj_own<VEC>(x, e, l, i0 + 1);
    PjEdge<T> edge = pj_edge<VEC>(x, e, b, l, i0, true);
    for (int64_t i = i0; i < i1; ++i) {
#pragma unroll
        for (int r = 0; r < WK_R; ++r)
            next[r] = add_e(to_f2(own.w.x[r]), to_f(own.e[r / 2]));
        const PjEdge<T> d = edge;
        // the next plane's loads go out before this plane is computed
        own = pj_own<VEC>(x, e, l, i + 1 < i1 ? i + 2 : -1);
        edge = pj_edge<VEC>(x, e, b, l, i + 1, i + 1 < i1);
        const float2 yt = add_e(to_f2(d.w.yt), to_f(d.eyt));
        const float2 yb = add_e(to_f2(d.w.yb), to_f(d.eyb));
        const int64_t q = i * l.plane + l.j0 * nz + l.k0;
#pragma unroll
        for (int r = 0; r < WK_R; ++r) {
            const Taps t = taps_of(cur, yt, yb, to_f(d.w.z[r]) + to_f(d.ez[r / 2]), r);
            const float2 bv = to_f2(d.w.b[r]);
            float2 v;
            v.x = pj_point(cur[r].x, prev[r].x, next[r].x, t.yn.x, t.ys.x, t.zw, cur[r].y,
                           bv.x, diag, off, omega);
            v.y = pj_point(cur[r].y, prev[r].y, next[r].y, t.yn.y, t.ys.y, cur[r].x, t.ze,
                           bv.y, diag, off, omega);
            if (r < l.rows) store_pair<VEC>(out, q + r * nz, v);
        }
#pragma unroll
        for (int r = 0; r < WK_R; ++r) {
            prev[r] = cur[r];
            cur[r] = next[r];
        }
    }
}

template <typename T>
cudaError_t launch_prolong_jacobi(const void* x, const void* b, const void* e, void* out,
                                  int64_t nx, int64_t ny, int64_t nz, int64_t slab,
                                  float diag, float off, float omega, cudaStream_t s) {
    const dim3 grid = walk_grid(nx, ny, nz, slab);
    const dim3 block(WK_TZ, WK_WY);
    // pairs are aligned when every array starts on a pair (nz is even)
    const size_t pair = 2 * sizeof(T);
    if (pair_aligned(x, pair) && pair_aligned(b, pair) && pair_aligned(out, pair))
        prolong_jacobi_kernel<T, true><<<grid, block, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(e),
            static_cast<T*>(out), nx, ny, nz, slab, diag, off, omega);
    else
        prolong_jacobi_kernel<T, false><<<grid, block, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(e),
            static_cast<T*>(out), nx, ny, nz, slab, diag, off, omega);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel B: stencil3d_residual_restrict
//
// Replaces ops/stencil_pallas.py:stencil3d_residual_restrict_pallas
// (_kernel3d_rr): rc = (scale/8) * sum over each 2x2x2 cell of (b - A x),
// written only to the (nx/2, ny/2, nz/2) coarse grid.  The fine residual
// never reaches device memory.
//
// Bound: memory bytes, one read of x and b and a write of rc (1/8 size):
// 8.5 bytes a fine point in f32, 4.25 in bf16 (0.57 GB at 512^3, 0.170 ms
// at 3.35 TB/s).
//
// Design: the warp walk above, with its loads staged.  A lane's z pair is
// one coarse cell in z and its 4 rows two coarse cells in y; its slab
// starts on an even plane and has an even length (walk_slab), so it walks
// the planes in pairs.  Each lane copies its own pairs of every plane (x
// of its rows and of the two halo rows, b of its rows, and for lanes 0
// and 31 the pair that holds the z halo) with cp.async into a per-warp
// ring of RrStages planes in shared memory, RrStages - 3 planes ahead of
// the one it computes: the copies hold no registers, and a lane reads
// back only what it copied itself, so the ring needs no barrier, only
// cp.async.wait_group.  Points outside the grid are zero-filled by the
// copy.  (Arrays that do not start on a pair, VEC false, are staged by
// plain loads and stores.)  With loads a plane ahead in registers, as in
// kernel C, the walk ran 6% slower at 512^3; with its arithmetic cut to
// one add a point it runs 94% of its time: B is held by this load stream,
// x with its halo rows and b, not by its arithmetic (PERF.md).  The
// residual is formed once at each fine point, from x in registers; the
// lane keeps the even plane's residuals and, at the odd plane, adds the x
// pairs, then the y pairs, then the z pair, and writes its two coarse
// values, neighbouring lanes on neighbouring z.  Every product and sum is
// rounded on its own (the _rn intrinsics, never contracted into an FMA),
// in the order of the plain version, and the result is rounded once to
// the storage type: the kernel has the plain version's bits.  (The Pallas
// kernel's 0/1 pairing matmuls were a Mosaic work-around for strided
// addressing and are not ported; in bf16 it rounded the pair sums twice.)
// No per-point division: coarse indices are the lane's own, shifted.
// ---------------------------------------------------------------------------

// planes in a warp's ring (31 KB of shared memory a block in bf16, 42 KB
// in f32), and blocks an SM must hold (the register cap: 80 registers in
// bf16, 128 in f32), by storage type
template <typename T> struct RrStages { enum { value = sizeof(T) == 2 ? 6 : 4 }; };
template <typename T> struct RrResident { enum { value = sizeof(T) == 2 ? 6 : 4 }; };

// One plane of a warp's loads, lane by lane
template <typename T> struct RrStage {
    typename PairOf<T>::type x[WK_R + 2][WK_TZ];  // rows j0 - 1 .. j0 + WK_R
    typename PairOf<T>::type b[WK_R][WK_TZ];
    typename PairOf<T>::type z[2][WK_R];          // lane 0's, lane 31's halo pairs
};

// Copy the pair at src to dst (shared), or zeros where ok is false
template <bool VEC, typename P, typename T>
__device__ __forceinline__ void stage_pair(P* dst, const T* __restrict__ src, bool ok) {
    if (VEC) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                     "n"(sizeof(P)), "r"(ok ? (int)sizeof(P) : 0)
                     : "memory");
    } else {
        *dst = ok ? load_pair<false>(src, 0) : zero_of<P>();
    }
}

template <bool VEC, typename T>
__device__ __forceinline__ void rr_stage(RrStage<T>& st, const T* __restrict__ x,
                                         const T* __restrict__ b, const WalkLane& l,
                                         int64_t p, bool in) {
    const int lane = threadIdx.x;
    in = in && p >= 0 && p < l.nx && l.rows > 0;
    // out-of-grid copies read nothing: they point at the array's start
    const int64_t q = in ? p * l.plane + l.j0 * l.nz + l.k0 : 0;
#pragma unroll
    for (int r = -1; r <= WK_R; ++r) {
        const bool ok = in && (r < 0 ? l.top : r == WK_R ? l.bot : r < l.rows);
        stage_pair<VEC>(&st.x[r + 1][lane], x + (ok ? q + r * l.nz : 0), ok);
    }
#pragma unroll
    for (int r = 0; r < WK_R; ++r) {
        const bool ok = in && r < l.rows;
        stage_pair<VEC>(&st.b[r][lane], b + (ok ? q + r * l.nz : 0), ok);
    }
    if (l.zdir != 0) {
        // the pair holding z point k0 - 1 (lane 0) or k0 + 2 (lane 31)
        const int64_t kp = l.zdir < 0 ? l.k0 - 2 : l.k0 + 2;
        const bool zin = in && kp >= 0 && kp < l.nz;
#pragma unroll
        for (int r = 0; r < WK_R; ++r) {
            const bool ok = zin && r < l.rows;
            stage_pair<VEC>(&st.z[l.zdir > 0][r], x + (ok ? q + r * l.nz + (kp - l.k0) : 0),
                            ok);
        }
    }
}

__device__ __forceinline__ void stage_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// b - A c at one point in the plain version's order, op by op
__device__ __forceinline__ float residual_rn(float bv, float diag, float off, float c,
                                             float xm, float xp, float ym, float yp,
                                             float zm, float zp) {
    const float t = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(xm, xp), ym), yp),
                              __fadd_rn(zm, zp));
    return __fsub_rn(bv, __fadd_rn(__fmul_rn(diag, c), __fmul_rn(off, t)));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(WK_NT, RrResident<T>::value) residual_restrict_kernel(
    const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ rc, int64_t nx,
    int64_t ny, int64_t nz, int64_t slab, float diag, float off, float s8) {
    constexpr int P = RrStages<T>::value;
    __shared__ __align__(16) unsigned char rings[sizeof(RrStage<T>) * WK_WY * P];
    RrStage<T>* ring = reinterpret_cast<RrStage<T>*>(rings) + threadIdx.y * P;
    const int lane = threadIdx.x;
    const WalkLane l = walk_lane(nx, ny, nz);
    const int64_t nzc = nz / 2, cplane = (ny / 2) * nzc;
    const int64_t kc = l.k0 / 2, cy0 = l.j0 / 2;
    const int64_t i0 = (int64_t)blockIdx.z * slab;
    const int64_t i1 = i0 + slab < nx ? i0 + slab : nx;

    // the ring holds planes i0 - 1 .. i1, plane p at (p - i0 + 1) % P; the
    // first P - 1 go out now
#pragma unroll
    for (int s = 0; s < P - 1; ++s) {
        rr_stage<VEC>(ring[s], x, b, l, i0 - 1 + s, i0 - 1 + s <= i1);
        stage_commit();
    }
    stage_wait<P - 3>();    // planes i0 - 1 and i0 are in
    // x at planes i-1, i and i+1; the residuals of the pair's even plane
    float2 prev[WK_R], cur[WK_R], next[WK_R], even[WK_R];
#pragma unroll
    for (int r = 0; r < WK_R; ++r) {
        prev[r] = to_f2(ring[0].x[r + 1][lane]);
        cur[r] = to_f2(ring[1].x[r + 1][lane]);
    }
    int s_cur = 1;          // the slot of plane i
    for (int64_t i = i0; i < i1; i += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int64_t ih = i + h;
            // plane ih + P - 2 goes into the slot of plane ih - 2
            const int s_old = s_cur < 2 ? s_cur + P - 2 : s_cur - 2;
            const int s_next = s_cur == P - 1 ? 0 : s_cur + 1;
            rr_stage<VEC>(ring[s_old], x, b, l, ih + P - 2, ih + P - 2 <= i1);
            stage_commit();
            stage_wait<P - 3>();    // plane ih + 1 is in
            const RrStage<T>& st = ring[s_cur];
#pragma unroll
            for (int r = 0; r < WK_R; ++r) next[r] = to_f2(ring[s_next].x[r + 1][lane]);
#pragma unroll
            for (int r = 0; r < WK_R; ++r) {
                const float up = __shfl_up_sync(0xffffffffu, cur[r].y, 1);
                const float down = __shfl_down_sync(0xffffffffu, cur[r].x, 1);
                const float zw = lane == 0 ? to_f2(st.z[0][r]).y : up;
                const float ze = lane == WK_TZ - 1 ? to_f2(st.z[1][r]).x : down;
                const float2 yn = r == 0 ? to_f2(st.x[0][lane]) : cur[r - 1];
                const float2 ys = r == WK_R - 1 ? to_f2(st.x[WK_R + 1][lane]) : cur[r + 1];
                const float2 bv = to_f2(st.b[r][lane]);
                float2 res;
                res.x = residual_rn(bv.x, diag, off, cur[r].x, prev[r].x, next[r].x, yn.x,
                                    ys.x, zw, cur[r].y);
                res.y = residual_rn(bv.y, diag, off, cur[r].y, prev[r].y, next[r].y, yn.y,
                                    ys.y, cur[r].x, ze);
                if (h == 0)
                    even[r] = res;
                else  // the x pair
                    even[r] = make_float2(__fadd_rn(even[r].x, res.x),
                                          __fadd_rn(even[r].y, res.y));
            }
            if (h == 1) {
#pragma unroll
                for (int c = 0; c < WK_R / 2; ++c) {
                    if (2 * c >= l.rows) continue;
                    // the y pair at each z point, then the z pair
                    const float s0 = __fadd_rn(even[2 * c].x, even[2 * c + 1].x);
                    const float s1 = __fadd_rn(even[2 * c].y, even[2 * c + 1].y);
                    store(rc, (ih >> 1) * cplane + (cy0 + c) * nzc + kc,
                          __fmul_rn(s8, __fadd_rn(s0, s1)));
                }
            }
#pragma unroll
            for (int r = 0; r < WK_R; ++r) {
                prev[r] = cur[r];
                cur[r] = next[r];
            }
            s_cur = s_next;
        }
    }
    stage_wait<0>();        // no copy outlives the block
}

template <typename T>
cudaError_t launch_residual_restrict(const void* x, const void* b, void* rc, int64_t nx,
                                     int64_t ny, int64_t nz, int64_t slab, float diag,
                                     float off, float s8, cudaStream_t s) {
    const dim3 grid = walk_grid(nx, ny, nz, slab);
    const dim3 block(WK_TZ, WK_WY);
    if (pair_aligned(x, 2 * sizeof(T)) && pair_aligned(b, 2 * sizeof(T)))
        residual_restrict_kernel<T, true><<<grid, block, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(rc), nx, ny,
            nz, slab, diag, off, s8);
    else
        residual_restrict_kernel<T, false><<<grid, block, 0, s>>>(
            static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(rc), nx, ny,
            nz, slab, diag, off, s8);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel A over a stack of grids: the kinds mv, residual, jacobi, mv_cast
//
// y = A x, b - A x, x + omega (b - A x), or A x with x's cast copy, on
// each of t contiguous (nx, ny, nz) grids with zero outside each grid, in
// one launch (the kinds of ops/stencil_pallas.py:stencil3d_apply_pallas
// and stencil3d_mv_cast_pallas without a sum).  A single grid is a stack of
// one.  The stacks are the shards' tiles of the sharded and tiled 3D paths
// and the strips of the stacked 3D operator, where JAX runs a tile a chip.
//
// Bound: memory bytes.  One read of x (and of b) and one write of y (and of
// the cast copy): 8 bytes a point for an f32 mv, 12 for residual and
// jacobi, 0.321 ms for an f32 mv at 512^3 and 0.040 ms on the stack
// (8, 32, 256, 256), at 3.35 TB/s.
//
// Design: a block owns a tile of ty rows by tz = tzv V z points of one grid
// for a slab of x planes, and never crosses a grid of the stack; a thread
// owns V neighbouring z points of one row, one 16-byte vector of the
// storage type (V = 4 in f32, 8 in bf16, 2 in f64).  Each plane of the
// tile, with its one-row y halo and its z halo, and b of the tile for the
// kinds with b, is copied into a ring of ST_RING planes in shared memory by
// cp.async, 16 bytes a copy (the z halo 4 or 8 bytes), ST_RING - 2 planes
// ahead of the plane computed, so that the copies of the next planes
// overlap the compute of this one; one barrier a plane.  (The ring is two
// planes deeper than double buffering: with one plane in flight a block
// waits a memory latency a plane.)  A thread keeps its x at plane i - 1 in
// registers and reads x at planes i and i + 1, its y and z neighbours and
// b from the ring, a 16-byte shared load a vector.  Points and planes
// outside the grid are 0 by the copy's zero fill.  The tile and the slab
// come from ops/stencil3d.stack_geometry: tzv vectors as nz takes, up to
// 32, rows up to 256 threads and 64 rows, and a slab of 32 planes, halved
// down to 2 while the launch would have fewer than two waves of ST_RESIDENT
// blocks on each of the card's 132 SMs, so the 32-plane tiles of the
// sharded 256^3 paths walk 8 planes a block and 512^3 keeps 32.  The slab
// is the fastest block index, so a tile's slabs run side by side and the
// planes they share come from L2.  Where nz is not a multiple of V or an
// array does not start on 16 bytes (VEC false), the same ring is filled by
// plain loads, point by point, each vector stored whole (the ring is only
// ever read as 16-byte vectors: written value by value in f64 and read as
// vectors, it gave wrong values on the card), and y is stored point by
// point.  Every
// point's value is stencil7 and the kind's epilogue on the operands of the
// column walk above, so a grid of a stack has the bits of its launch alone,
// and mv has the bits of mv_dot's and mv_norm's y.  What the design gives
// up: a slab re-reads its two neighbouring x planes (1.25x the x reads at
// a slab of 8, mostly from L2), and no TMA: the copies cost a thread's
// instructions, one or two a plane.
//
// Kernel A, kind mv_dot, is this walk on one grid: y = A x and x . A x (the
// kind mv_dot of ops/stencil_pallas.py:stencil3d_apply_pallas), PCG's
// p . A p, once an iteration of the north-star's PCG.  Bound: memory
// bytes, one read of x and one write of y, 8 bytes a point in f32 (1.07 GB
// at 512^3, 0.321 ms at 3.35 TB/s).  Its y is kind mv's.  Its dot keeps the
// column walk's summation order bit for bit, so that PCG's p . A p, and
// with it the solver's iterates, are what they were when apply_kernel ran
// mv_dot: the grid is cut into boxes of BZ z points by BY rows by SLAB x
// planes, the column walk's blocks; each point's products are summed over
// the box's planes in x order by dot_step, one accumulator a point; the 32
// z sums of a box row are added in block_sum's shuffle-down tree, its steps
// of V points and more by shuffles between threads (thread offsets 4, 2, 1
// in f32) and the smaller ones in registers; then the BY row sums in the
// tree of block_sum's second stage, zeros included (dot_flush); a box's sum
// is its partial, at the column walk's index, and sum_partials adds the
// partials as before.  So a tile is made of whole boxes and a slab of whole
// boxes (ops/stencil3d.dot_geometry; the launcher refuses any other), and a
// block flushes its boxes every SLAB planes, one more barrier each.  Points
// outside the grid add nothing, boxes outside it write no partial.
// ---------------------------------------------------------------------------

constexpr int ST_THREADS = 256;   // threads a block at most (ops/stencil3d.py STACK_THREADS)
constexpr int ST_ROWS = 64;       // rows a tile at most (STACK_ROWS): 48 KB of ring
constexpr int ST_RING = 4;        // planes in a block's ring
constexpr int ST_RESIDENT = 4;    // blocks an SM must hold: 64 registers a thread

// the values a thread owns, one 16-byte vector of the storage type
template <typename T> struct VecOf { enum { value = 16 / sizeof(T) }; };
// the values of a z-halo copy: 4 bytes (cp.async's least), or one value
template <typename T> struct HaloOf { enum { value = sizeof(T) < 4 ? 4 / sizeof(T) : 1 }; };

template <> __device__ __forceinline__ double zero_of<double>() { return 0.0; }

__device__ __forceinline__ unsigned word_of(const uint4& u, int i) {
    return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// value e of a 16-byte vector of the storage type, in the arithmetic type
// (bf16 to f32 is exact: its bits are the top half of the f32)
template <typename T> __device__ __forceinline__ typename Compute<T>::type value_of(const uint4& u, int e);
template <> __device__ __forceinline__ float value_of<float>(const uint4& u, int e) {
    return __uint_as_float(word_of(u, e));
}
template <> __device__ __forceinline__ float value_of<bf16>(const uint4& u, int e) {
    const unsigned w = word_of(u, e >> 1);
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
}
template <> __device__ __forceinline__ double value_of<double>(const uint4& u, int e) {
    return __hiloint2double((int)word_of(u, 2 * e + 1), (int)word_of(u, 2 * e));
}

template <typename T>
__device__ __forceinline__ uint4 vec_at(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
}

// V values of a storage type as one 16-byte vector.  The ring is written
// and read as such vectors only (or written by cp.async), never value by
// value: a store of one type and a load of another to the same shared
// memory may be reordered by the compiler.
__device__ __forceinline__ uint4 vec_of(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 vec_of(const double (&v)[2]) {
    return make_uint4((unsigned)__double2loint(v[0]), (unsigned)__double2hiint(v[0]),
                      (unsigned)__double2loint(v[1]), (unsigned)__double2hiint(v[1]));
}
__device__ __forceinline__ uint4 vec_of(const bf16 (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        w[i] = (unsigned)__bfloat16_as_ushort(v[2 * i]) |
               ((unsigned)__bfloat16_as_ushort(v[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// N values stored at p in the storage type, as 8-, 16- or 32-byte stores
// (p is aligned to the store, since nz is a multiple of the vector)
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
#pragma unroll
    for (int e = 0; e < N; e += 4)
        *reinterpret_cast<float4*>(p + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
}
template <int N>
__device__ __forceinline__ void store_vec(double* p, const double (&v)[N]) {
#pragma unroll
    for (int e = 0; e < N; e += 2)
        *reinterpret_cast<double2*>(p + e) = make_double2(v[e], v[e + 1]);
}
template <int N>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[N]) {
    if constexpr (N == 4) {
        *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
    } else {
#pragma unroll
        for (int e = 0; e < N; e += 8)
            *reinterpret_cast<uint4*>(p + e) =
                make_uint4(bf16_pair(v[e], v[e + 1]), bf16_pair(v[e + 2], v[e + 3]),
                           bf16_pair(v[e + 4], v[e + 5]), bf16_pair(v[e + 6], v[e + 7]));
    }
}

// The first `left` of N values (all, with VEC) stored at p
template <bool VEC, typename TO, typename TC, int N>
__device__ __forceinline__ void store_out(TO* p, const TC (&v)[N], int64_t left) {
    if constexpr (VEC) {
        store_vec(p, v);
    } else {
#pragma unroll
        for (int e = 0; e < N; ++e)
            if (e < left) store(p, e, v[e]);
    }
}

// cp.async of BYTES from global src to shared dst, zeros where ok is false
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                     "r"(ok ? 16 : 0)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                     "n"(BYTES), "r"(ok ? BYTES : 0)
                     : "memory");
}

// A block's tile: its grid's extents, its first row and z point, its rows,
// its vectors a row (a power of two) and their log2, its z points and the
// length of a staged row (the tile's z points and a vector on each side)
struct StackTile {
    int64_t nx, ny, nz, plane, j0, k0;
    int ty, tzv, lz, tz, w;
};

// The V values of row offset `row` from z point k into dst: one 16-byte
// copy (VEC), or loaded value by value (zero past nz) and stored as one
// vector; zeros unless ok
template <bool VEC, typename T>
__device__ __forceinline__ void stage_values(T* dst, const T* __restrict__ src, int64_t row,
                                             int64_t k, int64_t nz, bool ok) {
    constexpr int V = VecOf<T>::value;
    if constexpr (VEC) {
        ok = ok && k < nz;
        copy_async<16>(dst, src + (ok ? row + k : 0), ok);
    } else {
        T v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = ok && k + e < nz ? src[row + k + e] : zero_of<T>();
        *reinterpret_cast<uint4*>(dst) = vec_of(v);
    }
}

// One value as the vector that holds it in the ring: at place e, zeros
// around it
template <typename T>
__device__ __forceinline__ uint4 vec_with(T value, int e) {
    T v[VecOf<T>::value];
#pragma unroll
    for (int i = 0; i < VecOf<T>::value; ++i) v[i] = i == e ? value : zero_of<T>();
    return vec_of(v);
}

// Plane p of the tile into a ring slot: x of rows j0 - 1 .. j0 + ty (row r
// of the slot at r w, the tile's z points from column V), the z halo of
// rows j0 .. j0 + ty - 1 (z point k0 - 1 at column V - 1, k0 + tz at V +
// tz, in the vectors of padding either side), and, with_b, b of rows j0 ..
// j0 + ty - 1 after them (row stride tz).  Zeros outside the grid.
template <bool VEC, typename T>
__device__ __forceinline__ void stack_stage(T* slot, const T* __restrict__ x,
                                            const T* __restrict__ b, const StackTile& t,
                                            int64_t p, bool with_b) {
    constexpr int V = VecOf<T>::value, H = HaloOf<T>::value;
    const int tid = threadIdx.x + threadIdx.y * t.tzv, nt = t.ty * t.tzv;
    const bool in = p >= 0 && p < t.nx;
    const int64_t q = p * t.plane;
    for (int u = tid; u < (t.ty + 2) * t.tzv; u += nt) {
        const int r = u >> t.lz, c = u & (t.tzv - 1);
        const int64_t j = t.j0 - 1 + r;
        const bool ok = in && j >= 0 && j < t.ny;
        stage_values<VEC>(slot + r * t.w + V + c * V, x, ok ? q + j * t.nz : 0,
                          t.k0 + (int64_t)c * V, t.nz, ok);
    }
    for (int h = tid; h < 2 * t.ty; h += nt) {
        const bool left = h < t.ty;
        const int r = (left ? h : h - t.ty) + 1;
        const int64_t j = t.j0 + r - 1;
        const bool row_in = in && j < t.ny;
        // VEC copies H values, so the left copy starts H - 1 before k0 - 1
        const int64_t k = left ? t.k0 - (VEC ? H : 1) : t.k0 + t.tz;
        const bool ok = row_in && (left ? t.k0 > 0 : k < t.nz);
        T* dst = slot + r * t.w + (left ? V - (VEC ? H : 1) : V + t.tz);
        if constexpr (VEC)
            copy_async<(int)(H * sizeof(T))>(dst, x + (ok ? q + j * t.nz + k : 0), ok);
        else  // the vector of padding that holds the halo value
            *reinterpret_cast<uint4*>(left ? dst - (V - 1) : dst) =
                vec_with(ok ? x[q + j * t.nz + k] : zero_of<T>(), left ? V - 1 : 0);
    }
    if (with_b) {
        T* sb = slot + (t.ty + 2) * t.w;
        for (int u = tid; u < t.ty * t.tzv; u += nt) {
            const int r = u >> t.lz, c = u & (t.tzv - 1);
            const int64_t j = t.j0 + r;
            const bool ok = in && j < t.ny;
            stage_values<VEC>(sb + r * t.tz + c * V, b, ok ? q + j * t.nz : 0,
                              t.k0 + (int64_t)c * V, t.nz, ok);
        }
    }
}

// threads of a box row in the dot walk, and the box rows of a block at most
template <typename T> struct BoxOf {
    enum { threads = BZ / VecOf<T>::value, rows = ST_THREADS / threads };
};

// mv_dot's partials of a block's boxes after plane i, the last plane of a
// box: acc holds a thread's V sums over the box's planes; zeroed after
template <typename TX>
__device__ __forceinline__ void dot_flush(typename Compute<TX>::type (&acc)[VecOf<TX>::value],
                                          const StackTile& t, int64_t i,
                                          typename Compute<TX>::type* __restrict__ partials) {
    typedef typename Compute<TX>::type TC;
    constexpr int V = VecOf<TX>::value, BT = BoxOf<TX>::threads;
    static_assert(BY == 8, "the second stage below adds 8 row sums");
    __shared__ TC rows[BoxOf<TX>::rows];     // a box row's sum, by row and box
    // block_sum's first stage over the box row's BZ z points: point p takes
    // p + o, which for o >= V is the same place in the vector of the thread
    // o / V further along.  Plain adds, as block_sum's: with no product in
    // them there is nothing to contract.
#pragma unroll
    for (int o = BZ / 2; o >= V; o >>= 1)
#pragma unroll
        for (int e = 0; e < V; ++e)
            acc[e] += __shfl_down_sync(0xffffffffu, acc[e], o / V);
#pragma unroll
    for (int o = V / 2; o >= 1; o >>= 1)
#pragma unroll
        for (int e = 0; e < o; ++e) acc[e] += acc[e + o];
    const int nbz = t.tz / BZ;               // boxes along z in the tile
    if (threadIdx.x % BT == 0) rows[threadIdx.y * nbz + threadIdx.x / BT] = acc[0];
    __syncthreads();
    const int u = threadIdx.x + threadIdx.y * t.tzv;
    if (u < t.ty / BY * nbz) {
        const int by = u / nbz, bz = u % nbz;
        // block_sum's second stage: the 8 warp sums in lanes 0-7, zeros in
        // lanes 8-31, so each meets two zeros before the tree of the 8
        TC a[BY];
#pragma unroll
        for (int r = 0; r < BY; ++r) a[r] = (rows[(by * BY + r) * nbz + bz] + TC(0)) + TC(0);
        const TC sum = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]));
        const int64_t gx = (t.nz + BZ - 1) / BZ, gy = (t.ny + BY - 1) / BY;
        const int64_t px = t.k0 / BZ + bz, py = t.j0 / BY + by;
        if (px < gx && py < gy) partials[px + gx * (py + gy * (i / SLAB))] = sum;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = TC(0);
}

template <int KIND, typename TX, typename TO, bool VEC>
__global__ void __launch_bounds__(ST_THREADS, ST_RESIDENT) stack_kernel(
    const TX* __restrict__ x, const TX* __restrict__ b, TO* __restrict__ y,
    TO* __restrict__ y2, typename Compute<TX>::type* __restrict__ partials, int64_t nx,
    int64_t ny, int64_t nz, int64_t slab, int64_t nslab, int64_t ntz, int64_t nty,
    typename Compute<TX>::type diag, typename Compute<TX>::type off,
    typename Compute<TX>::type omega) {
    typedef typename Compute<TX>::type TC;
    constexpr int V = VecOf<TX>::value;
    constexpr bool RHS = KIND == RESIDUAL || KIND == JACOBI;
    extern __shared__ __align__(16) unsigned char stack_ring[];

    StackTile t;
    t.nx = nx; t.ny = ny; t.nz = nz; t.plane = ny * nz;
    t.ty = blockDim.y; t.tzv = blockDim.x; t.lz = __ffs(t.tzv) - 1;
    t.tz = t.tzv * V; t.w = t.tz + 2 * V;
    // the block: slab fastest, then the tile's z, its y, the grid
    int64_t blk = blockIdx.x;
    const int64_t i0 = (blk % nslab) * slab;
    blk /= nslab;
    t.k0 = (blk % ntz) * t.tz;
    blk /= ntz;
    t.j0 = (blk % nty) * t.ty;
    const int64_t grid = (blk / nty) * nx * t.plane;    // the grid's offset
    const TX* xg = x + grid;
    const TX* bg = RHS ? b + grid : nullptr;
    const int64_t i1 = i0 + slab < nx ? i0 + slab : nx;
    const int slot_len = (t.ty + 2) * t.w + (RHS ? t.ty * t.tz : 0);
    TX* const ring = reinterpret_cast<TX*>(stack_ring);
    // plane p's slot; the ring holds planes i0 - 1 .. i1
    auto slot = [&](int64_t p) {
        return ring + ((int)(p - i0 + 1) & (ST_RING - 1)) * slot_len;
    };
    auto stage = [&](int64_t p) {
        if (p <= i1) stack_stage<VEC>(slot(p), xg, bg, t, p, RHS && p >= i0 && p < i1);
        stage_commit();   // a group a plane, empty or not, so the waits count planes
    };

#pragma unroll
    for (int s = 0; s < ST_RING; ++s) stage(i0 - 1 + s);
    stage_wait<ST_RING - 2>();      // planes i0 - 1 and i0 are in
    __syncthreads();
    const int own = (threadIdx.y + 1) * t.w + V + threadIdx.x * V;   // in a slot
    const int64_t j = t.j0 + threadIdx.y, k = t.k0 + (int64_t)threadIdx.x * V;
    const bool owns = j < ny && k < nz;
    const int64_t left = nz - k;    // of the thread's V points, those in the grid
    TC acc[V];                      // mv_dot: its points' sums over a box's planes
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = TC(0);
    uint4 prev = vec_at(slot(i0 - 1) + own), cur = vec_at(slot(i0) + own);
    for (int64_t i = i0; i < i1; ++i) {
        stage_wait<ST_RING - 3>();  // plane i + 1 is in
        __syncthreads();            // and no thread reads plane i - 1's slot
        stage(i + ST_RING - 1);     // into plane i - 1's slot
        const TX* sc = slot(i);
        const uint4 next = vec_at(slot(i + 1) + own);
        const uint4 yn = vec_at(sc + own - t.w), ys = vec_at(sc + own + t.w);
        // z points k - 1 and k + V: the ends of the vectors either side
        const TC zw = value_of<TX>(vec_at(sc + own - V), V - 1);
        const TC ze = value_of<TX>(vec_at(sc + own + V), 0);
        const uint4 bv = RHS ? vec_at(sc + (t.ty + 2) * t.w + threadIdx.y * t.tz +
                                      threadIdx.x * V)
                             : make_uint4(0u, 0u, 0u, 0u);
        TC out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
            const TC c = value_of<TX>(cur, e);
            const TC zm = e == 0 ? zw : value_of<TX>(cur, e - 1);
            const TC zp = e == V - 1 ? ze : value_of<TX>(cur, e + 1);
            TC v = stencil7(diag, off, c, value_of<TX>(prev, e), value_of<TX>(next, e),
                            value_of<TX>(yn, e), value_of<TX>(ys, e), zm, zp);
            if (KIND == RESIDUAL) {
                v = value_of<TX>(bv, e) - v;
            } else if (KIND == JACOBI) {
                v = c + omega * (value_of<TX>(bv, e) - v);
            } else if (KIND == MV_DOT) {
                if (owns && e < left) acc[e] = dot_step(c, v, acc[e]);
            }
            out[e] = v;
        }
        if (owns) {
            const int64_t q = grid + i * t.plane + j * nz + k;
            store_out<VEC>(y + q, out, left);
            if (KIND == MV_CAST) {
                TC cv[V];
#pragma unroll
                for (int e = 0; e < V; ++e) cv[e] = value_of<TX>(cur, e);
                store_out<VEC>(y2 + q, cv, left);
            }
        }
        if constexpr (KIND == MV_DOT)
            if ((i + 1) % SLAB == 0 || i + 1 == i1) dot_flush<TX>(acc, t, i, partials);
        prev = cur;
        cur = next;
    }
    stage_wait<0>();                // no copy outlives the block
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// tzv, ty, slab within the stack walk's limits (ST_THREADS, ST_ROWS)
bool stack_fits(int tzv, int ty, int slab) {
    return tzv >= 1 && tzv <= 32 && !(tzv & (tzv - 1)) && ty >= 1 && ty <= ST_ROWS &&
           tzv * ty <= ST_THREADS && slab >= 1;
}

template <int KIND, typename TX, typename TO>
cudaError_t launch_stack(const void* x, const void* b, void* y, void* y2, void* partials,
                         int64_t t, int64_t nx, int64_t ny, int64_t nz, int tzv, int ty,
                         int slab, double diag, double off, double omega, cudaStream_t s) {
    typedef typename Compute<TX>::type TC;
    constexpr int V = VecOf<TX>::value;
    constexpr bool RHS = KIND == RESIDUAL || KIND == JACOBI, DOT = KIND == MV_DOT;
    const int tz = tzv * V;
    // the dot walk: one grid, a tile and a slab of whole boxes
    if (DOT && (t != 1 || tz % BZ || ty % BY || slab % SLAB)) return cudaErrorInvalidValue;
    const int64_t nslab = (nx + slab - 1) / slab, ntz = (nz + tz - 1) / tz,
                  nty = (ny + ty - 1) / ty;
    const int64_t blocks = t * nslab * ntz * nty;
    const size_t ring =
        (size_t)ST_RING * ((ty + 2) * (tz + 2 * V) + (RHS ? ty * tz : 0)) * sizeof(TX);
    const size_t rows = DOT ? BoxOf<TX>::rows * sizeof(TC) : 0;
    if (blocks > 0x7fffffff || ring + rows > 48 * 1024) return cudaErrorInvalidValue;
    const bool vec = nz % V == 0 && aligned16(x) && (!RHS || aligned16(b)) && aligned16(y) &&
                     (KIND != MV_CAST || aligned16(y2));
    const dim3 block(tzv, ty);
    if (vec)
        stack_kernel<KIND, TX, TO, true><<<(unsigned)blocks, block, ring, s>>>(
            static_cast<const TX*>(x), static_cast<const TX*>(b), static_cast<TO*>(y),
            static_cast<TO*>(y2), static_cast<TC*>(partials), nx, ny, nz, slab, nslab, ntz,
            nty, (TC)diag, (TC)off, (TC)omega);
    else
        stack_kernel<KIND, TX, TO, false><<<(unsigned)blocks, block, ring, s>>>(
            static_cast<const TX*>(x), static_cast<const TX*>(b), static_cast<TO*>(y),
            static_cast<TO*>(y2), static_cast<TC*>(partials), nx, ny, nz, slab, nslab, ntz,
            nty, (TC)diag, (TC)off, (TC)omega);
    return cudaGetLastError();
}

// Kind mv_dot: the dot walk, then sum_partials over its partials (as many
// as apply_grid has blocks)
template <typename TX, typename TO>
cudaError_t launch_mv_dot(const void* x, void* y, void* partials, void* dot, int64_t nx,
                          int64_t ny, int64_t nz, int tzv, int ty, int slab, double diag,
                          double off, cudaStream_t s) {
    typedef typename Compute<TX>::type TC;
    const cudaError_t err = launch_stack<MV_DOT, TX, TO>(
        x, nullptr, y, nullptr, partials, 1, nx, ny, nz, tzv, ty, slab, diag, off, 0.0, s);
    if (err != cudaSuccess) return err;
    const dim3 g = apply_grid(nx, ny, nz);
    sum_partials<TC><<<1, FINISH_THREADS, 0, s>>>(
        static_cast<const TC*>(partials), (int64_t)g.x * g.y * g.z, static_cast<TC*>(dot));
    return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t dispatch_stack(int kind, const void* x, const void* b, void* y, void* y2,
                           int64_t t, int64_t nx, int64_t ny, int64_t nz, int tzv, int ty,
                           int slab, double diag, double off, double omega, cudaStream_t s) {
    switch (kind) {
        case MV:
            return launch_stack<MV, TX, TO>(x, b, y, y2, nullptr, t, nx, ny, nz, tzv, ty, slab, diag, off, omega, s);
        case RESIDUAL:
            return launch_stack<RESIDUAL, TX, TO>(x, b, y, y2, nullptr, t, nx, ny, nz, tzv, ty, slab, diag, off, omega, s);
        case JACOBI:
            return launch_stack<JACOBI, TX, TO>(x, b, y, y2, nullptr, t, nx, ny, nz, tzv, ty, slab, diag, off, omega, s);
        case MV_CAST:
            return launch_stack<MV_CAST, TX, TO>(x, b, y, y2, nullptr, t, nx, ny, nz, tzv, ty, slab, diag, off, omega, s);
        default:
            return cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// Kernel A, kind jacobi_dot, on f32 and bf16 storage: the warp walk
//
// y = x + omega (b - A x) and b . y in one pass (the kind jacobi_dot of
// ops/stencil_pallas.py:stencil3d_apply_pallas), PCG's r . z taken in the
// multigrid cycle's last sweep.  f64 grids take apply_kernel's walk.
//
// Bound: memory bytes, reads of x and b and the write of y: 8 bytes a
// point from bf16 into f32 (1.07 GB at 512^3, 0.321 ms at 3.35 TB/s).
//
// Design: the warp walk above, over any grid (nz may be odd: then the
// scalar loads).  Each point's y is stencil7 and then the expression of
// stack_kernel's kind jacobi, so y has the bits of the kind jacobi.  A
// lane adds b . y over its points in an f32 register for its whole walk;
// each warp then sums its lanes by xor shuffles in a fixed order and
// writes one partial, with no block barrier; sum_partials adds the
// partials in a fixed order.  No float atomics: two launches give equal
// bits.  (apply_kernel's dot kinds write one partial a block after a
// block-wide reduction behind __syncthreads.)
// ---------------------------------------------------------------------------

template <typename TX, typename TO, bool VEC>
__global__ void __launch_bounds__(WK_NT, WalkResident<TX>::value) jacobi_dot_kernel(
    const TX* __restrict__ x, const TX* __restrict__ b, TO* __restrict__ y,
    float* __restrict__ partials, int64_t nx, int64_t ny, int64_t nz, int64_t slab,
    float diag, float off, float omega) {
    const WalkLane l = walk_lane(nx, ny, nz);
    const int64_t i0 = (int64_t)blockIdx.z * slab;
    const int64_t i1 = i0 + slab < nx ? i0 + slab : nx;

    float2 prev[WK_R], cur[WK_R], next[WK_R];
    {
        const WalkOwn<TX> a = walk_own<VEC, false>(x, l, i0 - 1);
        const WalkOwn<TX> c = walk_own<VEC, false>(x, l, i0);
#pragma unroll
        for (int r = 0; r < WK_R; ++r) {
            prev[r] = to_f2(a.x[r]);
            cur[r] = to_f2(c.x[r]);
        }
    }
    WalkOwn<TX> own = walk_own<VEC, false>(x, l, i0 + 1);
    WalkEdge<TX> edge = walk_edge<VEC, false>(x, b, l, i0, true);
    float acc = 0.f;
    for (int64_t i = i0; i < i1; ++i) {
#pragma unroll
        for (int r = 0; r < WK_R; ++r) next[r] = to_f2(own.x[r]);
        const WalkEdge<TX> d = edge;
        own = walk_own<VEC, false>(x, l, i + 1 < i1 ? i + 2 : -1);
        edge = walk_edge<VEC, false>(x, b, l, i + 1, i + 1 < i1);
        const int64_t q = i * l.plane + l.j0 * nz + l.k0;
#pragma unroll
        for (int r = 0; r < WK_R; ++r) {
            const Taps t = taps_of(cur, to_f2(d.yt), to_f2(d.yb), to_f(d.z[r]), r);
            const float2 bv = to_f2(d.b[r]);
            float2 v;
            v.x = stencil7(diag, off, cur[r].x, prev[r].x, next[r].x, t.yn.x, t.ys.x, t.zw,
                           cur[r].y);
            v.x = cur[r].x + omega * (bv.x - v.x);
            v.y = stencil7(diag, off, cur[r].y, prev[r].y, next[r].y, t.yn.y, t.ys.y,
                           cur[r].x, t.ze);
            v.y = cur[r].y + omega * (bv.y - v.y);
            if (r < l.rows) {
                store_pts<VEC>(y, q + r * nz, v, l.pts);
                acc += bv.x * v.x;
                if (l.pts == 2) acc += bv.y * v.y;
            }
        }
#pragma unroll
        for (int r = 0; r < WK_R; ++r) {
            prev[r] = cur[r];
            cur[r] = next[r];
        }
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (threadIdx.x == 0)
        partials[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * (gridDim.x * WK_WY) +
                 (int64_t)blockIdx.x * WK_WY + threadIdx.y] = acc;
}

template <typename TX, typename TO>
cudaError_t launch_jacobi_dot(const void* x, const void* b, void* y, void* partials,
                              void* dot, int64_t nx, int64_t ny, int64_t nz, int64_t slab,
                              float diag, float off, float omega, cudaStream_t s) {
    const dim3 grid = walk_grid(nx, ny, nz, slab);
    const dim3 block(WK_TZ, WK_WY);
    const bool vec = nz % 2 == 0 && pair_aligned(x, 2 * sizeof(TX)) &&
                     pair_aligned(b, 2 * sizeof(TX)) && pair_aligned(y, 2 * sizeof(TO));
    if (vec)
        jacobi_dot_kernel<TX, TO, true><<<grid, block, 0, s>>>(
            static_cast<const TX*>(x), static_cast<const TX*>(b), static_cast<TO*>(y),
            static_cast<float*>(partials), nx, ny, nz, slab, diag, off, omega);
    else
        jacobi_dot_kernel<TX, TO, false><<<grid, block, 0, s>>>(
            static_cast<const TX*>(x), static_cast<const TX*>(b), static_cast<TO*>(y),
            static_cast<float*>(partials), nx, ny, nz, slab, diag, off, omega);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sum_partials<float><<<1, FINISH_THREADS, 0, s>>>(
        static_cast<const float*>(partials), (int64_t)grid.x * grid.y * grid.z * WK_WY,
        static_cast<float*>(dot));
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel M (3D): the coarse Chebyshev solve, chebyshev_coarse.cuh, on a
// 7-point grid whose A d is stencil7, evaluated as kernel A evaluates it.
// ---------------------------------------------------------------------------

#include "chebyshev_coarse.cuh"

template <typename TC> struct Grid7 {
    static constexpr int DIRS = 3;     // x, y, z
    int nx, ny, nz;
    TC diag, off;
    __host__ __device__ __forceinline__ int points() const { return nx * ny * nz; }
    __host__ __device__ __forceinline__ int stride(int a) const {
        return a == 0 ? ny * nz : a == 1 ? nz : 1;
    }
    // bits: x-1, x+1, y-1, y+1, z-1, z+1 inside the grid
    __device__ __forceinline__ unsigned mask(int p) const {
        const int k = p % nz, j = (p / nz) % ny, i = p / (nz * ny);
        return (i > 0) | (i + 1 < nx) << 1 | (j > 0) << 2 | (j + 1 < ny) << 3 |
               (k > 0) << 4 | (k + 1 < nz) << 5;
    }
    __device__ __forceinline__ TC combine(TC c, const TC (&nb)[6]) const {
        return stencil7(diag, off, c, nb[0], nb[1], nb[2], nb[3], nb[4], nb[5]);
    }
};

template <typename T>
cudaError_t launch_chebyshev7(const void* b, void* x, int64_t batch, int64_t nx,
                              int64_t ny, int64_t nz, double diag, double off,
                              const double* coefs, int steps, cudaStream_t s) {
    typedef typename Compute<T>::type TC;
    if (nx < 1 || ny < 1 || nz < 1 || nx * ny * nz > CHEB_MAX_POINTS)
        return cudaErrorInvalidValue;
    const Grid7<TC> g = {(int)nx, (int)ny, (int)nz, (TC)diag, (TC)off};
    return launch_chebyshev_coarse<T>(b, x, batch, g, coefs, steps, s);
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

// The kinds with a sum, on one grid: kind 1 mv_dot, 4 jacobi_dot, 6
// mv_norm (kernel K).  b: the right-hand side of jacobi_dot and mv_norm
// (x's type) or null.  partials (stencil3d_apply_partials values) and dot
// (one value), both of the arithmetic type (f32, or f64 for f64 storage).
// f64 goes with f64 only; mv_norm takes one type for x, b and y, f32 or
// f64; jacobi_dot takes f64 alone (f32 and bf16 storage:
// stencil3d_jacobi_dot).  tzv, ty, slab: mv_dot's tile and slab, as
// stencil3d_apply_stack's and made of whole boxes of BZ z points, BY rows
// and SLAB planes (ops/stencil3d.py dot_geometry); the other kinds ignore
// them.
int stencil3d_apply(int kind, int x_dtype, int out_dtype, const void* x,
                    const void* b, void* y, void* partials, void* dot,
                    int64_t nx, int64_t ny, int64_t nz, int tzv, int ty, int slab,
                    double diag, double off, double omega, void* stream) {
    if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == JACOBI_DOT) {
        if (x_dtype == F64 && out_dtype == F64)
            return launch_apply<JACOBI_DOT, double, double>(x, b, y, partials, dot, nx, ny, nz, diag, off, omega, s);
        return cudaErrorInvalidValue;
    }
    if (kind == MV_NORM) {
        if (x_dtype == F32 && out_dtype == F32)
            return launch_apply<MV_NORM, float, float>(x, b, y, partials, dot, nx, ny, nz, diag, off, omega, s);
        if (x_dtype == F64 && out_dtype == F64)
            return launch_apply<MV_NORM, double, double>(x, b, y, partials, dot, nx, ny, nz, diag, off, omega, s);
        return cudaErrorInvalidValue;
    }
    if (kind != MV_DOT || !stack_fits(tzv, ty, slab)) return cudaErrorInvalidValue;
    if (x_dtype == F32 && out_dtype == F32)
        return launch_mv_dot<float, float>(x, y, partials, dot, nx, ny, nz, tzv, ty, slab, diag, off, s);
    if (x_dtype == F32 && out_dtype == BF16)
        return launch_mv_dot<float, bf16>(x, y, partials, dot, nx, ny, nz, tzv, ty, slab, diag, off, s);
    if (x_dtype == BF16 && out_dtype == F32)
        return launch_mv_dot<bf16, float>(x, y, partials, dot, nx, ny, nz, tzv, ty, slab, diag, off, s);
    if (x_dtype == BF16 && out_dtype == BF16)
        return launch_mv_dot<bf16, bf16>(x, y, partials, dot, nx, ny, nz, tzv, ty, slab, diag, off, s);
    if (x_dtype == F64 && out_dtype == F64)
        return launch_mv_dot<double, double>(x, y, partials, dot, nx, ny, nz, tzv, ty, slab, diag, off, s);
    return cudaErrorInvalidValue;
}

// The kinds without a sum on a stack of t contiguous (nx, ny, nz) grids:
// kind 0 mv, 2 residual, 3 jacobi, 5 mv_cast.  b: the right-hand side of
// residual and jacobi (x's type, x's shape) or null.  y2: the cast copy of
// x for mv_cast, or null.  tzv, ty, slab: the tile (tzv 16-byte vectors of
// x's type along z, a power of two up to 32, by ty rows, at most 64 and
// tzv ty <= 256) and the x planes a block walks (ops/stencil3d.py
// stack_geometry).  f64 goes with f64 only.
int stencil3d_apply_stack(int kind, int x_dtype, int out_dtype, const void* x,
                          const void* b, void* y, void* y2, int64_t t, int64_t nx,
                          int64_t ny, int64_t nz, int tzv, int ty, int slab,
                          double diag, double off, double omega, void* stream) {
    if (t < 1 || nx < 1 || ny < 1 || nz < 1 || !stack_fits(tzv, ty, slab))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_dtype == F32 && out_dtype == F32)
        return dispatch_stack<float, float>(kind, x, b, y, y2, t, nx, ny, nz, tzv, ty, slab, diag, off, omega, s);
    if (x_dtype == F32 && out_dtype == BF16)
        return dispatch_stack<float, bf16>(kind, x, b, y, y2, t, nx, ny, nz, tzv, ty, slab, diag, off, omega, s);
    if (x_dtype == BF16 && out_dtype == F32)
        return dispatch_stack<bf16, float>(kind, x, b, y, y2, t, nx, ny, nz, tzv, ty, slab, diag, off, omega, s);
    if (x_dtype == BF16 && out_dtype == BF16)
        return dispatch_stack<bf16, bf16>(kind, x, b, y, y2, t, nx, ny, nz, tzv, ty, slab, diag, off, omega, s);
    if (x_dtype == F64 && out_dtype == F64)
        return dispatch_stack<double, double>(kind, x, b, y, y2, t, nx, ny, nz, tzv, ty, slab, diag, off, omega, s);
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
// one type.  slab: x planes a block walks, even (ops/stencil3d.py
// walk_slab).  s8 = scale / 8.
int stencil3d_residual_restrict(int dtype, const void* x, const void* b,
                                void* rc, int64_t nx, int64_t ny, int64_t nz,
                                int64_t slab, float diag, float off, float s8,
                                void* stream) {
    if (nx < 2 || ny < 2 || nz < 2 || nx % 2 || ny % 2 || nz % 2 || slab % 2 ||
        !walk_fits(nx, ny, slab))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch_residual_restrict<float>(x, b, rc, nx, ny, nz, slab, diag, off, s8, s);
    if (dtype == BF16)
        return launch_residual_restrict<bf16>(x, b, rc, nx, ny, nz, slab, diag, off, s8, s);
    return cudaErrorInvalidValue;
}

// Number of partial sums stencil3d_jacobi_dot writes (one a warp).
int64_t stencil3d_jacobi_dot_partials(int64_t nx, int64_t ny, int64_t nz, int64_t slab) {
    const dim3 g = walk_grid(nx, ny, nz, slab);
    return (int64_t)g.x * g.y * g.z * WK_WY;
}

// Kernel A's kind jacobi_dot on f32 or bf16 storage (dtype codes 0, 1 for
// x and b, and for y): y = x + omega (b - A x) and dot = b . y.  slab: x
// planes a block walks (ops/stencil3d.py walk_slab); partials
// (stencil3d_jacobi_dot_partials values) and dot (one value): f32.
int stencil3d_jacobi_dot(int x_dtype, int out_dtype, const void* x, const void* b,
                         void* y, void* partials, void* dot, int64_t nx, int64_t ny,
                         int64_t nz, int64_t slab, float diag, float off, float omega,
                         void* stream) {
    if (nx < 1 || ny < 1 || nz < 1 || !walk_fits(nx, ny, slab))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_dtype == F32 && out_dtype == F32)
        return launch_jacobi_dot<float, float>(x, b, y, partials, dot, nx, ny, nz, slab, diag, off, omega, s);
    if (x_dtype == F32 && out_dtype == BF16)
        return launch_jacobi_dot<float, bf16>(x, b, y, partials, dot, nx, ny, nz, slab, diag, off, omega, s);
    if (x_dtype == BF16 && out_dtype == F32)
        return launch_jacobi_dot<bf16, float>(x, b, y, partials, dot, nx, ny, nz, slab, diag, off, omega, s);
    if (x_dtype == BF16 && out_dtype == BF16)
        return launch_jacobi_dot<bf16, bf16>(x, b, y, partials, dot, nx, ny, nz, slab, diag, off, omega, s);
    return cudaErrorInvalidValue;
}

// x, b, out: fine (nx, ny, nz), even dims; e: coarse (nx/2, ny/2, nz/2);
// all of one type.  slab: x planes a block walks (ops/stencil3d.py
// walk_slab).
int stencil3d_prolong_jacobi(int dtype, const void* x, const void* b,
                             const void* e, void* out, int64_t nx, int64_t ny,
                             int64_t nz, int64_t slab, float diag, float off,
                             float omega, void* stream) {
    if (nx < 2 || ny < 2 || nz < 2 || nx % 2 || ny % 2 || nz % 2 ||
        !walk_fits(nx, ny, slab))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch_prolong_jacobi<float>(x, b, e, out, nx, ny, nz, slab, diag, off, omega, s);
    if (dtype == BF16)
        return launch_prolong_jacobi<bf16>(x, b, e, out, nx, ny, nz, slab, diag, off, omega, s);
    return cudaErrorInvalidValue;
}

// Kernel M: `steps` Chebyshev steps from x0 = 0 on each of `batch`
// contiguous (nx, ny, nz) grids of b, into x, of f32, bf16 or f64 (dtype
// 0, 1, 2); at most 4096 points a grid and 128 steps.  coefs: host
// doubles, inv_theta then c1[k], c2[k] (chebyshev_coarse.cuh).
int stencil3d_chebyshev(int dtype, const void* b, void* x, int64_t batch,
                        int64_t nx, int64_t ny, int64_t nz, double diag,
                        double off, const double* coefs, int steps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch_chebyshev7<float>(b, x, batch, nx, ny, nz, diag, off, coefs, steps, s);
    if (dtype == BF16)
        return launch_chebyshev7<bf16>(b, x, batch, nx, ny, nz, diag, off, coefs, steps, s);
    if (dtype == F64)
        return launch_chebyshev7<double>(b, x, batch, nx, ny, nz, diag, off, coefs, steps, s);
    return cudaErrorInvalidValue;
}

}  // extern "C"
