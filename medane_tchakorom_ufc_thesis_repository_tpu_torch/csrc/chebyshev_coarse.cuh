// Kernel M: the multigrid cycle's coarse Chebyshev solve in one launch,
// included by stencil3d.cu (7-point grids) and stencil2d.cu (5-point
// grids) inside their anonymous namespaces, after their Compute<>, load()
// and store() and their stencil expression (stencil7, stencil5).
//
// Replaces the coarse loop that the JAX package's _df_fused_program
// (solvers/refine.py) runs inside its jitted W-cycle: chebyshev()'s
// lax.fori_loop (solvers/chebyshev.py:81), compiled by XLA, not a Pallas
// kernel.  The port ran it as 40 host-launched steps of about six kernels
// each, plus two norms the cycle never read.
//
// What it computes: `steps` Chebyshev iterations from x0 = 0 on each grid
// of a batch, exactly as the PyTorch loop
// (ops/coarse.py chebyshev_steps, with kernel A or E as the matvec):
//
//   d = r * inv_theta                 (CUDA's r / theta with a host scalar)
//   per step k:  x = x + d;  r = r - A d;  d = c1[k] d + c2[k] r
//
// Every operation is rounded on its own to the storage type, as the
// separate PyTorch kernels round it: the axpys are _rn intrinsics, which
// nvcc never contracts into an FMA, and a bf16 value is rounded to bf16
// after each operation; A d is the including file's stencil expression,
// compiled as its apply kernel compiles it, rounded once to the storage
// type as that kernel stores it.  The coefficients are the host-rounded
// ones of solvers/chebyshev.chebyshev_coefficients, passed by value (a
// __grid_constant__ parameter): a launch reads no host memory, so it can
// be captured in a CUDA graph.
//
// Bound: one read of b and one write of x (the grid fits on chip), 64-256
// bytes on the main path's grids (4^3, 4x4): no launch comes near it.  A
// launch is held by its latency: a launch with no step (its start, the
// read of b, the write of x), then 40 dependent steps, each a chain of an
// exchange of d between lanes (one round of shuffles, ~25-30 cycles) and
// of about ten dependent rounded operations (the stencil's four or five,
// r - A d, c2 r, the sum: ~4 cycles each in f32, ~8 with the bf16
// rounding after each), ~60-110 cycles a step, 2,400-4,400 cycles for
// the 40, ~1.2-2.2 us at 1.98 GHz above the launch with no step.
//
// Design: the warp path, for a grid of at most 32 CHEB_WARP_PTS = 64
// points whose rows (2D) or planes (3D) hold fewer than 32 points (the
// main path's 4^3 and 4x4, the strips' 4x8): one warp a grid, CHEB_WARPS
// grids a block.  Lane l owns the points l and l + 32 (PTS of them: 1, or
// 2 past 32 points) and keeps their x, r and d in registers, with a bit
// mask of the neighbours inside the grid.  A step reads the neighbours' d
// by warp shuffles, one for each axis, sign and owned point: the lane a
// stride away gives the d of the point its receiver needs (in the
// receiver's slot, or in the next or previous one where the offset wraps
// past the warp), so a step has no barrier and no shared memory.  The
// next step's coefficients are read ahead, off the chain.  (With 4 or 8
// points a lane, 4x8x8, one warp issues all their work in turn: a first
// warp path that did so ran 4x slower than the block path's point a
// thread.)  The block path, for the other grids (the SM 3D strips' 4x8x8,
// an odd coarsest grid, up to CHEB_MAX_POINTS): one block a grid, the
// grid's d in shared memory (at most CHEB_MAX_POINTS values of the
// arithmetic type, 32 KB in f64); each thread owns up to CHEB_PTS points.
// Each step: update the owned points from the shared d, barrier, write the
// new d, barrier.  On both paths a point's neighbours are the same values
// in the same order of the including file's stencil (G::combine), so both
// give the loop's bits.

constexpr int CHEB_MAX_THREADS = 1024;
constexpr int CHEB_PTS = 4;
constexpr int CHEB_MAX_POINTS = CHEB_MAX_THREADS * CHEB_PTS;   // 4096
constexpr int CHEB_MAX_STEPS = 128;
constexpr int CHEB_WARP_PTS = 2;     // points a lane at most (the warp path: 64 points a grid)
constexpr int CHEB_WARPS = 4;        // grids a block on the warp path

template <typename TC> struct ChebCoefs {
    TC inv_theta;
    TC c[2 * CHEB_MAX_STEPS + 2];   // c1[k], c2[k] interleaved; a zero pair read ahead
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// v rounded to the storage type T, in the arithmetic type
template <typename T> __device__ __forceinline__ float as_stored(float v) { return v; }
template <> __device__ __forceinline__ float as_stored<bf16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename T> __device__ __forceinline__ double as_stored(double v) { return v; }

// G: the grid: points(); DIRS axes, the stride of axis a, stride(a), the
// largest first (both on the host and the device); mask(p), bit 2a set where the neighbour p - stride(a) is
// inside the grid, bit 2a + 1 where p + stride(a) is; and combine(c, nb),
// A d at a point from its d, c, and its neighbours' d, nb[2a] and
// nb[2a + 1] (zero outside the grid), in the stencil's order.

// A d at point p from the d in shared memory
template <typename G, typename TC>
__device__ __forceinline__ TC apply_shared(const G& g, const TC* s, int p, unsigned mk) {
    TC nb[2 * G::DIRS];
#pragma unroll
    for (int a = 0; a < G::DIRS; ++a) {
        const int o = g.stride(a);
        nb[2 * a] = mk >> (2 * a) & 1 ? s[p - o] : TC(0);
        nb[2 * a + 1] = mk >> (2 * a + 1) & 1 ? s[p + o] : TC(0);
    }
    return g.combine(s[p], nb);
}

// The block path: one block a grid of the batch.
template <typename T, typename TC, typename G>
__global__ void __launch_bounds__(CHEB_MAX_THREADS) chebyshev_coarse_kernel(
    const T* __restrict__ b, T* __restrict__ x, const G g,
    const __grid_constant__ ChebCoefs<TC> cf, int steps) {
    extern __shared__ __align__(16) unsigned char cheb_smem[];
    TC* s = reinterpret_cast<TC*>(cheb_smem);
    const int n = g.points();
    const T* __restrict__ bg = b + (int64_t)blockIdx.x * n;
    T* __restrict__ xg = x + (int64_t)blockIdx.x * n;
    TC xv[CHEB_PTS], rv[CHEB_PTS], dv[CHEB_PTS];
    unsigned mk[CHEB_PTS];
#pragma unroll
    for (int q = 0; q < CHEB_PTS; ++q) {
        const int p = threadIdx.x + q * blockDim.x;
        xv[q] = rv[q] = dv[q] = TC(0);
        mk[q] = 0;
        if (p < n) {
            rv[q] = load(bg, p);
            dv[q] = as_stored<T>(mul_rn(rv[q], cf.inv_theta));
            s[p] = dv[q];
            mk[q] = g.mask(p);
        }
    }
    __syncthreads();
    for (int k = 0; k < steps; ++k) {
        const TC c1 = cf.c[2 * k], c2 = cf.c[2 * k + 1];
#pragma unroll
        for (int q = 0; q < CHEB_PTS; ++q) {
            const int p = threadIdx.x + q * blockDim.x;
            if (p < n) {
                xv[q] = as_stored<T>(add_rn(xv[q], dv[q]));
                const TC t = as_stored<T>(apply_shared(g, s, p, mk[q]));
                rv[q] = as_stored<T>(sub_rn(rv[q], t));
                dv[q] = as_stored<T>(add_rn(as_stored<T>(mul_rn(dv[q], c1)),
                                            as_stored<T>(mul_rn(rv[q], c2))));
            }
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < CHEB_PTS; ++q) {
            const int p = threadIdx.x + q * blockDim.x;
            if (p < n) s[p] = dv[q];
        }
        __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < CHEB_PTS; ++q) {
        const int p = threadIdx.x + q * blockDim.x;
        if (p < n) store(xg, p, xv[q]);
    }
}

// The warp path: one warp a grid of at most 32 PTS points, CHEB_WARPS
// grids a block; lane l owns the points l + 32 q, q < PTS.
template <typename T, typename TC, typename G, int PTS>
__global__ void __launch_bounds__(32 * CHEB_WARPS) chebyshev_warp_kernel(
    const T* __restrict__ b, T* __restrict__ x, int batch, const G g,
    const __grid_constant__ ChebCoefs<TC> cf, int steps) {
    constexpr unsigned ALL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int grid = blockIdx.x * CHEB_WARPS + (threadIdx.x >> 5);
    if (grid >= batch) return;      // the whole warp; nothing waits for it
    const int n = g.points();
    const T* __restrict__ bg = b + (int64_t)grid * n;
    T* __restrict__ xg = x + (int64_t)grid * n;
    TC xv[PTS], rv[PTS], dv[PTS];
    unsigned mk[PTS];
#pragma unroll
    for (int q = 0; q < PTS; ++q) {
        const int p = lane + 32 * q;
        xv[q] = rv[q] = dv[q] = TC(0);
        mk[q] = 0;
        if (p < n) {
            rv[q] = load(bg, p);
            dv[q] = as_stored<T>(mul_rn(rv[q], cf.inv_theta));
            mk[q] = g.mask(p);
        }
    }
    // Axis a's stride v (less than 32): a receiver's point p + v lies at
    // lane (l + v) & 31, in the receiver's slot, or in the next one where
    // the lane index wraps past 31, which the giving lane knows by
    // lane < v; p - v at lane (l - v) & 31, in the previous slot where
    // lane + v >= 32.  A slot past the lane's points gives 0.  With one
    // point a lane a wrapped offset always leaves the grid, where the
    // receiver's mask gives 0, so the giver needs no choice of slot.
    bool up_wraps[G::DIRS], dn_wraps[G::DIRS];
#pragma unroll
    for (int a = 0; a < G::DIRS; ++a) {
        up_wraps[a] = lane < g.stride(a);
        dn_wraps[a] = lane + g.stride(a) >= 32;
    }
    TC c1 = cf.c[0], c2 = cf.c[1];
    for (int k = 0; k < steps; ++k) {
        const TC c1n = cf.c[2 * k + 2], c2n = cf.c[2 * k + 3];
        TC nb[PTS][2 * G::DIRS];
#pragma unroll
        for (int a = 0; a < G::DIRS; ++a) {
            const int v = g.stride(a);
#pragma unroll
            for (int q = 0; q < PTS; ++q) {
                const TC give_up = PTS > 1 && up_wraps[a] ? (q + 1 < PTS ? dv[q + 1] : TC(0))
                                                          : dv[q];
                const TC give_dn = PTS > 1 && dn_wraps[a] ? (q > 0 ? dv[q - 1] : TC(0))
                                                          : dv[q];
                const TC up = __shfl_sync(ALL, give_up, (lane + v) & 31);
                const TC dn = __shfl_sync(ALL, give_dn, (lane - v) & 31);
                nb[q][2 * a] = mk[q] >> (2 * a) & 1 ? dn : TC(0);
                nb[q][2 * a + 1] = mk[q] >> (2 * a + 1) & 1 ? up : TC(0);
            }
        }
#pragma unroll
        for (int q = 0; q < PTS; ++q) {
            xv[q] = as_stored<T>(add_rn(xv[q], dv[q]));
            const TC t = as_stored<T>(g.combine(dv[q], nb[q]));
            rv[q] = as_stored<T>(sub_rn(rv[q], t));
            dv[q] = as_stored<T>(add_rn(as_stored<T>(mul_rn(dv[q], c1)),
                                        as_stored<T>(mul_rn(rv[q], c2))));
        }
        c1 = c1n;
        c2 = c2n;
    }
#pragma unroll
    for (int q = 0; q < PTS; ++q) {
        const int p = lane + 32 * q;
        if (p < n) store(xg, p, xv[q]);
    }
}

template <typename T, typename TC, typename G, int PTS>
cudaError_t launch_chebyshev_warp(const T* b, T* x, int batch, const G& g,
                                  const ChebCoefs<TC>& cf, int steps,
                                  cudaStream_t stream) {
    const int warps = batch < CHEB_WARPS ? batch : CHEB_WARPS;
    const unsigned blocks = (unsigned)((batch + CHEB_WARPS - 1) / CHEB_WARPS);
    chebyshev_warp_kernel<T, TC, G, PTS><<<blocks, 32 * warps, 0, stream>>>(b, x, batch, g,
                                                                          cf, steps);
    return cudaGetLastError();
}

// Launch on a batch of grids; coefs (host memory, doubles, each exact in
// the arithmetic type): inv_theta, then c1[k], c2[k] for k < steps.  The
// warp path takes a grid of at most 32 CHEB_WARP_PTS points whose largest
// stride, stride(0), is less than 32, 1 point a lane up to 32 points and
// CHEB_WARP_PTS past them; the block path any other grid.
template <typename T, typename G>
cudaError_t launch_chebyshev_coarse(const void* b, void* x, int64_t batch,
                                    const G& g, const double* coefs, int steps,
                                    cudaStream_t stream) {
    typedef typename Compute<T>::type TC;
    const int n = g.points();
    if (batch < 1 || batch > INT32_MAX || n < 1 || n > CHEB_MAX_POINTS ||
        steps < 0 || steps > CHEB_MAX_STEPS)
        return cudaErrorInvalidValue;
    const int lane_pts = n > 32 * CHEB_WARP_PTS || g.stride(0) >= 32 ? 0
                         : n <= 32 ? 1 : CHEB_WARP_PTS;
    ChebCoefs<TC> cf;
    cf.inv_theta = (TC)coefs[0];
    for (int k = 0; k < 2 * CHEB_MAX_STEPS + 2; ++k)
        cf.c[k] = k < 2 * steps ? (TC)coefs[1 + k] : TC(0);
    const T* bt = static_cast<const T*>(b);
    T* xt = static_cast<T*>(x);
    switch (lane_pts) {
        case 0: {
            // a point a thread up to 1024 points, then up to CHEB_PTS a thread
            const int threads = (n < CHEB_MAX_THREADS ? n + 31 : CHEB_MAX_THREADS) / 32 * 32;
            chebyshev_coarse_kernel<T, TC, G><<<(unsigned)batch, threads, n * sizeof(TC),
                                                stream>>>(bt, xt, g, cf, steps);
            return cudaGetLastError();
        }
        case 1:
            return launch_chebyshev_warp<T, TC, G, 1>(bt, xt, (int)batch, g, cf, steps, stream);
        case CHEB_WARP_PTS:
            return launch_chebyshev_warp<T, TC, G, CHEB_WARP_PTS>(bt, xt, (int)batch, g, cf,
                                                                  steps, stream);
        default:
            return cudaErrorInvalidValue;
    }
}
