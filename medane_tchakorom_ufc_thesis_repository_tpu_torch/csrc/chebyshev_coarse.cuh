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
// of a batch, one block a grid, exactly as the PyTorch loop
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
// Bound: one read of b and one write of x (the grid fits on chip).  A
// grid of the main path (4^3, 4x4) is 64-256 bytes, so a launch is bound
// by its 40 dependent steps, two block barriers each, not by bytes.
//
// Design: the grid's d lives in shared memory (at most CHEB_MAX_POINTS
// values of the arithmetic type, 32 KB in f64); each thread owns up to
// CHEB_PTS points and keeps their x, r and d in registers, with a bit mask
// of the neighbours inside the grid.  Each step: update the owned points
// from the shared d, barrier, write the new d, barrier.

constexpr int CHEB_MAX_THREADS = 1024;
constexpr int CHEB_PTS = 4;
constexpr int CHEB_MAX_POINTS = CHEB_MAX_THREADS * CHEB_PTS;   // 4096
constexpr int CHEB_MAX_STEPS = 128;

template <typename TC> struct ChebCoefs {
    TC inv_theta;
    TC c[2 * CHEB_MAX_STEPS];   // c1[k], c2[k] interleaved
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

// G: the grid: points() (host and device), mask(p), and apply(s, p, mask),
// A d at point p from the shared d.  One block a grid of the batch.
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
                const TC t = as_stored<T>(g.apply(s, p, mk[q]));
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

// Launch on a batch of grids; coefs (host memory, doubles, each exact in
// the arithmetic type): inv_theta, then c1[k], c2[k] for k < steps.
template <typename T, typename G>
cudaError_t launch_chebyshev_coarse(const void* b, void* x, int64_t batch,
                                    const G& g, const double* coefs, int steps,
                                    cudaStream_t stream) {
    typedef typename Compute<T>::type TC;
    const int n = g.points();
    if (batch < 1 || batch > INT32_MAX || n < 1 || n > CHEB_MAX_POINTS ||
        steps < 0 || steps > CHEB_MAX_STEPS)
        return cudaErrorInvalidValue;
    ChebCoefs<TC> cf;
    cf.inv_theta = (TC)coefs[0];
    for (int k = 0; k < 2 * CHEB_MAX_STEPS; ++k)
        cf.c[k] = k < 2 * steps ? (TC)coefs[1 + k] : TC(0);
    // a point a thread up to 1024 points, then up to CHEB_PTS a thread
    const int threads = (n < CHEB_MAX_THREADS ? n + 31 : CHEB_MAX_THREADS) / 32 * 32;
    chebyshev_coarse_kernel<T, TC, G><<<(unsigned)batch, threads, n * sizeof(TC), stream>>>(
        static_cast<const T*>(b), static_cast<T*>(x), g, cf, steps);
    return cudaGetLastError();
}
