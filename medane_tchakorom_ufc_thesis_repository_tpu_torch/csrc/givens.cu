// Hopper (sm_90a) kernel O, givens_step: the small-state work of one Arnoldi
// step of restarted GMRES (solvers/krylov.py:gmres), for a batch of systems.
//
// For each system b, with hcol = h[b] the new Hessenberg column (m + 1
// values, hcol[j+1] = ||w|| already set) and j the step:
//
//   1. the accumulated rotations i < j, in order:
//        t1 = cs[i] hcol[i] + sn[i] hcol[i+1],  t2 = (-sn[i]) hcol[i] + cs[i] hcol[i+1];
//   2. the new rotation annihilating hcol[j+1]:
//        denom = sqrt(a a + b b), pos = denom > 0, safe = pos ? denom : 1,
//        c = pos ? a / safe : 1, s = pos ? b / safe : 0;
//   3. g[j] = c g[j], g[j+1] = (-s) g[j], rnorm_new = |g[j+1]|;
//   4. the masked commits, where active = !converged && iters < maxiter:
//        H[:, j] = active ? the rotated column : 0,  cs[j] = active ? c : 1,
//        sn[j] = active ? s : 0,  g[j], g[j+1] and rnorm kept where frozen,
//        iters += active,  converged |= active && (rnorm_new <= tol || happy),
//      and active itself written out for the basis commit that follows.
//
// Replaces no kernel of the JAX package: there XLA fuses the step's Givens
// work (solvers/krylov.py's gmres body) into its loop.  In the port it takes
// the place of about 37 + 9 j PyTorch kernels a step, each a launch on a few
// values: about 2,900 a restart cycle of 20 steps, ~1.4 us of device time
// each inside a CUDA graph.
//
// Bound: latency.  A system's state is a few dozen values, read and written
// once: no bytes or operations bound worth the name.  Its floor is one
// launch and one chain of 2 j + 4 dependent rounded operations.
//
// Design.  One thread a system (a batch is a handful of blocks of the
// multisplitting driver, or the shards of one system): the rotations form a
// chain, each reading what the one before wrote.  The loop is unrolled so
// the loads of several rotations are in flight together; the chain's carry
// stays in a register and no rotated value goes back to h.  Every product,
// sum, quotient and square root is rounded on its own, in the order PyTorch
// takes them one kernel at a time (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn and their f64 forms, no FMA contraction): the results equal the
// plain step (ops/givens.py:givens_step_plain) bit for bit, which the GMRES
// inner sweep needs, since its map amplifies one ulp ~1e9.
//
// Plain C interface, bound with ctypes by ops/givens.py.  The entry point
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launch.  Every array is contiguous: h and g (nsys,
// m + 1), H (nsys, m + 1, m), cs and sn (nsys, m), iters int32, converged,
// happy and active one byte a system.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { F32 = 0, F64 = 2 };

constexpr int THREADS = 128;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename T>
__global__ void __launch_bounds__(THREADS) givens_step_kernel(
    const T* __restrict__ h, const uint8_t* __restrict__ happy,
    const T* __restrict__ tol, T* __restrict__ H, T* __restrict__ cs,
    T* __restrict__ sn, T* __restrict__ g, int32_t* __restrict__ iters,
    T* __restrict__ rnorm, uint8_t* __restrict__ converged,
    uint8_t* __restrict__ active, int64_t nsys, int64_t m, int64_t j,
    int64_t maxiter) {
    const int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (b >= nsys) return;
    const T* hb = h + b * (m + 1);
    T* Hb = H + b * (m + 1) * m + j;                  // H[b, i, j] = Hb[i m]
    T* csb = cs + b * m;
    T* snb = sn + b * m;
    T* gb = g + b * (m + 1);
    const int32_t it = iters[b];
    const bool was_converged = converged[b] != 0;
    const bool act = !was_converged && static_cast<int64_t>(it) < maxiter;
    const T zero = T(0), one = T(1);

    // 1. the accumulated rotations; the carry is hcol[i] as rotation i - 1
    // left it
    T carry = hb[0];
#pragma unroll 4
    for (int64_t i = 0; i < j; ++i) {
        const T c = csb[i], s = snb[i], hi1 = hb[i + 1];
        const T t1 = add_rn(mul_rn(c, carry), mul_rn(s, hi1));
        const T t2 = add_rn(mul_rn(-s, carry), mul_rn(c, hi1));
        Hb[i * m] = act ? t1 : zero;
        carry = t2;
    }
    // 2. the new rotation; hcol[j+1] is untouched by the rotations above
    const T a = carry, bb = hb[j + 1];
    const T denom = sqrt_rn(add_rn(mul_rn(a, a), mul_rn(bb, bb)));
    const bool pos = denom > zero;
    const T safe = pos ? denom : one;
    const T c_new = pos ? div_rn(a, safe) : one;
    const T s_new = pos ? div_rn(bb, safe) : zero;
    // 3. the right-hand side of the least squares
    const T gj = gb[j];
    const T g_j = mul_rn(c_new, gj);
    const T g_j1 = mul_rn(-s_new, gj);
    const T rnorm_new = fabs(g_j1);
    // 4. the masked commits; rows past j + 1 carry h as it came
    Hb[j * m] = act ? denom : zero;
    Hb[(j + 1) * m] = zero;
    for (int64_t i = j + 2; i <= m; ++i) Hb[i * m] = act ? hb[i] : zero;
    csb[j] = act ? c_new : one;
    snb[j] = act ? s_new : zero;
    active[b] = act;
    if (act) {
        gb[j] = g_j;
        gb[j + 1] = g_j1;
        iters[b] = it + 1;
        rnorm[b] = rnorm_new;
        converged[b] = (rnorm_new <= tol[b]) || happy[b] != 0;
    }
}

template <typename T>
cudaError_t launch(const void* h, const void* happy, const void* tol, void* H,
                   void* cs, void* sn, void* g, void* iters, void* rnorm,
                   void* converged, void* active, int64_t nsys, int64_t m,
                   int64_t j, int64_t maxiter, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((nsys + THREADS - 1) / THREADS);
    givens_step_kernel<T><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(h), static_cast<const uint8_t*>(happy),
        static_cast<const T*>(tol), static_cast<T*>(H), static_cast<T*>(cs),
        static_cast<T*>(sn), static_cast<T*>(g), static_cast<int32_t*>(iters),
        static_cast<T*>(rnorm), static_cast<uint8_t*>(converged),
        static_cast<uint8_t*>(active), nsys, m, j, maxiter);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int givens_step(int dtype, const void* h, const void* happy, const void* tol,
                void* H, void* cs, void* sn, void* g, void* iters, void* rnorm,
                void* converged, void* active, int64_t nsys, int64_t m,
                int64_t j, int64_t maxiter, void* stream) {
    if (nsys < 1 || (nsys + THREADS - 1) / THREADS > INT32_MAX || m < 1 ||
        j < 0 || j >= m)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch<float>(h, happy, tol, H, cs, sn, g, iters, rnorm,
                             converged, active, nsys, m, j, maxiter, s);
    if (dtype == F64)
        return launch<double>(h, happy, tol, H, cs, sn, g, iters, rnorm,
                              converged, active, nsys, m, j, maxiter, s);
    return cudaErrorInvalidValue;
}

}  // extern "C"
