// Hopper (sm_90a) kernels for GMRES's classical Gram-Schmidt pair on a
// batch of independent systems:
//
//   kernel F, mdot  (PETSc VecMDot):  h[b,k] = sum_n V[b,k,n] * w[b,n]
//   kernel G, maxpy (PETSc VecMAXPY): y[b,n] = y0[b,n] + sum_k alphas[b,k] * V[b,k,n]
//
// Replace ops/fused_pallas.py:mdot_pallas (_mdot_kernel) and maxpy_pallas
// (_maxpy_kernel).  The JAX GMRES computes the same two products with
// dot_general against its zero-padded basis (solvers/krylov.py:183-200,
// 272-275); here they take the count of live basis rows, k_active, and skip
// the rest: rows >= k_active are zero in that basis, so the values are the
// same.  mdot writes 0 there.
//
// Plain C interface, bound with ctypes by ops/fused.py.  Every entry point
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launches.  V is (batch, K, N) with unit stride along
// N and strides sb, sk (in elements) along batch and K, so that a basis
// stored row-major as (K, batch, N) is read in place; w, y0 and y are
// contiguous (batch, N), alphas and h contiguous (batch, K).  The basis V
// is stored in f32, bf16 or f64 (code 0, 1, 2); w, alphas, y0, y and h are
// in the accumulation type, f32 or f64 (code 0 or 2), and every product
// and sum is taken in it.  As in the JAX GMRES with a reduced-precision basis
// (v.astype(vdtype) before the dot), w and the alphas are first rounded to
// V's type.
//
// Bound: memory bytes.  mdot reads k_active rows of V and w once: at the
// GMRES(20) basis of 4096^2 strips, (2, 21, 2^23) in f32, up to 1.4 GB a
// call (0.42 ms at 3.35 TB/s); maxpy reads them and y0 and writes y.
//
// Design.  mdot: each block takes a chunk of CHUNK columns of one system,
// holds its w values in registers, and for each live row writes one partial
// sum (warp shuffles, then the warps in order); a second kernel adds a row's
// partials in chunk order.  No atomics: the same h from run to run, so GMRES
// and the multisplitting sweep counts repeat (the Pallas kernel carried the
// sum across its sequential grid, which Hopper's blocks do not have).
// maxpy: one thread per column, the alphas in shared memory, the rows summed
// in order k = 0, 1, ... and y0 added last, as the Pallas kernel does.
// What the simple design gives up: no 16-byte vector loads, and mdot
// synchronises its block once per row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { F32 = 0, BF16 = 1, F64 = 2 };

constexpr int THREADS = 256;
constexpr int ELEMS = 8;                    // columns per thread in mdot
constexpr int64_t CHUNK = (int64_t)THREADS * ELEMS;
constexpr int MAX_K = 256;                  // maxpy keeps the alphas in shared memory
constexpr int64_t MAX_GRID_YZ = 65535;

template <typename TA> __device__ __forceinline__ TA as_acc(float v) { return (TA)v; }
template <typename TA> __device__ __forceinline__ TA as_acc(double v) { return (TA)v; }
template <typename TA> __device__ __forceinline__ TA as_acc(bf16 v) { return (TA)__bfloat162float(v); }

// the accumulation-type value a, rounded to V's storage type and back
template <typename TV, typename TA> __device__ __forceinline__ TA round_to(TA a);
template <> __device__ __forceinline__ float round_to<float, float>(float a) { return a; }
template <> __device__ __forceinline__ double round_to<float, double>(double a) { return (double)(float)a; }
template <> __device__ __forceinline__ double round_to<double, double>(double a) { return a; }
template <> __device__ __forceinline__ float round_to<bf16, float>(float a) {
    return __bfloat162float(__float2bfloat16_rn(a));
}
template <> __device__ __forceinline__ double round_to<bf16, double>(double a) {
    return (double)__bfloat162float(__double2bfloat16(a));
}

// Sum of v over the block, valid in thread 0.  Fixed order: warp shuffles,
// then the warp sums in warp order.  Safe to call again at once.
template <typename TA>
__device__ __forceinline__ TA block_sum(TA v) {
    __shared__ TA warp_sums[THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    TA s = TA(0);
    if (warp == 0) {
        s = lane < THREADS / 32 ? warp_sums[lane] : TA(0);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    }
    __syncthreads();
    return s;
}

// ---------------------------------------------------------------------------
// Kernel F: mdot
// ---------------------------------------------------------------------------

template <typename TV, typename TA>
__global__ void __launch_bounds__(THREADS) mdot_partials(
    const TV* __restrict__ V, const TA* __restrict__ w, TA* __restrict__ partials,
    int64_t sb, int64_t sk, int64_t K, int64_t N, int64_t k_active) {
    const int64_t chunk = blockIdx.x;
    const int64_t nchunks = gridDim.x;
    const int64_t b = blockIdx.y;
    const int64_t n0 = chunk * CHUNK + threadIdx.x;
    TA wr[ELEMS];
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
        const int64_t n = n0 + (int64_t)e * THREADS;
        wr[e] = n < N ? round_to<TV, TA>(w[b * N + n]) : TA(0);
    }
    for (int64_t k = 0; k < k_active; ++k) {
        const TV* __restrict__ row = V + b * sb + k * sk;
        TA acc = TA(0);
#pragma unroll
        for (int e = 0; e < ELEMS; ++e) {
            const int64_t n = n0 + (int64_t)e * THREADS;
            if (n < N) acc += as_acc<TA>(row[n]) * wr[e];
        }
        acc = block_sum<TA>(acc);
        if (threadIdx.x == 0) partials[(b * K + k) * nchunks + chunk] = acc;
    }
}

// One block per (k, b): thread t adds partials t, t + THREADS, ... in
// order, then the block sum.  Rows >= k_active get 0.
template <typename TA>
__global__ void __launch_bounds__(THREADS) mdot_finish(
    const TA* __restrict__ partials, TA* __restrict__ h, int64_t K,
    int64_t nchunks, int64_t k_active) {
    const int64_t k = blockIdx.x;
    const int64_t b = blockIdx.y;
    TA s = TA(0);
    if (k < k_active) {
        const TA* __restrict__ p = partials + (b * K + k) * nchunks;
        for (int64_t i = threadIdx.x; i < nchunks; i += THREADS) s += p[i];
        s = block_sum<TA>(s);
    }
    if (threadIdx.x == 0) h[b * K + k] = s;
}

template <typename TV, typename TA>
cudaError_t launch_mdot(const void* V, const void* w, void* partials, void* h,
                        int64_t batch, int64_t sb, int64_t sk, int64_t K,
                        int64_t N, int64_t k_active, cudaStream_t stream) {
    const int64_t nchunks = (N + CHUNK - 1) / CHUNK;
    if (k_active > 0) {
        mdot_partials<TV, TA><<<dim3((unsigned)nchunks, (unsigned)batch),
                                THREADS, 0, stream>>>(
            static_cast<const TV*>(V), static_cast<const TA*>(w),
            static_cast<TA*>(partials), sb, sk, K, N, k_active);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    mdot_finish<TA><<<dim3((unsigned)K, (unsigned)batch), THREADS, 0, stream>>>(
        static_cast<const TA*>(partials), static_cast<TA*>(h), K, nchunks,
        k_active);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel G: maxpy
// ---------------------------------------------------------------------------

template <typename TV, typename TA>
__global__ void __launch_bounds__(THREADS) maxpy_kernel(
    const TV* __restrict__ V, const TA* __restrict__ alphas,
    const TA* __restrict__ y0, TA* __restrict__ y, int64_t sb, int64_t sk,
    int64_t K, int64_t N, int64_t k_active) {
    __shared__ TA a[MAX_K];
    const int64_t b = blockIdx.y;
    for (int64_t k = threadIdx.x; k < k_active; k += THREADS)
        a[k] = round_to<TV, TA>(alphas[b * K + k]);
    __syncthreads();
    const int64_t n = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (n >= N) return;
    const TV* __restrict__ col = V + b * sb + n;
    TA acc = TA(0);
    for (int64_t k = 0; k < k_active; ++k) acc += a[k] * as_acc<TA>(col[k * sk]);
    y[b * N + n] = y0[b * N + n] + acc;
}

template <typename TV, typename TA>
cudaError_t launch_maxpy(const void* V, const void* alphas, const void* y0,
                         void* y, int64_t batch, int64_t sb, int64_t sk,
                         int64_t K, int64_t N, int64_t k_active,
                         cudaStream_t stream) {
    if (k_active > MAX_K) return cudaErrorInvalidValue;
    const int64_t blocks = (N + THREADS - 1) / THREADS;
    maxpy_kernel<TV, TA><<<dim3((unsigned)blocks, (unsigned)batch), THREADS, 0,
                           stream>>>(
        static_cast<const TV*>(V), static_cast<const TA*>(alphas),
        static_cast<const TA*>(y0), static_cast<TA*>(y), sb, sk, K, N,
        k_active);
    return cudaGetLastError();
}

bool shape_ok(int64_t batch, int64_t K, int64_t N, int64_t k_active) {
    return batch >= 1 && batch <= MAX_GRID_YZ && K >= 1 && K <= INT32_MAX &&
           N >= 1 && (N + THREADS - 1) / THREADS <= INT32_MAX &&
           k_active >= 0 && k_active <= K;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Length of the partials scratch mdot needs, in accumulation-type values.
int64_t mdot_partials_count(int64_t batch, int64_t K, int64_t N) {
    return batch * K * ((N + CHUNK - 1) / CHUNK);
}

int mdot(int v_dtype, int acc_dtype, const void* V, const void* w,
         void* partials, void* h, int64_t batch, int64_t sb, int64_t sk,
         int64_t K, int64_t N, int64_t k_active, cudaStream_t stream) {
    if (!shape_ok(batch, K, N, k_active)) return cudaErrorInvalidValue;
    if (acc_dtype == F32) {
        if (v_dtype == F32)
            return launch_mdot<float, float>(V, w, partials, h, batch, sb, sk, K, N, k_active, stream);
        if (v_dtype == BF16)
            return launch_mdot<bf16, float>(V, w, partials, h, batch, sb, sk, K, N, k_active, stream);
    } else if (acc_dtype == F64) {
        if (v_dtype == F32)
            return launch_mdot<float, double>(V, w, partials, h, batch, sb, sk, K, N, k_active, stream);
        if (v_dtype == BF16)
            return launch_mdot<bf16, double>(V, w, partials, h, batch, sb, sk, K, N, k_active, stream);
        if (v_dtype == F64)
            return launch_mdot<double, double>(V, w, partials, h, batch, sb, sk, K, N, k_active, stream);
    }
    return cudaErrorInvalidValue;
}

int maxpy(int v_dtype, int acc_dtype, const void* V, const void* alphas,
          const void* y0, void* y, int64_t batch, int64_t sb, int64_t sk,
          int64_t K, int64_t N, int64_t k_active, cudaStream_t stream) {
    if (!shape_ok(batch, K, N, k_active)) return cudaErrorInvalidValue;
    if (acc_dtype == F32) {
        if (v_dtype == F32)
            return launch_maxpy<float, float>(V, alphas, y0, y, batch, sb, sk, K, N, k_active, stream);
        if (v_dtype == BF16)
            return launch_maxpy<bf16, float>(V, alphas, y0, y, batch, sb, sk, K, N, k_active, stream);
    } else if (acc_dtype == F64) {
        if (v_dtype == F32)
            return launch_maxpy<float, double>(V, alphas, y0, y, batch, sb, sk, K, N, k_active, stream);
        if (v_dtype == BF16)
            return launch_maxpy<bf16, double>(V, alphas, y0, y, batch, sb, sk, K, N, k_active, stream);
        if (v_dtype == F64)
            return launch_maxpy<double, double>(V, alphas, y0, y, batch, sb, sk, K, N, k_active, stream);
    }
    return cudaErrorInvalidValue;
}

}  // extern "C"
