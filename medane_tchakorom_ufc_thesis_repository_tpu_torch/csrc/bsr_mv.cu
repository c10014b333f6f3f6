// Hopper (sm_90a) kernel I: block-sparse (block-ELL) matrix-vector product,
//
//   y[b, r*bs + i] = sum_w sum_j values[r, w, j, i] * x[b, indices[r, w]*bs + j]
//
// for a batch of vectors x (k, n_in) -> y (k, n_out); f32 or f64, the sums
// taken in that type.
//
// Replaces ops/bsr_pallas.py:bsr_mv_pallas (_bsr_kernel), the product behind
// core/operators.py BSR.mv and BSR.rmv.  The layout is the JAX package's
// pack: indices (nbr, width) int32 block-column ids, values
// (nbr, width, bs, bs) with every block stored TRANSPOSED
// (values[r, w, j, i] = A_blk[i, j]); a padded slot has index 0 and a zero
// block and is read like a real one, as the TPU kernel does.  The transpose
// product is this same kernel on the pack of the transpose.
//
// Plain C interface, bound with ctypes by ops/bsr.py.  The entry point
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launch.  All arrays contiguous; n_in and n_out need
// not be multiples of bs: x reads past n_in are 0 and y rows past n_out
// are not written, so the caller pads and cuts nothing.
//
// Bound: memory bytes.  The blocks are read once, nbr*width*bs*bs values;
// the x blocks and y are bs times smaller.
//
// Design.  One block of 256 threads per block row (the TPU kernel's grid).
// The stored transpose makes the whole block row one contiguous run of
// width*bs*bs values in which element e belongs to output i = e % bs, so
// thread t reads elements t, t + 256, ...: every warp load is contiguous,
// each thread keeps one fixed i, and 256/bs threads share an output.  The x
// blocks of a chunk of slots are staged in shared memory first (where the
// TPU kernel issues one DMA per slot through a prefetched index); the
// threads' partial sums meet in shared memory and are added in a fixed
// order.  No atomics: the same bits on every launch.  Up to KB = 4 vectors
// of the batch share one pass over the blocks; blockIdx.y walks the batch
// in tiles of KB.  What the simple design gives up: 4-byte loads, no
// cp.async or TMA pipeline, two block-wide barriers per chunk of slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KB = 4;                 // vectors of the batch per pass
constexpr int XS = 1024;              // staged x values per vector and chunk
constexpr int64_t MAX_GRID_Y = 65535;

template <typename T>
__global__ void __launch_bounds__(THREADS) bsr_mv_kernel(
    const int32_t* __restrict__ indices, const T* __restrict__ values,
    const T* __restrict__ x, T* __restrict__ y, int64_t width, int bs,
    int64_t n_out, int64_t n_in, int64_t k) {
    __shared__ T xs[KB][XS];
    __shared__ T red[KB][THREADS];
    const int t = threadIdx.x;
    const int64_t r = blockIdx.x;
    const int64_t b0 = (int64_t)blockIdx.y * KB;
    const int kb = (int)(k - b0 < KB ? k - b0 : KB);
    const int lg = __ffs(bs) - 1;     // bs is a power of two
    const int64_t bs2 = (int64_t)bs * bs;
    const int64_t cw = XS / bs;       // slots per chunk
    const int32_t* __restrict__ idx = indices + r * width;
    const T* __restrict__ vrow = values + r * width * bs2;

    T acc[KB];
#pragma unroll
    for (int b = 0; b < KB; ++b) acc[b] = T(0);

    for (int64_t w0 = 0; w0 < width; w0 += cw) {
        const int64_t nw = width - w0 < cw ? width - w0 : cw;
        __syncthreads();              // the last chunk's reads are done
        for (int64_t e = t; e < nw * bs; e += THREADS) {
            const int64_t col = (int64_t)idx[w0 + (e >> lg)] * bs + (e & (bs - 1));
#pragma unroll
            for (int b = 0; b < KB; ++b)
                if (b < kb) xs[b][e] = col < n_in ? x[(b0 + b) * n_in + col] : T(0);
        }
        __syncthreads();
        const T* __restrict__ v = vrow + w0 * bs2;
        const int64_t count = nw * bs2;
#pragma unroll 4
        for (int64_t e = t; e < count; e += THREADS) {
            const T a = v[e];
            const int64_t wj = e >> lg;       // slot * bs + j
#pragma unroll
            for (int b = 0; b < KB; ++b)
                if (b < kb) acc[b] += a * xs[b][wj];
        }
    }

    // thread t holds output i = t % bs (THREADS is a multiple of bs): add
    // the THREADS / bs partial sums of each output in thread order
#pragma unroll
    for (int b = 0; b < KB; ++b) red[b][t] = acc[b];
    __syncthreads();
    if (t < bs) {
        const int64_t row = r * bs + t;
        if (row < n_out) {
#pragma unroll
            for (int b = 0; b < KB; ++b) {
                if (b < kb) {
                    T s = T(0);
                    for (int q = t; q < THREADS; q += bs) s += red[b][q];
                    y[(b0 + b) * n_out + row] = s;
                }
            }
        }
    }
}

template <typename T>
cudaError_t launch(const void* indices, const void* values, const void* x,
                   void* y, int64_t nbr, int64_t width, int bs, int64_t n_out,
                   int64_t n_in, int64_t k, cudaStream_t stream) {
    const int64_t tiles = (k + KB - 1) / KB;
    if (nbr > INT32_MAX || tiles > MAX_GRID_Y) return cudaErrorInvalidValue;
    bsr_mv_kernel<T><<<dim3((unsigned)nbr, (unsigned)tiles), THREADS, 0, stream>>>(
        static_cast<const int32_t*>(indices), static_cast<const T*>(values),
        static_cast<const T*>(x), static_cast<T*>(y), width, bs, n_out, n_in, k);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 2 = f64.  bs: a power of two from 8 to 128.
int bsr_mv(int dtype, const void* indices, const void* values, const void* x,
           void* y, int64_t nbr, int64_t width, int bs, int64_t n_out,
           int64_t n_in, int64_t k, cudaStream_t stream) {
    if (nbr < 1 || width < 1 || n_out < 1 || n_in < 1 || k < 1)
        return cudaErrorInvalidValue;
    if (bs < 8 || bs > 128 || (bs & (bs - 1))) return cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(indices, values, x, y, nbr, width, bs, n_out, n_in, k, stream);
    if (dtype == 2)
        return launch<double>(indices, values, x, y, nbr, width, bs, n_out, n_in, k, stream);
    return cudaErrorInvalidValue;
}

}  // extern "C"
