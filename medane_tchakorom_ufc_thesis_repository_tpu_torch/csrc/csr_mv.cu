// Hopper (sm_90a) kernel H: sparse matrix-vector product in CSR,
//
//   y[b, i] = sum_{p in [indptr[i], indptr[i+1])} data[p] * x[b, indices[p]]
//
// for a batch of vectors x (k, ncols) -> y (k, nrows); f32 or f64, the sums
// taken in that type.
//
// Replaces ops/aij_pallas.py:aij_mv_pallas (the segment passes of
// _aij_segment_mv and _perm_pass), the product behind core/operators.py
// AIJ.mv and AIJ.rmv.  The TPU kernel routes every nonzero's x value through
// Clos permutation stages because its gather primitive reaches only one
// (8, 128) tile; a GPU thread loads any address, so none of that is carried
// over: the matrix stays in CSR (rows sorted by column, duplicates summed on
// the host) and the transpose product is this same kernel on the CSR of the
// transpose.
//
// Plain C interface, bound with ctypes by ops/csr.py.  The entry point
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launch.  indptr (nrows + 1) and indices (nnz) are int32,
// data (nnz) and y (k, nrows) contiguous; x arrives TRANSPOSED, (ncols, k)
// contiguous, so that the k values one nonzero gathers are neighbours in
// memory (with x as (k, ncols) a batch of 4 took 7.6 times one vector's time
// on an H100: four scattered sectors a nonzero, and four vectors of n = 2^22
// no longer fit the L2 cache).  Offsets into x and y are computed in 64 bits.
//
// Bound: memory bytes.  Each nonzero costs its value and its column index
// once (8 bytes in f32) plus a gathered x value, which for a structureless
// pattern is a 32-byte sector fetched for 4 useful bytes wherever x does not
// stay in the L2 cache; the least the card must move is
// nnz (sizeof + 4) + 4 (nrows + 1) + sizeof (nrows + ncols) per system.
//
// Design.  A group of G lanes (2, 4, 8, 16 or 32, chosen by the caller from
// the mean row length) takes one row: lane l reads entries l, l + G, ... of
// the row, so a warp's loads of data and indices are contiguous, and the
// lanes' sums are added by shuffles in a fixed order.  No atomics: a row's
// sum has the same bits on every launch, so the Krylov iteration counts
// repeat run to run.  Up to KB = 4 vectors of the batch share one pass over
// the matrix (the sums of one row for the KB vectors sit in registers), and
// blockIdx.y walks the batch in tiles of KB.  An empty row writes 0.  What
// the simple design gives up: one very long row is walked by a single
// group, rows are not binned by length, and nothing is staged through shared
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KB = 4;                       // vectors of the batch per pass
constexpr int64_t MAX_GRID_Y = 65535;

template <typename T, int G>
__global__ void __launch_bounds__(THREADS) csr_mv_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
    int64_t nrows, int64_t ncols, int64_t k) {
    const int lane = threadIdx.x % G;
    const int64_t row = (int64_t)blockIdx.x * (THREADS / G) + threadIdx.x / G;
    const int64_t b0 = (int64_t)blockIdx.y * KB;
    const int kb = (int)(k - b0 < KB ? k - b0 : KB);
    // every lane of a warp reaches the shuffles: rows past the end read an
    // empty range
    int32_t start = 0, end = 0;
    if (row < nrows) {
        start = indptr[row];
        end = indptr[row + 1];
    }
    T acc[KB];
#pragma unroll
    for (int b = 0; b < KB; ++b) acc[b] = T(0);
    const T* __restrict__ xb = x + b0;
    for (int32_t p = start + lane; p < end; p += G) {
        const T a = data[p];
        const int64_t c = indices[p];
#pragma unroll
        for (int b = 0; b < KB; ++b)
            if (b < kb) acc[b] += a * xb[c * k + b];
    }
#pragma unroll
    for (int b = 0; b < KB; ++b)
        for (int o = G / 2; o > 0; o >>= 1)
            acc[b] += __shfl_down_sync(0xffffffffu, acc[b], o, G);
    if (lane == 0 && row < nrows) {
#pragma unroll
        for (int b = 0; b < KB; ++b)
            if (b < kb) y[(b0 + b) * nrows + row] = acc[b];
    }
}

template <typename T, int G>
cudaError_t launch(const void* indptr, const void* indices, const void* data,
                   const void* x, void* y, int64_t nrows, int64_t ncols,
                   int64_t k, cudaStream_t stream) {
    const int64_t rows_per_block = THREADS / G;
    const int64_t blocks = (nrows + rows_per_block - 1) / rows_per_block;
    const int64_t tiles = (k + KB - 1) / KB;
    if (blocks > INT32_MAX || tiles > MAX_GRID_Y) return cudaErrorInvalidValue;
    csr_mv_kernel<T, G><<<dim3((unsigned)blocks, (unsigned)tiles), THREADS, 0,
                          stream>>>(
        static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), nrows, ncols, k);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int group, const void* indptr, const void* indices,
                     const void* data, const void* x, void* y, int64_t nrows,
                     int64_t ncols, int64_t k, cudaStream_t stream) {
    switch (group) {
        case 2: return launch<T, 2>(indptr, indices, data, x, y, nrows, ncols, k, stream);
        case 4: return launch<T, 4>(indptr, indices, data, x, y, nrows, ncols, k, stream);
        case 8: return launch<T, 8>(indptr, indices, data, x, y, nrows, ncols, k, stream);
        case 16: return launch<T, 16>(indptr, indices, data, x, y, nrows, ncols, k, stream);
        case 32: return launch<T, 32>(indptr, indices, data, x, y, nrows, ncols, k, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 2 = f64.  group: lanes per row, 2, 4, 8, 16 or 32.
int csr_mv(int dtype, int group, const void* indptr, const void* indices,
           const void* data, const void* x, void* y, int64_t nrows,
           int64_t ncols, int64_t k, cudaStream_t stream) {
    if (nrows < 1 || ncols < 1 || k < 1) return cudaErrorInvalidValue;
    if (dtype == 0)
        return dispatch<float>(group, indptr, indices, data, x, y, nrows, ncols, k, stream);
    if (dtype == 2)
        return dispatch<double>(group, indptr, indices, data, x, y, nrows, ncols, k, stream);
    return cudaErrorInvalidValue;
}

}  // extern "C"
