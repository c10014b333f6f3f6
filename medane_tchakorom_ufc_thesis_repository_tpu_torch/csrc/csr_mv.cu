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
// cudaError_t of its launches.  indptr (nrows + 1) and indices (nnz) are
// int32, data (nnz) and y (k, nrows) contiguous; x arrives TRANSPOSED,
// (ncols, k) contiguous, so that the k values one nonzero gathers are
// neighbours in memory.
//
// Bound: memory bytes.  Each nonzero costs its value and its column index
// once (8 bytes in f32) plus a gathered x value, a 32-byte sector for 4
// useful bytes on a structureless pattern; the least the card must move is
// nnz (sizeof + 4) + 4 (nrows + 1) + sizeof (nrows + ncols) per system.
// The sectors are cheap only while x stays in the 50 MB L2 cache.
//
// Design: balanced by nonzeros, not rows.  Block c owns the nonzeros
// [c CHUNK, (c + 1) CHUNK) and the rows that START in them; part[c] (built
// once per matrix, ops/csr.py csr_partition) is its first row.
//   1. The block streams its chunk of indices and data with 16-byte loads
//      marked evict-first (ld.global.cs), so that the 8 bytes a nonzero that
//      are read once do not push x out of L2; x is gathered through the
//      normal cached path (a batch of 2 or 4 vectors in one 8- or 16-byte
//      load a nonzero), and the products go to shared memory.
//   2. The chunk splits into segments: the head (the entries of a row that
//      started in an earlier chunk) and the in-chunk part of each owned row.
//      A group of g lanes sums each segment, g the largest power of two up
//      to 32 that lets all of a round's segments run at once, so short rows
//      take one or two lanes and one long segment a whole warp; the lanes'
//      sums meet by shuffles in a fixed order.  Only the K live vectors of
//      the batch are summed and shuffled.
//   3. A row that crosses chunks leaves one head sum in each later chunk
//      (the carry).  A second launch adds a row's carries in block order to
//      the value its owner wrote.  No atomics anywhere: two launches give
//      the same bits, so Krylov iteration counts repeat.
// A row of 50,000 entries spreads over 25 blocks; an empty row writes 0
// (rows past the last nonzero belong to the last block).  Up to 4 vectors
// of a batch share one pass over the matrix; a larger batch takes one pass
// per 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 2048;                 // nonzeros a block; ops/csr.py CHUNK
constexpr int QUADS = CHUNK / (4 * THREADS);  // 4-nonzero groups a thread
constexpr int KB = 4;                       // vectors of the batch per pass
constexpr int FIX_THREADS = 256;

static_assert(CHUNK % (4 * THREADS) == 0, "a thread takes whole quads");

template <typename T>
__device__ __forceinline__ void load_quad(const T* __restrict__ data, int64_t p,
                                          T (&a)[4]);

template <>
__device__ __forceinline__ void load_quad<float>(const float* __restrict__ data,
                                                 int64_t p, float (&a)[4]) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(data + p));
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

template <>
__device__ __forceinline__ void load_quad<double>(const double* __restrict__ data,
                                                  int64_t p, double (&a)[4]) {
    const double2 lo = __ldcs(reinterpret_cast<const double2*>(data + p));
    const double2 hi = __ldcs(reinterpret_cast<const double2*>(data + p + 2));
    a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
}

// The K values of one nonzero's column, x[c k .. c k + K): one 8- or 16-byte
// load (two for 4 f64 values) where the row of x is that wide and aligned
// (vec: k == K, a power of two, and x aligned), K scalar loads otherwise.
template <int K, typename T>
__device__ __forceinline__ void gather(const T* __restrict__ xc, T (&v)[K], bool vec) {
    if constexpr (K == 4 && sizeof(T) == 4) {
        if (vec) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(xc));
            v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
            return;
        }
    } else if constexpr (K == 2 && sizeof(T) == 4) {
        if (vec) {
            const float2 t = __ldg(reinterpret_cast<const float2*>(xc));
            v[0] = t.x; v[1] = t.y;
            return;
        }
    } else if constexpr ((K == 2 || K == 4) && sizeof(T) == 8) {
        if (vec) {
#pragma unroll
            for (int h = 0; h < K; h += 2) {
                const double2 t = __ldg(reinterpret_cast<const double2*>(xc) + h / 2);
                v[h] = t.x; v[h + 1] = t.y;
            }
            return;
        }
    }
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = __ldg(xc + i);
}

__device__ __forceinline__ void store_quad(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store_quad(double* p, double a, double b, double c, double d) {
    reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
    reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

// One block: products of its chunk, then the sums of its segments.
// carry[c * KB + v] and carry_row[c] receive the head's sum and row (-1
// when the head is empty).  x points at the first vector of this pass.
template <typename T, int K>
__global__ void __launch_bounds__(THREADS) csr_chunk_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    const T* __restrict__ data, const int32_t* __restrict__ part,
    const T* __restrict__ x, T* __restrict__ y, T* __restrict__ carry,
    int32_t* __restrict__ carry_row, int64_t nrows, int64_t nnz, int32_t k,
    bool aligned, bool xvec) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* prod = reinterpret_cast<T*>(smem);         // [K][CHUNK]
    __shared__ int32_t bounds[THREADS + 1];

    const int64_t nz0 = (int64_t)blockIdx.x * CHUNK;
    const int64_t nz1 = nz0 + CHUNK < nnz ? nz0 + CHUNK : nnz;
    const int n = (int)(nz1 - nz0);               // nonzeros in this chunk
    const int32_t r0 = part[blockIdx.x], r1 = part[blockIdx.x + 1];

    // 1. every load of the chunk first, then every gather, then the products
    int32_t c[QUADS][4];
    T a[QUADS][4];
#pragma unroll
    for (int u = 0; u < QUADS; ++u) {
        const int q = (u * THREADS + threadIdx.x) * 4;
        if (aligned && q + 4 <= n) {
            const int4 cv = __ldcs(reinterpret_cast<const int4*>(indices + nz0 + q));
            c[u][0] = cv.x; c[u][1] = cv.y; c[u][2] = cv.z; c[u][3] = cv.w;
            load_quad(data, nz0 + q, a[u]);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool in = q + e < n;
                c[u][e] = in ? __ldcs(indices + nz0 + q + e) : 0;
                a[u][e] = in ? __ldcs(data + nz0 + q + e) : T(0);
            }
        }
    }
    T xv[QUADS][4][K];
#pragma unroll
    for (int u = 0; u < QUADS; ++u) {
        const int q = (u * THREADS + threadIdx.x) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (q + e < n) {
                gather<K>(x + (int64_t)c[u][e] * k, xv[u][e], xvec);
            } else {
#pragma unroll
                for (int v = 0; v < K; ++v) xv[u][e][v] = T(0);
            }
        }
    }
    // a thread's 4 products of one vector are neighbours: one 16-byte store
    // in f32 (two in f64)
#pragma unroll
    for (int u = 0; u < QUADS; ++u) {
        const int q = (u * THREADS + threadIdx.x) * 4;
#pragma unroll
        for (int v = 0; v < K; ++v)
            store_quad(prod + v * CHUNK + q, a[u][0] * xv[u][0][v], a[u][1] * xv[u][1][v],
                       a[u][2] * xv[u][2][v], a[u][3] * xv[u][3][v]);
    }
    __syncthreads();

    // 2. segment s = 0 is the head, s >= 1 the in-chunk part of row
    //    r0 + s - 1; rounds of THREADS segments
    const int32_t nseg_all = r1 - r0 + 1;
    for (int32_t s0 = 0; s0 < nseg_all; s0 += THREADS) {
        const int nseg = nseg_all - s0 < THREADS ? (int)(nseg_all - s0) : THREADS;
        for (int j = threadIdx.x; j <= nseg; j += THREADS) {
            const int32_t s = s0 + j;
            int64_t end = s == 0 ? nz0 : (int64_t)__ldcs(indptr + r0 + s - 1);
            bounds[j] = (int32_t)((end < nz1 ? end : nz1) - nz0);
        }
        __syncthreads();
        int g = 32;
        while (g > 1 && nseg * g > THREADS) g >>= 1;
        const int seg = threadIdx.x / g, lane = threadIdx.x & (g - 1);
        T acc[K];
#pragma unroll
        for (int v = 0; v < K; ++v) acc[v] = T(0);
        if (seg < nseg) {
            const int end = bounds[seg + 1];
            for (int p = bounds[seg] + lane; p < end; p += g)
#pragma unroll
                for (int v = 0; v < K; ++v) acc[v] += prod[v * CHUNK + p];
        }
        for (int o = g >> 1; o > 0; o >>= 1)
#pragma unroll
            for (int v = 0; v < K; ++v) acc[v] += __shfl_down_sync(0xffffffffu, acc[v], o, g);
        if (lane == 0 && seg < nseg) {
            const int32_t s = s0 + seg;
            if (s == 0) {
#pragma unroll
                for (int v = 0; v < K; ++v) carry[(int64_t)blockIdx.x * KB + v] = acc[v];
                carry_row[blockIdx.x] = bounds[1] > 0 ? r0 - 1 : -1;
            } else {
#pragma unroll
                for (int v = 0; v < K; ++v) __stcs(y + v * nrows + r0 + s - 1, acc[v]);
            }
        }
        __syncthreads();
    }
}

// The carries: the first block carrying into a row adds its own and its
// followers' carries, in block order, to the value the row's owner wrote.
template <typename T, int K>
__global__ void __launch_bounds__(FIX_THREADS) csr_carry_kernel(
    const T* __restrict__ carry, const int32_t* __restrict__ carry_row,
    T* __restrict__ y, int64_t nblocks, int64_t nrows) {
    const int64_t c = (int64_t)blockIdx.x * FIX_THREADS + threadIdx.x;
    if (c >= nblocks) return;
    const int32_t row = carry_row[c];
    if (row < 0 || (c > 0 && carry_row[c - 1] == row)) return;
    T s[K];
#pragma unroll
    for (int v = 0; v < K; ++v) s[v] = carry[c * KB + v];
    for (int64_t q = c + 1; q < nblocks && carry_row[q] == row; ++q)
#pragma unroll
        for (int v = 0; v < K; ++v) s[v] += carry[q * KB + v];
#pragma unroll
    for (int v = 0; v < K; ++v) y[v * nrows + row] += s[v];
}

template <typename T, int K>
cudaError_t launch(const int32_t* indptr, const int32_t* indices, const T* data,
                   const int32_t* part, const T* x, T* y, T* carry,
                   int32_t* carry_row, int64_t nrows, int64_t nnz, int64_t k,
                   int64_t nblocks, bool aligned, cudaStream_t stream) {
    // the K values a nonzero gathers in one load: a single pass of 2 or 4
    // vectors, x on a boundary of their width
    const bool xvec = (K == 2 || K == 4) && k == K &&
                      reinterpret_cast<uintptr_t>(x) % (K * sizeof(T) < 16 ? K * sizeof(T) : 16) == 0;
    const size_t smem = (size_t)K * CHUNK * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            csr_chunk_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
    }
    csr_chunk_kernel<T, K><<<(unsigned)nblocks, THREADS, smem, stream>>>(
        indptr, indices, data, part, x, y, carry, carry_row, nrows, nnz,
        (int32_t)k, aligned, xvec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    csr_carry_kernel<T, K><<<(unsigned)((nblocks + FIX_THREADS - 1) / FIX_THREADS),
                             FIX_THREADS, 0, stream>>>(carry, carry_row, y,
                                                       nblocks, nrows);
    return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* indptr_, const void* indices_, const void* data_,
                const void* part_, const void* x_, void* y_, void* carry_,
                void* carry_row_, int64_t nrows, int64_t nnz, int64_t k,
                cudaStream_t stream) {
    const int32_t* indptr = static_cast<const int32_t*>(indptr_);
    const int32_t* indices = static_cast<const int32_t*>(indices_);
    const T* data = static_cast<const T*>(data_);
    const int32_t* part = static_cast<const int32_t*>(part_);
    const T* x = static_cast<const T*>(x_);
    T* y = static_cast<T*>(y_);
    T* carry = static_cast<T*>(carry_);
    int32_t* carry_row = static_cast<int32_t*>(carry_row_);
    const int64_t nblocks = nnz > 0 ? (nnz + CHUNK - 1) / CHUNK : 1;
    const bool aligned = reinterpret_cast<uintptr_t>(indices) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(data) % 16 == 0;
    // one pass per KB vectors; the passes share the carry buffer in stream
    // order
    for (int64_t b0 = 0; b0 < k; b0 += KB) {
        const int64_t kb = k - b0 < KB ? k - b0 : KB;
        cudaError_t err;
        switch (kb) {
            case 1: err = launch<T, 1>(indptr, indices, data, part, x + b0, y + b0 * nrows, carry, carry_row, nrows, nnz, k, nblocks, aligned, stream); break;
            case 2: err = launch<T, 2>(indptr, indices, data, part, x + b0, y + b0 * nrows, carry, carry_row, nrows, nnz, k, nblocks, aligned, stream); break;
            case 3: err = launch<T, 3>(indptr, indices, data, part, x + b0, y + b0 * nrows, carry, carry_row, nrows, nnz, k, nblocks, aligned, stream); break;
            default: err = launch<T, 4>(indptr, indices, data, part, x + b0, y + b0 * nrows, carry, carry_row, nrows, nnz, k, nblocks, aligned, stream); break;
        }
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 2 = f64.  part: int32 (nblocks + 1), the first row of
// each chunk and nrows last (ops/csr.py csr_partition).  carry: nblocks * 4
// values of the data type; carry_row: nblocks int32 (scratch).
int csr_mv(int dtype, const void* indptr, const void* indices, const void* data,
           const void* part, const void* x, void* y, void* carry,
           void* carry_row, int64_t nrows, int64_t ncols, int64_t nnz,
           int64_t k, cudaStream_t stream) {
    if (nrows < 1 || ncols < 1 || k < 1 || k >= INT32_MAX || nnz < 0 ||
        nnz >= INT32_MAX)
        return cudaErrorInvalidValue;
    if (dtype == 0)
        return run<float>(indptr, indices, data, part, x, y, carry, carry_row, nrows, nnz, k, stream);
    if (dtype == 2)
        return run<double>(indptr, indices, data, part, x, y, carry, carry_row, nrows, nnz, k, stream);
    return cudaErrorInvalidValue;
}

}  // extern "C"
