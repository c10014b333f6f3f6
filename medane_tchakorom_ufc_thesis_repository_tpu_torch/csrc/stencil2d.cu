// Hopper (sm_90a) kernels E and L, and the 2D half of kernel M (the
// multigrid cycle's coarse Chebyshev solve in one launch, whose device code
// is in chebyshev_coarse.cuh): the matrix-free 2D 5-point Poisson apply on
// a batch of Dirichlet rectangles,
//
//   y[b,i,j] = diag*x[b,i,j] + off*(((x[b,i-1,j] + x[b,i+1,j]) + x[b,i,j-1]) + x[b,i,j+1])
//
// with zero outside each (m, n) slab: the batch index is a hard boundary.
//
// Replaces ops/stencil_pallas.py:stencil2d_mv_pallas (_kernel2d, one grid)
// and ops/fused_pallas.py:stencil2d_spmm_pallas (_spmm2d_kernel, R = A S for
// an (s, m, n) basis panel): one kernel serves both, the panel being a batch
// of s grids.  The multisplitting strips A_ii x_i are the same operator on
// each (rows, n) strip, so a stack of strips is a batch too.
//
// Kernel L is the same expression with a fused residual norm: it replaces
// ops/fused_pallas.py:stencil2d_mv_norm_pallas (_mv_norm2d_kernel), y = A x
// and ||b - y||^2 of one grid in one pass, on the column walk below.  Its y
// has kernel E's bits (one expression, stencil5, on the same operands).
// Each block writes the partial sum of its (b - y)^2 and a second one-block
// kernel adds the partials in a fixed order: no float atomics, so two
// launches give equal bits.  (The Pallas kernel carried the sum across its
// sequential grid.)  Bound: memory bytes, reads of x and b and one write:
// 12 bytes a point in f32 (0.81 GB at 8192^2, 0.24 ms).
//
// Plain C interface, bound with ctypes by ops/stencil2d.py and ops/fused.py.
// The entry points launch on the stream they are given, allocate nothing,
// and return the cudaError_t of their launches.  Storage and arithmetic are
// f32 or f64 (dtype code 0 or 2), or, for kernel E only, bf16 storage (code
// 1: the level-0 applies of a bf16 multigrid cycle) with f32 arithmetic and
// one rounding where y is stored; indices are 64-bit (a basis panel at
// 8192^2 holds s x 2^26 points).  The file builds with -fmad=false: the apply is then rounded
// operation by operation in the order of the plain PyTorch version
// (stencil2d_apply_plain), and agrees with it bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { F32 = 0, BF16 = 1, F64 = 2 };

// the arithmetic type of a storage type
template <typename T> struct Compute { typedef T type; };
template <> struct Compute<bf16> { typedef float type; };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ double load(const double* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const bf16* p, int64_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(double* p, int64_t i, double v) { p[i] = v; }
__device__ __forceinline__ void store(bf16* p, int64_t i, float v) { p[i] = __float2bfloat16_rn(v); }

constexpr int64_t MAX_GRID_YZ = 65535;

// A c at one point from its four neighbours: the one expression kernels E,
// L and M evaluate, rounded op by op (the file builds with -fmad=false).
template <typename TC>
__device__ __forceinline__ TC stencil5(TC diag, TC off, TC c, TC up, TC down,
                                       TC left, TC right) {
    return diag * c + off * (((up + down) + left) + right);
}

// ---------------------------------------------------------------------------
// Kernel E: the row-tile walk
//
// Bound: memory bytes.  One read of x and one write of y: 8 bytes a point
// in f32 (0.54 GB at 8192^2, 0.16 ms at 3.35 TB/s; 0.040 ms at (2, 2048,
// 4096)), 4 in bf16, 16 in f64.
//
// Design: a block owns a tile of tz = tzv V columns of one grid of the
// batch and walks a slab of rows down it, ty rows a step; a thread owns V
// neighbouring columns of one row, one 16-byte vector of the storage type
// (V = 4 in f32, 8 in bf16, 2 in f64).  The rows, with the row above the
// slab and the row below it, pass through a ring of TILE_RING stages of ty
// rows in shared memory, each row with its left and right halo values in a
// vector of padding either side: a thread copies its vector of a row by
// cp.async, 16 bytes a copy (a halo 4 or 8 bytes), two stages ahead of the
// step computed, so that the copies of the next rows overlap the compute of
// these; one barrier a step.  A thread reads the row above, its own row and
// the row below, and the vectors either side of its own, as 16-byte shared
// loads, and stores its V values of y as one 16-byte vector.  Rows outside
// the grid are 0 by the copy's zero fill, so no row of a neighbouring grid
// of the batch is ever read.  The geometry (tile_geometry): tzv vectors as
// n takes, up to 32, ty rows up to 256 threads and 16 rows but at least 2
// (the row below a step's rows must lie in the next stage, whose copies
// the step waits for), and the slab: 32 rows on a large launch; on a grid
// the card's L2 cache holds, where a block's latency and not the memory
// rate holds the launch, up to 128 rows, halved while the launch would
// have fewer than 256 blocks (about two on each of the 132 SMs).
// The slab is the fastest block index, so a tile's slabs run side by side
// and the rows they share come from L2.
// Where n is not a multiple of V or an array does not start on 16 bytes
// (VEC false), the same ring is filled by plain loads, value by value, each
// vector stored whole (the ring is only ever read as 16-byte vectors), and
// y is stored point by point.  Every point's value is stencil5 on the
// operands of the plain version, so both paths give its bits.  What the
// design gives up: a slab re-reads the row above it and the row below it
// (1.06x the x reads at a slab of 32, mostly from L2), the halo values
// are 4- or 8-byte copies, and no TMA: the copies cost a thread one or two
// instructions a row.
// ---------------------------------------------------------------------------

constexpr int TILE_THREADS = 256;  // threads a block at most
constexpr int TILE_VECS = 32;      // vectors a row of the tile at most
constexpr int TILE_ROWS = 16;      // rows of the tile at most
constexpr int TILE_RING = 4;       // stages of ty rows in a block's ring
// the slab: TILE_SLAB rows on a launch of at least TILE_LARGE blocks at
// that slab; else up to TILE_SLAB_MID, halved (down to ty) while the
// launch would have fewer than TILE_MID_BLOCKS blocks
constexpr int TILE_SLAB = 32, TILE_LARGE = 2048;
constexpr int TILE_SLAB_MID = 128, TILE_MID_BLOCKS = 256;
constexpr int TILE_RESIDENT = 4;   // blocks an SM must hold: 64 registers a thread

// the values of one 16-byte vector, and of a halo copy: 4 bytes
// (cp.async's least), or one value
template <typename T> struct VecOf { enum { value = 16 / sizeof(T) }; };
template <typename T> struct HaloOf { enum { value = sizeof(T) < 4 ? 4 / sizeof(T) : 1 }; };

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ double zero_of<double>() { return 0.0; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16_rn(0.f); }

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

// V values of a storage type as one 16-byte vector: the ring is written
// and read as such vectors only (or written by cp.async), never value by
// value, since a store of one type and a load of another to the same
// shared memory may be reordered by the compiler
__device__ __forceinline__ uint4 vec_of(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 vec_of(const double (&v)[2]) {
    return make_uint4((unsigned)__double2loint(v[0]), (unsigned)__double2hiint(v[0]),
                      (unsigned)__double2loint(v[1]), (unsigned)__double2hiint(v[1]));
}
__device__ __forceinline__ unsigned bf16_bits(bf16 a, bf16 b) {
    return (unsigned)__bfloat16_as_ushort(a) | ((unsigned)__bfloat16_as_ushort(b) << 16);
}
__device__ __forceinline__ uint4 vec_of(const bf16 (&v)[8]) {
    return make_uint4(bf16_bits(v[0], v[1]), bf16_bits(v[2], v[3]), bf16_bits(v[4], v[5]),
                      bf16_bits(v[6], v[7]));
}

// One value as the vector of padding that holds it in the ring: at place
// e, zeros around it
template <typename T>
__device__ __forceinline__ uint4 vec_with(T value, int e) {
    T v[VecOf<T>::value];
#pragma unroll
    for (int i = 0; i < VecOf<T>::value; ++i) v[i] = i == e ? value : zero_of<T>();
    return vec_of(v);
}

// The V values of y at p (16-byte aligned) as one 16-byte store
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
    return bf16_bits(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                              bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
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
__device__ __forceinline__ void stage_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The V values of x from column k of the row at `row` into dst: one
// 16-byte copy (VEC), or loaded value by value (zero past n) and stored as
// one vector; zeros unless ok
template <bool VEC, typename T>
__device__ __forceinline__ void stage_values(T* dst, const T* __restrict__ x, int64_t row,
                                             int64_t k, int64_t n, bool ok) {
    constexpr int V = VecOf<T>::value;
    if constexpr (VEC) {
        ok = ok && k < n;
        copy_async<16>(dst, x + (ok ? row + k : 0), ok);
    } else {
        T v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = ok && k + e < n ? x[row + k + e] : zero_of<T>();
        *reinterpret_cast<uint4*>(dst) = vec_of(v);
    }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(TILE_THREADS, TILE_RESIDENT) tile_kernel(
    const T* __restrict__ x, T* __restrict__ y, int64_t m, int64_t n, int slab,
    unsigned nslab, unsigned ntn, typename Compute<T>::type diag,
    typename Compute<T>::type off) {
    typedef typename Compute<T>::type TC;
    constexpr int V = VecOf<T>::value, H = HaloOf<T>::value;
    extern __shared__ __align__(16) unsigned char tile_ring[];
    T* const ring = reinterpret_cast<T*>(tile_ring);
    const int tzv = blockDim.x, ty = blockDim.y, tx = threadIdx.x, r = threadIdx.y;
    const int tz = tzv * V, w = tz + 2 * V, ring_rows = TILE_RING * ty;
    // the block: slab fastest, then the column tile, then the grid
    unsigned blk = blockIdx.x;
    const int64_t i0 = (int64_t)(blk % nslab) * slab;
    blk /= nslab;
    const int64_t k0 = (int64_t)(blk % ntn) * tz;
    const int64_t grid = (int64_t)(blk / ntn) * m * n;     // the grid's offset
    const T* const xg = x + grid;
    const int64_t i1 = i0 + slab < m ? i0 + slab : m;
    const int64_t k = k0 + (int64_t)tx * V;
    // row p of the grid in the ring (rows i0 - 1 .. i1 pass through it),
    // at the thread's vector
    auto at = [&](int64_t p) {
        return ring + ((int)(p - i0 + 1) & (ring_rows - 1)) * w + V + tx * V;
    };
    // stage s: rows i0 - 1 + s ty .. i0 - 1 + (s + 1) ty - 1, up to row i1;
    // a thread copies its vector of row r, the edge threads the halos
    auto stage = [&](int64_t s) {
        const int64_t p = i0 - 1 + s * ty + r;
        if (p <= i1) {
            const bool in = p >= 0 && p < m;
            const int64_t row = in ? p * n : 0;
            T* const dst = at(p);
            stage_values<VEC>(dst, xg, row, k, n, in);
            if (tx == 0) {              // column k0 - 1 (VEC: k0 - H .. k0 - 1)
                const bool ok = in && k0 > 0;
                if constexpr (VEC)
                    copy_async<(int)(H * sizeof(T))>(dst - H, xg + (ok ? row + k0 - H : 0), ok);
                else
                    *reinterpret_cast<uint4*>(dst - V) =
                        vec_with(ok ? xg[row + k0 - 1] : zero_of<T>(), V - 1);
            }
            if (tx == tzv - 1) {        // column k0 + tz
                const bool ok = in && k0 + tz < n;
                if constexpr (VEC)
                    copy_async<(int)(H * sizeof(T))>(dst + V, xg + (ok ? row + k0 + tz : 0), ok);
                else
                    *reinterpret_cast<uint4*>(dst + V) =
                        vec_with(ok ? xg[row + k0 + tz] : zero_of<T>(), 0);
            }
        }
        stage_commit();   // a group a stage, empty or not, so the waits count stages
    };

#pragma unroll
    for (int s = 0; s < TILE_RING - 1; ++s) stage(s);
    const int64_t steps = (i1 - i0 + ty - 1) / ty;
    for (int64_t t = 0; t < steps; ++t) {
        stage_wait<TILE_RING - 3>();    // stages t and t + 1 are in
        __syncthreads();                // and no thread reads stage t - 1's rows
        stage(t + TILE_RING - 1);       // into stage t - 1's rows
        const int64_t i = i0 + t * ty + r;
        if (i < i1 && k < n) {
            const T* const own = at(i);
            const uint4 cur = vec_at(own), up = vec_at(at(i - 1)), down = vec_at(at(i + 1));
            // columns k - 1 and k + V: the ends of the vectors either side
            const TC left = value_of<T>(vec_at(own - V), V - 1);
            const TC right = value_of<T>(vec_at(own + V), 0);
            TC out[V];
#pragma unroll
            for (int e = 0; e < V; ++e)
                out[e] = stencil5(diag, off, value_of<T>(cur, e), value_of<T>(up, e),
                                  value_of<T>(down, e),
                                  e == 0 ? left : value_of<T>(cur, e - 1),
                                  e == V - 1 ? right : value_of<T>(cur, e + 1));
            T* const yp = y + grid + i * n + k;
            if constexpr (VEC) {
                store_vec(yp, out);
            } else {
#pragma unroll
                for (int e = 0; e < V; ++e)
                    if (k + e < n) store(yp, e, out[e]);
            }
        }
    }
    stage_wait<0>();                    // no copy outlives the block
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the least power of two at or above n, at most cap (a power of two)
int pow2_at_least(int64_t n, int cap) {
    int p = 1;
    while (p < n && p < cap) p *= 2;
    return p;
}

struct TileGeometry { int tzv, ty, slab; };

// the row-tile walk's geometry on a (batch, m, n) array, V values a vector
template <int V>
TileGeometry tile_geometry(int64_t batch, int64_t m, int64_t n) {
    const int tzv = pow2_at_least((n + V - 1) / V, TILE_VECS);
    const int rows = TILE_THREADS / tzv < TILE_ROWS ? TILE_THREADS / tzv : TILE_ROWS;
    const int ty = pow2_at_least(m > 2 ? m : 2, rows);
    const int64_t tiles = batch * ((n + (int64_t)tzv * V - 1) / ((int64_t)tzv * V));
    if (tiles * ((m + TILE_SLAB - 1) / TILE_SLAB) >= TILE_LARGE)
        return {tzv, ty, ty > TILE_SLAB ? ty : TILE_SLAB};
    int slab = TILE_SLAB_MID;
    while (slab > ty && tiles * ((m + slab - 1) / slab) < TILE_MID_BLOCKS) slab /= 2;
    return {tzv, ty, slab};
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t batch, int64_t m, int64_t n,
                   double diag, double off, cudaStream_t stream) {
    typedef typename Compute<T>::type TC;
    constexpr int V = VecOf<T>::value;
    const TileGeometry geo = tile_geometry<V>(batch, m, n);
    const int tzv = geo.tzv, ty = geo.ty, slab = geo.slab;
    const int64_t tz = (int64_t)tzv * V;
    const int64_t nslab = (m + slab - 1) / slab, ntn = (n + tz - 1) / tz;
    const int64_t blocks = batch * nslab * ntn;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
    const size_t ring = (size_t)TILE_RING * ty * (tz + 2 * V) * sizeof(T);
    const bool vec = n % V == 0 && aligned16(x) && aligned16(y);
    if (vec)
        tile_kernel<T, true><<<(unsigned)blocks, dim3(tzv, ty), ring, stream>>>(
            static_cast<const T*>(x), static_cast<T*>(y), m, n, slab, (unsigned)nslab,
            (unsigned)ntn, (TC)diag, (TC)off);
    else
        tile_kernel<T, false><<<(unsigned)blocks, dim3(tzv, ty), ring, stream>>>(
            static_cast<const T*>(x), static_cast<T*>(y), m, n, slab, (unsigned)nslab,
            (unsigned)ntn, (TC)diag, (TC)off);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel L: the column walk with the norm
//
// One thread per column j and slab of ROWS rows, threads along j so that a
// warp reads 32 neighbouring values of a row; each thread walks its slab
// keeping x[i-1,j], x[i,j] and x[i+1,j] in registers, re-reads the j-1 and
// j+1 neighbours through L1, and adds its (b - y)^2 in row order.
// ---------------------------------------------------------------------------

constexpr int BX = 32;     // threads along n
constexpr int BY = 8;      // threads along m
constexpr int ROWS = 16;   // rows walked by one thread

constexpr int FINISH_THREADS = 1024;

// Sum of v over the block, valid in thread 0.  Fixed order: warp shuffles,
// then the warp sums in warp order.
template <int THREADS, typename T>
__device__ __forceinline__ T block_sum(T v) {
    __shared__ T warp_sums[THREADS / 32];
    const int t = threadIdx.x + threadIdx.y * blockDim.x;
    const int lane = t & 31, warp = t >> 5;
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

// y = A x and, with NORM, the block's partial sum of (b - y)^2: kernel E's
// first walk, kept as it was for kernel L, its one instance (written
// without the NORM branches, the same walk gave the same bits 8% slower on
// an H100).
template <typename T, bool NORM>
__global__ void __launch_bounds__(BX * BY) apply2d_kernel(
    const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y,
    typename Compute<T>::type* __restrict__ partials, int64_t m, int64_t n,
    typename Compute<T>::type diag, typename Compute<T>::type off) {
    typedef typename Compute<T>::type TC;
    const int64_t j = (int64_t)blockIdx.x * BX + threadIdx.x;
    const int64_t i0 = ((int64_t)blockIdx.y * BY + threadIdx.y) * ROWS;
    TC acc = TC(0);
    if (j < n && i0 < m) {
        const int64_t i1 = i0 + ROWS < m ? i0 + ROWS : m;
        const int64_t slab = (int64_t)blockIdx.z * m * n;
        const T* __restrict__ xs = x + slab;
        T* __restrict__ ys = y + slab;
        int64_t idx = i0 * n + j;
        TC up = i0 > 0 ? load(xs, idx - n) : TC(0);
        TC cur = load(xs, idx);
        for (int64_t i = i0; i < i1; ++i, idx += n) {
            const TC down = i + 1 < m ? load(xs, idx + n) : TC(0);
            const TC left = j > 0 ? load(xs, idx - 1) : TC(0);
            const TC right = j + 1 < n ? load(xs, idx + 1) : TC(0);
            const TC v = stencil5(diag, off, cur, up, down, left, right);
            store(ys, idx, v);
            if (NORM) {
                const TC d = load(b, slab + idx) - v;
                acc += d * d;
            }
            up = cur;
            cur = down;
        }
    }
    if (NORM) {
        const TC s = block_sum<BX * BY>(acc);
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

// Kernel L's launch grid, or false when the shape exceeds it.
bool grid_of(int64_t m, int64_t n, dim3* grid) {
    const int64_t rows_per_block = (int64_t)BY * ROWS;
    const int64_t gx = (n + BX - 1) / BX;
    const int64_t gy = (m + rows_per_block - 1) / rows_per_block;
    if (gy > MAX_GRID_YZ || gx > INT32_MAX) return false;
    *grid = dim3((unsigned)gx, (unsigned)gy, 1);
    return true;
}

template <typename T>
cudaError_t launch_norm(const void* x, const void* b, void* y, void* partials,
                        void* out, int64_t m, int64_t n, double diag,
                        double off, cudaStream_t stream) {
    dim3 grid;
    if (!grid_of(m, n, &grid)) return cudaErrorInvalidValue;
    apply2d_kernel<T, true><<<grid, dim3(BX, BY), 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(y),
        static_cast<T*>(partials), m, n, (T)diag, (T)off);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sum_partials<T><<<1, FINISH_THREADS, 0, stream>>>(
        static_cast<const T*>(partials), (int64_t)grid.x * grid.y,
        static_cast<T*>(out));
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel M (2D): the coarse Chebyshev solve, chebyshev_coarse.cuh, on a
// 5-point grid whose A d is stencil5, as kernel E evaluates it; a batch of
// grids is the stack of multisplitting strips under inner pc='mg'.
// ---------------------------------------------------------------------------

#include "chebyshev_coarse.cuh"

template <typename TC> struct Grid5 {
    static constexpr int DIRS = 2;     // rows, columns
    int m, n;
    TC diag, off;
    __host__ __device__ __forceinline__ int points() const { return m * n; }
    __host__ __device__ __forceinline__ int stride(int a) const { return a == 0 ? n : 1; }
    // bits: row above, row below, column left, column right inside the grid
    __device__ __forceinline__ unsigned mask(int p) const {
        const int j = p % n, i = p / n;
        return (i > 0) | (i + 1 < m) << 1 | (j > 0) << 2 | (j + 1 < n) << 3;
    }
    __device__ __forceinline__ TC combine(TC c, const TC (&nb)[4]) const {
        return stencil5(diag, off, c, nb[0], nb[1], nb[2], nb[3]);
    }
};

template <typename T>
cudaError_t launch_chebyshev5(const void* b, void* x, int64_t batch, int64_t m,
                              int64_t n, double diag, double off,
                              const double* coefs, int steps, cudaStream_t s) {
    typedef typename Compute<T>::type TC;
    if (m < 1 || n < 1 || m * n > CHEB_MAX_POINTS) return cudaErrorInvalidValue;
    const Grid5<TC> g = {(int)m, (int)n, (TC)diag, (TC)off};
    return launch_chebyshev_coarse<T>(b, x, batch, g, coefs, steps, s);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel E: y = A x on a contiguous (batch, m, n) array of f32 (dtype 0),
// bf16 (1) or f64 (2), on the row-tile walk.
int stencil2d_apply(int dtype, const void* x, void* y, int64_t batch,
                    int64_t m, int64_t n, double diag, double off,
                    cudaStream_t stream) {
    if (batch < 1 || m < 1 || n < 1) return cudaErrorInvalidValue;
    switch (dtype) {
        case F32:
            return launch<float>(x, y, batch, m, n, diag, off, stream);
        case BF16:
            return launch<bf16>(x, y, batch, m, n, diag, off, stream);
        case F64:
            return launch<double>(x, y, batch, m, n, diag, off, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// Number of partial sums stencil2d_mv_norm writes, or -1 for a shape the
// launch grid cannot take.
int64_t stencil2d_mv_norm_partials(int64_t m, int64_t n) {
    dim3 grid;
    if (m < 1 || n < 1 || !grid_of(m, n, &grid)) return -1;
    return (int64_t)grid.x * grid.y;
}

// Kernel L: y = A x and out[0] = sum (b - y)^2 on one contiguous (m, n)
// grid of f32 (dtype 0) or f64 (2); partials (stencil2d_mv_norm_partials
// values) and out are device memory of the same type.
int stencil2d_mv_norm(int dtype, const void* x, const void* b, void* y,
                      void* partials, void* out, int64_t m, int64_t n,
                      double diag, double off, cudaStream_t stream) {
    if (m < 1 || n < 1) return cudaErrorInvalidValue;
    switch (dtype) {
        case F32:
            return launch_norm<float>(x, b, y, partials, out, m, n, diag, off, stream);
        case F64:
            return launch_norm<double>(x, b, y, partials, out, m, n, diag, off, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// Kernel M: `steps` Chebyshev steps from x0 = 0 on each of `batch`
// contiguous (m, n) grids of b, into x, of f32, bf16 or f64 (dtype 0, 1,
// 2); at most 4096 points a grid and 128 steps.  coefs: host doubles,
// inv_theta then c1[k], c2[k] (chebyshev_coarse.cuh).
int stencil2d_chebyshev(int dtype, const void* b, void* x, int64_t batch,
                        int64_t m, int64_t n, double diag, double off,
                        const double* coefs, int steps, cudaStream_t stream) {
    switch (dtype) {
        case F32:
            return launch_chebyshev5<float>(b, x, batch, m, n, diag, off, coefs, steps, stream);
        case BF16:
            return launch_chebyshev5<bf16>(b, x, batch, m, n, diag, off, coefs, steps, stream);
        case F64:
            return launch_chebyshev5<double>(b, x, batch, m, n, diag, off, coefs, steps, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // extern "C"
