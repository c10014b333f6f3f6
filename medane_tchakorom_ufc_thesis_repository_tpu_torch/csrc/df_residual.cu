// Hopper (sm_90a) kernel D: the double-float (two-f32) residual
// r = b - A x of the 3D 7-point stencil, from (xhi, xlo, bhi, blo) to
// (rhi, rlo).
//
// Replaces ops/stencil_pallas.py:stencil3d_df_residual_pallas
// (_kernel3d_dfr).  It follows the operation order of
// solvers/df64.py:_df_residual_core_3d step for step, so it matches the
// plain PyTorch version bit for bit.  Every add and multiply is an
// explicitly rounded __fadd_rn/__fsub_rn/__fmul_rn, and the file is also
// compiled with -fmad=false (ops/build.py): nvcc contracts a*b+c into an
// FMA by default, and that breaks the error-free transforms.
//
// Bound: memory bytes, four f32 reads and two f32 writes: 24 bytes a
// point, 3.2 GB at 512^3, about 1 ms at 3.35 TB/s.  The ~60 flops a point
// of the two_sum tree stay below the balance point.
//
// Design: one thread per point, threads along z; the 6 neighbours of hi
// and lo are read through L1/L2.  What the simple design gives up: each x
// value is read up to 7 times through the cache, with no shared-memory
// staging of planes.
//
// Plain C interface, bound with ctypes by ops/stencil3d.py; launches on
// the given stream, allocates nothing, returns the cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct DF {
    float hi, lo;
};

// Knuth two-sum: a + b = s + e exactly.
__device__ __forceinline__ DF two_sum(float a, float b) {
    const float s = __fadd_rn(a, b);
    const float bb = __fsub_rn(s, a);
    const float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
    return {s, e};
}

__device__ __forceinline__ DF df_add(DF a, DF b) {
    const DF se = two_sum(a.hi, b.hi);
    const float e = __fadd_rn(se.lo, __fadd_rn(a.lo, b.lo));
    return two_sum(se.hi, e);
}

__device__ __forceinline__ DF df_add_f32(DF a, float b) {
    const DF se = two_sum(a.hi, b);
    const float e = __fadd_rn(se.lo, a.lo);
    return two_sum(se.hi, e);
}

// df * f32 by Dekker's split two-product (df64.df_mul_f32).
__device__ __forceinline__ DF df_mul_f32(DF a, float s) {
    const float c = 4097.0f;
    const float p = __fmul_rn(a.hi, s);
    const float ca = __fmul_rn(c, a.hi);
    const float ah = __fsub_rn(ca, __fsub_rn(ca, a.hi));
    const float at = __fsub_rn(a.hi, ah);
    const float cs = __fmul_rn(c, s);
    const float sh = __fsub_rn(cs, __fsub_rn(cs, s));
    const float st = __fsub_rn(s, sh);
    const float err = __fadd_rn(
        __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, sh), p), __fmul_rn(ah, st)),
                  __fmul_rn(at, sh)),
        __fmul_rn(at, st));
    const float e = __fadd_rn(err, __fmul_rn(a.lo, s));
    return two_sum(p, e);
}

// How a coefficient c multiplies an f32 x into a df (df64._int_coeff_mul
// and df64._df_combine); the wrapper picks the mode on the host.
enum { ONE_POW2 = 0, TWO_POW2 = 1, DEKKER = 2, SCALE = 3 };

struct Coeff {
    int mode;
    float p0, p1, c;
};

__device__ __forceinline__ DF coeff_mul(float x, const Coeff& k) {
    if (k.mode == ONE_POW2) return {__fmul_rn(k.p0, x), 0.0f};
    if (k.mode == TWO_POW2) return two_sum(__fmul_rn(k.p0, x), __fmul_rn(k.p1, x));
    return df_mul_f32({x, 0.0f}, k.c);
}

// (hi + lo) * c as a df: exact scaling for SCALE, else coeff_mul of hi
// plus the f32 product of lo.
__device__ __forceinline__ DF df_combine(float hi, float lo, const Coeff& k) {
    if (k.mode == SCALE) return {__fmul_rn(hi, k.c), __fmul_rn(lo, k.c)};
    return df_add_f32(coeff_mul(hi, k), __fmul_rn(k.c, lo));
}

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) df_residual_kernel(
    const float* __restrict__ xhi, const float* __restrict__ xlo,
    const float* __restrict__ bhi, const float* __restrict__ blo,
    float* __restrict__ rhi, float* __restrict__ rlo, int64_t nx, int64_t ny,
    int64_t nz, Coeff diag, Coeff off) {
    const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (t >= nx * ny * nz) return;
    const int64_t k = t % nz;
    const int64_t j = (t / nz) % ny;
    const int64_t i = t / (nz * ny);
    const int64_t plane = ny * nz;
    const bool hx0 = i > 0, hx1 = i + 1 < nx, hy0 = j > 0, hy1 = j + 1 < ny;
    const bool hz0 = k > 0, hz1 = k + 1 < nz;

    const float xnh = hx0 ? xhi[t - plane] : 0.0f;
    const float xsh = hx1 ? xhi[t + plane] : 0.0f;
    const float ynh = hy0 ? xhi[t - nz] : 0.0f;
    const float ysh = hy1 ? xhi[t + nz] : 0.0f;
    const float zwh = hz0 ? xhi[t - 1] : 0.0f;
    const float zeh = hz1 ? xhi[t + 1] : 0.0f;
    const DF se1 = two_sum(xnh, xsh);
    const DF se2 = two_sum(ynh, ysh);
    const DF se3 = two_sum(zwh, zeh);
    const DF te4 = two_sum(se1.hi, se2.hi);
    const DF ne5 = two_sum(te4.hi, se3.hi);

    const float xnl = hx0 ? xlo[t - plane] : 0.0f;
    const float xsl = hx1 ? xlo[t + plane] : 0.0f;
    const float ynl = hy0 ? xlo[t - nz] : 0.0f;
    const float ysl = hy1 ? xlo[t + nz] : 0.0f;
    const float zwl = hz0 ? xlo[t - 1] : 0.0f;
    const float zel = hz1 ? xlo[t + 1] : 0.0f;
    const float tlo = __fadd_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(xnl, xsl), ynl), ysl), zwl), zel);
    const float nl = __fadd_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(se1.lo, se2.lo), __fadd_rn(se3.lo, te4.lo)),
                  ne5.lo),
        tlo);

    const DF ndf = df_combine(ne5.hi, nl, off);
    DF ddf = coeff_mul(xhi[t], diag);
    ddf = df_add_f32(ddf, __fmul_rn(diag.c, xlo[t]));
    const DF ax = df_add(ddf, ndf);
    const DF r = df_add({bhi[t], blo[t]}, {-ax.hi, -ax.lo});
    rhi[t] = r.hi;
    rlo[t] = r.lo;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All six arrays f32 (nx, ny, nz).  The coefficient modes are
// 0 one power of two (p0), 1 two powers of two (p0, p1), 2 Dekker product
// by c, 3 exact scaling by c (off only); c is the coefficient itself.
int stencil3d_df_residual(const void* xhi, const void* xlo, const void* bhi,
                          const void* blo, void* rhi, void* rlo, int64_t nx,
                          int64_t ny, int64_t nz, int diag_mode, float diag_p0,
                          float diag_p1, float diag, int off_mode,
                          float off_p0, float off_p1, float off,
                          void* stream) {
    if (nx < 1 || ny < 1 || nz < 1) return cudaErrorInvalidValue;
    if (diag_mode < ONE_POW2 || diag_mode > DEKKER) return cudaErrorInvalidValue;
    if (off_mode < ONE_POW2 || off_mode > SCALE) return cudaErrorInvalidValue;
    const int64_t n = nx * ny * nz;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    df_residual_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xhi), static_cast<const float*>(xlo),
        static_cast<const float*>(bhi), static_cast<const float*>(blo),
        static_cast<float*>(rhi), static_cast<float*>(rlo), nx, ny, nz,
        Coeff{diag_mode, diag_p0, diag_p1, diag},
        Coeff{off_mode, off_p0, off_p1, off});
    return cudaGetLastError();
}

}  // extern "C"
