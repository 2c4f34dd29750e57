// K1: fused warm swept SDF for analytic robot shapes, for Hopper (sm_90a).
//
// Replaces the TPU kernel isdf_tpu/sweep/pallas_zoom.py:_fused_callable._single
// (body _make_sweep_kernel, entered through sweep_warm_fused).  For every query
// point p, in one launch:
//   1. a coarse scan over the (coarse_n, 12) [x | R] pose table at the uniform
//      times j * step, step = total / (coarse_n - 1);
//   2. two zooms of `rounds` rounds, k = 8 candidates each, re-centred on the
//      plateau-centred argmin (pallas_zoom._plateau_rows), the window shrinking
//      by 2/(k-1) per round: zoom A from t_warm (window warm_window), zoom B
//      from the scan argmin (window = step);
//   3. the deeper branch (dA <= dB) gives t*, d*;
//   4. dSDF/dp_rel at t*, from the same templated SDF instantiated on a
//      forward-mode dual number with three partials (what jax.grad gives at
//      pallas_zoom.py:390-392, not a finite difference).
//
// What bounds it on this card: FP32 arithmetic on the CUDA cores plus one
// sqrt/rsqrt chain per candidate (about (coarse_n + 2*rounds*k) body SDF
// evaluations per point); the bytes are tiny (16 B in, 20 B out per point, a
// pose table and a few hundred coefficients shared by all points).  So it is
// compute-bound.  The design keeps everything a point touches on chip: one
// thread per point, its k candidates and their SDF values in registers (all
// candidate loops are unrolled over the compile-time k), the piecewise
// trajectory tables (starts, durations, cumulative ends and the
// derivative-folded Horner coefficients of pos/vel/acc) staged once per block
// in shared memory, and the pose table read through the read-only cache (every
// thread of a warp reads the same row, a broadcast; at the audit's
// coarse_n = 2048 the table is 96 KB, past the 48 KB static shared limit).
// Only the located piece is evaluated (binary search over the cumulative ends),
// not all N pieces under masks as on the TPU.
//
// Built without --use_fast_math and with -fmad=false, and every expression is
// written in the order its plain PyTorch version (fused_zoom.
// sweep_warm_fused_ref) evaluates it, so the two round alike op by op: a
// division by a constant is a product with its reciprocal, as PyTorch divides
// a CUDA tensor by a Python number.  Why it matters: t* is often set by a
// near-tie (a flat minimum, a plateau, a CSG seam), and near the CappedCone
// surface its sqrt-distance metric turns the gradient by ~6000 per metre, so
// one ulp of difference in a candidate's SDF moved t* far enough to miss the
// 1e-3 gradient band on the card (|Δgrad| up to 0.07 with FMA contraction
// on).  t* and d* then agree bitwise; the gradient agrees to rounding (the
// dual-number product rule and autograd's chain rule round differently).

#include <cuda_runtime.h>

#define MAX_PARAMS 16
#define SDF_BALL 1
#define SDF_ROUNDED_CONE 2
#define SDF_CAPPED_CONE 3
#define NCOEF 6                  // MINCO s = 3: quintic pieces
#define NFOLD (3 * NCOEF - 3)    // pos (6) + vel (5) + acc (4) coefficients
#define ZK 8                     // zoom candidates per round
#define BLOCK 128

struct ShapeSpec {
    int kind;
    int posed;
    float p[MAX_PARAMS];
    float R[9];   // row-major pose rotation (shapes/spec.py)
    float t[3];
};

struct FlatArgs {
    float grav;
    float kd;     // dh / mass
    float cp;
    float veps;
};

#define KEPS 1e-12f

// ---------------------------------------------------------------------------
// forward-mode dual number: value and d/d(prel_x, prel_y, prel_z)
struct Dual {
    float v, g0, g1, g2;
};

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ float val(const Dual& a) { return a.v; }

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
    return {a.v + b.v, a.g0 + b.g0, a.g1 + b.g1, a.g2 + b.g2};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
    return {a.v - b.v, a.g0 - b.g0, a.g1 - b.g1, a.g2 - b.g2};
}
__device__ __forceinline__ Dual operator-(Dual a) {
    return {-a.v, -a.g0, -a.g1, -a.g2};
}
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
    return {a.v * b.v, a.g0 * b.v + a.v * b.g0, a.g1 * b.v + a.v * b.g1,
            a.g2 * b.v + a.v * b.g2};
}
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.g0, a.g1, a.g2}; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return {a.v - b, a.g0, a.g1, a.g2}; }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.g0 * b, a.g1 * b, a.g2 * b}; }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.g0, a * b.g1, a * b.g2}; }

__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual dsqrt(Dual a) {
    float r = sqrtf(a.v);
    float h = 0.5f / r;
    return {r, a.g0 * h, a.g1 * h, a.g2 * h};
}
template <class S> __device__ __forceinline__ S dconst(float c);
template <> __device__ __forceinline__ float dconst<float>(float c) { return c; }
template <> __device__ __forceinline__ Dual dconst<Dual>(float c) { return {c, 0.f, 0.f, 0.f}; }

// max/min/abs/clip select by value (the JAX twins split the gradient at exact
// ties; a tie of two float values is a measure-zero event here)
template <class S> __device__ __forceinline__ S dmax(S a, float b) {
    return val(a) >= b ? a : dconst<S>(b);
}
template <class S> __device__ __forceinline__ S dmin(S a, S b) {
    return val(a) <= val(b) ? a : b;
}
template <class S> __device__ __forceinline__ S dabs(S a) {
    return val(a) < 0.f ? -a : a;
}
template <class S> __device__ __forceinline__ S dclip(S a, float lo, float hi) {
    if (val(a) < lo) return dconst<S>(lo);
    if (val(a) > hi) return dconst<S>(hi);
    return a;
}

// ---------------------------------------------------------------------------
// body SDFs — the device forms of shapes/spec.py:_ball/_rounded_cone/_capped_cone
template <class S>
__device__ __forceinline__ S sdf_ball(const float* p, S x, S y, S z) {
    return dsqrt(x * x + y * y + z * z + KEPS) - p[0];
}

template <class S>
__device__ __forceinline__ S sdf_rounded_cone(const float* p, S x, S y, S z) {
    const float r1 = p[0], r2 = p[1], h = p[2], b = p[3], a = p[4], ah = p[5];
    S qx = dsqrt(x * x + y * y + KEPS);
    S qy = z;
    float k = -b * val(qx) + a * val(qy);
    if (k < 0.f) return dsqrt(qx * qx + qy * qy + KEPS) - r1;
    if (k > ah) {
        S qh = qy - h;
        return dsqrt(qx * qx + qh * qh + KEPS) - r2;
    }
    return (a * qx + b * qy) - r1;
}

template <class S>
__device__ __forceinline__ S sdf_capped_cone(const float* p, S x, S y, S z) {
    const float ax = p[0], ay = p[1], az = p[2], bax = p[3], bay = p[4],
                baz = p[5], baba = p[6], ra = p[7], rb = p[8], rba = p[9],
                kk = p[10];
    // x / c for a constant c is x * (1/c), as PyTorch's CUDA division by a
    // Python number computes it (the plain version's arithmetic)
    const float inv_baba = 1.f / baba, inv_kk = 1.f / kk;
    S pax = x - ax, pay = y - ay, paz = z - az;
    S papa = pax * pax + pay * pay + paz * paz;
    S paba = (pax * bax + pay * bay + paz * baz) * inv_baba;
    S xx = dsqrt(dmax(papa - paba * paba * baba, KEPS));
    S cax = dmax(xx - (val(paba) < 0.5f ? ra : rb), 0.f);
    S cay = dabs(paba - 0.5f) - 0.5f;
    S f = dclip((rba * (xx - ra) + paba * baba) * inv_kk, 0.f, 1.f);
    S cbx = xx - ra - f * rba;
    S cby = paba - f;
    float s = (val(cbx) < 0.f && val(cay) < 0.f) ? -1.f : 1.f;
    S d = dsqrt(dmin(cax * cax + cay * cay * baba, cbx * cbx + cby * cby * baba));
    return s * dsqrt(dmax(d, KEPS)) * inv_baba;
}

template <int KIND, class S>
__device__ __forceinline__ S sdf_body(const float* p, S x, S y, S z) {
    if (KIND == SDF_BALL) return sdf_ball(p, x, y, z);
    if (KIND == SDF_ROUNDED_CONE) return sdf_rounded_cone(p, x, y, z);
    return sdf_capped_cone(p, x, y, z);
}

// the poly_params pose, as shapes/ops.transformed3 applies it
template <int KIND, class S>
__device__ __forceinline__ S sdf_shape(const ShapeSpec& sp, S x, S y, S z) {
    if (sp.posed) {
        S dx = x - sp.t[0], dy = y - sp.t[1], dz = z - sp.t[2];
        S lx = sp.R[0] * dx + sp.R[3] * dy + sp.R[6] * dz;
        S ly = sp.R[1] * dx + sp.R[4] * dy + sp.R[7] * dz;
        S lz = sp.R[2] * dx + sp.R[5] * dy + sp.R[8] * dz;
        return sdf_body<KIND>(sp.p, lx, ly, lz);
    }
    return sdf_body<KIND>(sp.p, x, y, z);
}

// ---------------------------------------------------------------------------
// trajectory state at time t (t already in [0, total])
struct Tables {
    const float* start;
    const float* dur;
    const float* cum;
    const float* coef;   // [N][3][NFOLD]
    int N;
};

__device__ __forceinline__ void pose_at(const Tables& tb, const FlatArgs& fp,
                                        float t, float x[3], float R[9]) {
    // idx = #{n < N-1 : t > cum[n]}: first n in [0, N-1) with cum[n] >= t
    int lo = 0, hi = tb.N - 1;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (t > tb.cum[mid]) lo = mid + 1; else hi = mid;
    }
    const float s = fminf(fmaxf(t - tb.start[lo], 0.f), tb.dur[lo]);
    const float* c = tb.coef + lo * 3 * NFOLD;
    float vel[3], acc[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const float* ca = c + ax * NFOLD;
        float h = ca[NCOEF - 1];
#pragma unroll
        for (int k = NCOEF - 2; k >= 0; --k) h = h * s + ca[k];
        x[ax] = h;
        const float* cv = ca + NCOEF;
        h = cv[NCOEF - 2];
#pragma unroll
        for (int k = NCOEF - 3; k >= 0; --k) h = h * s + cv[k];
        vel[ax] = h;
        const float* cc = cv + NCOEF - 1;
        h = cc[NCOEF - 3];
#pragma unroll
        for (int k = NCOEF - 4; k >= 0; --k) h = h * s + cc[k];
        acc[ax] = h;
    }
    // quadrotor tilt (fast_eval.pose_components)
    const float cp_term = sqrtf(vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2] + fp.veps);
    const float w_term = 1.f + fp.cp * cp_term;
    const float zux = acc[0] + fp.kd * w_term * vel[0];
    const float zuy = acc[1] + fp.kd * w_term * vel[1];
    const float zuz = acc[2] + fp.kd * w_term * vel[2] + fp.grav;
    const float izn = rsqrtf(zux * zux + zuy * zuy + zuz * zuz);
    const float zx = zux * izn, zy = zuy * izn, zz = zuz * izn;
    const float td2 = 2.f * (1.f + zz);
    const float itd = rsqrtf(td2);
    const float qw = 0.5f * td2 * itd;
    const float qx = -zy * itd;
    const float qy = zx * itd;
    const float ww = qw * qw, xx = qx * qx, yy = qy * qy;
    const float xy2 = 2.f * qx * qy, wx2 = 2.f * qw * qx, wy2 = 2.f * qw * qy;
    R[0] = ww + xx - yy; R[1] = xy2;          R[2] = wy2;
    R[3] = xy2;          R[4] = ww - xx + yy; R[5] = -wx2;
    R[6] = -wy2;         R[7] = wx2;          R[8] = ww - xx - yy;
}

__device__ __forceinline__ void rel(const float p[3], const float x[3],
                                    const float R[9], float r[3]) {
    const float dx = p[0] - x[0], dy = p[1] - x[1], dz = p[2] - x[2];
    r[0] = R[0] * dx + R[3] * dy + R[6] * dz;
    r[1] = R[1] * dx + R[4] * dy + R[7] * dz;
    r[2] = R[2] * dx + R[5] * dy + R[8] * dz;
}

template <int KIND>
__device__ __forceinline__ float sdf_at(const Tables& tb, const FlatArgs& fp,
                                        const ShapeSpec& sp, const float p[3],
                                        float t) {
    float x[3], R[9], r[3];
    pose_at(tb, fp, t, x, R);
    rel(p, x, R, r);
    return sdf_shape<KIND>(sp, r[0], r[1], r[2]);
}

// fixed-round k = 8 plateau zoom from (t, w); returns the last round's min
template <int KIND>
__device__ __forceinline__ float zoom(const Tables& tb, const FlatArgs& fp,
                                      const ShapeSpec& sp, const float p[3],
                                      float total, int rounds, float& t,
                                      float w) {
    const float shrink = (float)(2.0 / (ZK - 1));
    float dmin = 0.f;
    for (int rd = 0; rd < rounds; ++rd) {
        float cand[ZK], d[ZK];
#pragma unroll
        for (int i = 0; i < ZK; ++i) {
            const float off = (float)i * shrink - 1.f;
            cand[i] = fminf(fmaxf(t + w * off, 0.f), total);
            d[i] = sdf_at<KIND>(tb, fp, sp, p, cand[i]);
        }
        // plateau-centred argmin (pallas_zoom._plateau_rows)
        dmin = d[0];
#pragma unroll
        for (int i = 1; i < ZK; ++i) dmin = fminf(dmin, d[i]);
        const float eps = 1e-4f * fmaxf(1.f, fabsf(dmin));
        bool tie[ZK];
        int j = 0;
        bool found = false;
#pragma unroll
        for (int i = 0; i < ZK; ++i) {
            tie[i] = d[i] <= dmin + eps;
            const bool hit = tie[i] && (d[i] <= dmin) && !found;
            j = hit ? i : j;
            found = found || hit;
        }
        bool cr[ZK], cl[ZK];
        bool run = tie[0] || (j > 0);
        cr[0] = run;
#pragma unroll
        for (int i = 1; i < ZK; ++i) {
            run = run && (tie[i] || j >= i);
            cr[i] = run;
        }
        run = tie[ZK - 1] || (j < ZK - 1);
        cl[ZK - 1] = run;
#pragma unroll
        for (int i = ZK - 2; i >= 0; --i) {
            run = run && (tie[i] || j <= i);
            cl[i] = run;
        }
        float wsum = 0.f, tsum = 0.f;
#pragma unroll
        for (int i = 0; i < ZK; ++i) {
            const bool conn = (j <= i) ? cr[i] : cl[i];
            if (conn) {
                wsum += 1.f;
                tsum += cand[i];
            }
        }
        t = tsum / wsum;
        w = w * shrink;
    }
    return dmin;
}

template <int KIND>
__global__ void __launch_bounds__(BLOCK)
sweep_warm_kernel(const float* __restrict__ pts, const float* __restrict__ t_warm,
                  const float* __restrict__ pose, const float* __restrict__ starts,
                  const float* __restrict__ durs, const float* __restrict__ coeffs,
                  float* __restrict__ t_star, float* __restrict__ d_star,
                  float* __restrict__ grad, int P, int N, int coarse_n,
                  int rounds, float warm_window, ShapeSpec sp, FlatArgs fp) {
    extern __shared__ float smem[];
    float* s_start = smem;
    float* s_dur = smem + N;
    float* s_cum = smem + 2 * N;
    float* s_coef = smem + 3 * N;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        s_start[n] = starts[n];
        s_dur[n] = durs[n];
    }
    // derivative-folded Horner tables (pallas_zoom._load_coeff_tables)
    for (int e = threadIdx.x; e < 3 * N; e += blockDim.x) {
        const int n = e / 3, ax = e % 3;
        const float* c = coeffs + n * NCOEF * 3 + ax;
        float* o = s_coef + e * NFOLD;
#pragma unroll
        for (int k = 0; k < NCOEF; ++k) o[k] = c[k * 3];
#pragma unroll
        for (int k = 1; k < NCOEF; ++k) o[NCOEF + k - 1] = c[k * 3] * (float)k;
#pragma unroll
        for (int k = 2; k < NCOEF; ++k)
            o[2 * NCOEF - 1 + k - 2] = c[k * 3] * (float)(k * (k - 1));
    }
    if (threadIdx.x == 0) {
        float acc = durs[0];
        s_cum[0] = acc;
        for (int n = 1; n < N; ++n) {
            acc = acc + durs[n];
            s_cum[n] = acc;
        }
    }
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= P) return;
    const Tables tb{s_start, s_dur, s_cum, s_coef, N};
    const float total = s_cum[N - 1];
    const float p[3] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};

    // coarse scan, in the TPU kernel's order (row r = j mod k outer, group
    // g = j / k inner; strict < keeps the first of equal minima in that order)
    const float step = total / (float)(coarse_n - 1);
    const int groups = coarse_n / ZK;
    float dbest = 0.f, tbest = 0.f;
    bool have = false;
    for (int r = 0; r < ZK; ++r) {
        for (int g = 0; g < groups; ++g) {
            const int j = g * ZK + r;
            const float* row = pose + 12 * j;
            float x[3], R[9], q[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) x[c] = __ldg(row + c);
#pragma unroll
            for (int c = 0; c < 9; ++c) R[c] = __ldg(row + 3 + c);
            rel(p, x, R, q);
            const float d = sdf_shape<KIND>(sp, q[0], q[1], q[2]);
            if (!have || d < dbest) {
                dbest = d;
                tbest = (float)j * step;
                have = true;
            }
        }
    }

    float tA = fminf(fmaxf(t_warm[i], 0.f), total);
    const float dA = zoom<KIND>(tb, fp, sp, p, total, rounds, tA, warm_window);
    float tB = tbest;
    const float dB = zoom<KIND>(tb, fp, sp, p, total, rounds, tB, step);
    const bool use_a = dA <= dB;
    const float ts = use_a ? tA : tB;

    // dSDF/dp_rel at t* through the dual-number SDF
    float x[3], R[9], q[3];
    pose_at(tb, fp, ts, x, R);
    rel(p, x, R, q);
    const Dual gx{q[0], 1.f, 0.f, 0.f};
    const Dual gy{q[1], 0.f, 1.f, 0.f};
    const Dual gz{q[2], 0.f, 0.f, 1.f};
    const Dual D = sdf_shape<KIND>(sp, gx, gy, gz);

    t_star[i] = ts;
    d_star[i] = use_a ? dA : dB;
    grad[3 * i] = D.g0;
    grad[3 * i + 1] = D.g1;
    grad[3 * i + 2] = D.g2;
}

template <int KIND>
static void launch(const float* pts, const float* t_warm, const float* pose,
                   const float* starts, const float* durs, const float* coeffs,
                   float* t_star, float* d_star, float* grad, int P, int N,
                   int coarse_n, int rounds, float warm_window,
                   const ShapeSpec& sp, const FlatArgs& fp, cudaStream_t st) {
    const int blocks = (P + BLOCK - 1) / BLOCK;
    const size_t smem = (size_t)N * (3 + 3 * NFOLD) * sizeof(float);
    sweep_warm_kernel<KIND><<<blocks, BLOCK, smem, st>>>(
        pts, t_warm, pose, starts, durs, coeffs, t_star, d_star, grad, P, N,
        coarse_n, rounds, warm_window, sp, fp);
}

// Plain C entry point (loaded with ctypes).  Launches on `stream` without
// synchronising; returns cudaGetLastError() of the launch.
extern "C" int isdf_sweep_warm_fused(
    const float* pts, const float* t_warm, const float* pose,
    const float* starts, const float* durs, const float* coeffs,
    float* t_star, float* d_star, float* grad, int P, int N, int coarse_n,
    int rounds, float warm_window, ShapeSpec sp, FlatArgs fp, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (sp.kind) {
        case SDF_BALL:
            launch<SDF_BALL>(pts, t_warm, pose, starts, durs, coeffs, t_star,
                             d_star, grad, P, N, coarse_n, rounds, warm_window,
                             sp, fp, st);
            break;
        case SDF_ROUNDED_CONE:
            launch<SDF_ROUNDED_CONE>(pts, t_warm, pose, starts, durs, coeffs,
                                     t_star, d_star, grad, P, N, coarse_n,
                                     rounds, warm_window, sp, fp, st);
            break;
        case SDF_CAPPED_CONE:
            launch<SDF_CAPPED_CONE>(pts, t_warm, pose, starts, durs, coeffs,
                                    t_star, d_star, grad, P, N, coarse_n,
                                    rounds, warm_window, sp, fp, st);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
