// The trajectory pose chain and the plateau pick shared by the swept-SDF
// kernels (sweep_warm.cu: K1, K2, K4; grid_sweep.cu: K3).
//
//   load_tables  stages one scenario's piece tables in shared memory
//                (pallas_zoom._load_coeff_tables);
//   pose_at      position and quadrotor-tilt rotation at a time t, from the
//                located piece only (pallas_zoom._pvaj_rows +
//                fast_eval.pose_components);
//   rel          p_rel = R^T (p - x) (fast_eval.rel_components);
//   plateau_pick the plateau-centred argmin of K candidates
//                (pallas_zoom._plateau_rows): K1/K4 zoom with K = 8, K3
//                with K = 4.
//
// Every expression is written in the order of its plain PyTorch version
// (sweep/fast_eval.py, fused_zoom._plateau_rows); the sources are built with
// -fmad=false, so the two round alike op by op.
#pragma once

#include <cuda_runtime.h>

#define NCOEF 6                  // MINCO s = 3: quintic pieces
#define NFOLD (3 * NCOEF - 3)    // pos (6) + vel (5) + acc (4) coefficients

struct FlatArgs {
    float grav;
    float kd;     // dh / mass
    float cp;
    float veps;
};

// trajectory tables of one scenario, in shared memory
struct Tables {
    const float* start;
    const float* dur;
    const float* cum;
    const float* coef;   // [N][3][NFOLD]
    int N;
};

// trajectory state at time t (t already in [0, total])
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

// plateau-centred argmin of K candidates (pallas_zoom._plateau_rows): t
// becomes the mean of the connected near-minimum run around the first
// argmin; returns the minimum
template <int K>
__device__ __forceinline__ float plateau_pick(const float (&cand)[K],
                                              const float (&d)[K], float& t) {
    float dmin = d[0];
#pragma unroll
    for (int i = 1; i < K; ++i) dmin = fminf(dmin, d[i]);
    const float eps = 1e-4f * fmaxf(1.f, fabsf(dmin));
    bool tie[K];
    int j = 0;
    bool found = false;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        tie[i] = d[i] <= dmin + eps;
        const bool hit = tie[i] && (d[i] <= dmin) && !found;
        j = hit ? i : j;
        found = found || hit;
    }
    bool cr[K], cl[K];
    bool run = tie[0] || (j > 0);
    cr[0] = run;
#pragma unroll
    for (int i = 1; i < K; ++i) {
        run = run && (tie[i] || j >= i);
        cr[i] = run;
    }
    run = tie[K - 1] || (j < K - 1);
    cl[K - 1] = run;
#pragma unroll
    for (int i = K - 2; i >= 0; --i) {
        run = run && (tie[i] || j <= i);
        cl[i] = run;
    }
    float wsum = 0.f, tsum = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const bool conn = (j <= i) ? cr[i] : cl[i];
        if (conn) {
            wsum += 1.f;
            tsum += cand[i];
        }
    }
    t = tsum / wsum;
    return dmin;
}

// stage one scenario's piece tables in shared memory → its total duration.
// Derivative-folded Horner tables as pallas_zoom._load_coeff_tables builds.
__device__ __forceinline__ Tables load_tables(float* smem, const float* starts,
                                              const float* durs,
                                              const float* coeffs, int N) {
    float* s_start = smem;
    float* s_dur = smem + N;
    float* s_cum = smem + 2 * N;
    float* s_coef = smem + 3 * N;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        s_start[n] = starts[n];
        s_dur[n] = durs[n];
    }
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
    return Tables{s_start, s_dur, s_cum, s_coef, N};
}

// shared memory of one scenario's tables
static inline size_t table_bytes(int N) {
    return (size_t)N * (3 + 3 * NFOLD) * sizeof(float);
}
