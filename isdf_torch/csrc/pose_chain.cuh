// The trajectory pose chain, the plateau pick and the lane-parallel zoom
// shared by the swept-SDF kernels (sweep_warm.cu: K1, K2, K4; grid_sweep.cu:
// K3).
//
//   load_tables     stages one scenario's piece tables in shared memory
//                   (pallas_zoom._load_coeff_tables);
//   piece_of,       the piece rule and the Horner chains of one axis, in any
//   horner_*        float type (also K5, pieces.cu);
//   pose_at         position and rotation at a time t, from the located
//                   piece only (pallas_zoom._pvaj_rows +
//                   fast_eval.pose_components), under either pose map: the
//                   quadrotor tilt (FlatArgs) or SE(2) (PlanarArgs);
//   rel             p_rel = R^T (p - x) (fast_eval.rel_components);
//   plateau_pick    the plateau-centred argmin of K candidates
//                   (pallas_zoom._plateau_rows): K1/K4 zoom with K = 8, K3
//                   with K = 4;
//   coarse_scan     a lane's share of the coarse scan over the pose rows,
//                   and lanes_first_min, the combine of the lanes' minima;
//   lane_zoom       the fixed-round plateau zoom, one candidate per lane.
//
// The piece tables.  Before, a piece stored its derivative-folded Horner
// coefficients (pos 6, vel 5, acc 4 per axis) and a candidate's pose read
// 48 of its ~620 issued instructions from shared memory (SASS of K2's zoom,
// CappedCone; PERF.md §6).  Now a piece stores only its 18 position
// coefficients, 8 floats per axis (6 and 2 of padding), read as one 16-byte
// and one 8-byte vector, and {start, duration} as one 8-byte pair: 7 loads
// plus the piece search, 8 in the SASS.  The velocity and acceleration
// coefficients c[k]·k and c[k]·k·(k−1) are formed in registers by the float
// products the folded tables held, so every value is bitwise what it was.
//
// Lanes.  A kernel may give each query point LANES consecutive threads of a
// warp (a compile-time parameter dividing 32).  Every lane of a point keeps
// the point's uniform state (t, w, the branch).  In a zoom round lane l
// evaluates candidate l, the K values are exchanged with __shfl_sync (width
// K), every lane recomputes the K candidate times from the uniform (t, w)
// and runs the unchanged plateau_pick, so the sum of the plateau stays in
// index order and t is bitwise the one-lane value (lane_zoom).  The coarse
// scan splits the rows of the TPU kernel's order (row r = j mod 8 outer,
// group j / 8 inner, strict <) over the lanes, and the lanes' first minima
// combine to the least d, on an exact tie the earlier place in that order:
// the first minimum, as with one lane (coarse_scan, lanes_first_min).
// Lanes of a point past P still take part in every shuffle (the caller
// clamps the index and skips the store).
//
// Every expression is written in the order of its plain PyTorch version
// (sweep/fast_eval.py, fused_zoom._plateau_rows); the sources are built with
// -fmad=false, so the two round alike op by op.
#pragma once

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#define NCOEF 6                  // MINCO s = 3: quintic pieces
#define CSTRIDE 8                // floats per axis of a piece's coefficients
#define FULL_MASK 0xffffffffu

// The pose maps.  A kernel takes one of them as a template parameter PM and
// calls pose_at(tb, pm, t, x, R); the C entry points take a PoseArgs and
// launch the instantiation its `planar` flag names.
struct FlatArgs {      // quadrotor tilt (core/flatness.FlatParams)
    float grav;
    float kd;     // dh / mass
    float cp;
    float veps;
};

struct PlanarArgs {    // SE(2) (core/flatness.PlanarPose): the third axis is ψ
    float z_ref;
};

// what the C entry points take: either map, by its flag
struct PoseArgs {
    int planar;        // 0: FlatArgs, 1: PlanarArgs
    float grav, kd, cp, veps;
    float z_ref;
};

static inline FlatArgs flat_args(const PoseArgs& pa) {
    return FlatArgs{pa.grav, pa.kd, pa.cp, pa.veps};
}

static inline PlanarArgs planar_args(const PoseArgs& pa) {
    return PlanarArgs{pa.z_ref};
}

// trajectory tables of one scenario, in shared memory
struct Tables {
    const float* coef;   // [N][3][CSTRIDE]: c0..c5 of each axis, 2 pad
    const float2* sd;    // [N] {start, duration}
    const float* cum;    // [N] cumulative ends
    int N;
};

// the piece rule (fast_eval.piece_index): idx = #{n < N-1 : t > cum[n]},
// the first n in [0, N-1) with cum[n] >= t, over N cumulative ends
template <class T>
__device__ __forceinline__ int piece_of(const T* cum, int N, T t) {
    int lo = 0, hi = N - 1;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (t > cum[mid]) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Horner on one axis's position coefficients c0..c5 and on the velocity's
// (c[k]·k) and the acceleration's (c[k]·k·(k−1)), folded as
// pallas_zoom._load_coeff_tables and fast_eval.pvaj_tables fold them (c·1
// is c)
template <class T>
__device__ __forceinline__ T horner_p(T c0, T c1, T c2, T c3, T c4, T c5,
                                      T s) {
    return ((((c5 * s + c4) * s + c3) * s + c2) * s + c1) * s + c0;
}

template <class T>
__device__ __forceinline__ T horner_v(T c1, T c2, T c3, T c4, T c5, T s) {
    return ((((c5 * T(5)) * s + c4 * T(4)) * s + c3 * T(3)) * s
            + c2 * T(2)) * s + c1;
}

template <class T>
__device__ __forceinline__ T horner_a(T c2, T c3, T c4, T c5, T s) {
    return (((c5 * T(20)) * s + c4 * T(12)) * s + c3 * T(6)) * s
           + c2 * T(2);
}

// the piece that holds time t and the local time in it → its coefficients
__device__ __forceinline__ const float* locate(const Tables& tb, float t,
                                               float& s) {
    const int lo = piece_of(tb.cum, tb.N, t);
    const float2 sd = tb.sd[lo];
    s = fminf(fmaxf(t - sd.x, 0.f), sd.y);
    return tb.coef + lo * 3 * CSTRIDE;
}

// position Horner of axis ax (c0..c5)
__device__ __forceinline__ float horner_pos(const float* c, int ax, float s) {
    const float4 a = *reinterpret_cast<const float4*>(c + ax * CSTRIDE);
    const float2 e = *reinterpret_cast<const float2*>(c + ax * CSTRIDE + 4);
    return horner_p(a.x, a.y, a.z, a.w, e.x, e.y, s);
}

// SE(2) pose at time t (t already in [0, total]): the position Horner of the
// three axes alone, x = (p0, p1, z_ref) and R = Rz(p2) row-major, as
// fast_eval.pose_components builds it.  sinf/cosf are the full-precision
// routines (the sources are built without fast math), as torch.sin/cos of
// a CUDA tensor call them.
__device__ __forceinline__ void pose_at(const Tables& tb, const PlanarArgs& pp,
                                        float t, float x[3], float R[9]) {
    float s;
    const float* c = locate(tb, t, s);
    x[0] = horner_pos(c, 0, s);
    x[1] = horner_pos(c, 1, s);
    const float psi = horner_pos(c, 2, s);
    x[2] = pp.z_ref;
    const float cs = cosf(psi), sn = sinf(psi);
    R[0] = cs;  R[1] = -sn; R[2] = 0.f;
    R[3] = sn;  R[4] = cs;  R[5] = 0.f;
    R[6] = 0.f; R[7] = 0.f; R[8] = 1.f;
}

// quadrotor-tilt pose at time t (t already in [0, total])
__device__ __forceinline__ void pose_at(const Tables& tb, const FlatArgs& fp,
                                        float t, float x[3], float R[9]) {
    float s;
    const float* c = locate(tb, t, s);
    float vel[3], acc[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const float4 a = *reinterpret_cast<const float4*>(c + ax * CSTRIDE);
        const float2 e = *reinterpret_cast<const float2*>(c + ax * CSTRIDE + 4);
        x[ax] = horner_p(a.x, a.y, a.z, a.w, e.x, e.y, s);
        vel[ax] = horner_v(a.y, a.z, a.w, e.x, e.y, s);
        acc[ax] = horner_a(a.z, a.w, e.x, e.y, s);
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

// a [x | R] pose row of 12 floats in shared memory (16-byte aligned), read
// as three 16-byte vectors
__device__ __forceinline__ void pose_row(const float* row, float x[3],
                                         float R[9]) {
    const float4* v = reinterpret_cast<const float4*>(row);
    const float4 a = v[0], b = v[1], c = v[2];
    x[0] = a.x; x[1] = a.y; x[2] = a.z;
    R[0] = a.w; R[1] = b.x; R[2] = b.y; R[3] = b.z; R[4] = b.w;
    R[5] = c.x; R[6] = c.y; R[7] = c.z; R[8] = c.w;
}

__device__ __forceinline__ void store_pose_row(float* row, const float x[3],
                                               const float R[9]) {
    float4* v = reinterpret_cast<float4*>(row);
    v[0] = make_float4(x[0], x[1], x[2], R[0]);
    v[1] = make_float4(R[1], R[2], R[3], R[4]);
    v[2] = make_float4(R[5], R[6], R[7], R[8]);
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

// The coarse scan's combine over the LANES lanes of a point: each lane
// brings its first minimum d at pose row j, whose place in the scan order
// (row r = j mod 8 outer, group j / 8 inner) is key = r * groups + j / 8.
// The result is the least d, on an exact tie the smaller key: the first
// minimum in (row, group) order over all rows.  A lane that scanned no row
// brings d = +inf at key INT_MAX and so never wins.  Every lane returns lane
// 0's j, so the lanes stay uniform whatever the values.
template <int LANES>
__device__ __forceinline__ int lanes_first_min(float d, int key, int j) {
    if constexpr (LANES > 1) {
#pragma unroll
        for (int m = 1; m < LANES; m <<= 1) {
            const float d2 = __shfl_xor_sync(FULL_MASK, d, m, LANES);
            const int k2 = __shfl_xor_sync(FULL_MASK, key, m, LANES);
            const int j2 = __shfl_xor_sync(FULL_MASK, j, m, LANES);
            if (d2 < d || (d2 == d && k2 < key)) {
                d = d2;
                key = k2;
                j = j2;
            }
        }
        j = __shfl_sync(FULL_MASK, j, 0, LANES);
    }
    return j;
}

// The coarse scan of one lane over the pose rows in shared memory, in the
// TPU kernel's order (row r = j mod 8 outer, group g = j / 8 inner; strict
// < keeps the first of equal minima): lane l of LANES scans the rows
// r = l mod 8, l mod 8 + LANES, ... (LANES <= 8) or, with more lanes than
// rows, every (LANES / 8)-th group of row l mod 8 from group l / 8; with
// fewer groups than LANES / 8 (coarse_n = 8 and 16 lanes) the last lanes
// scan nothing.  sdf(q) is the body SDF at p_rel q.  → the point's first
// minimum's row j, the same in every lane.
template <int LANES, class Sdf>
__device__ __forceinline__ int coarse_scan(const Sdf& sdf, const float* s_pose,
                                           const float p[3], int coarse_n,
                                           int lane) {
    constexpr int ROWS = 8;
    constexpr int RSTEP = LANES < ROWS ? LANES : ROWS;
    constexpr int GSTEP = LANES > ROWS ? LANES / ROWS : 1;
    const int groups = coarse_n / ROWS;
    float dbest = INFINITY;
    int jbest = 0, kbest = INT_MAX;
    bool have = false;
    auto visit = [&](int r, int g) {
        const int j = g * ROWS + r;
        float x[3], R[9], q[3];
        pose_row(s_pose + 12 * j, x, R);
        rel(p, x, R, q);
        const float d = sdf(q);
        if (!have || d < dbest) {
            dbest = d;
            jbest = j;
            kbest = r * groups + g;
            have = true;
        }
    };
    for (int r = lane % ROWS; r < ROWS; r += RSTEP) {
        // several lanes a point are latency-bound: unrolled rows overlap;
        // one lane a point fills the card and is not helped by it
        if constexpr (LANES > 1) {
#pragma unroll 4
            for (int g = lane / ROWS; g < groups; g += GSTEP) visit(r, g);
        } else {
            for (int g = 0; g < groups; ++g) visit(r, g);
        }
    }
    return lanes_first_min<LANES>(dbest, kbest, jbest);
}

// `rounds` rounds of the K-candidate plateau zoom from (t, w): candidate i
// at clip(t + w·(2i/(K−1) − 1), 0, total), t re-centred on the
// plateau-centred argmin, w shrunk by 2/(K−1).  eval(t) is the SDF at time
// t.  With LANES = K lane l evaluates candidate l and the values are
// exchanged; with LANES = 1 one thread evaluates all K.  Returns the last
// round's minimum; t, the result and the control flow are uniform over a
// point's lanes.
template <int K, int LANES, class Eval>
__device__ __forceinline__ float lane_zoom(const Eval& eval, float total,
                                           int rounds, float& t, float w,
                                           int lane) {
    static_assert(LANES == 1 || LANES == K, "a zoom lane per candidate");
    const float shrink = (float)(2.0 / (K - 1));
    float dmin = 0.f;
    for (int rd = 0; rd < rounds; ++rd) {
        float cand[K], d[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const float off = (float)i * shrink - 1.f;
            cand[i] = fminf(fmaxf(t + w * off, 0.f), total);
        }
        if constexpr (LANES == 1) {
#pragma unroll
            for (int i = 0; i < K; ++i) d[i] = eval(cand[i]);
        } else {
            // the same expression as cand[lane], bitwise
            const float off = (float)lane * shrink - 1.f;
            const float mine = eval(fminf(fmaxf(t + w * off, 0.f), total));
#pragma unroll
            for (int i = 0; i < K; ++i)
                d[i] = __shfl_sync(FULL_MASK, mine, i, LANES);
        }
        dmin = plateau_pick<K>(cand, d, t);
        w = w * shrink;
    }
    return dmin;
}

// floats of one scenario's piece tables in shared memory
static inline size_t table_floats(int N) {
    return (size_t)N * (3 * CSTRIDE + 2 + 1);
}

// stage one scenario's piece tables in shared memory at `smem` (16-byte
// aligned) and wait for the block.  The coefficients of piece n, axis ax,
// power k sit at coeffs[(n * NCOEF + k) * 3 + ax].
__device__ __forceinline__ Tables load_tables(float* smem, const float* starts,
                                              const float* durs,
                                              const float* coeffs, int N) {
    float* s_coef = smem;
    float2* s_sd = reinterpret_cast<float2*>(smem + N * 3 * CSTRIDE);
    float* s_cum = smem + N * (3 * CSTRIDE + 2);
    for (int e = threadIdx.x; e < 3 * N; e += blockDim.x) {
        const int n = e / 3, ax = e % 3;
        const float* c = coeffs + n * NCOEF * 3 + ax;
        float* o = s_coef + e * CSTRIDE;
#pragma unroll
        for (int k = 0; k < NCOEF; ++k) o[k] = c[k * 3];
        o[NCOEF] = 0.f;
        o[NCOEF + 1] = 0.f;
    }
    for (int n = threadIdx.x; n < N; n += blockDim.x)
        s_sd[n] = make_float2(starts[n], durs[n]);
    if (threadIdx.x == 0) {
        float acc = durs[0];
        s_cum[0] = acc;
        for (int n = 1; n < N; ++n) {
            acc = acc + durs[n];
            s_cum[n] = acc;
        }
    }
    __syncthreads();
    return Tables{s_coef, s_sd, s_cum, N};
}

// Dynamic shared memory above the default 48 KB must be granted to each
// kernel instantiation; `granted` (one per instantiation) remembers the
// largest grant.  → cudaSuccess or the attribute call's error.
template <class Kernel>
static inline cudaError_t allow_smem(Kernel kernel, size_t bytes,
                                     size_t& granted) {
    if (bytes <= 48 * 1024 || bytes <= granted) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess) granted = bytes;
    return e;
}
