// The analytic-shape swept-SDF kernels for Hopper (sm_90a): K1, K2 and K4.
//
// K1/K2: fused warm swept SDF.  Replaces the TPU kernels
// isdf_tpu/sweep/pallas_zoom.py:_fused_callable._single (K1) and ._batched
// with its custom_vmap rule (K2), body _make_sweep_kernel, entered through
// sweep_warm_fused.  Both are one __global__, sweep_warm_kernel<KIND, LANES>:
// K2 launches it over B scenarios (a block covers points of ONE scenario and
// stages that scenario's pose table and piece tables in shared memory; its
// total and step are the scenario's own), K1 is the B = 1 launch.  The
// block index is one-dimensional, scenario-major, so B is not bound by the
// 65 535 limit of gridDim.y.  For every query point p, in one launch:
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
// What bounds it on this card.  The bytes are tiny (16 B in and 20 B out a
// point, a pose table and a few hundred coefficients a scenario); the work
// is ~(coarse_n + 2 * rounds * 8) body-SDF evaluations a point, each a pose
// chain of ~200 FP32 operations.  With one thread a point, a single
// trajectory's sweep (P = 4096: 32 blocks on 132 SMs) was latency-bound: a
// quarter of the SMs ran one warp per scheduler down a 512-evaluation chain.
// The batched solve's B = 4096 x 512 fills the card and is bound by the
// instructions it issues, where the ~49 shared-memory loads per candidate
// (against ~207 FP32 instructions; one shared-memory wavefront a clock per
// SM against four FP32 warp instructions) were a co-limit (PERF.md §6 holds
// the SASS count).
//
// What the design does about it:
//   * LANES threads a point, a template parameter: 16 or 1, chosen by the
//     launch size B*P alone (fused_zoom._lanes_for; 16 up to 16 384 points,
//     measured on an H100, PERF.md §6).  With 16, lanes 0..7 run zoom A and
//     lanes 8..15 zoom B side by side, lane l evaluating candidate l mod 8
//     each round; the 8 values of a zoom are exchanged with shuffles and
//     each lane runs the same plateau pick (pose_chain.cuh: lane_zoom); the
//     coarse scan gives lane l row l mod 8 and every other group from
//     l / 8, and the lanes' first minima combine by the tie rule
//     (coarse_scan, lanes_first_min).  A point's chain is 8 + 24
//     evaluations, not 128 + 384 (slice size), and P = 4096 is 512 blocks.
//     Where one lane a point already fills the card (the batched solve's
//     B = 4096 x 512), more lanes only add shuffles and a pick repeated on
//     every lane.  Both instantiations give bitwise the same results.
//   * The scenario's pose table is staged in shared memory (three 16-byte
//     loads a row; the lanes of a point read rows g*8 + r, r = 0..7, whose
//     banks 12r mod 32 are all distinct); above the default 48 KB (the
//     audit's coarse_n = 2048 is 96 KB) the launch grants each
//     instantiation the dynamic shared memory once.
//   * The piece tables hold only the position coefficients, read as
//     vectors: 7 shared-memory loads a candidate plus the piece search
//     (pose_chain.cuh).
//   * Only the located piece is evaluated (binary search over the cumulative
//     ends), not all N pieces under masks as on the TPU; every candidate's k
//     values and the SDF stay in registers.
//
// K4: zoom_refine_kernel<KIND, LANES>, the fixed-round k = 8 plateau zoom
// alone, from per-point (t0, w0) to t*.  Replaces pallas_zoom.py:zoom_refine
// (kernel _make_kernel).  It is K1's zoom device function (lane_zoom) behind
// its own __global__, with 8 lanes a point (one zoom) where K1's rule gives
// lanes, else 1; like K1, rounds * 8 body SDF evaluations per point, 20 B in
// and 4 B out.
//
// The body SDF is chosen at compile time: the file is compiled once per kind
// with -DSDF_KIND=<id> (shapes/spec.py holds the ids), each into a library of
// its own, so the kinds build in parallel and a launch loads only its own.
// The pose map is a template parameter of every kernel (pose_chain.cuh:
// FlatArgs, the quadrotor tilt; PlanarArgs, SE(2)), both instantiated in
// each library and chosen by the entry points' PoseArgs.
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

#include "pose_chain.cuh"

#define MAX_PARAMS 24
#define SDF_BALL 1
#define SDF_ROUNDED_CONE 2
#define SDF_CAPPED_CONE 3
#define SDF_TORUS 4
#define SDF_CAPPED_TORUS 5
#define SDF_WIREFRAME_BOX 6
#define SDF_BEND_LINEAR 7
#define SDF_TWIST_BOX 8
#define SDF_BEND_BOX 9
#define SDF_TABLE 10
#define SDF_BLOBBY 11
#define SDF_TREFOIL 12
#define SDF_BOX_SPHERE 13
#define SDF_CSG 14
#define SDF_BOX 15
#define SDF_POINT 16
#ifndef SDF_KIND
#error "compile with -DSDF_KIND=<kind id of shapes/spec.py>"
#endif
#define ZK 8                     // zoom candidates per round
#define BLOCK 128                // threads per block
#define SMEM_MAX 232448          // shared memory a block can have (227 KB)

struct ShapeSpec {
    int kind;
    int posed;
    float p[MAX_PARAMS];
    float R[9];   // row-major pose rotation (shapes/spec.py)
    float t[3];
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
__device__ __forceinline__ Dual operator+(float a, Dual b) { return {a + b.v, b.g0, b.g1, b.g2}; }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return {a - b.v, -b.g0, -b.g1, -b.g2}; }

__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual dsqrt(Dual a) {
    float r = sqrtf(a.v);
    float h = 0.5f / r;
    return {r, a.g0 * h, a.g1 * h, a.g2 * h};
}
__device__ __forceinline__ float dcos(float a) { return cosf(a); }
__device__ __forceinline__ Dual dcos(Dual a) {
    const float c = cosf(a.v), s = -sinf(a.v);
    return {c, a.g0 * s, a.g1 * s, a.g2 * s};
}
__device__ __forceinline__ float dsin(float a) { return sinf(a); }
__device__ __forceinline__ Dual dsin(Dual a) {
    const float s = sinf(a.v), c = cosf(a.v);
    return {s, a.g0 * c, a.g1 * c, a.g2 * c};
}
__device__ __forceinline__ float datan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
    const float r = 1.f / (x.v * x.v + y.v * y.v);
    const float wy = x.v * r, wx = -y.v * r;
    return {atan2f(y.v, x.v), y.g0 * wy + x.g0 * wx, y.g1 * wy + x.g1 * wx,
            y.g2 * wy + x.g2 * wx};
}
template <class S> __device__ __forceinline__ S dconst(float c);
template <> __device__ __forceinline__ float dconst<float>(float c) { return c; }
template <> __device__ __forceinline__ Dual dconst<Dual>(float c) { return {c, 0.f, 0.f, 0.f}; }

// max/min/clip split the partials 0.5/0.5 at an exact tie, as jnp.maximum,
// torch.maximum and their min twins do (the plain version's and the TPU
// kernel's gradient convention).  Exact ties are not rare at t*: inside a box
// the SDF is max(qx, qy, qz), and the minimum over time of a max sits where
// two of its arguments cross, which the zoom resolves to the last float.
// abs selects (x < 0 ? -x : x), as smoothing.vabs does.
__device__ __forceinline__ float tie_mean(float a, float) { return a; }
__device__ __forceinline__ Dual tie_mean(const Dual& a, const Dual& b) {
    return {a.v, 0.5f * (a.g0 + b.g0), 0.5f * (a.g1 + b.g1),
            0.5f * (a.g2 + b.g2)};
}
template <class S> __device__ __forceinline__ S dmaxv(S a, S b) {
    return val(a) > val(b) ? a : (val(a) < val(b) ? b : tie_mean(a, b));
}
template <class S> __device__ __forceinline__ S dmin(S a, S b) {
    return val(a) < val(b) ? a : (val(a) > val(b) ? b : tie_mean(a, b));
}
template <class S> __device__ __forceinline__ S dmax(S a, float b) {
    return dmaxv(a, dconst<S>(b));
}
template <class S> __device__ __forceinline__ S dminc(S a, float b) {
    return dmin(a, dconst<S>(b));
}
template <class S> __device__ __forceinline__ S dabs(S a) {
    return val(a) < 0.f ? -a : a;
}
template <class S> __device__ __forceinline__ S dclip(S a, float lo, float hi) {
    return dminc(dmax(a, lo), hi);
}

// ---------------------------------------------------------------------------
// body SDFs — the device forms of the plain functions of shapes/spec.py, one
// per kind, in their order of operations.  x / c for a host constant c is
// x * (1/c), as PyTorch's CUDA division by a Python number computes it.
template <class S> __device__ __forceinline__ S n3(S x, S y, S z) {
    return dsqrt(x * x + y * y + z * z + KEPS);
}
template <class S> __device__ __forceinline__ S n2(S x, S y) {
    return dsqrt(x * x + y * y + KEPS);
}
template <class S>
__device__ __forceinline__ S box_d(S x, S y, S z, float hx, float hy, float hz) {
    S qx = dabs(x) - hx, qy = dabs(y) - hy, qz = dabs(z) - hz;
    S outside = n3(dmax(qx, 0.f), dmax(qy, 0.f), dmax(qz, 0.f));
    S inside = dminc(dmaxv(qx, dmaxv(qy, qz)), 0.f);
    return outside + inside;
}
template <class S>
__device__ __forceinline__ S smooth_union(S d1, S d2, float k, float inv_k) {
    S h = dclip(0.5f + 0.5f * (d2 - d1) * inv_k, 0.f, 1.f);
    S m = d2 + (d1 - d2) * h;
    return m - k * h * (1.f - h);
}

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

template <class S>
__device__ __forceinline__ S sdf_torus(const float* p, S x, S y, S z) {
    return n2(n2(x, z) - p[0], y) - p[1];
}

template <class S>
__device__ __forceinline__ S sdf_capped_torus(const float* p, S x, S y, S z) {
    const float s0 = p[0], s1 = p[1], ra2 = p[2], two_ra = p[3], rb = p[4];
    S ax = dabs(x);
    S k = (s1 * val(ax) > s0 * val(y)) ? ax * s0 + y * s1 : n2(ax, y);
    S psq = ax * ax + y * y + z * z;
    return dsqrt(dmax(psq + ra2 - two_ra * k, KEPS)) - rb;
}

template <class S>
__device__ __forceinline__ S wire_g(S a, S b, S c) {
    return n3(dmax(a, 0.f), dmax(b, 0.f), dmax(c, 0.f))
           + dminc(dmaxv(a, dmaxv(b, c)), 0.f);
}

template <class S>
__device__ __forceinline__ S sdf_wireframe_box(const float* p, S x, S y, S z) {
    const float hx = p[0], hy = p[1], hz = p[2], ht = p[3];
    S psx = dabs(x) - hx - ht, psy = dabs(y) - hy - ht, psz = dabs(z) - hz - ht;
    S qx = dabs(psx + ht) - ht, qy = dabs(psy + ht) - ht, qz = dabs(psz + ht) - ht;
    return dmin(dmin(wire_g(psx, qy, qz), wire_g(qx, psy, qz)),
                wire_g(qx, qy, psz));
}

template <class S>
__device__ __forceinline__ S sdf_bend_linear(const float* p, S x, S y, S z) {
    const float inv_ab2 = 1.f / p[6], inv_bb = 1.f / p[16];
    S t = dclip(((x - p[0]) * p[3] + (y - p[1]) * p[4] + (z - p[2]) * p[5]) * inv_ab2,
                0.f, 1.f);
    S u = 2.f * t - 1.f;
    S e = val(t) < 0.5f ? 2.f * t * t : -0.5f * (u * (u - 2.f) - 1.f);
    S pax = e * p[7] + x - p[10], pay = e * p[8] + y - p[11],
      paz = e * p[9] + z - p[12];
    const float bax = p[13], bay = p[14], baz = p[15];
    S h = dclip((pax * bax + pay * bay + paz * baz) * inv_bb, 0.f, 1.f);
    return n3(pax - h * bax, pay - h * bay, paz - h * baz) - p[17];
}

template <class S>
__device__ __forceinline__ S sdf_twist_box(const float* p, S x, S y, S z) {
    S c = dcos(p[0] * z), s = dsin(p[0] * z);
    return box_d(c * x - s * y, s * x + c * y, z, p[1], p[2], p[3]);
}

template <class S>
__device__ __forceinline__ S sdf_bend_box(const float* p, S x, S y, S z) {
    S c = dcos(p[0] * x), s = dsin(p[0] * x);
    return box_d(c * x - s * y, s * x + c * y, z, p[1], p[2], p[3]);
}

template <class S>
__device__ __forceinline__ S sdf_table(const float* p, S x, S y, S z) {
    S qx = dabs(x), qy = dabs(y);
    S f1 = box_d(qx - p[0], qy - p[1], z - p[2], p[3], p[4], p[5]);
    S f2 = box_d(qx - p[6], qy - p[7], z - p[8], p[9], p[10], p[11]);
    return dmin(f1, f2);
}

template <class S>
__device__ __forceinline__ S sdf_blobby(const float* p, S x, S y, S z) {
    const float k = p[16], inv_k = 1.f / k;
    S s0 = n3(x - p[0], y - p[1], z - p[2]) - p[3];
    S s1 = n3(x - p[4], y - p[5], z - p[6]) - p[7];
    S s2 = n3(x - p[8], y - p[9], z - p[10]) - p[11];
    S s3 = n3(x - p[12], y - p[13], z - p[14]) - p[15];
    return smooth_union(smooth_union(s0, s1, k, inv_k),
                        smooth_union(s2, s3, k, inv_k), k, inv_k);
}

template <class S>
__device__ __forceinline__ S sdf_trefoil(const float*, S x, S y, S z) {
    const float pi_f = 3.14159265358979323846f, inv_pi = 1.f / pi_f;
    S a = datan2(y, x);
    S qx = dsqrt(x * x + y * y + KEPS) - 3.5f;
    S qy = -z;
    S c = dcos(1.5f * a), s = dsin(1.5f * a);
    S rx = qx * c + qy * s, ry = qy * c - qx * s;
    // the fold angle is piecewise constant (floor): no partials
    const float fold = -pi_f * floorf(atan2f(val(ry), val(rx)) * inv_pi + 0.5f);
    const float cf = cosf(fold), sf = sinf(fold);
    S fx = rx * cf + ry * sf, fy = ry * cf - rx * sf;
    fx = fx - 1.0f;
    S dx = dabs(fx) - 0.2f, dy = dabs(fy) - 0.2f;
    S mx = dmax(dx, 0.f), my = dmax(dy, 0.f);
    S box2 = dminc(dmaxv(dx, dy), 0.f) + dsqrt(mx * mx + my * my + KEPS);
    return 0.4f * (box2 - 0.05f);
}

template <class S>
__device__ __forceinline__ S sdf_box_sphere(const float* p, S x, S y, S z) {
    const float k = p[4], inv_k = 1.f / k;
    S d1 = box_d(x, y, z, p[0], p[1], p[2]);
    S d2 = n3(x, y, z) - p[3];
    S h, m;
    if (p[5] == 0.f) {      // smooth intersection
        h = dclip(0.5f - 0.5f * (d2 - d1) * inv_k, 0.f, 1.f);
        m = d2 + (d1 - d2) * h;
    } else {                // smooth difference
        h = dclip(0.5f - 0.5f * (d2 + d1) * inv_k, 0.f, 1.f);
        m = d1 - (d1 + d2) * h;
    }
    return m + k * h * (1.f - h);
}

template <class S>
__device__ __forceinline__ S sdf_csg(const float* p, S x, S y, S z) {
    const float rc = p[4];
    S f = dmaxv(n3(x, y, z) - p[0], box_d(x, y, z, p[1], p[2], p[3]));
    S g = dmin(dmin(n2(y, z) - rc, n2(z, x) - rc), n2(x, y) - rc);
    return dmaxv(f, -g);
}

template <int KIND, class S>
__device__ __forceinline__ S sdf_body(const float* p, S x, S y, S z) {
    if constexpr (KIND == SDF_BALL) return sdf_ball(p, x, y, z);
    else if constexpr (KIND == SDF_ROUNDED_CONE) return sdf_rounded_cone(p, x, y, z);
    else if constexpr (KIND == SDF_CAPPED_CONE) return sdf_capped_cone(p, x, y, z);
    else if constexpr (KIND == SDF_TORUS) return sdf_torus(p, x, y, z);
    else if constexpr (KIND == SDF_CAPPED_TORUS) return sdf_capped_torus(p, x, y, z);
    else if constexpr (KIND == SDF_WIREFRAME_BOX) return sdf_wireframe_box(p, x, y, z);
    else if constexpr (KIND == SDF_BEND_LINEAR) return sdf_bend_linear(p, x, y, z);
    else if constexpr (KIND == SDF_TWIST_BOX) return sdf_twist_box(p, x, y, z);
    else if constexpr (KIND == SDF_BEND_BOX) return sdf_bend_box(p, x, y, z);
    else if constexpr (KIND == SDF_TABLE) return sdf_table(p, x, y, z);
    else if constexpr (KIND == SDF_BLOBBY) return sdf_blobby(p, x, y, z);
    else if constexpr (KIND == SDF_TREFOIL) return sdf_trefoil(p, x, y, z);
    else if constexpr (KIND == SDF_BOX_SPHERE) return sdf_box_sphere(p, x, y, z);
    else if constexpr (KIND == SDF_CSG) return sdf_csg(p, x, y, z);
    else if constexpr (KIND == SDF_BOX) return box_d(x, y, z, p[0], p[1], p[2]);
    else {
        static_assert(KIND == SDF_POINT, "unknown SDF_KIND");
        return n3(x, y, z);
    }
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

template <int KIND, class PM>
__device__ __forceinline__ float sdf_at(const Tables& tb, const PM& fp,
                                        const ShapeSpec& sp, const float p[3],
                                        float t) {
    float x[3], R[9], r[3];
    pose_at(tb, fp, t, x, R);
    rel(p, x, R, r);
    return sdf_shape<KIND>(sp, r[0], r[1], r[2]);
}

// fixed-round k = 8 plateau zoom from (t, w) (lane_zoom); returns the last
// round's min
template <int KIND, int LANES, class PM>
__device__ __forceinline__ float zoom(const Tables& tb, const PM& fp,
                                      const ShapeSpec& sp, const float p[3],
                                      float total, int rounds, float& t,
                                      float w, int lane) {
    return lane_zoom<ZK, LANES>(
        [&](float tc) { return sdf_at<KIND>(tb, fp, sp, p, tc); }, total,
        rounds, t, w, lane);
}

// K1 (B = 1) and K2: block `blockIdx.x` covers points
// [blk * PPB, blk * PPB + PPB) of scenario b, b = blockIdx.x / bps, LANES
// consecutive threads per point: 1, or 2 * ZK (both zooms side by side).
// PM is the pose map (FlatArgs or PlanarArgs, pose_chain.cuh).
template <int KIND, int LANES, class PM>
__global__ void __launch_bounds__(BLOCK)
sweep_warm_kernel(const float* __restrict__ pts, const float* __restrict__ t_warm,
                  const float* __restrict__ pose, const float* __restrict__ starts,
                  const float* __restrict__ durs, const float* __restrict__ coeffs,
                  float* __restrict__ t_star, float* __restrict__ d_star,
                  float* __restrict__ grad, int P, int N, int coarse_n,
                  int rounds, float warm_window, int bps, ShapeSpec sp,
                  PM fp) {
    static_assert(LANES == 1 || LANES == 2 * ZK, "1 or 16 lanes a point");
    constexpr int PPB = BLOCK / LANES;
    extern __shared__ float4 smem4[];
    const size_t b = blockIdx.x / bps;
    const int blk = blockIdx.x % bps;
    // the scenario's pose table, then its piece tables
    float* s_pose = reinterpret_cast<float*>(smem4);
    const float4* g_pose = reinterpret_cast<const float4*>(pose + b * coarse_n * 12);
    for (int e = threadIdx.x; e < coarse_n * 3; e += BLOCK)
        smem4[e] = __ldg(g_pose + e);
    const Tables tb = load_tables(s_pose + coarse_n * 12, starts + b * N,
                                  durs + b * N, coeffs + b * N * NCOEF * 3, N);

    const int lane = threadIdx.x % LANES;
    const int i = blk * PPB + threadIdx.x / LANES;
    const bool live = i < P;              // past P: compute, store nothing
    const size_t gi = b * P + (live ? i : P - 1);
    const float total = tb.cum[N - 1];
    const float p[3] = {pts[3 * gi], pts[3 * gi + 1], pts[3 * gi + 2]};

    // coarse scan over the pose table (pose_chain.cuh: coarse_scan)
    const float step = total / (float)(coarse_n - 1);
    const int jbest = coarse_scan<LANES>(
        [&](const float q[3]) { return sdf_shape<KIND>(sp, q[0], q[1], q[2]); },
        s_pose, p, coarse_n, lane);

    // zoom A from t_warm and zoom B from the scan's argmin: one after the
    // other on one lane, or side by side on 2 * ZK lanes (lanes 0..7 zoom A,
    // 8..15 zoom B, one candidate each) that then exchange their results
    float tA = fminf(fmaxf(t_warm[gi], 0.f), total);
    float tB = (float)jbest * step;
    float dA, dB;
    if constexpr (LANES == 1) {
        dA = zoom<KIND, 1>(tb, fp, sp, p, total, rounds, tA, warm_window, 0);
        dB = zoom<KIND, 1>(tb, fp, sp, p, total, rounds, tB, step, 0);
    } else {
        const bool b_half = lane >= ZK;
        float t = b_half ? tB : tA;
        const float d = zoom<KIND, ZK>(tb, fp, sp, p, total, rounds, t,
                                       b_half ? step : warm_window, lane % ZK);
        tA = t;
        dA = d;
        tB = __shfl_xor_sync(FULL_MASK, t, ZK, LANES);
        dB = __shfl_xor_sync(FULL_MASK, d, ZK, LANES);
    }
    if (lane != 0 || !live) return;
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

    t_star[gi] = ts;
    d_star[gi] = use_a ? dA : dB;
    grad[3 * gi] = D.g0;
    grad[3 * gi + 1] = D.g1;
    grad[3 * gi + 2] = D.g2;
}

// K4: the plateau zoom alone, from per-point (t0, w0); the candidates are
// clipped to [0, total], t0 itself is not (pallas_zoom._make_kernel).
template <int KIND, int LANES, class PM>
__global__ void __launch_bounds__(BLOCK)
zoom_refine_kernel(const float* __restrict__ pts, const float* __restrict__ t0,
                   const float* __restrict__ w0, const float* __restrict__ starts,
                   const float* __restrict__ durs, const float* __restrict__ coeffs,
                   float* __restrict__ t_star, int P, int N, int rounds,
                   ShapeSpec sp, PM fp) {
    extern __shared__ float4 smem4[];
    const Tables tb = load_tables(reinterpret_cast<float*>(smem4), starts,
                                  durs, coeffs, N);
    const int lane = threadIdx.x % LANES;
    const int i = blockIdx.x * (BLOCK / LANES) + threadIdx.x / LANES;
    const bool live = i < P;
    const int ic = live ? i : P - 1;
    const float p[3] = {pts[3 * ic], pts[3 * ic + 1], pts[3 * ic + 2]};
    float t = t0[ic];
    zoom<KIND, LANES>(tb, fp, sp, p, tb.cum[N - 1], rounds, t, w0[ic], lane);
    if (lane == 0 && live) t_star[ic] = t;
}

// Plain C entry points (loaded with ctypes).  Each launches on `stream`
// without synchronising and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for arguments the kernels do not take (a spec of
// another kind than this library's, a lane count the kernel has no
// instantiation for, more shared memory than a block has), or the error of
// granting the shared memory.
extern "C" int isdf_sdf_kind(void) { return SDF_KIND; }

// shared memory of one block: the pose table and the piece tables
static inline size_t sweep_smem(int N, int coarse_n) {
    return ((size_t)coarse_n * 12 + table_floats(N)) * sizeof(float);
}

template <int LANES, class PM>
static int launch_sweep(const float* pts, const float* t_warm,
                        const float* pose, const float* starts,
                        const float* durs, const float* coeffs, float* t_star,
                        float* d_star, float* grad, int B, int P, int N,
                        int coarse_n, int rounds, float warm_window,
                        ShapeSpec sp, PM fp, cudaStream_t stream) {
    static size_t granted = 0;
    const int bps = (P + BLOCK / LANES - 1) / (BLOCK / LANES);
    const long long blocks = (long long)bps * B;
    const size_t smem = sweep_smem(N, coarse_n);
    if (blocks < 1 || blocks > 2147483647LL || smem > SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = allow_smem(sweep_warm_kernel<SDF_KIND, LANES, PM>,
                                     smem, granted);
    if (e != cudaSuccess) return (int)e;
    sweep_warm_kernel<SDF_KIND, LANES, PM><<<(unsigned)blocks, BLOCK, smem,
                                            stream>>>(
        pts, t_warm, pose, starts, durs, coeffs, t_star, d_star, grad, P, N,
        coarse_n, rounds, warm_window, bps, sp, fp);
    return (int)cudaGetLastError();
}

template <class PM>
static int sweep_lanes(const float* pts, const float* t_warm,
                       const float* pose, const float* starts,
                       const float* durs, const float* coeffs, float* t_star,
                       float* d_star, float* grad, int B, int P, int N,
                       int coarse_n, int rounds, float warm_window, int lanes,
                       ShapeSpec sp, PM fp, void* stream) {
    if (lanes == 1)
        return launch_sweep<1>(pts, t_warm, pose, starts, durs, coeffs, t_star,
                               d_star, grad, B, P, N, coarse_n, rounds,
                               warm_window, sp, fp, (cudaStream_t)stream);
    if (lanes == 2 * ZK)
        return launch_sweep<2 * ZK>(pts, t_warm, pose, starts, durs, coeffs,
                                    t_star, d_star, grad, B, P, N, coarse_n,
                                    rounds, warm_window, sp, fp,
                                    (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

// K1 is the call with B = 1; K2 any B.  Arrays carry a leading B:
// pts (B, P, 3), t_warm (B, P), pose (B, coarse_n, 12) (16-byte aligned),
// starts/durs (B, N), coeffs (B, N, 6, 3) -> t_star, d_star (B, P),
// grad (B, P, 3).  lanes: threads per point, 1 or 16 (fused_zoom._lanes_for).
// pa: the pose map, tilt or planar.
extern "C" int isdf_sweep_warm_fused(
    const float* pts, const float* t_warm, const float* pose,
    const float* starts, const float* durs, const float* coeffs,
    float* t_star, float* d_star, float* grad, int B, int P, int N,
    int coarse_n, int rounds, float warm_window, int lanes, ShapeSpec sp,
    PoseArgs pa, void* stream) {
    if (sp.kind != SDF_KIND) return (int)cudaErrorInvalidValue;
    if (pa.planar == 1)
        return sweep_lanes(pts, t_warm, pose, starts, durs, coeffs, t_star,
                           d_star, grad, B, P, N, coarse_n, rounds,
                           warm_window, lanes, sp, planar_args(pa), stream);
    if (pa.planar == 0)
        return sweep_lanes(pts, t_warm, pose, starts, durs, coeffs, t_star,
                           d_star, grad, B, P, N, coarse_n, rounds,
                           warm_window, lanes, sp, flat_args(pa), stream);
    return (int)cudaErrorInvalidValue;
}

template <int LANES, class PM>
static int launch_zoom(const float* pts, const float* t0, const float* w0,
                       const float* starts, const float* durs,
                       const float* coeffs, float* t_star, int P, int N,
                       int rounds, ShapeSpec sp, PM fp,
                       cudaStream_t stream) {
    static size_t granted = 0;
    const int blocks = (P + BLOCK / LANES - 1) / (BLOCK / LANES);
    const size_t smem = table_floats(N) * sizeof(float);
    if (blocks < 1 || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    const cudaError_t e = allow_smem(zoom_refine_kernel<SDF_KIND, LANES, PM>,
                                     smem, granted);
    if (e != cudaSuccess) return (int)e;
    zoom_refine_kernel<SDF_KIND, LANES, PM><<<blocks, BLOCK, smem, stream>>>(
        pts, t0, w0, starts, durs, coeffs, t_star, P, N, rounds, sp, fp);
    return (int)cudaGetLastError();
}

template <class PM>
static int zoom_lanes(const float* pts, const float* t0, const float* w0,
                      const float* starts, const float* durs,
                      const float* coeffs, float* t_star, int P, int N,
                      int rounds, int lanes, ShapeSpec sp, PM fp,
                      void* stream) {
    if (lanes == 1)
        return launch_zoom<1>(pts, t0, w0, starts, durs, coeffs, t_star, P, N,
                              rounds, sp, fp, (cudaStream_t)stream);
    if (lanes == ZK)
        return launch_zoom<ZK>(pts, t0, w0, starts, durs, coeffs, t_star, P,
                               N, rounds, sp, fp, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

extern "C" int isdf_zoom_refine(
    const float* pts, const float* t0, const float* w0, const float* starts,
    const float* durs, const float* coeffs, float* t_star, int P, int N,
    int rounds, int lanes, ShapeSpec sp, PoseArgs pa, void* stream) {
    if (sp.kind != SDF_KIND) return (int)cudaErrorInvalidValue;
    if (pa.planar == 1)
        return zoom_lanes(pts, t0, w0, starts, durs, coeffs, t_star, P, N,
                          rounds, lanes, sp, planar_args(pa), stream);
    if (pa.planar == 0)
        return zoom_lanes(pts, t0, w0, starts, durs, coeffs, t_star, P, N,
                          rounds, lanes, sp, flat_args(pa), stream);
    return (int)cudaErrorInvalidValue;
}
