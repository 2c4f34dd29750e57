// K3: the swept-SDF kernel of mesh robots (voxel-grid body SDF) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel isdf_tpu/sweep/pallas_grid_zoom.py:
// _grid_sweep_callable.call (body _make_grid_sweep_kernel), entered through
// grid_sweep_warm_fused.  Per query point p, in one launch:
//   1. a coarse scan at coarse_n times clip(j * step, 0, total),
//      step = total / (coarse_n - 1), on the 2x-min-pooled twin of the field
//      (pooled origin, 1/res and res, also in the outside term), keeping the
//      first minimum in the TPU kernel's order: row r = j mod 8 outer, group
//      j / 8 inner, strict <;
//   2. a 2-round warm pre-zoom (k = 4) from clip(t_warm, 0, total), window
//      warm_window, on the true field: tA and its last round's minimum dA;
//   3. one true-field evaluation dB0 at the coarse argmin t0;
//   4. the seed pick: dA <= dB0 takes (tA, warm_window * (2/3)^2), else
//      (t0, step) - the window depends on the branch, as in the code
//      (pallas_grid_zoom.py:248);
//   5. one deep zoom of `rounds` rounds (k = 4, the window shrinking by 2/3
//      a round), re-centred on the plateau-centred argmin;
//   6. the trilinear value at t* and its gradient dSDF/dp_rel in closed form
//      (the lerps of the corner differences, zero where the clamp holds a
//      coordinate, plus the outside-box distance's slope).
// The block index is one-dimensional and scenario-major: a block covers
// BLOCK / LANES points of one scenario and stages that scenario's piece
// tables in shared memory; every scenario reads the one field, and the
// single sweep is the B = 1 launch.
//
// On the TPU the trilinear lookup is a two-hot bf16 MXU product over the
// whole field held in VMEM, because the TPU has no vector gather.  Here it
// is a direct gather of the 8 corners through the read-only cache: the
// field stays float32 in global memory and L2 (a mesh robot's field is
// a few hundred KB, the L2 50 MB), and no field size limit applies, so the
// TPU's pooled search of fields beyond its VMEM budget has no counterpart.
//
// What bounds it on this card.  The bytes that must move are the field, its
// twin and 36 B a point (gathers served from L2 are not DRAM bytes).  The
// work is coarse_n pooled trilinear evaluations and 4 * (rounds + 2) + 2
// pose-chain and trilinear evaluations a point, plus coarse_n pose chains a
// scenario.  With one thread a point the mesh plan's sweep (P = 4096: 32
// blocks on 132 SMs) was latency-bound: a quarter of the SMs ran one warp per
// scheduler down a chain of ~234 dependent evaluations with 8 gathers each,
// and every thread evaluated the coarse poses anew although they depend on
// the time alone.
//
// What the design does about it:
//   * The coarse poses are computed once per block, pose_at at
//     clip(j * step, 0, total) - the same device function at the same time,
//     so bitwise the value each thread computed - into a pose table in
//     shared memory; the scan then costs p_rel, grid coordinates and the
//     pooled trilinear lookup per row.  Past 48 KB (coarse_n = 2048 is
//     96 KB) the launch grants the dynamic shared memory once.
//   * LANES = 4 threads a point, one per zoom candidate: lane l scans the
//     coarse rows r = l and l + 4 (in that order), the lanes' first minima
//     combine to the least d, on a tie the smaller row (pose_chain.cuh:
//     lanes_first_min); each zoom round lane l evaluates candidate l and the
//     values are exchanged with shuffles (lane_zoom).  A point's chain is
//     2 * coarse_n / 8 pooled lookups and 27 evaluations, and P = 4096 is
//     128 blocks.  The epilogue runs on lane 0.
//
// The pose map is a template parameter (pose_chain.cuh: FlatArgs or
// PlanarArgs), both instantiated and chosen by the entry point's PoseArgs.
//
// Built with -fmad=false and written in the order of its plain PyTorch
// version (sweep/grid_zoom.grid_sweep_warm_fused_ref), so the two round
// alike op by op.

#include <climits>
#include <cuda_runtime.h>

#include "pose_chain.cuh"

#define GK 4            // zoom candidates per round
#define KC 8            // coarse-scan group
#define PRE 2           // warm pre-zoom rounds
#define BLOCK 128       // threads per block
#define LANES_K3 GK     // threads per point: one per zoom candidate
#define SMEM_MAX 232448 // shared memory a block can have (227 KB)

struct GridField {
    const float* f;      // (nx, ny, nz), flat index (ix * ny + iy) * nz + iz
    int nx, ny, nz;
    float ox, oy, oz, inv_res, res;
    float hx, hy, hz;    // the clamp's upper bounds, (n - 1) - 1e-5
};

// clamped coordinate → corner index in [0, n - 2] and the fraction
__device__ __forceinline__ float cell(float g, int n, float hi, int& i0) {
    const float gc = fminf(fmaxf(g, 0.f), hi);
    i0 = min(max((int)floorf(gc), 0), n - 2);
    return gc - (float)i0;
}

// max(g - (n - 1), 0) + min(g, 0): how far g lies outside [0, n - 1]
__device__ __forceinline__ float over(float g, int n) {
    return fmaxf(g - (float)(n - 1), 0.f) + fminf(g, 0.f);
}

// the field at body-frame point r: clamped trilinear value plus the distance
// to the grid box; with GRAD also dSDF/dr in dg
template <bool GRAD>
__device__ __forceinline__ float field_at(const GridField& G, const float r[3],
                                          float dg[3]) {
    const float gx = (r[0] - G.ox) * G.inv_res;
    const float gy = (r[1] - G.oy) * G.inv_res;
    const float gz = (r[2] - G.oz) * G.inv_res;
    int ix, iy, iz;
    const float fx = cell(gx, G.nx, G.hx, ix);
    const float fy = cell(gy, G.ny, G.hy, iy);
    const float fz = cell(gz, G.nz, G.hz, iz);
    const int sx = G.ny * G.nz, sy = G.nz;
    const float* c = G.f + (ix * G.ny + iy) * G.nz + iz;
    const float f000 = __ldg(c), f100 = __ldg(c + sx);
    const float f010 = __ldg(c + sy), f110 = __ldg(c + sx + sy);
    const float f001 = __ldg(c + 1), f101 = __ldg(c + sx + 1);
    const float f011 = __ldg(c + sy + 1), f111 = __ldg(c + sx + sy + 1);
    const float ux = 1.f - fx, uy = 1.f - fy, uz = 1.f - fz;
    const float c00 = f000 * ux + f100 * fx;
    const float c10 = f010 * ux + f110 * fx;
    const float c01 = f001 * ux + f101 * fx;
    const float c11 = f011 * ux + f111 * fx;
    const float c0 = c00 * uy + c10 * fy;
    const float c1 = c01 * uy + c11 * fy;
    const float inner = c0 * uz + c1 * fz;
    const float ovx = over(gx, G.nx), ovy = over(gy, G.ny), ovz = over(gz, G.nz);
    const float ov2 = ovx * ovx + ovy * ovy + ovz * ovz;
    const float outside = sqrtf(ov2 * (G.res * G.res) + 1e-12f);
    if (GRAD) {
        const float dx0 = (f100 - f000) * uy + (f110 - f010) * fy;
        const float dx1 = (f101 - f001) * uy + (f111 - f011) * fy;
        const float dix = dx0 * uz + dx1 * fz;
        const float diy = (c10 - c00) * uz + (c11 - c01) * fz;
        const float diz = c1 - c0;
        const float mx = (gx > 0.f && gx < G.hx) ? 1.f : 0.f;
        const float my = (gy > 0.f && gy < G.hy) ? 1.f : 0.f;
        const float mz = (gz > 0.f && gz < G.hz) ? 1.f : 0.f;
        const float oslope = (G.res * G.res) / outside;
        dg[0] = (dix * mx + ovx * oslope) * G.inv_res;
        dg[1] = (diy * my + ovy * oslope) * G.inv_res;
        dg[2] = (diz * mz + ovz * oslope) * G.inv_res;
    }
    return inner + outside;
}

// body SDF of the field G at trajectory time t (t already in [0, total])
// under the pose map PM (FlatArgs or PlanarArgs, pose_chain.cuh)
template <class PM>
__device__ __forceinline__ float sdf_at(const Tables& tb, const PM& fp,
                                        const GridField& G, const float p[3],
                                        float t) {
    float x[3], R[9], r[3];
    pose_at(tb, fp, t, x, R);
    rel(p, x, R, r);
    return field_at<false>(G, r, nullptr);
}

// fixed-round k = 4 plateau zoom from (t, w) on the field G (lane_zoom);
// returns the last round's minimum
template <int LANES, class PM>
__device__ __forceinline__ float zoom(const Tables& tb, const PM& fp,
                                      const GridField& G, const float p[3],
                                      float total, int rounds, float& t,
                                      float w, int lane) {
    return lane_zoom<GK, LANES>(
        [&](float tc) { return sdf_at(tb, fp, G, p, tc); }, total, rounds, t,
        w, lane);
}

// block `blockIdx.x` covers points [blk * PPB, blk * PPB + PPB) of scenario
// b = blockIdx.x / bps, LANES consecutive threads per point; PM is the pose
// map
template <int LANES, class PM>
__global__ void __launch_bounds__(BLOCK)
grid_sweep_kernel(const float* __restrict__ pts, const float* __restrict__ t_warm,
                  const float* __restrict__ starts, const float* __restrict__ durs,
                  const float* __restrict__ coeffs, float* __restrict__ t_star,
                  float* __restrict__ d_star, float* __restrict__ grad, int P,
                  int N, int coarse_n, int rounds, float warm_window,
                  float w_seed_a, GridField fine, GridField pooled, PM fp,
                  int bps) {
    constexpr int PPB = BLOCK / LANES;
    extern __shared__ float4 smem4[];
    const size_t b = blockIdx.x / bps;
    const int blk = blockIdx.x % bps;
    float* s_pose = reinterpret_cast<float*>(smem4);
    const Tables tb = load_tables(s_pose + coarse_n * 12, starts + b * N,
                                  durs + b * N, coeffs + b * N * NCOEF * 3, N);
    const float total = tb.cum[N - 1];
    const float step = total / (float)(coarse_n - 1);

    // the coarse poses, once per block: row j at clip(j * step, 0, total)
    for (int j = threadIdx.x; j < coarse_n; j += BLOCK) {
        float x[3], R[9];
        pose_at(tb, fp, fminf(fmaxf((float)j * step, 0.f), total), x, R);
        store_pose_row(s_pose + 12 * j, x, R);
    }
    __syncthreads();

    const int lane = threadIdx.x % LANES;
    const int i = blk * PPB + threadIdx.x / LANES;
    const bool live = i < P;              // past P: compute, store nothing
    const size_t gi = b * P + (live ? i : P - 1);
    const float p[3] = {pts[3 * gi], pts[3 * gi + 1], pts[3 * gi + 2]};

    // 1. coarse scan on the pooled twin (pose_chain.cuh: coarse_scan; lane
    // l scans the rows r = l and l + 4)
    const int jbest = coarse_scan<LANES>(
        [&](const float q[3]) { return field_at<false>(pooled, q, nullptr); },
        s_pose, p, coarse_n, lane);
    const float t0 = fminf(fmaxf((float)jbest * step, 0.f), total);

    // 2.-5. warm pre-zoom, the coarse seed's true value, the pick, deep zoom
    float tA = fminf(fmaxf(t_warm[gi], 0.f), total);
    const float dA = zoom<LANES>(tb, fp, fine, p, total, PRE, tA, warm_window,
                                 lane);
    const float dB0 = sdf_at(tb, fp, fine, p, t0);
    const bool use_a = dA <= dB0;
    float ts = use_a ? tA : t0;
    zoom<LANES>(tb, fp, fine, p, total, rounds, ts, use_a ? w_seed_a : step,
                lane);
    if (lane != 0 || !live) return;

    // 6. value and gradient at t*
    float x[3], R[9], r[3], dg[3];
    pose_at(tb, fp, ts, x, R);
    rel(p, x, R, r);
    const float d = field_at<true>(fine, r, dg);
    t_star[gi] = ts;
    d_star[gi] = d;
    grad[3 * gi] = dg[0];
    grad[3 * gi + 1] = dg[1];
    grad[3 * gi + 2] = dg[2];
}

template <class PM>
static int launch_grid(const float* pts, const float* t_warm,
                       const float* starts, const float* durs,
                       const float* coeffs, float* t_star, float* d_star,
                       float* grad, int B, int P, int N, int coarse_n,
                       int rounds, float warm_window, float w_seed_a,
                       GridField fine, GridField pooled, PM fp, void* stream) {
    static size_t granted = 0;
    const int bps = (P + BLOCK / LANES_K3 - 1) / (BLOCK / LANES_K3);
    const long long blocks = (long long)bps * B;
    const size_t smem = ((size_t)coarse_n * 12 + table_floats(N)) * sizeof(float);
    if (blocks < 1 || blocks > INT_MAX || N < 1 || coarse_n < KC
        || coarse_n % KC != 0 || smem > SMEM_MAX || fine.nx < 3
        || fine.ny < 3 || fine.nz < 3 || pooled.nx < 2 || pooled.ny < 2
        || pooled.nz < 2)
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = allow_smem(grid_sweep_kernel<LANES_K3, PM>, smem,
                                     granted);
    if (e != cudaSuccess) return (int)e;
    grid_sweep_kernel<LANES_K3, PM><<<(unsigned)blocks, BLOCK, smem,
                                      (cudaStream_t)stream>>>(
        pts, t_warm, starts, durs, coeffs, t_star, d_star, grad, P, N,
        coarse_n, rounds, warm_window, w_seed_a, fine, pooled, fp, bps);
    return (int)cudaGetLastError();
}

// Plain C entry point (loaded with ctypes).  Launches on `stream` without
// synchronising and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take, or the error
// of granting the shared memory.  Arrays carry a leading B: pts (B, P, 3),
// t_warm (B, P), starts/durs (B, N), coeffs (B, N, 6, 3) -> t_star, d_star
// (B, P), grad (B, P, 3); the single sweep is B = 1.
// w_seed_a = warm_window * (2/3)^2, computed by the caller in double.
// pa: the pose map, tilt or planar.
extern "C" int isdf_grid_sweep_warm_fused(
    const float* pts, const float* t_warm, const float* starts,
    const float* durs, const float* coeffs, float* t_star, float* d_star,
    float* grad, int B, int P, int N, int coarse_n, int rounds,
    float warm_window, float w_seed_a, GridField fine, GridField pooled,
    PoseArgs pa, void* stream) {
    if (pa.planar == 1)
        return launch_grid(pts, t_warm, starts, durs, coeffs, t_star, d_star,
                           grad, B, P, N, coarse_n, rounds, warm_window,
                           w_seed_a, fine, pooled, planar_args(pa), stream);
    if (pa.planar == 0)
        return launch_grid(pts, t_warm, starts, durs, coeffs, t_star, d_star,
                           grad, B, P, N, coarse_n, rounds, warm_window,
                           w_seed_a, fine, pooled, flat_args(pa), stream);
    return (int)cudaErrorInvalidValue;
}
