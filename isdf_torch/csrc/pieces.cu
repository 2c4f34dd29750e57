// K5: the trajectory's position, velocity and acceleration at given times,
// and their gradient, for Hopper (sm_90a), behind sweep/pieces.py.
//
// Replaces no TPU kernel.  The JAX package evaluates the state at t* in
// isdf_tpu/sweep/fast_eval.py, which sums every piece under masks because a
// gather scalarizes on the TPU.  The port gathers the located piece
// (sweep/fast_eval.pvaj_tables), and on the card that gather's backward was
// the cost of the evaluation at t*: PyTorch's advanced-index backward sorts
// the indices and sums each piece's duplicates in a serial loop, and each of
// the 45 coefficient slices' backwards fills and adds a zero tensor of the
// gathered shape.
//
// Forward (pieces_forward_kernel), one thread a time t: the piece rule on
// clip(t, 0, total), the local time s = clip(t - start, 0, dur) and the
// Horner chains of pos, vel and acc of the three axes (pose_chain.cuh:
// piece_of, horner_p/v/a), op for op as pvaj_tables runs on the card, with
// torch.maximum/minimum's NaN rule (tmax, tmin) and -fmad=false: bitwise its
// result.
//
// Backward, two passes, no float atomics:
//   1. pieces_tile_kernel: a block takes TILE times of one scenario.  Each
//      thread forms the gradient of its time's state with respect to its
//      piece's row (the 18 coefficients, the start and the duration through
//      the clip, which splits the gradient half and half where its operands
//      are equal, as torch.maximum/minimum do) and t's gradient.  The block
//      then sums the row gradients per piece over the tile's times, in
//      their order, into partials (B, tiles, N, 20): thread j owns values
//      (n, v) = j, j + TILE, ... and loops over the tile; pieces that no
//      time of the tile holds are written 0 without the loop;
//   2. pieces_sum_kernel sums the tiles of each (b, n, v) in order into the
//      gradients of the starts, the durations and the coefficients.
// Every sum has a fixed order, so two calls give the same bits, and a
// graph's replay those of its warm-ups.
//
// What bounds it: bytes.  A time reads t and its piece's row (a scenario's
// few rows stay in L1/L2) and writes 9 components, ~40 B a point; the
// backward reads t and the 9 components' gradients and writes t's gradient
// and 80·N/TILE B of partials a point, ~44 B + 8 B at N = 13.  A plan's
// evaluation (P = 4096) moves ~0.2 MB, so launch latency rules there; a
// batch's (B = 4096, P = 512) ~84 MB each way, ~25 us at 3.35 TB/s.  The
// pieces' duplicates (~315 times a piece at P = 4096, N = 13) are summed in
// shared memory inside a tile and across tiles in the second small pass,
// with no sort and no zero tensor of the gathered shape.
#include "pose_chain.cuh"

#define VALUES 20        // a row's gradient: 18 coefficients, start, duration
#define TILE 128         // times a block of the backward's first pass
#define FWD_BLOCK 256    // threads a block of the forward

// pos x, y, z | vel x, y, z | acc x, y, z, each shaped like t
struct Nine {
    void* p[9];
};

// torch.maximum / torch.minimum of a CUDA tensor: a NaN operand wins, else
// ::max / ::min
__device__ __forceinline__ float tmax(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ double tmax(double a, double b) {
    return a != a ? a : (b != b ? b : fmax(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ double tmin(double a, double b) {
    return a != a ? a : (b != b ? b : fmin(a, b));
}

// the piece of time t in one scenario's tables, u = t - start, m = max(u,
// 0) and the local time s = min(m, dur), as pvaj_tables forms them
template <class T>
__device__ __forceinline__ int locate_at(const T* cum, const T* starts,
                                         const T* durs, int N, T t, T& u,
                                         T& m, T& s) {
    const T tc = tmin(tmax(t, T(0)), cum[N - 1]);
    const int n = piece_of(cum, N, tc);
    u = t - starts[n];
    m = tmax(u, T(0));
    s = tmin(m, durs[n]);
    return n;
}

template <class T>
__global__ void pieces_forward_kernel(const T* __restrict__ starts,
                                      const T* __restrict__ durs,
                                      const T* __restrict__ cum,
                                      const T* __restrict__ coeffs,
                                      const T* __restrict__ t, Nine out,
                                      int M, int N, long long total) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const long long row = (i / M) * N;
    T u, m, s;
    const int n = locate_at(cum + row, starts + row, durs + row, N, t[i], u,
                            m, s);
    // coefficients (N, 6, 3): power k of axis ax at k * 3 + ax
    const T* c = coeffs + (row + n) * (NCOEF * 3);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const T c0 = c[ax], c1 = c[3 + ax], c2 = c[6 + ax];
        const T c3 = c[9 + ax], c4 = c[12 + ax], c5 = c[15 + ax];
        static_cast<T*>(out.p[ax])[i] = horner_p(c0, c1, c2, c3, c4, c5, s);
        static_cast<T*>(out.p[3 + ax])[i] = horner_v(c1, c2, c3, c4, c5, s);
        static_cast<T*>(out.p[6 + ax])[i] = horner_a(c2, c3, c4, c5, s);
    }
}

// a component's upstream gradient at i, 0 where autograd brought none
template <class T>
__device__ __forceinline__ T grad_at(const Nine& g, int j, long long i) {
    return g.p[j] ? static_cast<const T*>(g.p[j])[i] : T(0);
}

template <class T>
__global__ void __launch_bounds__(TILE)
pieces_tile_kernel(const T* __restrict__ starts, const T* __restrict__ durs,
                   const T* __restrict__ cum, const T* __restrict__ coeffs,
                   const T* __restrict__ t, Nine g, T* __restrict__ gt,
                   T* __restrict__ partial, int M, int N, int tiles) {
    __shared__ T s_val[VALUES][TILE + 1];     // + 1: no bank conflicts
    __shared__ int s_n[TILE];
    __shared__ int s_lo, s_hi;
    const int b = blockIdx.x / tiles;
    const int p = (blockIdx.x % tiles) * TILE + threadIdx.x;
    const long long row = (long long)b * N;
    if (threadIdx.x == 0) {
        s_lo = N;
        s_hi = -1;
    }
    __syncthreads();
    int n = -1;
    T v[VALUES];
    if (p < M) {
        const long long i = (long long)b * M + p;
        T u, m, s;
        n = locate_at(cum + row, starts + row, durs + row, N, t[i], u, m, s);
        const T* c = coeffs + (row + n) * (NCOEF * 3);
        const T dur = durs[row + n];
        const T s2 = s * s, s3 = s2 * s, s4 = s3 * s, s5 = s4 * s;
        T gs = T(0);
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
            const T gp = grad_at<T>(g, ax, i);
            const T gv = grad_at<T>(g, 3 + ax, i);
            const T ga = grad_at<T>(g, 6 + ax, i);
            // d/dc_k: gp s^k + gv k s^(k-1) + ga k (k-1) s^(k-2)
            v[ax] = gp;
            v[3 + ax] = gp * s + gv;
            v[6 + ax] = gp * s2 + gv * (T(2) * s) + ga * T(2);
            v[9 + ax] = gp * s3 + gv * (T(3) * s2) + ga * (T(6) * s);
            v[12 + ax] = gp * s4 + gv * (T(4) * s3) + ga * (T(12) * s2);
            v[15 + ax] = gp * s5 + gv * (T(5) * s4) + ga * (T(20) * s3);
            // d/ds: gp vel + gv acc + ga jerk
            const T c1 = c[3 + ax], c2 = c[6 + ax], c3 = c[9 + ax];
            const T c4 = c[12 + ax], c5 = c[15 + ax];
            const T jerk = ((c5 * T(60)) * s + c4 * T(24)) * s + c3 * T(6);
            gs = gs + gp * horner_v(c1, c2, c3, c4, c5, s)
                 + gv * horner_a(c2, c3, c4, c5, s) + ga * jerk;
        }
        // s = min(m, dur), m = max(u, 0), u = t - start
        const T gm = m == dur ? gs * T(0.5) : (m > dur ? T(0) : gs);
        const T gd = m == dur ? gs * T(0.5) : (m < dur ? T(0) : gs);
        const T gu = u == T(0) ? gm * T(0.5) : (u < T(0) ? T(0) : gm);
        v[18] = -gu;
        v[19] = gd;
        if (gt) gt[i] = gu;
        atomicMin(&s_lo, n);                  // integers: exact in any order
        atomicMax(&s_hi, n);
    }
    s_n[threadIdx.x] = n;
#pragma unroll
    for (int k = 0; k < VALUES; ++k)
        s_val[k][threadIdx.x] = n >= 0 ? v[k] : T(0);
    __syncthreads();
    const int lo = s_lo, hi = s_hi;
    T* out = partial + (long long)blockIdx.x * N * VALUES;
    for (int e = threadIdx.x; e < N * VALUES; e += TILE) {
        const int pn = e / VALUES, k = e % VALUES;
        T acc = T(0);
        if (pn >= lo && pn <= hi) {
            for (int q = 0; q < TILE; ++q)
                if (s_n[q] == pn) acc = acc + s_val[k][q];
        }
        out[e] = acc;
    }
}

template <class T>
__global__ void pieces_sum_kernel(const T* __restrict__ partial,
                                  T* __restrict__ gcoef,
                                  T* __restrict__ gstart,
                                  T* __restrict__ gdur, int N, int tiles,
                                  long long total) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= total) return;
    const long long per = (long long)N * VALUES;
    const long long b = e / per;
    const int r = (int)(e % per);
    const T* src = partial + b * tiles * per + r;
    T acc = T(0);
    for (int j = 0; j < tiles; ++j) acc = acc + src[j * per];
    const long long row = b * N + r / VALUES;
    const int k = r % VALUES;
    if (k < NCOEF * 3) gcoef[row * (NCOEF * 3) + k] = acc;
    else if (k == NCOEF * 3) gstart[row] = acc;
    else gdur[row] = acc;
}

template <class T>
static void forward(const void* starts, const void* durs, const void* cum,
                    const void* coeffs, const void* t, Nine out, int B,
                    int M, int N, cudaStream_t st) {
    const long long total = (long long)B * M;
    const unsigned blocks = (unsigned)((total + FWD_BLOCK - 1) / FWD_BLOCK);
    pieces_forward_kernel<T><<<blocks, FWD_BLOCK, 0, st>>>(
        (const T*)starts, (const T*)durs, (const T*)cum, (const T*)coeffs,
        (const T*)t, out, M, N, total);
}

template <class T>
static void backward(const void* starts, const void* durs, const void* cum,
                     const void* coeffs, const void* t, Nine g, void* gt,
                     void* partial, void* gcoef, void* gstart, void* gdur,
                     int B, int M, int N, int tiles, cudaStream_t st) {
    if (tiles > 0)
        pieces_tile_kernel<T><<<(unsigned)B * tiles, TILE, 0, st>>>(
            (const T*)starts, (const T*)durs, (const T*)cum,
            (const T*)coeffs, (const T*)t, g, (T*)gt, (T*)partial, M, N,
            tiles);
    const long long total = (long long)B * N * VALUES;
    pieces_sum_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        (const T*)partial, (T*)gcoef, (T*)gstart, (T*)gdur, N, tiles, total);
}

extern "C" {

// the backward's tile: the wrapper sizes the partials by it
int isdf_pieces_tile() { return TILE; }

// dtype 0: float32, 1: float64.  starts, durs, cum (B, N), coeffs (B, N, 6,
// 3), t (B, M), the nine outputs (B, M), contiguous; B = 1 for one
// trajectory.  → cudaSuccess or the launch's error.
int isdf_pieces_forward(int dtype, const void* starts, const void* durs,
                        const void* cum, const void* coeffs, const void* t,
                        Nine out, int B, int M, int N, void* stream) {
    if (B < 1 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) forward<float>(starts, durs, cum, coeffs, t, out, B, M, N, st);
    else if (dtype == 1) forward<double>(starts, durs, cum, coeffs, t, out, B, M, N, st);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// g: the nine components' gradients (NULL: none); gt: t's gradient (NULL:
// not wanted); partial (B, tiles, N, 20) scratch, tiles = ceil(M / TILE);
// gcoef (B, N, 6, 3), gstart and gdur (B, N) are written whole.
int isdf_pieces_backward(int dtype, const void* starts, const void* durs,
                         const void* cum, const void* coeffs, const void* t,
                         Nine g, void* gt, void* partial, void* gcoef,
                         void* gstart, void* gdur, int B, int M, int N,
                         int tiles, void* stream) {
    if (B < 1 || M < 0 || N < 1 || tiles != (M + TILE - 1) / TILE)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        backward<float>(starts, durs, cum, coeffs, t, g, gt, partial, gcoef,
                        gstart, gdur, B, M, N, tiles, st);
    else if (dtype == 1)
        backward<double>(starts, durs, cum, coeffs, t, g, gt, partial, gcoef,
                         gstart, gdur, B, M, N, tiles, st);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
