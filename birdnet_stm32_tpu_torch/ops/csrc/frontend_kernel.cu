// Fused linear |STFT| frontend for Hopper (sm_90a), float32.
//
// Replaces birdnet_stm32_tpu/ops/pallas/frontend_kernel.py::_kernel /
// fused_spectrogram (grid="sample") in its mode="linear", mag_scale="none",
// quant=None specialisation: the hybrid frontend of the serving path.
// Per sample it computes, in one launch:
//   1. framing straight from the waveform: frame k = ypad[k*hop, k*hop+n_fft)
//      with ypad = n_fft/2 zeros ++ y ++ zeros (2*hop >= n_fft, so frame k
//      never reaches past (n_frames+1)*hop, the reference's `need` cut);
//   2. re/im = frame . windowed DFT bases, accumulated in float32 FMA (no
//      TF32: the reference runs at HIGHEST precision and the gate is 1e-5);
//   3. magnitude sqrt(re^2 + im^2);
//   4. per-sample min-max over the whole [n_frames, F] block,
//      (S - min) / (max - min + 1e-10);
//   5. freq-major output [B, F, W].
//
// What bounds it: the bytes. The function needs each waveform sample read
// once and each feature written once: at the flagship 66150 floats in and
// 257 x 256 floats out per sample, 34 MB at B=64, 10.1 us at 3.35 TB/s.
// Its arithmetic through an FFT is ~2.5 * n_fft * log2(n_fft) FLOP per
// frame plus the window, |.| and min-max epilogue, ~14.1 kFLOP per frame or
// 231 MFLOP at B=64, 3.4 us at the card's 67 TFLOP/s fp32: below the bytes.
// This design does more arithmetic than the function needs: it computes the
// DFT as a matrix product, 2 * n_frames * n_fft * 2F FLOP per sample
// (flagship: 2*256*512*514 = 134.7 MFLOP, ~40x the FFT's count), so in
// practice its fp32 FMA rate limits it, not memory. The bases
// (2 * n_fft * F_pad * 4 B = 1.2 MB) stay resident in L2.
//
// Design. A sample's magnitudes (257 x 256 x 4 B = 263 KB) exceed the
// 227 KB of shared memory a block may hold, so one block cannot keep a
// whole sample the way the TPU kernel kept it in VMEM. Instead each sample
// is cut into 64-frame x 32-bin output tiles, one block per tile (flagship:
// 4 x 9 = 36 blocks per sample, 2304 blocks at B=64, enough to fill all
// 132 SMs). A block runs a register-tiled SIMT GEMM: 128 threads, each
// holding a 4 x 4 micro-tile of both re and im (32 accumulators, 32 FMA per
// three float4 shared-memory loads), over K = n_fft in steps of 32 taps.
// The frame tile is read from global memory as 4 frames x 8 taps per warp
// (coalesced) and stored transposed into a padded shared array without bank
// conflicts. The epilogue stages the tile's magnitudes through shared memory
// so each warp writes whole rows of the freq-major output, and writes the
// tile's min and max to a scratch array. The min-max normalisation across
// tiles needs every tile of the sample, so the last block of a sample to
// finish (an atomic arrival count after a __threadfence) reduces the
// per-tile extrema, normalises the sample's output in place (that re-read
// is L2-resident) and resets the sample's arrival count to zero, so the
// counters are ready for the next launch on the stream without a memset.
// One launch, no second pass over device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;                          // frames per block tile
constexpr int BN = 32;                          // bins per block tile
constexpr int BK = 32;                          // DFT taps per k-step
constexpr int TM = 4;                           // frames per thread
constexpr int TN = 4;                           // bins per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int WARPS = THREADS / 32;
constexpr int AS = BM + 4;  // padded row stride: float4-aligned rows, conflict-free stores
static_assert(BN <= BK, "the epilogue stages [BN][BM] magnitudes in the [BK][AS] frame tile");
static_assert(BK == 32 && BM % 16 == 0, "the frame-tile load mapping assumes 32 taps, 16-frame groups");

__device__ __forceinline__ void block_minmax(float& mn, float& mx,
                                             float* s_min, float* s_max) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) {
        s_min[warp] = mn;
        s_max[warp] = mx;
    }
    __syncthreads();
    mn = s_min[0];
    mx = s_max[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
        mn = fminf(mn, s_min[w]);
        mx = fmaxf(mx, s_max[w]);
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
frontend_linear_kernel(const float* __restrict__ y,      // [B, T]
                       const float* __restrict__ bases,  // [2, n_fft, f_pad]: cos, sin
                       float* __restrict__ out,          // [B, n_bins, n_frames]
                       float* __restrict__ tile_minmax,  // [B, tiles, 2]
                       unsigned int* __restrict__ arrived,  // [B], zero on entry and exit
                       int T, int n_fft, int hop, int n_frames, int n_bins,
                       int f_pad) {
    __shared__ __align__(16) float As[BK][AS];  // frame tile, [tap][frame]; later [bin][frame]
    __shared__ __align__(16) float Cs[BK][BN];  // cos bases tile
    __shared__ __align__(16) float Ss[BK][BN];  // sin bases tile
    __shared__ float s_min[WARPS], s_max[WARPS];
    __shared__ bool is_last;

    const int b = blockIdx.y;
    const int tiles_n = f_pad / BN;
    const int f0 = (blockIdx.x / tiles_n) * BM;
    const int n0 = (blockIdx.x % tiles_n) * BN;
    const int t = threadIdx.x;
    const int tx = t % (BN / TN);
    const int ty = t / (BN / TN);
    const int pad = n_fft / 2;
    const float* yb = y + (size_t)b * T;
    const float* cos_b = bases;
    const float* sin_b = bases + (size_t)n_fft * f_pad;

    float re[TM][TN], im[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) re[i][j] = im[i][j] = 0.0f;

    for (int k0 = 0; k0 < n_fft; k0 += BK) {
        // Frame tile As[k][f] = ypad[(f0+f)*hop + k0 + k]. Element e maps to
        // k = (e%8) + 8*((e/32)%4), f = ((e/8)%4) + 4*(e/128): a warp reads 4
        // frames x 8 consecutive taps and stores them to 32 distinct banks.
#pragma unroll
        for (int i = 0; i < BK * BM / THREADS; ++i) {
            const int e = i * THREADS + t;
            const int k = (e & 7) + ((e >> 5) & 3) * 8;
            const int f = ((e >> 3) & 3) + (e >> 7) * 4;
            const int frame = f0 + f;
            const int idx = frame * hop + k0 + k - pad;
            float v = 0.0f;
            if (frame < n_frames && idx >= 0 && idx < T) v = __ldg(yb + idx);
            As[k][f] = v;
        }
#pragma unroll
        for (int i = 0; i < BK * BN / THREADS; ++i) {
            const int e = i * THREADS + t;
            const int k = e / BN, n = e % BN;
            const size_t g = (size_t)(k0 + k) * f_pad + n0 + n;
            Cs[k][n] = __ldg(cos_b + g);
            Ss[k][n] = __ldg(sin_b + g);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
            const float4 c = *reinterpret_cast<const float4*>(&Cs[k][tx * TN]);
            const float4 s = *reinterpret_cast<const float4*>(&Ss[k][tx * TN]);
            const float av[TM] = {a.x, a.y, a.z, a.w};
            const float cv[TN] = {c.x, c.y, c.z, c.w};
            const float sv[TN] = {s.x, s.y, s.z, s.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    re[i][j] = fmaf(av[i], cv[j], re[i][j]);
                    im[i][j] = fmaf(av[i], sv[j], im[i][j]);
                }
        }
        __syncthreads();
    }

    // Magnitudes -> shared [bin][frame] staging, plus this thread's extrema
    // over the valid (frame < n_frames, bin < n_bins) entries.
    float lmin = INFINITY, lmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        float m[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            m[i] = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
            if (f0 + ty * TM + i < n_frames && n0 + tx * TN + j < n_bins) {
                lmin = fminf(lmin, m[i]);
                lmax = fmaxf(lmax, m[i]);
            }
        }
        *reinterpret_cast<float4*>(&As[tx * TN + j][ty * TM]) =
            make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();

    float* ob = out + (size_t)b * n_bins * n_frames;
    for (int e = t; e < BN * BM; e += THREADS) {
        const int n = e / BM, f = e % BM;
        if (n0 + n < n_bins && f0 + f < n_frames)
            ob[(size_t)(n0 + n) * n_frames + f0 + f] = As[n][f];
    }

    block_minmax(lmin, lmax, s_min, s_max);
    if (t == 0) {
        float* mm = tile_minmax + ((size_t)b * gridDim.x + blockIdx.x) * 2;
        mm[0] = lmin;
        mm[1] = lmax;
    }

    // Publish this tile's output and extrema, then count its arrival; the
    // last tile of the sample to arrive normalises the whole sample.
    __threadfence();
    __syncthreads();
    if (t == 0) is_last = atomicAdd(&arrived[b], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (t == 0) arrived[b] = 0u;  // every tile of sample b has arrived

    float mn = INFINITY, mx = -INFINITY;
    for (int i = t; i < gridDim.x; i += THREADS) {
        const float* mm = tile_minmax + ((size_t)b * gridDim.x + i) * 2;
        mn = fminf(mn, __ldcg(mm));
        mx = fmaxf(mx, __ldcg(mm + 1));
    }
    block_minmax(mn, mx, s_min, s_max);
    const float den = mx - mn + 1e-10f;

    // __ldcg reads through L2: other blocks' writes are not in this SM's L1.
    const size_t total = (size_t)n_bins * n_frames;
    if ((total & 3) == 0) {
        float4* ob4 = reinterpret_cast<float4*>(ob);
        for (size_t e = t; e < total / 4; e += THREADS) {
            float4 v = __ldcg(ob4 + e);
            v.x = (v.x - mn) / den;
            v.y = (v.y - mn) / den;
            v.z = (v.z - mn) / den;
            v.w = (v.w - mn) / den;
            ob4[e] = v;
        }
    } else {
        for (size_t e = t; e < total; e += THREADS) ob[e] = (__ldcg(ob + e) - mn) / den;
    }
}

}  // namespace

extern "C" {

// Bins padded to a whole number of block tiles: the bases' row length.
int frontend_linear_bin_pad(int n_fft) {
    const int n_bins = n_fft / 2 + 1;
    return (n_bins + BN - 1) / BN * BN;
}

// Output tiles (blocks) per sample: the length of a sample's min/max scratch.
int frontend_linear_tiles(int n_fft, int n_frames) {
    return (n_frames + BM - 1) / BM * (frontend_linear_bin_pad(n_fft) / BN);
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// `arrived` must hold B zeros, and holds B zeros again when the kernel ends;
// `tile_minmax` B * tiles * 2 floats.
int frontend_linear_f32(const float* y, const float* bases, float* out,
                        float* tile_minmax, unsigned int* arrived, int B, int T,
                        int n_fft, int hop, int n_frames, void* stream) {
    if (B <= 0 || B > 65535 || n_fft % BK != 0 || 2 * hop < n_fft || n_frames <= 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(frontend_linear_tiles(n_fft, n_frames), B);
    frontend_linear_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        y, bases, out, tile_minmax, arrived, T, n_fft, hop, n_frames,
        n_fft / 2 + 1, frontend_linear_bin_pad(n_fft));
    return (int)cudaGetLastError();
}

}  // extern "C"
