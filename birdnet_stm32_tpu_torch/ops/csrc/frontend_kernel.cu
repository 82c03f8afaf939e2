// Fused |STFT| frontends for Hopper (sm_90a), float32 math, float32 or
// int8 out.
//
// Replaces birdnet_stm32_tpu/ops/pallas/frontend_kernel.py::_kernel /
// fused_spectrogram (grid="sample"), in two kernels that share one DFT tile
// loop (dft_tile). Each has a float32 and an int8-entry specialisation
// (quant=(scale, zp), _sample_epilogue's last step): the int8 one computes
// the same normalized floats S in the same operations, then stores
// q = clip(round_half_away(S * inv_scale) + zp, -128, 127) as int8 in the
// frame-major [W, bins] layout, the INT8 executor's entry tensor. inv_scale
// is float32(1) / float32(scale), taken on the host: jitted XLA turns the
// reference's S / scale into that multiply. __fmul_rn / __fadd_rn keep
// nvcc from contracting the rounding into an FMA, and the build has no
// --use_fast_math, so the codes equal quantize(float kernel output) bit for
// bit. The two kernels:
//
// frontend_linear_kernel: mode="linear", mag_scale="none", the hybrid
// frontend. Per sample, in one launch:
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
// frontend_features_kernel: every other epilogue of _sample_epilogue:
// the mel product, then mel / pwl / db / pcen, log_mel
// (log1p), mfcc (power, mel, power_to_db over all frames, DCT, slice), and
// the linear mode with pwl / db / pcen. Per sample, in one launch:
//   1-2. as above, over a 64-frame strip and all bins;
//   3. |X|, or |X|^2 for mfcc, staged per 32-bin tile in shared memory and
//      multiplied into the mel bank (or, with no mel, written out as is);
//   4. the strip's [64, C] rows go to a frame-major scratch [B, W, C];
//   5. the last strip of the sample to arrive runs the per-sample
//      epilogue, with every reduction it needs, and writes [B, bins, W'].
//
// What bounds them: the bytes. The function needs each waveform sample
// read once and each feature written once: at the flagship 66150 floats in
// and bins x 256 floats out per sample (34 MB at B=64 for the 257 linear
// bins, 10.1 us at 3.35 TB/s; 21.1 MB and 6.3 us for 64 mels). Its
// arithmetic through an FFT is ~14.1 kFLOP per frame, plus 2 x the mel
// bank's nonzeros and the DCT: ~3.8 us at the card's 67 TFLOP/s fp32,
// below the bytes. This design does more arithmetic than the function
// needs: it computes the DFT as a matrix product, 2 * n_frames * n_fft *
// 2F FLOP per sample (flagship: 134.7 MFLOP, ~40x the FFT's count), so in
// practice its fp32 FMA rate limits it, not memory. The bases
// (2 * n_fft * F_pad * 4 B = 1.2 MB) and the mel bank stay resident in L2.
//
// Design of the linear kernel. A sample's magnitudes (257 x 256 x 4 B =
// 263 KB) exceed the 227 KB of shared memory a block may hold, so one block
// cannot keep a whole sample the way the TPU kernel kept it in VMEM.
// Instead each sample is cut into 64-frame x 32-bin output tiles, one
// block per tile (flagship: 4 x 9 = 36 blocks per sample, 2304 blocks at
// B=64, enough to fill all 132 SMs). A block runs a register-tiled SIMT
// GEMM: 128 threads, each holding a 4 x 4 micro-tile of both re and im (32
// accumulators, 32 FMA per three float4 shared-memory loads), over K =
// n_fft in steps of 32 taps. The frame tile is read from global memory as
// 4 frames x 8 taps per warp (coalesced) and stored transposed into a
// padded shared array without bank conflicts. The epilogue stages the
// tile's magnitudes through shared memory so each warp writes whole rows of
// the freq-major output, and writes the tile's min and max to a scratch
// array. The min-max normalisation across tiles needs every tile of the
// sample, so the last block of a sample to finish (an atomic arrival count
// after a __threadfence) reduces the per-tile extrema, normalises the
// sample's output in place (that re-read is L2-resident) and resets the
// sample's arrival count to zero, so the counters are ready for the next
// launch on the stream without a memset. One launch, no second pass over
// device memory.
//
// Design of the features kernel. After the mel product a sample is small
// (256 x 64 x 4 B = 64 KB; mfcc's 257 frames 65.8 KB), so one block can
// hold it. A block owns a 64-frame strip of one sample and walks all bin
// tiles with the same DFT tile loop, staging each 64 x 32 magnitude tile
// in shared memory and accumulating the mel product in registers: thread
// t owns mel t % 64 of its 64-mel chunk for 32 frames, and sums the bins
// in increasing order, skipping a tile row only when the whole warp's
// weights are zero (the sum is unchanged). More than 64 mels take more
// blocks (grid.x = strips x mel chunks), each recomputing the DFT. The
// strip's rows go to scratch; the last block of the sample to arrive
// loads the sample from L2 into shared memory (rows padded to C+1 floats,
// so the freq-major transpose on the way out is free of bank conflicts)
// and runs the epilogue there: the multi-pass reductions (pwl: min-max,
// curve, min-max; db: max, dB, peak-80 clamp, min-max; mfcc: max, dB over
// all frames, clamp, DCT, min-max) and pcen's smoother, one thread per
// channel walking the frames in order. Sums never use float atomics: each
// is computed by one thread in a fixed order, so the result does not
// depend on which block arrives last. A sample too large for shared
// memory (the linear mode's 257 bins) runs the same epilogue in place in
// the L2-resident scratch. The shared memory is one dynamic buffer, the
// strip's tiles first and the sample after, so every block holds only the
// larger of the two.
//
// The int8 specialisations. The linear kernel's tiles then write their
// magnitudes frame-major into a float scratch ([B, W, bins], the float
// output's bytes), and the last block reads them back, normalizes and
// quantizes them in the same order, so both its loads and its int8 stores
// are contiguous (float4 in, char4 out). The features kernel's last block
// quantizes where the float one writes its normalized output, walking the
// output frame-major; its float output buffer stays the scratch that pcen
// (the smoother) and mfcc (the DCT) use. Bytes at the flagship B=64: the
// waveform (16.9 MB) plus B x W x bins int8 codes (4.2 MB linear, 1.0 MB
// for 64 mels).

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
constexpr int MEL_CHUNK = 64;                            // mels per block
constexpr int MEL_FRAMES = BM * MEL_CHUNK / THREADS;     // frames per thread: 32
constexpr int TILE_FLOATS = BK * AS + 2 * BK * BN;       // As, Cs, Ss
static_assert(BN <= BK, "the epilogue stages [BN][BM] magnitudes in the [BK][AS] frame tile");
static_assert(BK == 32 && BM % 16 == 0, "the frame-tile load mapping assumes 32 taps, 16-frame groups");
static_assert(THREADS % MEL_CHUNK == 0 && MEL_FRAMES % 4 == 0,
              "mel threads own whole float4 frame runs");

// The per-sample epilogues of _sample_epilogue.
enum Epilogue { EPI_NONE = 0, EPI_PWL = 1, EPI_DB = 2, EPI_PCEN = 3, EPI_LOG1P = 4, EPI_MFCC = 5 };

// The int8-entry quantization of one normalized value:
// clip(round_half_away(s * inv_scale) + zp, -128, 127).
__device__ __forceinline__ signed char quantize_code(float s, float inv_scale, float zp) {
    const float f = __fmul_rn(s, inv_scale);
    const float q = __fadd_rn(copysignf(floorf(__fadd_rn(fabsf(f), 0.5f)), f), zp);
    return static_cast<signed char>(fminf(fmaxf(q, -128.0f), 127.0f));
}

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

// re/im of frames [f0, f0+BM) x bins [n0, n0+BN) of one sample: each
// thread's 4 x 4 micro-tile at frames f0 + ty*TM.., bins n0 + tx*TN...
__device__ __forceinline__ void dft_tile(const float* __restrict__ yb,
                                         const float* __restrict__ bases,
                                         float (*As)[AS], float (*Cs)[BN], float (*Ss)[BN],
                                         int f0, int n0, int T, int n_fft, int hop,
                                         int n_frames, int f_pad,
                                         float (&re)[TM][TN], float (&im)[TM][TN]) {
    const int t = threadIdx.x;
    const int tx = t % (BN / TN);
    const int ty = t / (BN / TN);
    const int pad = n_fft / 2;
    const float* cos_b = bases;
    const float* sin_b = bases + (size_t)n_fft * f_pad;
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
}

// Counts this block's arrival at sample b after publishing its writes;
// true in the last block of the sample to arrive, which also resets the
// sample's count to zero for the next launch.
__device__ __forceinline__ bool last_to_arrive(unsigned int* arrived, int b, bool* is_last) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *is_last = atomicAdd(&arrived[b], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!*is_last) return false;
    __threadfence();
    if (threadIdx.x == 0) arrived[b] = 0u;  // every block of sample b has arrived
    return true;
}

// kInt8: `out` is the frame-major scratch [B, n_frames, n_bins] and the
// result is out8 [B, n_frames, n_bins] int8; else out [B, n_bins, n_frames].
template <bool kInt8>
__global__ void __launch_bounds__(THREADS)
frontend_linear_kernel(const float* __restrict__ y,      // [B, T]
                       const float* __restrict__ bases,  // [2, n_fft, f_pad]: cos, sin
                       float* __restrict__ out,
                       signed char* __restrict__ out8,
                       float* __restrict__ tile_minmax,  // [B, tiles, 2]
                       unsigned int* __restrict__ arrived,  // [B], zero on entry and exit
                       int T, int n_fft, int hop, int n_frames, int n_bins,
                       int f_pad, float inv_scale, float zp) {
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

    float re[TM][TN], im[TM][TN];
    dft_tile(y + (size_t)b * T, bases, As, Cs, Ss, f0, n0, T, n_fft, hop, n_frames,
             f_pad, re, im);

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
    if constexpr (kInt8) {
        for (int e = t; e < BM * BN; e += THREADS) {
            const int f = e / BN, n = e % BN;
            if (n0 + n < n_bins && f0 + f < n_frames)
                ob[(size_t)(f0 + f) * n_bins + n0 + n] = As[n][f];
        }
    } else {
        for (int e = t; e < BN * BM; e += THREADS) {
            const int n = e / BM, f = e % BM;
            if (n0 + n < n_bins && f0 + f < n_frames)
                ob[(size_t)(n0 + n) * n_frames + f0 + f] = As[n][f];
        }
    }

    block_minmax(lmin, lmax, s_min, s_max);
    if (t == 0) {
        float* mm = tile_minmax + ((size_t)b * gridDim.x + blockIdx.x) * 2;
        mm[0] = lmin;
        mm[1] = lmax;
    }

    // The last tile of the sample to arrive normalises the whole sample.
    if (!last_to_arrive(arrived, b, &is_last)) return;

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
    if constexpr (kInt8) {
        // Same order of the same values: codes frame-major, like the scratch.
        signed char* qb = out8 + (size_t)b * total;
        if ((total & 3) == 0) {
            const float4* ob4 = reinterpret_cast<const float4*>(ob);
            char4* qb4 = reinterpret_cast<char4*>(qb);
            for (size_t e = t; e < total / 4; e += THREADS) {
                const float4 v = __ldcg(ob4 + e);
                qb4[e] = make_char4(quantize_code((v.x - mn) / den, inv_scale, zp),
                                    quantize_code((v.y - mn) / den, inv_scale, zp),
                                    quantize_code((v.z - mn) / den, inv_scale, zp),
                                    quantize_code((v.w - mn) / den, inv_scale, zp));
            }
        } else {
            for (size_t e = t; e < total; e += THREADS)
                qb[e] = quantize_code((__ldcg(ob + e) - mn) / den, inv_scale, zp);
        }
    } else if ((total & 3) == 0) {
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

// pwl_compress of ops/magnitude.py on a [0, 1]-normalized value, in its order.
__device__ __forceinline__ float pwl(float x) {
    float y = 0.40f * x;
    y = y + 0.25f * fmaxf(x - 0.10f, 0.0f);
    y = y + 0.15f * fmaxf(x - 0.35f, 0.0f);
    y = y + 0.08f * fmaxf(x - 0.65f, 0.0f);
    return y;
}

// One sample's epilogue, run by one block over buf[w * ld + c] (w < rows
// frames, c < C channels, frame-major; in shared memory or in the scratch),
// which it may overwrite. Writes the normalized freq-major ob[c * out_w + w]
// (mfcc: ob[k * out_w + w], k < n_mfcc); with o8, writes those values'
// int8 codes frame-major to o8[w * bins + c] instead, and ob is scratch.
// Every reduction is a min or a max, and every sum (the DCT) is one
// thread's, in order.
__device__ void sample_epilogue(float* buf, int ld, int rows, int C, float* ob, int out_w,
                                int epi, const float* __restrict__ dct, int n_mfcc,
                                float pcen_a, float pcen_b, float* s_min, float* s_max,
                                signed char* o8, float inv_scale, float zp) {
    const int t = threadIdx.x;
    const int n = rows * C;
    // Element e of the sample, in frame-major order.
    const auto at = [=](int e) -> float& { return buf[(e / C) * ld + e % C]; };

    float mn = INFINITY, mx = -INFINITY;
    if (epi == EPI_NONE || epi == EPI_PWL) {
        for (int e = t; e < n; e += THREADS) {
            mn = fminf(mn, at(e));
            mx = fmaxf(mx, at(e));
        }
    }
    if (epi == EPI_PWL) {
        block_minmax(mn, mx, s_min, s_max);
        const float lo = mn, den = mx - mn + 1e-10f;
        mn = INFINITY;
        mx = -INFINITY;
        for (int e = t; e < n; e += THREADS) {
            float& x = at(e);
            x = pwl((x - lo) / den);
            mn = fminf(mn, x);
            mx = fmaxf(mx, x);
        }
    } else if (epi == EPI_LOG1P) {
        for (int e = t; e < n; e += THREADS) {
            float& x = at(e);
            x = log1pf(x);
            mn = fminf(mn, x);
            mx = fmaxf(mx, x);
        }
    } else if (epi == EPI_DB || epi == EPI_MFCC) {
        // db: amplitude_to_db(S, ref=max S) = power_to_db(S^2, ref^2,
        // amin 1e-10); mfcc: power_to_db(S, ref=max S) of the power mel.
        const bool square = epi == EPI_DB;
        for (int e = t; e < n; e += THREADS) mx = fmaxf(mx, at(e));
        block_minmax(mn, mx, s_min, s_max);
        const float ref_db = 10.0f * log10f(fmaxf(square ? mx * mx : mx, 1e-10f));
        mx = -INFINITY;
        for (int e = t; e < n; e += THREADS) {
            float& x = at(e);
            x = 10.0f * log10f(fmaxf(square ? x * x : x, 1e-10f)) - ref_db;
            mx = fmaxf(mx, x);
        }
        block_minmax(mn, mx, s_min, s_max);
        const float floor_db = mx - 80.0f;  // top_db over every frame
        mn = INFINITY;
        mx = -INFINITY;
        for (int e = t; e < n; e += THREADS) {
            float& x = at(e);
            x = fmaxf(x, floor_db);
            mn = fminf(mn, x);
            mx = fmaxf(mx, x);
        }
        if (epi == EPI_MFCC) {
            __syncthreads();
            // DCT over the mel axis for the first out_w frames, then the
            // min-max of the coefficients.
            mn = INFINITY;
            mx = -INFINITY;
            for (int e = t; e < n_mfcc * out_w; e += THREADS) {
                const int k = e / out_w, w = e % out_w;
                const float* row = buf + (size_t)w * ld;
                float acc = 0.0f;
                for (int m = 0; m < C; ++m) acc = fmaf(row[m], __ldg(dct + m * n_mfcc + k), acc);
                ob[e] = acc;
                mn = fminf(mn, acc);
                mx = fmaxf(mx, acc);
            }
            block_minmax(mn, mx, s_min, s_max);  // its barriers publish ob
            const float den = mx - mn + 1e-10f;
            if (o8) {
                for (int e = t; e < n_mfcc * out_w; e += THREADS) {
                    const int w = e / n_mfcc, k = e % n_mfcc;
                    o8[e] = quantize_code((ob[k * out_w + w] - mn) / den, inv_scale, zp);
                }
                return;
            }
            for (int e = t; e < n_mfcc * out_w; e += THREADS) ob[e] = (ob[e] - mn) / den;
            return;
        }
    } else if (epi == EPI_PCEN) {  // on S * 2^31, librosa.pcen's defaults
        // The smoother, one thread per channel over the frames in order:
        // m[0] = s[0], m[w] = a*m[w-1] + b*s[w]; M parks in ob (rows == out_w).
        for (int c = t; c < C; c += THREADS) {
            float m = buf[c] * 2147483648.0f;
            ob[(size_t)c * out_w] = m;
            for (int w = 1; w < rows; ++w) {
                m = pcen_a * m + pcen_b * (buf[(size_t)w * ld + c] * 2147483648.0f);
                ob[(size_t)c * out_w + w] = m;
            }
        }
        __syncthreads();
        const float log_eps = logf(1e-6f);
        for (int e = t; e < n; e += THREADS) {
            float& x = at(e);
            const float s = x * 2147483648.0f;
            const float M = ob[(size_t)(e % C) * out_w + e / C];
            const float smooth = expf(-0.98f * (log_eps + log1pf(M / 1e-6f)));
            x = 1.41421356f * expm1f(0.5f * log1pf(s * smooth / 2.0f));
            mn = fminf(mn, x);
            mx = fmaxf(mx, x);
        }
    }
    block_minmax(mn, mx, s_min, s_max);
    const float den = mx - mn + 1e-10f;
    if (o8) {
        for (int e = t; e < C * out_w; e += THREADS) {
            const int w = e / C, c = e % C;
            o8[e] = quantize_code((buf[(size_t)w * ld + c] - mn) / den, inv_scale, zp);
        }
        return;
    }
    for (int e = t; e < C * out_w; e += THREADS) {
        const int c = e / out_w, w = e % out_w;
        ob[e] = (buf[(size_t)w * ld + c] - mn) / den;
    }
}

__global__ void __launch_bounds__(THREADS)
frontend_features_kernel(const float* __restrict__ y,       // [B, T]
                         const float* __restrict__ bases,   // [2, n_fft, f_pad]
                         const float* __restrict__ mel_fb,  // [f_pad, n_mel], zero rows past F
                         const float* __restrict__ dct,     // [n_mel, n_mfcc] (mfcc)
                         float* __restrict__ scratch,       // [B, n_frames, C]
                         float* __restrict__ out,           // [B, bins, out_w]
                         signed char* __restrict__ out8,    // [B, out_w, bins] or null
                         unsigned int* __restrict__ arrived,  // [B], zero on entry and exit
                         int T, int n_fft, int hop, int n_frames, int n_bins, int f_pad,
                         int n_mel, int n_mfcc, int out_w, int epi, float pcen_a,
                         float pcen_b, int stage_in_smem, float inv_scale, float zp) {
    extern __shared__ __align__(16) float smem[];  // the strip's tiles, then the sample
    float (*As)[AS] = reinterpret_cast<float (*)[AS]>(smem);
    float (*Cs)[BN] = reinterpret_cast<float (*)[BN]>(smem + BK * AS);
    float (*Ss)[BN] = reinterpret_cast<float (*)[BN]>(smem + BK * AS + BK * BN);
    __shared__ float s_min[WARPS], s_max[WARPS];
    __shared__ bool is_last;

    const int b = blockIdx.y;
    const int strips = (n_frames + BM - 1) / BM;
    const int f0 = (blockIdx.x % strips) * BM;
    const int t = threadIdx.x;
    const int tx = t % (BN / TN);
    const int ty = t / (BN / TN);
    const int C = n_mel > 0 ? n_mel : n_bins;
    const bool power = epi == EPI_MFCC;
    float* sb = scratch + (size_t)b * n_frames * C;

    // Mel product: thread t owns mel m of frames fm .. fm + MEL_FRAMES.
    const int m = (blockIdx.x / strips) * MEL_CHUNK + t % MEL_CHUNK;
    const int fm = (t / MEL_CHUNK) * MEL_FRAMES;
    float mel[MEL_FRAMES];
#pragma unroll
    for (int j = 0; j < MEL_FRAMES; ++j) mel[j] = 0.0f;

    for (int n0 = 0; n0 < f_pad; n0 += BN) {
        float re[TM][TN], im[TM][TN];
        dft_tile(y + (size_t)b * T, bases, As, Cs, Ss, f0, n0, T, n_fft, hop, n_frames,
                 f_pad, re, im);
        // |X| (mfcc: |X|^2) -> As[bin][frame]; bins past F are zero.
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            float v[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                v[i] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
                if (!power) v[i] = sqrtf(v[i]);
            }
            *reinterpret_cast<float4*>(&As[tx * TN + j][ty * TM]) =
                make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncthreads();
        if (n_mel > 0) {
            for (int kk = 0; kk < BN; ++kk) {
                const float w = m < n_mel ? __ldg(mel_fb + (size_t)(n0 + kk) * n_mel + m) : 0.0f;
                if (!__any_sync(0xffffffffu, w != 0.0f)) continue;  // adds exact zeros only
                const float4* row = reinterpret_cast<const float4*>(&As[kk][fm]);
#pragma unroll
                for (int q = 0; q < MEL_FRAMES / 4; ++q) {
                    const float4 a = row[q];
                    mel[4 * q + 0] = fmaf(a.x, w, mel[4 * q + 0]);
                    mel[4 * q + 1] = fmaf(a.y, w, mel[4 * q + 1]);
                    mel[4 * q + 2] = fmaf(a.z, w, mel[4 * q + 2]);
                    mel[4 * q + 3] = fmaf(a.w, w, mel[4 * q + 3]);
                }
            }
        } else {
            for (int e = t; e < BM * BN; e += THREADS) {
                const int f = e / BN, k = e % BN;
                if (f0 + f < n_frames && n0 + k < n_bins)
                    sb[(size_t)(f0 + f) * C + n0 + k] = As[k][f];
            }
        }
        __syncthreads();
    }
    if (n_mel > 0 && m < n_mel) {
#pragma unroll
        for (int j = 0; j < MEL_FRAMES; ++j)
            if (f0 + fm + j < n_frames) sb[(size_t)(f0 + fm + j) * C + m] = mel[j];
    }

    if (!last_to_arrive(arrived, b, &is_last)) return;

    float* buf = sb;
    int ld = C;
    if (stage_in_smem) {
        // __ldcg reads through L2: other blocks' writes are not in this SM's L1.
        ld = C + 1;
        for (int e = t; e < n_frames * C; e += THREADS)
            smem[(e / C) * ld + e % C] = __ldcg(sb + e);
        __syncthreads();
        buf = smem;
    }
    const int bins = epi == EPI_MFCC ? n_mfcc : C;
    sample_epilogue(buf, ld, n_frames, C, out + (size_t)b * bins * out_w, out_w, epi, dct,
                    n_mfcc, pcen_a, pcen_b, s_min, s_max,
                    out8 ? out8 + (size_t)b * bins * out_w : nullptr, inv_scale, zp);
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

// Launches the linear kernel on `stream` and returns cudaGetLastError()
// (0 = ok). `out` holds B * bins * n_frames floats: the result [B, bins, W],
// or with `out8` (B * n_frames * bins int8, the codes [B, W, bins]) the
// scratch. `arrived` must hold B zeros, and holds B zeros again when the
// kernel ends; `tile_minmax` B * tiles * 2 floats.
int frontend_linear(const float* y, const float* bases, float* out, signed char* out8,
                    float* tile_minmax, unsigned int* arrived, int B, int T, int n_fft,
                    int hop, int n_frames, float inv_scale, int zp, void* stream) {
    if (B <= 0 || B > 65535 || n_fft % BK != 0 || 2 * hop < n_fft || n_frames <= 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(frontend_linear_tiles(n_fft, n_frames), B);
    if (out8)
        frontend_linear_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            y, bases, out, out8, tile_minmax, arrived, T, n_fft, hop, n_frames,
            n_fft / 2 + 1, frontend_linear_bin_pad(n_fft), inv_scale, (float)zp);
    else
        frontend_linear_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            y, bases, out, nullptr, tile_minmax, arrived, T, n_fft, hop, n_frames,
            n_fft / 2 + 1, frontend_linear_bin_pad(n_fft), 0.0f, 0.0f);
    return (int)cudaGetLastError();
}

// Launches the features kernel on `stream`; returns a cudaError_t (0 = ok).
// `epi` is an Epilogue; n_mel 0 means no mel product (linear bins). `mel_fb`
// is [bin_pad, n_mel] with zero rows past n_fft/2+1, `dct` [n_mel, n_mfcc]
// (mfcc only), `scratch` B * n_frames * C floats (C = n_mel, or the bins),
// `out` B * bins * out_w floats (bins = n_mfcc for mfcc, else C); out_w ==
// n_frames except for mfcc. With `out8` (B * out_w * bins int8) the codes
// go there, frame-major, and `out` is scratch. `arrived` as for
// frontend_linear.
int frontend_features(const float* y, const float* bases, const float* mel_fb,
                      const float* dct, float* scratch, float* out, signed char* out8,
                      unsigned int* arrived, int B, int T, int n_fft, int hop,
                      int n_frames, int n_mel, int n_mfcc, int out_w, int epi,
                      float pcen_a, float pcen_b, float inv_scale, int zp, void* stream) {
    const int n_bins = n_fft / 2 + 1;
    const int C = n_mel > 0 ? n_mel : n_bins;
    if (B <= 0 || B > 65535 || n_fft % BK != 0 || 2 * hop < n_fft || n_frames <= 0 ||
        n_mel < 0 || epi < EPI_NONE || epi > EPI_MFCC ||
        (epi == EPI_MFCC ? (n_mel == 0 || n_mfcc <= 0 || out_w <= 0 || out_w > n_frames)
                         : out_w != n_frames))
        return (int)cudaErrorInvalidValue;
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&attr, frontend_features_kernel) != cudaSuccess)
        return (int)cudaGetLastError();
    const size_t tile_bytes = sizeof(float) * TILE_FLOATS;
    const size_t sample_bytes = sizeof(float) * (size_t)n_frames * (C + 1);
    const int stage_in_smem = sample_bytes + attr.sharedSizeBytes <= (size_t)optin;
    const size_t smem = stage_in_smem && sample_bytes > tile_bytes ? sample_bytes : tile_bytes;
    if (smem > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            frontend_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    const int strips = (n_frames + BM - 1) / BM;
    const int chunks = n_mel > 0 ? (n_mel + MEL_CHUNK - 1) / MEL_CHUNK : 1;
    const dim3 grid(strips * chunks, B);
    frontend_features_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        y, bases, mel_fb, dct, scratch, out, out8, arrived, T, n_fft, hop, n_frames, n_bins,
        frontend_linear_bin_pad(n_fft), n_mel, n_mfcc, out_w, epi, pcen_a, pcen_b,
        stage_in_smem, inv_scale, (float)zp);
    return (int)cudaGetLastError();
}

}  // extern "C"
