// Fused |STFT| frontends for Hopper (sm_90a), float32 math, float32 or
// int8 out.
//
// Replaces birdnet_stm32_tpu/ops/pallas/frontend_kernel.py::_kernel
// (fused_spectrogram(grid="sample"), with _frame_and_mag and
// _sample_epilogue) and ::_kernel_tile (grid="tile"), in two kernels built
// on one in-block real FFT (frame_fft, spectrum_bins):
//
// frontend_linear_kernel: mode="linear", mag_scale="none", the hybrid
// frontend: framing, FFT, |X|, per-sample min-max
// (S - min) / (max - min + 1e-10), out [B, F, W] (the tile grid and the
// int8 scratch: frame-major [B, W, F]).
//
// frontend_features_kernel: every other epilogue of _sample_epilogue: the
// mel product, then none / pwl / db / pcen, log_mel (log1p), mfcc (power,
// mel, power_to_db over all frames, DCT, slice), and the linear mode with
// pwl / db / pcen.
//
// Each has an int8-entry specialisation (quant=(scale, zp), the last step
// of _sample_epilogue): the same normalized floats S in the same
// operations, stored as q = clip(round_half_away(S * inv_scale) + zp,
// -128, 127) in the frame-major [W, bins] layout, the INT8 executor's
// entry tensor. inv_scale is float32(1) / float32(scale), taken on the
// host: jitted XLA turns the reference's S / scale into that multiply.
//
// The FFT stage. A block owns a 64-row strip of frames (8 warps, 8 rows
// each); a warp transforms its frames one after another. Frame k of a
// sample is ypad[k*hop, k*hop + n_fft) with ypad = n_fft/2 zeros ++ y ++
// zeros (2*hop >= n_fft, so no frame reaches past (n_frames+1)*hop, the
// reference's `need` cut). The n_fft real taps, times the float32 periodic
// Hann window (ops/stft.py::hann_window), are packed as N = n_fft/2
// complex points z[n] = x[2n] + i x[2n+1] and transformed by a self-sorting
// (Stockham) radix-8/4 FFT: each pass, a lane loads its butterflies'
// points into registers, runs the radix-R DFT there, and stores them back
// to the warp's own buffer in shared memory (indices padded by one slot in
// 16 against bank conflicts); the first pass loads the taps straight from
// the waveform, coalesced, zero outside [0, T). The split post-processing
// X[k] = (Z[k] + conj Z[N-k]) / 2 - i W^k (Z[k] - conj Z[N-k]) / 2 gives
// the n_fft/2 + 1 bins. Twiddles W^m = exp(-2 pi i m / n_fft), m < n_fft,
// and the window come from one host table (float64, rounded once, like the
// DFT bases of ops/stft.py), held in shared memory; each block lays the
// passes' twiddles out again as rows a butterfly's lanes read without bank
// conflicts. Every add, multiply and multiply-add is written out
// (__fadd_rn, __fmul_rn, fmaf), so nvcc contracts nothing: a frame's bins
// are the same bits in every kernel and grid that computes them. n_fft is a
// power of two from 64 to 2048, one template per size.
//
// What bounds them: the bytes. The function needs each waveform sample
// read once and each feature written once: at the flagship (B=64) 16.9 MB
// in and 16.8 MB (257 linear bins) or 4.2 MB (64 mels) out, 10.1 or 6.3 us
// at 3.35 TB/s. Its arithmetic through the FFT is ~14 kFLOP per frame plus
// the mel bank's nonzeros, the DCT and the epilogue, ~4 us at 67 TFLOP/s
// fp32. What keeps the kernels above that, and what the design does:
// - the FFT stage is latency-bound: a warp's frame is a chain of dependent
//   steps through shared memory (the passes and the post-processing; four
//   at the flagship) with 16-24 warps per SM. The passes' twiddle rows keep
//   its shared-memory loads free of bank conflicts; the taps are read twice
//   (hop 258 < n_fft 512), from L2 the second time;
// - the per-sample min-max needs every strip of a sample: the last strip to
//   arrive (an atomic count after a __threadfence; it resets the count for
//   the next launch) reduces the per-strip extrema and normalizes the
//   sample in place, an L2 re-read of its output (the linear kernel), or
//   runs the whole epilogue on the sample staged in shared memory (the
//   features kernel). That tail runs on one block per sample, after the
//   strips, and takes a third of the linear and mel kernels' time on an
//   H100; pcen's smoother in it is a sequential scan over the frames, one
//   thread per channel, and the mfcc tail (dB over all frames, DCT) two
//   thirds of its kernel;
// - shared memory and registers hold 2 blocks of the linear kernel per SM
//   (its freq-major strip tile is 66.8 KB at 257 bins) and 3 of the
//   features kernel (a staged sample is 66.5 KB).

// The linear kernel. The warp writes each frame's |X| to a strip tile
// [F][rows + 1] in shared memory (conflict-free: rows + 1 is odd), and the
// block stores the tile freq-major, one 64-frame row per bin; frame-major
// launches store each frame's bins straight from registers. Where a tile
// of 64 rows does not fit (n_fft 2048), the strip is done in sub-strips of
// 32, 16 or 8 rows. Each warp reduces its frames' extrema, and the block
// keeps one (min, max) per sample it touches in strip_minmax.
//
// The features kernel. After its frame's FFT a warp puts |X| (|X|^2 for
// mfcc) in its buffer and each lane sums its mels over their nonzero bin
// ranges (a compact bank from the host: per mel [lo, hi) and an offset into
// its weights, in increasing bin order with fmaf, the dense product's sum
// without its exact zeros), then writes the frame's mel row to the
// frame-major scratch [B, W, C]; with no mel (the linear mode) the bins go
// there as they are. The last strip of a sample to arrive loads the sample
// from L2 into shared memory (rows padded to C+1 floats, so the freq-major
// transpose on the way out is free of bank conflicts) and runs the
// epilogue: the multi-pass reductions (pwl: min-max, curve, min-max; db:
// max, dB, peak-80 clamp, min-max; mfcc: max, dB over all frames, clamp,
// DCT, min-max) and pcen's smoother. Sums never use float atomics: each is
// one thread's, in a fixed order, so the result does not depend on which
// block arrives last. A sample too large for shared memory (the linear
// mode's 257 bins) runs the same epilogue in place in the L2-resident
// scratch. The shared memory is one dynamic buffer, the FFT's table and
// buffers first and the sample after.
//
// The int8 specialisations. The linear kernel then writes its magnitudes
// frame-major into a float scratch ([B, W, F], the float output's bytes)
// and the last block reads them back, normalizes and quantizes them in the
// same order (float4 in, char4 out). The features kernel's last block
// quantizes where the float one writes its normalized output; its float
// output buffer stays the scratch that pcen (the smoother) and mfcc (the
// DCT) use. __fmul_rn / __fadd_rn keep the rounding out of any FMA and the
// build has no --use_fast_math, so the codes equal quantize(float kernel
// output) bit for bit.
//
// The tile grid (_kernel_tile, batch_tile samples per program). A group of
// `tile` samples is a stack of tile * n_frames rows, row r being frame
// r % n_frames of sample r / n_frames, and the 64-row strips of both
// kernels walk the stack (grid = (strips per group, B / tile)); the sample
// grid is tile == 1. A warp maps each of its rows to (sample, frame) once,
// by one __umulhi (exact: see frame_of), so a strip that straddles two
// samples costs nothing extra. A frame's arithmetic does not depend on the
// block that computes it, so the two grids are equal bit for bit. What
// used to count to gridDim.x counts to the sample's own number of strips
// (first strip and count per sample of a group from the host,
// ops/kernels/frontend_kernel.py::tile_layout): a block arrives at every
// sample it touches, keeps one extrema slot per sample in the linear
// kernel, and runs each epilogue it is last for. Float results are written
// frame-major [B, W, bins], the TPU kernel's layout (the caller sees them
// through a transposed view); the int8 codes are frame-major in both grids.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;                 // rows (frames) of a strip
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_LOG2_N = 5;          // N = n_fft / 2 complex points: n_fft 64 ..
constexpr int MAX_LOG2_N = 10;         // .. 2048
static_assert(BM % WARPS == 0, "a strip's rows split evenly over the warps");

// The per-sample epilogues of _sample_epilogue.
enum Epilogue { EPI_NONE = 0, EPI_PWL = 1, EPI_DB = 2, EPI_PCEN = 3, EPI_LOG1P = 4, EPI_MFCC = 5 };

// The int8-entry quantization of one normalized value:
// clip(round_half_away(s * inv_scale) + zp, -128, 127).
__device__ __forceinline__ signed char quantize_code(float s, float inv_scale, float zp) {
    const float f = __fmul_rn(s, inv_scale);
    const float q = __fadd_rn(copysignf(floorf(__fadd_rn(fabsf(f), 0.5f)), f), zp);
    return static_cast<signed char>(fminf(fmaxf(q, -128.0f), 127.0f));
}

__device__ __forceinline__ void warp_minmax(float& mn, float& mx) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
}

__device__ __forceinline__ void block_minmax(float& mn, float& mx,
                                             float* s_min, float* s_max) {
    warp_minmax(mn, mx);
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

// Complex float32 arithmetic with every rounding written out (no FMA
// contraction by the compiler).
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(fmaf(a.x, b.x, -__fmul_rn(a.y, b.y)), fmaf(a.x, b.y, __fmul_rn(a.y, b.x)));
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// In-register forward DFTs of 4 and 8 points, natural order in and out.
__device__ __forceinline__ void dft(float2 (&v)[4]) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = mul_neg_i(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[1] = cadd(t1, t3);
    v[2] = csub(t0, t2);
    v[3] = csub(t1, t3);
}
__device__ __forceinline__ void dft(float2 (&v)[8]) {
    constexpr float C = 0.70710678118654752f;  // cos(pi/4)
    float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
    dft(e);
    dft(o);
    o[1] = make_float2(__fmul_rn(C, __fadd_rn(o[1].x, o[1].y)),    // W8^1 = C (1 - i)
                       __fmul_rn(C, __fsub_rn(o[1].y, o[1].x)));
    o[2] = mul_neg_i(o[2]);                                         // W8^2 = -i
    o[3] = make_float2(__fmul_rn(C, __fsub_rn(o[3].y, o[3].x)),    // W8^3 = -C (1 + i)
                       -__fmul_rn(C, __fadd_rn(o[3].x, o[3].y)));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[k] = cadd(e[k], o[k]);
        v[k + 4] = csub(e[k], o[k]);
    }
}

// A warp's buffer index: one padding slot per 16 complex points, so the
// strided stores of the early passes spread over the banks.
__device__ __forceinline__ int padded(int e) { return e + (e >> 4); }

// log2 of the radix of the pass that leaves `rem` of the FFT's log2 N bits
// to do: radix 8, and radix 4 to finish 2 or 4 bits (8,4 for N=32; 8,8 for
// N=64; 8,4,4 for N=128; 8,8,4 for N=256; 8,8,8 for N=512; 8,8,4,4 for
// N=1024). No N from 2^5 to 2^10 leaves a single bit.
__host__ __device__ constexpr int pass_log2_radix(int rem) { return rem == 2 || rem == 4 ? 2 : 3; }

// Complex slots of a warp's buffer for an N-point FFT.
__host__ __device__ constexpr int buffer_slots(int n) { return n + n / 16; }

// Complex slots of the twiddle rows of the passes after the first that
// start before bit `until` of a 2^log2n-point FFT: (R - 1) Ns per pass.
// The pass starting at bit `done` finds its rows at offset
// pass_twiddle_slots(log2n, done); the whole table is
// pass_twiddle_slots(log2n, log2n).
__host__ __device__ constexpr int pass_twiddle_slots(int log2n, int until) {
    int slots = 0;
    for (int done = pass_log2_radix(log2n); done < until; done += pass_log2_radix(log2n - done))
        slots += ((1 << pass_log2_radix(log2n - done)) - 1) << done;
    return slots;
}

// Lays out each pass's twiddles W_N^{k r} = tw[k r S] as rows
// ptw[offset + (r - 1) Ns + k], k < Ns, so the lanes of a butterfly's
// twiddle load read consecutive slots (strided reads of tw conflicted
// 4-8-way on the banks). Every thread of the block takes part.
template <int LOG2N, int DONE>
__device__ __forceinline__ void fill_pass_twiddles(float2* ptw, const float2* tw) {
    if constexpr (DONE < LOG2N) {
        constexpr int LR = pass_log2_radix(LOG2N - DONE), R = 1 << LR, NS = 1 << DONE;
        constexpr int S = 2 * (1 << LOG2N) / (NS * R), OFF = pass_twiddle_slots(LOG2N, DONE);
        for (int i = threadIdx.x; i < (R - 1) * NS; i += THREADS)
            ptw[OFF + i] = tw[(i % NS) * (i / NS + 1) * S];
        fill_pass_twiddles<LOG2N, DONE + LR>(ptw, tw);
    }
}

// The Stockham passes after the first, each of the N/R radix-R butterflies
// j = lane + 32q: twiddles W_N^{(j mod Ns) r} (from the pass's rows of
// ptw) on the points j + r N/R, the R-point DFT, the results to
// (j - j mod Ns) R + j mod Ns + r Ns. Every lane reads its points before
// any lane writes, so one buffer serves in place.
template <int LOG2N, int DONE>
__device__ __forceinline__ void fft_passes(float2* buf, const float2* ptw, int lane) {
    static_assert(LOG2N - DONE != 1, "no radix-2 pass");
    if constexpr (DONE < LOG2N) {
        constexpr int N = 1 << LOG2N, LR = pass_log2_radix(LOG2N - DONE);
        constexpr int R = 1 << LR, NS = 1 << DONE, NB = N / R, Q = (NB + 31) / 32;
        constexpr int OFF = pass_twiddle_slots(LOG2N, DONE);
        float2 v[Q][R];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int j = lane + 32 * q;
            if (NB % 32 == 0 || j < NB) {
#pragma unroll
                for (int r = 0; r < R; ++r) v[q][r] = buf[padded(j + r * NB)];
            }
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int j = lane + 32 * q;
            if (NB % 32 == 0 || j < NB) {
                const int k = j & (NS - 1);
#pragma unroll
                for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], ptw[OFF + (r - 1) * NS + k]);
                dft(v[q]);
                const int base = (j - k) * R + k;
#pragma unroll
                for (int r = 0; r < R; ++r) buf[padded(base + r * NS)] = v[q][r];
            }
        }
        __syncwarp();
        fft_passes<LOG2N, DONE + LR>(buf, ptw, lane);
    }
}

// The first pass's shape: radix R, its N/R butterflies j = lane + 32q,
// q < Q, and so Q x R packed taps per lane.
template <int LOG2N>
struct FirstPass {
    static constexpr int N = 1 << LOG2N, R = 1 << pass_log2_radix(LOG2N), NB = N / R;
    static constexpr int Q = (NB + 31) / 32;
    __device__ static constexpr bool active(int j) { return NB % 32 == 0 || j < NB; }
};

// The lane's packed taps of one frame, z[n] = (x[2n], x[2n+1]) for
// n = j + r N/R: ys is the frame's sample, its tap i is ys[start + i], zero
// outside [0, T). A warp reads 2 N/R consecutive taps per r, coalesced, as
// scalars: a waveform row of 66150 floats starts 8-byte aligned only every
// other row, and float2 loads where a pair was aligned ran no faster on an
// H100.
template <int LOG2N>
__device__ __forceinline__ void load_taps(const float* __restrict__ ys, int start, int T,
                                          int lane,
                                          float2 (&z)[FirstPass<LOG2N>::Q][FirstPass<LOG2N>::R]) {
    using P = FirstPass<LOG2N>;
#pragma unroll
    for (int q = 0; q < P::Q; ++q) {
        const int j = lane + 32 * q;
        if (P::active(j)) {
#pragma unroll
            for (int r = 0; r < P::R; ++r) {
                const int i = start + 2 * (j + r * P::NB);
                z[q][r].x = (unsigned)i < (unsigned)T ? __ldg(ys + i) : 0.0f;
                z[q][r].y = (unsigned)(i + 1) < (unsigned)T ? __ldg(ys + i + 1) : 0.0f;
            }
        }
    }
}

// The N = 2^LOG2N-point complex FFT of one frame's packed taps z (from
// load_taps), by one warp, into buf in natural order. The first pass
// multiplies the taps by the window pairs win[n] = (w[2n], w[2n+1]) and
// needs no twiddles; the others read theirs from ptw (fill_pass_twiddles).
template <int LOG2N>
__device__ __forceinline__ void frame_fft(float2 (&z)[FirstPass<LOG2N>::Q][FirstPass<LOG2N>::R],
                                          const float2* win, const float2* ptw, float2* buf,
                                          int lane) {
    using P = FirstPass<LOG2N>;
    __syncwarp();  // the warp's previous frame is out of buf
#pragma unroll
    for (int q = 0; q < P::Q; ++q) {
        const int j = lane + 32 * q;
        if (P::active(j)) {
            float2 v[P::R];
#pragma unroll
            for (int r = 0; r < P::R; ++r) {
                const float2 w = win[j + r * P::NB];
                v[r] = make_float2(__fmul_rn(z[q][r].x, w.x), __fmul_rn(z[q][r].y, w.y));
            }
            dft(v);
#pragma unroll
            for (int r = 0; r < P::R; ++r) buf[padded(j * P::R + r)] = v[r];
        }
    }
    __syncwarp();
    fft_passes<LOG2N, pass_log2_radix(LOG2N)>(buf, ptw, lane);
}

// Sample and frame of stacked row f0 + f of a strip (f0: the strip's first
// frame in its first sample): ds = (f0 + f) / n_frames by one __umulhi with
// magic = ceil(2^32 / n_frames), exact for numerators and n_frames below
// 2^16 (the launchers check n_frames + 64 < 2^16).
__device__ __forceinline__ int2 frame_of(int f0, int f, int n_frames, unsigned int magic) {
    const unsigned int a = f0 + f;
    const int ds = n_frames == 1 ? (int)a : (int)__umulhi(a, magic);
    return make_int2(ds, (int)a - ds * n_frames);
}

// A warp's walk over strip rows f = first, first + WARPS, .. < end: calls
// body(f, z) with row f's packed taps. Row f is frame (f0 + f) mod n_frames
// of sample (f0 + f) / n_frames after the strip's first sample ys0
// (frame_of). Loading the next row's taps before row f's FFT ran no faster
// on an H100 (PERF.md), so a row's loads come just before its FFT.
template <int LOG2N, typename Body>
__device__ __forceinline__ void walk_rows(int first, int end, const float* ys0, int f0,
                                         int n_frames, int T, int hop, int lane, Body body) {
    using P = FirstPass<LOG2N>;
    const unsigned int magic = 0xffffffffu / n_frames + 1u;
    for (int f = first; f < end; f += WARPS) {
        const int2 sf = frame_of(f0, f, n_frames, magic);
        const int start = sf.y * hop - P::N;  // centre pad of n_fft / 2 = N taps
        float2 z[P::Q][P::R];
        load_taps<LOG2N>(ys0 + (size_t)sf.x * T, start, T, lane, z);
        body(f, z);
    }
}

// Bins per lane: bin k = lane + 32q, q < kBins, k <= N.
template <int LOG2N>
constexpr int kBins = (1 << LOG2N) / 32 + 1;

// |X[k]| (power: |X[k]|^2) of the real frame from its packed FFT Z in buf,
// for the lane's bins k = lane + 32q <= N:
// X[k] = ((Z[k] + conj Z[N-k]) - i W^k (Z[k] - conj Z[N-k])) / 2.
template <int LOG2N>
__device__ __forceinline__ void spectrum_bins(const float2* buf, const float2* tw, int lane,
                                              bool power, float (&mag)[kBins<LOG2N>]) {
    constexpr int N = 1 << LOG2N;
#pragma unroll
    for (int q = 0; q < kBins<LOG2N>; ++q) {
        const int k = lane + 32 * q;
        if (q + 1 < kBins<LOG2N> || k <= N) {
            const float2 a = buf[padded(k & (N - 1))];
            const float2 b = buf[padded((N - k) & (N - 1))];
            const float2 s = make_float2(__fadd_rn(a.x, b.x), __fsub_rn(a.y, b.y));
            const float2 d = make_float2(__fadd_rn(a.y, b.y), __fsub_rn(b.x, a.x));
            const float2 wd = cmul(d, tw[k]);
            const float re = __fmul_rn(0.5f, __fadd_rn(s.x, wd.x));
            const float im = __fmul_rn(0.5f, __fadd_rn(s.y, wd.y));
            const float p = fmaf(re, re, __fmul_rn(im, im));
            mag[q] = power ? p : sqrtf(p);
        }
    }
}

// Copies the host table (tw[2N] = W_{2N}^m, then win[N] window pairs) into
// shared memory.
__device__ __forceinline__ void load_table(float2* dst, const float2* __restrict__ table,
                                           int n) {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = __ldg(table + i);
}

// Counts this block's arrival at sample b, which `blocks` blocks touch,
// after publishing its writes; true in the last of them to arrive, which
// also resets the sample's count to zero for the next launch.
__device__ __forceinline__ bool last_to_arrive(unsigned int* arrived, int b, int blocks,
                                               bool* is_last) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *is_last = atomicAdd(&arrived[b], 1u) == (unsigned int)blocks - 1u;
    __syncthreads();
    if (!*is_last) return false;
    __threadfence();
    if (threadIdx.x == 0) arrived[b] = 0u;  // every block of sample b has arrived
    return true;
}

// The linear kernel's last step for sample b, by one block: (S - mn) / den
// over its `total` magnitudes in out (either layout) in place, or with
// kInt8 their codes, in the same order, into out8 (frame-major, like the
// scratch). __ldcg reads through L2: other blocks' writes are not in this
// SM's L1.
template <bool kInt8>
__device__ void normalize_sample(float* __restrict__ out, signed char* __restrict__ out8, int b,
                                 size_t total, float mn, float den, float inv_scale, float zp) {
    const int t = threadIdx.x;
    float* ob = out + (size_t)b * total;
    if constexpr (kInt8) {
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

// One block per 64-row strip of a group of `tile` samples (grid.y: the
// group), all bins. frame_major: `out` is [B, n_frames, F] (the tile
// grid's float result, or the int8 path's scratch), else [B, F, n_frames]
// (the sample grid, tile == 1), through the strip tile in `sub_rows`-row
// sub-strips. kInt8: the result is out8 [B, n_frames, F] int8 (needs
// frame_major). layout[g] = (first strip, strips) of the group's sample g;
// strip_minmax holds `slots` (min, max) pairs per sample, one per strip
// that touches it.
template <int LOG2N, bool kInt8>
__global__ void __launch_bounds__(THREADS, 2)
frontend_linear_kernel(const float* __restrict__ y,        // [B, T]
                       const float2* __restrict__ table,   // [3N]: tw, win
                       float* __restrict__ out,
                       signed char* __restrict__ out8,
                       float* __restrict__ strip_minmax,   // [B, slots, 2]
                       unsigned int* __restrict__ arrived,  // [B], zero on entry and exit
                       const int2* __restrict__ layout,     // [tile]
                       int T, int hop, int n_frames, int tile, int slots, int sub_rows,
                       bool frame_major, float inv_scale, float zp) {
    constexpr int N = 1 << LOG2N, F = N + 1, KB = kBins<LOG2N>;
    extern __shared__ __align__(16) float2 smem2[];
    constexpr int PT = pass_twiddle_slots(LOG2N, LOG2N);
    float2* tw = smem2;                                  // [2N]
    float2* win = tw + 2 * N;                            // [N]
    float2* ptw = win + N;                               // [PT]
    float2* buf = ptw + PT + (threadIdx.x / 32) * buffer_slots(N);  // this warp's
    float* stile = reinterpret_cast<float*>(ptw + PT + WARPS * buffer_slots(N));  // [F][ld]
    __shared__ float row_min[BM], row_max[BM];
    __shared__ float s_min[WARPS], s_max[WARPS];
    __shared__ bool is_last;

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    load_table(smem2, table, 3 * N);
    __syncthreads();
    fill_pass_twiddles<LOG2N, pass_log2_radix(LOG2N)>(ptw, tw);
    __syncthreads();

    const int group = blockIdx.y;
    const int n_rows = tile * n_frames;
    const int strip = blockIdx.x;
    const int r0 = strip * BM;
    const int rows = min(BM, n_rows - r0);
    const int s0 = r0 / n_frames;
    const int f0 = r0 - s0 * n_frames;
    const float* ys0 = y + ((size_t)group * tile + s0) * T;  // the strip's first sample
    float* og = out + (size_t)group * n_rows * F;            // the group's rows
    const int ld = sub_rows + 1;

    for (int sub0 = 0; sub0 < rows; sub0 += sub_rows) {
        const int sub_end = min(sub0 + sub_rows, rows);
        walk_rows<LOG2N>(sub0 + warp, sub_end, ys0, f0, n_frames, T, hop, lane,
                         [&](int f, float2 (&z)[FirstPass<LOG2N>::Q][FirstPass<LOG2N>::R]) {
            frame_fft<LOG2N>(z, win, ptw, buf, lane);
            float mag[KB];
            spectrum_bins<LOG2N>(buf, tw, lane, false, mag);
            float mn = INFINITY, mx = -INFINITY;
#pragma unroll
            for (int q = 0; q < KB; ++q) {
                if (q + 1 < KB || lane == 0) {
                    mn = fminf(mn, mag[q]);
                    mx = fmaxf(mx, mag[q]);
                }
            }
            warp_minmax(mn, mx);
            if (lane == 0) {
                row_min[f] = mn;
                row_max[f] = mx;
            }
            if (frame_major) {
                float* orow = og + (size_t)(r0 + f) * F;
#pragma unroll
                for (int q = 0; q < KB; ++q)
                    if (q + 1 < KB || lane == 0) orow[lane + 32 * q] = mag[q];
            } else {
#pragma unroll
                for (int q = 0; q < KB; ++q)
                    if (q + 1 < KB || lane == 0) stile[(lane + 32 * q) * ld + f - sub0] = mag[q];
            }
        });
        if (!frame_major) {
            __syncthreads();
            const int n = sub_end - sub0;
            for (int k = warp; k < F; k += WARPS)
                for (int f = lane; f < n; f += 32)
                    og[(size_t)k * n_rows + r0 + sub0 + f] = stile[k * ld + f];
            __syncthreads();
        }
    }
    __syncthreads();

    // The strip's extrema over each sample it touches, in that sample's slot.
    const int g_hi = (r0 + rows - 1) / n_frames;
    if (warp == 0) {
        for (int g = s0; g <= g_hi; ++g) {
            const int lo = max(g * n_frames - r0, 0), hi = min((g + 1) * n_frames - r0, rows);
            float mn = INFINITY, mx = -INFINITY;
            for (int f = lo + lane; f < hi; f += 32) {
                mn = fminf(mn, row_min[f]);
                mx = fmaxf(mx, row_max[f]);
            }
            warp_minmax(mn, mx);
            if (lane == 0) {
                float* mm = strip_minmax +
                            ((size_t)(group * tile + g) * slots + strip - __ldg(&layout[g].x)) * 2;
                mm[0] = mn;
                mm[1] = mx;
            }
        }
    }

    // The last strip of a sample to arrive normalises the whole sample.
    for (int g = s0; g <= g_hi; ++g) {
        const int b = group * tile + g;
        const int n_strips = __ldg(&layout[g].y);
        if (!last_to_arrive(arrived, b, n_strips, &is_last)) continue;

        float mn = INFINITY, mx = -INFINITY;
        for (int i = t; i < n_strips; i += THREADS) {
            const float* mm = strip_minmax + ((size_t)b * slots + i) * 2;
            mn = fminf(mn, __ldcg(mm));
            mx = fmaxf(mx, __ldcg(mm + 1));
        }
        block_minmax(mn, mx, s_min, s_max);
        normalize_sample<kInt8>(out, out8, b, (size_t)F * n_frames, mn, mx - mn + 1e-10f,
                                inv_scale, zp);
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
// (mfcc: ob[k * out_w + w], k < n_mfcc), or with frame_major ob[w * bins +
// c]; with o8 (which comes with frame_major), writes those values' int8
// codes to o8[w * bins + c] instead, and ob is scratch. Every reduction is
// a min or a max, and every sum (the DCT) is one thread's, in order, so the
// layout changes no value.
__device__ void sample_epilogue(float* buf, int ld, int rows, int C, float* ob, int out_w,
                                bool frame_major, int epi, const float* __restrict__ dct,
                                int n_mfcc, float pcen_a, float pcen_b, float* s_min,
                                float* s_max, signed char* o8, float inv_scale, float zp) {
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
            // DCT over the mel axis for the first out_w frames, into ob in
            // the output's layout, then the min-max of the coefficients.
            mn = INFINITY;
            mx = -INFINITY;
            for (int e = t; e < n_mfcc * out_w; e += THREADS) {
                const int k = frame_major ? e % n_mfcc : e / out_w;
                const int w = frame_major ? e / n_mfcc : e % out_w;
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
                for (int e = t; e < n_mfcc * out_w; e += THREADS)
                    o8[e] = quantize_code((ob[e] - mn) / den, inv_scale, zp);
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
    if (frame_major) {
        for (int e = t; e < C * out_w; e += THREADS) {
            const int w = e / C, c = e % C;
            const float v = (buf[(size_t)w * ld + c] - mn) / den;
            if (o8)
                o8[e] = quantize_code(v, inv_scale, zp);
            else
                ob[e] = v;
        }
        return;
    }
    for (int e = t; e < C * out_w; e += THREADS) {
        const int c = e / out_w, w = e % out_w;
        ob[e] = (buf[(size_t)w * ld + c] - mn) / den;
    }
}

// One block per 64-row strip of a group of `tile` samples (grid.y: the
// group), all mels; layout as for the linear kernel.
// frame_major (as for the linear kernel): `out` is [B, out_w, bins], else
// [B, bins, out_w]. mel_ranges[m] = (lo, hi, offset - lo) of mel m's bins
// [lo, hi) and its weights mel_w[offset ..]. 3 blocks per SM: a staged
// mel sample (66.5 KB) allows no more, and the bound keeps ptxas at 80
// registers.
template <int LOG2N>
__global__ void __launch_bounds__(THREADS, 3)
frontend_features_kernel(const float* __restrict__ y,         // [B, T]
                         const float2* __restrict__ table,    // [3N]: tw, win
                         const int4* __restrict__ mel_ranges,  // [n_mel]
                         const float* __restrict__ mel_w,      // [n_nz]
                         const float* __restrict__ dct,        // [n_mel, n_mfcc] (mfcc)
                         float* __restrict__ scratch,          // [B, n_frames, C]
                         float* __restrict__ out,              // B * bins * out_w
                         signed char* __restrict__ out8,       // [B, out_w, bins] or null
                         unsigned int* __restrict__ arrived,   // [B], zero on entry and exit
                         const int2* __restrict__ layout,      // [tile]
                         int T, int hop, int n_frames, int n_mel, int n_nz, int n_mfcc,
                         int out_w, int epi, float pcen_a, float pcen_b, int stage_in_smem,
                         int tile, int frame_major, float inv_scale, float zp) {
    constexpr int N = 1 << LOG2N, KB = kBins<LOG2N>;
    extern __shared__ __align__(16) float2 smem2[];  // the FFT's table and buffers, then the sample
    float* smem = reinterpret_cast<float*>(smem2);
    constexpr int PT = pass_twiddle_slots(LOG2N, LOG2N);
    float2* tw = smem2;                                             // [2N]
    float2* win = tw + 2 * N;                                       // [N]
    float2* ptw = win + N;                                          // [PT]
    float2* buf = ptw + PT + (threadIdx.x / 32) * buffer_slots(N);  // this warp's
    int4* mr = reinterpret_cast<int4*>(ptw + PT + WARPS * buffer_slots(N));  // [n_mel]
    float* mw = reinterpret_cast<float*>(mr + n_mel);                       // [n_nz]
    __shared__ float s_min[WARPS], s_max[WARPS];
    __shared__ bool is_last;

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    load_table(smem2, table, 3 * N);
    for (int i = t; i < n_mel; i += THREADS) mr[i] = __ldg(mel_ranges + i);
    for (int i = t; i < n_nz; i += THREADS) mw[i] = __ldg(mel_w + i);
    __syncthreads();
    fill_pass_twiddles<LOG2N, pass_log2_radix(LOG2N)>(ptw, tw);
    __syncthreads();

    const int group = blockIdx.y;
    const int n_rows = tile * n_frames;
    const int r0 = blockIdx.x * BM;
    const int rows = min(BM, n_rows - r0);
    const int s0 = r0 / n_frames;
    const int f0 = r0 - s0 * n_frames;
    const int C = n_mel > 0 ? n_mel : N + 1;
    const bool power = epi == EPI_MFCC;
    const float* ys0 = y + ((size_t)group * tile + s0) * T;
    float* sg = scratch + (size_t)group * n_rows * C;  // the group's rows

    walk_rows<LOG2N>(warp, rows, ys0, f0, n_frames, T, hop, lane,
                     [&](int f, float2 (&z)[FirstPass<LOG2N>::Q][FirstPass<LOG2N>::R]) {
        frame_fft<LOG2N>(z, win, ptw, buf, lane);
        float mag[KB];
        spectrum_bins<LOG2N>(buf, tw, lane, power, mag);
        float* srow = sg + (size_t)(r0 + f) * C;
        if (n_mel == 0) {
#pragma unroll
            for (int q = 0; q < KB; ++q)
                if (q + 1 < KB || lane == 0) srow[lane + 32 * q] = mag[q];
            return;
        }
        // Mel product from the frame's bins, staged in the warp's buffer.
        float* bins = reinterpret_cast<float*>(buf);
        __syncwarp();  // every lane has read the FFT
#pragma unroll
        for (int q = 0; q < KB; ++q)
            if (q + 1 < KB || lane == 0) bins[lane + 32 * q] = mag[q];
        __syncwarp();
        for (int m = lane; m < n_mel; m += 32) {
            const int4 r = mr[m];
            float acc = 0.0f;
            for (int k = r.x; k < r.y; ++k) acc = fmaf(bins[k], mw[r.z + k], acc);
            srow[m] = acc;
        }
    });

    // Every sample the strip touches: the last of its strips to arrive
    // runs its epilogue.
    const int g_hi = (r0 + rows - 1) / n_frames;
    for (int g = s0; g <= g_hi; ++g) {
        const int b = group * tile + g;
        if (!last_to_arrive(arrived, b, __ldg(&layout[g].y), &is_last)) continue;

        float* sb = scratch + (size_t)b * n_frames * C;
        float* sbuf = sb;
        int ld = C;
        if (stage_in_smem) {
            // __ldcg reads through L2: other blocks' writes are not in this SM's L1.
            ld = C + 1;
            for (int e = t; e < n_frames * C; e += THREADS)
                smem[(e / C) * ld + e % C] = __ldcg(sb + e);
            __syncthreads();
            sbuf = smem;
        }
        const int bins = epi == EPI_MFCC ? n_mfcc : C;
        sample_epilogue(sbuf, ld, n_frames, C, out + (size_t)b * bins * out_w, out_w,
                        frame_major != 0, epi, dct, n_mfcc, pcen_a, pcen_b, s_min, s_max,
                        out8 ? out8 + (size_t)b * bins * out_w : nullptr, inv_scale, zp);
    }
}

}  // namespace

namespace {

// log2 N (N = n_fft / 2) for a power-of-two n_fft in 64..2048, else -1.
int log2_points(int n_fft) {
    if (n_fft < 2 << MIN_LOG2_N || n_fft > 2 << MAX_LOG2_N || (n_fft & (n_fft - 1))) return -1;
    int lg = MIN_LOG2_N;
    while ((2 << lg) < n_fft) ++lg;
    return lg;
}

// The checks both launchers share: B samples in groups of `tile`, one
// group per grid row; the freq-major layout only with tile == 1 and
// without int8 codes.
bool bad_geometry(int B, int tile, int n_fft, int hop, int n_frames, int frame_major,
                  const signed char* out8) {
    return B <= 0 || tile <= 0 || B % tile != 0 || B / tile > 65535 || log2_points(n_fft) < 0 ||
           2 * hop < n_fft || n_frames <= 0 || n_frames + BM > 65535 ||
           n_frames > (1 << 30) / tile || (!frame_major && (tile != 1 || out8));
}

// The kernel's opt-in shared memory less its static shared memory.
template <typename Kernel>
cudaError_t dynamic_smem_limit(Kernel kernel, size_t* limit) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, kernel);
    *limit = rc == cudaSuccess && (size_t)optin > attr.sharedSizeBytes
                 ? (size_t)optin - attr.sharedSizeBytes : 0;
    return rc;
}

// Sets `kernel`'s dynamic shared memory to `smem` bytes; with `occupancy`
// (*query: the caller stops there), stores (smem, blocks per SM) in it.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int* occupancy, bool* query) {
    *query = occupancy != nullptr;
    cudaError_t rc = cudaSuccess;
    if (smem > 48 * 1024)
        rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc == cudaSuccess && occupancy) {
        occupancy[0] = (int)smem;
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy + 1, kernel, THREADS, smem);
    }
    return rc;
}

// Dynamic shared memory of the FFT stage: the table, the passes' twiddle
// rows and the warps' buffers.
size_t fft_smem(int lg) {
    const size_t n = (size_t)1 << lg;
    return sizeof(float2) * (3 * n + pass_twiddle_slots(lg, lg) + WARPS * buffer_slots((int)n));
}

struct LinearArgs {
    const float* y;
    const float2* table;
    float* out;
    signed char* out8;
    float* strip_minmax;
    unsigned int* arrived;
    const int2* layout;
    int B, T, hop, n_frames, tile, slots, frame_major;
    float inv_scale, zp;
    cudaStream_t stream;
};

// Launches the linear kernel, or with `occupancy` reports its shared
// memory and blocks per SM. Freq-major launches take the largest strip
// tile of 64, 32, 16 or 8 rows that fits.
template <int LOG2N, bool kInt8>
int linear_run(const LinearArgs& a, int* occupancy) {
    const auto kernel = frontend_linear_kernel<LOG2N, kInt8>;
    size_t limit = 0;
    cudaError_t rc = dynamic_smem_limit(kernel, &limit);
    if (rc != cudaSuccess) return (int)rc;
    int sub_rows = BM;
    size_t smem = fft_smem(LOG2N);
    if (!a.frame_major) {
        const size_t row_bytes = sizeof(float) * ((1 << LOG2N) + 1);
        while (sub_rows >= WARPS && fft_smem(LOG2N) + row_bytes * (sub_rows + 1) > limit)
            sub_rows /= 2;
        smem += row_bytes * (sub_rows + 1);
    }
    if (sub_rows < WARPS || smem > limit) return (int)cudaErrorInvalidValue;
    bool query = false;
    rc = prepare(kernel, smem, occupancy, &query);
    if (rc != cudaSuccess || query) return (int)rc;
    const dim3 grid((a.tile * a.n_frames + BM - 1) / BM, a.B / a.tile);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        a.y, a.table, a.out, a.out8, a.strip_minmax, a.arrived, a.layout, a.T, a.hop,
        a.n_frames, a.tile, a.slots, sub_rows, a.frame_major != 0, a.inv_scale, a.zp);
    return (int)cudaGetLastError();
}

template <bool kInt8>
int linear_dispatch(int lg, const LinearArgs& a, int* occupancy) {
    switch (lg) {
        case 5: return linear_run<5, kInt8>(a, occupancy);
        case 6: return linear_run<6, kInt8>(a, occupancy);
        case 7: return linear_run<7, kInt8>(a, occupancy);
        case 8: return linear_run<8, kInt8>(a, occupancy);
        case 9: return linear_run<9, kInt8>(a, occupancy);
        case 10: return linear_run<10, kInt8>(a, occupancy);
    }
    return (int)cudaErrorInvalidValue;
}

struct FeaturesArgs {
    const float* y;
    const float2* table;
    const int4* mel_ranges;
    const float* mel_w;
    const float* dct;
    float* scratch;
    float* out;
    signed char* out8;
    unsigned int* arrived;
    const int2* layout;
    int B, T, hop, n_frames, n_mel, n_nz, n_mfcc, out_w, epi;
    float pcen_a, pcen_b;
    int tile, frame_major;
    float inv_scale, zp;
    cudaStream_t stream;
};

// Launches the features kernel, or with `occupancy` reports its shared
// memory and blocks per SM. The sample is staged in shared memory when it
// fits, after the FFT stage in the same buffer.
template <int LOG2N>
int features_run(const FeaturesArgs& a, int* occupancy) {
    const auto kernel = frontend_features_kernel<LOG2N>;
    size_t limit = 0;
    cudaError_t rc = dynamic_smem_limit(kernel, &limit);
    if (rc != cudaSuccess) return (int)rc;
    const int C = a.n_mel > 0 ? a.n_mel : (1 << LOG2N) + 1;
    const size_t strip_bytes =
        fft_smem(LOG2N) + sizeof(int4) * a.n_mel + sizeof(float) * a.n_nz;
    const size_t sample_bytes = sizeof(float) * (size_t)a.n_frames * (C + 1);
    const int stage_in_smem = sample_bytes <= limit;
    const size_t smem = stage_in_smem && sample_bytes > strip_bytes ? sample_bytes : strip_bytes;
    if (smem > limit) return (int)cudaErrorInvalidValue;
    bool query = false;
    rc = prepare(kernel, smem, occupancy, &query);
    if (rc != cudaSuccess || query) return (int)rc;
    const dim3 grid((a.tile * a.n_frames + BM - 1) / BM, a.B / a.tile);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        a.y, a.table, a.mel_ranges, a.mel_w, a.dct, a.scratch, a.out, a.out8, a.arrived,
        a.layout, a.T, a.hop, a.n_frames, a.n_mel, a.n_nz, a.n_mfcc, a.out_w, a.epi, a.pcen_a,
        a.pcen_b, stage_in_smem, a.tile, a.frame_major, a.inv_scale, a.zp);
    return (int)cudaGetLastError();
}

int features_dispatch(int lg, const FeaturesArgs& a, int* occupancy) {
    switch (lg) {
        case 5: return features_run<5>(a, occupancy);
        case 6: return features_run<6>(a, occupancy);
        case 7: return features_run<7>(a, occupancy);
        case 8: return features_run<8>(a, occupancy);
        case 9: return features_run<9>(a, occupancy);
        case 10: return features_run<10>(a, occupancy);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The rows of a strip: the host's tile_layout uses it.
int frontend_strip_rows() { return BM; }

// Launches the linear kernel on `stream` and returns cudaGetLastError()
// (0 = ok). `table` is the FFT table of n_fft (a power of two in 64..2048:
// W^m = exp(-2 pi i m / n_fft) for m < n_fft as (re, im) pairs, then the
// Hann window). Samples go in groups of `tile` (B % tile == 0; 1 is the
// sample grid); `layout` holds, for each sample g of a group, (first
// strip, strips) as int pairs (ops/kernels/frontend_kernel.py::tile_layout).
// `out` holds B * bins * n_frames floats: the result, [B, bins, W] or with
// frame_major [B, W, bins], or with `out8` (B * n_frames * bins int8, the
// codes [B, W, bins]; needs frame_major) the scratch. `arrived` must hold B
// zeros, and holds B zeros again when the kernel ends; `strip_minmax`
// B * slots * 2 floats, slots >= the most strips a sample touches.
int frontend_linear(const float* y, const float* table, float* out, signed char* out8,
                    float* strip_minmax, unsigned int* arrived, const int* layout, int B, int T,
                    int n_fft, int hop, int n_frames, int tile, int slots, int frame_major,
                    float inv_scale, int zp, void* stream) {
    if (bad_geometry(B, tile, n_fft, hop, n_frames, frame_major, out8) || slots <= 0)
        return (int)cudaErrorInvalidValue;
    const LinearArgs a{y, reinterpret_cast<const float2*>(table), out, out8, strip_minmax,
                       arrived, reinterpret_cast<const int2*>(layout), B, T, hop, n_frames,
                       tile, slots, out8 ? 1 : frame_major, out8 ? inv_scale : 0.0f,
                       out8 ? (float)zp : 0.0f, (cudaStream_t)stream};
    const int lg = log2_points(n_fft);
    return out8 ? linear_dispatch<true>(lg, a, nullptr) : linear_dispatch<false>(lg, a, nullptr);
}

// Launches the features kernel on `stream`; returns a cudaError_t (0 = ok).
// `epi` is an Epilogue; n_mel 0 means no mel product (linear bins). The
// mel bank is compact: `mel_ranges` [n_mel, 4] ints, mel m's nonzero bins
// [lo, hi) and its weights' offset less lo (the third int; the fourth is
// unused), `mel_w` its n_nz weights. `dct` is [n_mel, n_mfcc] (mfcc only),
// `scratch` B * n_frames * C floats (C = n_mel, or the bins), `out`
// B * bins * out_w floats (bins = n_mfcc for mfcc, else C): the result,
// [B, bins, out_w] or with frame_major [B, out_w, bins]; out_w == n_frames
// except for mfcc. With `out8` (B * out_w * bins int8; needs frame_major)
// the codes go there, frame-major, and `out` is scratch. `table`, `tile`,
// `layout` and `arrived` as for frontend_linear.
int frontend_features(const float* y, const float* table, const int* mel_ranges,
                      const float* mel_w, const float* dct, float* scratch, float* out,
                      signed char* out8, unsigned int* arrived, const int* layout, int B, int T,
                      int n_fft, int hop, int n_frames, int n_mel, int n_nz, int n_mfcc,
                      int out_w, int epi, float pcen_a, float pcen_b, int tile, int frame_major,
                      float inv_scale, int zp, void* stream) {
    if (bad_geometry(B, tile, n_fft, hop, n_frames, frame_major, out8) || n_mel < 0 ||
        n_nz < 0 || (n_mel > 0 && (!mel_ranges || (n_nz > 0 && !mel_w))) || epi < EPI_NONE ||
        epi > EPI_MFCC ||
        (epi == EPI_MFCC ? (n_mel == 0 || n_mfcc <= 0 || out_w <= 0 || out_w > n_frames || !dct)
                         : out_w != n_frames))
        return (int)cudaErrorInvalidValue;
    const FeaturesArgs a{y, reinterpret_cast<const float2*>(table),
                         reinterpret_cast<const int4*>(mel_ranges), mel_w, dct, scratch, out,
                         out8, arrived, reinterpret_cast<const int2*>(layout), B, T, hop,
                         n_frames, n_mel, n_nz, n_mfcc, out_w, epi, pcen_a, pcen_b, tile,
                         frame_major, inv_scale, (float)zp, (cudaStream_t)stream};
    return features_dispatch(log2_points(n_fft), a, nullptr);
}

// The dynamic shared memory (bytes) and the blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the linear kernel for
// n_fft, into out[0] and out[1]; returns a cudaError_t.
int frontend_linear_occupancy(int n_fft, int frame_major, int int8, int* out) {
    LinearArgs a{};
    a.frame_major = int8 ? 1 : frame_major;
    const int lg = log2_points(n_fft);
    return int8 ? linear_dispatch<true>(lg, a, out) : linear_dispatch<false>(lg, a, out);
}

// The same for the features kernel at n_frames frames, n_mel mels (0: the
// linear bins) and n_nz mel weights.
int frontend_features_occupancy(int n_fft, int n_frames, int n_mel, int n_nz, int* out) {
    FeaturesArgs a{};
    a.n_frames = n_frames;
    a.n_mel = n_mel;
    a.n_nz = n_nz;
    return features_dispatch(log2_points(n_fft), a, out);
}

}  // extern "C"
